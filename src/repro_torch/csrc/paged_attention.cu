// Paged-attention decode over a block-pooled KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   repro/kernels/paged_attention/kernel.py:33  _paged_kernel (body)
//   repro/kernels/paged_attention/kernel.py:73  paged_attention (entry)
//
// What it computes (the same function, not the TPU's grid carried over):
// one decode query token per lane b attends over positions [0, kv_len[b])
// of that lane's KV, whose logical block j lives at pool row
// block_tables[b, j] (clamped into [0, num_blocks) here, as the JAX entry
// clamps it).  Softmax is online, with running max, sum and accumulator in
// float32; positions >= kv_len get weight exactly zero; the output is
// acc / max(l, 1e-30), so a lane with kv_len 0 writes zeros.
//
//   q            (B, H, D)            T
//   k_pool/v_pool (NB, bs, KV, D)     T      T = float or __nv_bfloat16
//   block_tables (B, max_blocks)      int32
//   kv_len       (B,)                 int32
//   out          (B, H, D)            T
//
// Bound: HBM bytes.  A decode token does 4 flops per cached element
// (q.k and p.v) against 2 bytes read (bf16), far under the ~295 flop/byte
// the H100 needs before its tensor cores are the limit, so the least time
// is the KV the lanes own, sum_b kv_len_b * KV * D * 2 (k and v) * 2 B,
// over 3.35 TB/s: 0.004-0.012 ms at the main path's shapes.  That is
// about one empty launch (0.005-0.007 ms through this library's ctypes
// path), so what a call costs is latency: the launch, the chain of
// dependent loads before the first K row arrives, the longest walk of one
// CTA over its positions, and the merge of the CTAs' softmax states.
//
// What the design does about it:
// * Work is split by positions read on the device.  The grid is (KV, B,
//   ceil(max_blocks * bs / kChunk)): each CTA takes one kv head of one lane
//   and a fixed chunk of kChunk positions; a CTA whose chunk starts at or
//   past its lane's kv_len exits before it loads anything.  The longest
//   walk is one chunk whatever the lanes' skew (tiles dealt to a number
//   of splits fixed by the table's width left a 1000-position lane
//   walking 4-8 tiles in turn while the CTAs of short lanes sat idle).
// * The chunks of a (lane, kv head) merge in the same launch: each writes
//   its (m, l, acc) to the workspace and counts itself on a per-(lane, kv
//   head) counter (one acq_rel atomic: release for its state, acquire for
//   the others'); the last one merges them all, eight chunks' loads in
//   flight at once, writes the output and sets the counter back to 0.  A
//   lane of one chunk writes its output directly.  No second kernel,
//   nothing read on the host, nothing allocated that depends on kv_len: a
//   CUDA graph can replay a call.
// * One CTA covers the whole GQA group G = H/KV, so each K/V row is read
//   from HBM once for all G query heads.
// * bf16, four warps a CTA, each walking its own 16-position pages (pages
//   w, w + 4, ... of the chunk): the warp copies its pages' K and V rows
//   into shared memory with 16-byte cp.async (zero-filled past kv_len),
//   all of the chunk's pages in flight from the start (8 at kChunk 128:
//   cp.async rather than TMA, because a page's rows come through the block
//   table one row at a time for any block size, and cp.async's per-thread
//   addresses cost nothing here, where a tensor map would need a box per
//   page of one kv head).  Rows are padded by 16 bytes, so ldmatrix hits
//   distinct banks.  The table entries are read beside kv_len and q, not
//   after it.  A warp waits only for its own copies (__syncwarp): no CTA
//   barrier until its pages are done.
// * bf16 products on the tensor cores, mma.sync m16n8k16 with float32
//   accumulation: S^T (16 positions x 8 heads) = K q^T, with the G query
//   heads padded to 8 columns (the padding costs nothing that matters at
//   4 flops per 2 bytes), K's fragments by ldmatrix and q's kept in
//   registers for the CTA; then O^T (D x 8 heads) += V^T P^T, V's
//   fragments by ldmatrix.trans.  The online softmax runs on S^T's
//   accumulator fragments in registers (a column max over the positions by
//   three shuffles); P^T's B fragments come from them by movmatrix.trans.
//   p is kept to ~2^-16 as two bf16 terms (hi + lo), as the flash kernel
//   keeps it, and both go through the p.v product: the Pallas kernel keeps
//   p in float32.  At the end each warp writes its state over its own
//   pages and the CTA merges the four after one barrier.
// * float32, the same partition with a simpler tile body: 256 threads over
//   tiles of 32 positions (two stages of cp.async), scores as float32 dot
//   products through shared memory, one warp per head for the softmax,
//   one column per thread in p.v.
// * D is a template parameter, one of 16, 32, 64, 80 and 128 (80 is
//   zamba2-2.7b's shared attention): all multiples of the 16 of an mma.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError(); it allocates nothing (the caller passes the
// workspace of the chunks' softmax states and the counters) and does not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 8;
// Positions a CTA covers: a multiple of the float32 tile (32) and of four
// warps' 16-position pages.  Chosen from readings at 64 / 128 / 256 on an
// H100 of this partition with the float32 route's tile body for bf16 too
// (ms cold, benchmarks/paged_readings.py; skewed, uniform and one-lane
// mixes): granite-8b 0.0281 / 0.0270 / 0.0306, 0.0290 / 0.0273 / 0.0279,
// 0.0189 / 0.0194 / 0.0254; zamba2-2.7b (D = 80) 0.0430 / 0.0386 /
// 0.0382, 0.0475 / 0.0444 / 0.0389, 0.0221 / 0.0203 / 0.0225.
constexpr int kChunk = 128;
constexpr int kPage = 16;  // positions of one mma tile
constexpr int kWarps = 4;  // bf16: warps a CTA
constexpr int kPagesPerWarp = kChunk / kPage / kWarps;
constexpr int kF32Threads = 256;
constexpr int kF32Tile = 32;  // float32: positions a tile
static_assert(kChunk % (kPage * kWarps) == 0 && kChunk % kF32Tile == 0,
              "a chunk is whole pages of every warp and whole tiles");

__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

// 16 bytes, or 16 zero bytes (nothing read) where !valid.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// wait_group takes an immediate: n folds to a constant in unrolled loops.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  static_assert(kPagesPerWarp <= 4, "one case per page a warp");
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// The transpose of an 8x8 b16 fragment held by the warp.
__device__ __forceinline__ unsigned movmatrix_trans(unsigned x) {
  unsigned y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// c += a b: a 16x16 (row), b 16x8 (col), bf16 in, float32 accumulated.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Two floats as bf16, `lo` in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A lane's chunks keep their softmax states in the workspace: acc
// [B][KV][chunks][G][D], then (m, l) [B][KV][chunks][G][2].  These point
// at this CTA's (lane, kv head).
struct ChunkStates {
  float* acc;  // [chunks][G][D]
  float* ml;   // [chunks][G][2]
};
__device__ __forceinline__ ChunkStates chunk_states(float* partial, int n,
                                                    int group,
                                                    int num_kv_heads) {
  const size_t unit0 =
      ((size_t)blockIdx.y * num_kv_heads + blockIdx.x) * gridDim.z;
  return {partial + unit0 * n,
          partial + (size_t)gridDim.y * num_kv_heads * gridDim.z * n +
              unit0 * group * 2};
}

// Called by every thread once the CTA has written its chunk's state:
// counts the chunk on its (lane, kv head)'s counter, and the last of the
// lane's nch chunks to count itself merges them all into the output,
//   out = sum_c acc_c e^(m_c - M) / max(sum_c l_c e^(m_c - M), 1e-30),
// M = max_c m_c, then sets the counter back to 0.  Every chunk below nch
// holds a position, so every m_c is finite.
template <typename T>
__device__ void count_and_merge(ChunkStates st, int n, int head_dim,
                                int group, int nch, T* out_row,
                                int* counters, int num_kv_heads) {
  const int tid = threadIdx.x;
  __syncthreads();
  __shared__ int last;
  int* counter = counters + (size_t)blockIdx.y * num_kv_heads + blockIdx.x;
  if (tid == 0) {
    // release: the CTA's state (ordered before by the barrier) is visible
    // before the count; acquire: the other chunks' states are, after it
    int old;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(counter)
                 : "memory");
    last = old == nch - 1;
  }
  __syncthreads();
  if (!last) return;
  // Read through L2 (other CTAs wrote these), four outputs of one head a
  // thread (D is a multiple of 16), eight chunks at a time: their loads
  // all in flight together, and their weights independent of each other
  // (one rescale per eight chunks).
  constexpr int kZ = 8;
  for (int e = 4 * tid; e < n; e += 4 * blockDim.x) {
    const float* ml = st.ml + (e / head_dim) * 2;
    float mx = -INFINITY, lsum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < nch; z0 += kZ) {
      float2 mz[kZ];
      float4 v[kZ];
      float gmax = mx;
#pragma unroll
      for (int j = 0; j < kZ; ++j) {
        const int z = z0 + j;
        mz[j] = z < nch ? __ldcg(reinterpret_cast<const float2*>(
                              ml + (size_t)z * group * 2))
                        : make_float2(-INFINITY, 0.f);
        v[j] = z < nch ? __ldcg(reinterpret_cast<const float4*>(
                             st.acc + (size_t)z * n + e))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        gmax = fmaxf(gmax, mz[j].x);
      }
      const float c = expf(mx - gmax);  // 0 on the first group
      lsum *= c;
      a.x *= c;
      a.y *= c;
      a.z *= c;
      a.w *= c;
#pragma unroll
      for (int j = 0; j < kZ; ++j) {
        const float w = expf(mz[j].x - gmax);  // 0 past nch
        lsum += mz[j].y * w;
        a.x += v[j].x * w;
        a.y += v[j].y * w;
        a.z += v[j].z * w;
        a.w += v[j].w * w;
      }
      mx = gmax;
    }
    const float den = fmaxf(lsum, 1e-30f);
    store(a.x / den, out_row + e);
    store(a.y / den, out_row + e + 1);
    store(a.z / den, out_row + e + 2);
    store(a.w / den, out_row + e + 3);
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

// The lane's chunks that hold a position (one for an empty lane, which
// writes zeros), from its kv_len clamped to the table.
__device__ __forceinline__ int lane_chunks(int klen) {
  return max(1, (klen + kChunk - 1) / kChunk);
}

// ---- bf16: tensor cores --------------------------------------------------

template <int D>
struct Bf16Layout {
  static constexpr int kRow = D + 8;  // padded row, elements (+16 B)
  static constexpr int kPageElems = kPage * kRow;  // one K or V page
  static constexpr int kWarpElems = 2 * kPageElems * kPagesPerWarp;
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * kWarpElems * kWarps;
  // a warp's state reuses its pages once it has read them
  static_assert(sizeof(float) * kMaxGroup * D <=
                    sizeof(__nv_bfloat16) * kWarpElems,
                "a warp's state fits its pages");
};

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    paged_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k_pool,
                                const __nv_bfloat16* __restrict__ v_pool,
                                const int32_t* __restrict__ block_tables,
                                const int32_t* __restrict__ kv_len,
                                __nv_bfloat16* __restrict__ out,
                                float* __restrict__ partial,
                                int* __restrict__ counters, int num_kv_heads,
                                int group, int num_blocks, int block_size,
                                int max_blocks, float scale) {
  using L = Bf16Layout<D>;
  constexpr int kK = D / 16;     // k steps of S^T, d tiles of O^T
  constexpr int kParts = D / 8;  // 16-byte parts of a row
  // a page's K (or V) rows are kPage * kParts 16-byte parts: kK a lane
  static_assert(kPage * kParts == 32 * kK, "copies a lane");

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int pos0 = blockIdx.z * kChunk;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int num_heads = num_kv_heads * group;

  // Loads that need nothing else, issued together: kv_len, the table
  // entries of this lane's copies, and q (issuing q after the exit test,
  // beside the copies, read 0.0005 ms slower at granite-8b's shapes).
  const int klen_raw = kv_len[b];
  const int32_t* bt = block_tables + (size_t)b * max_blocks;
  // With 16-position blocks (the engine's) a page is one block: one entry
  // a page and no division; otherwise one entry per row copied.
  const bool page_is_block = block_size == kPage;
  int entry[kPagesPerWarp][kK];
#pragma unroll
  for (int i = 0; i < kPagesPerWarp; ++i) {
    const int pstart = pos0 + (warp + i * kWarps) * kPage;
    if (page_is_block) {
      const int blk = pstart / kPage;
      const int e = blk < max_blocks ? __ldg(bt + blk) : 0;
#pragma unroll
      for (int j = 0; j < kK; ++j) entry[i][j] = e;
    } else {
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        const int blk = (pstart + (lane + 32 * j) / kParts) / block_size;
        entry[i][j] = blk < max_blocks ? __ldg(bt + blk) : 0;
      }
    }
  }
  // q as the B operand of S^T = K q^T: column n = lane / 4 is head n,
  // k = 2 (lane % 4) + {0, 1} (b0) and + 8 (b1) within each k step
  const int qn = lane / 4;
  const __nv_bfloat16* q_row =
      q + ((size_t)b * num_heads + (size_t)h * group + qn) * D +
      2 * (lane % 4);
  unsigned qf[kK][2];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    qf[kk][0] = qn < group
                    ? __ldg(reinterpret_cast<const unsigned*>(q_row + 16 * kk))
                    : 0u;
    qf[kk][1] = qn < group ? __ldg(reinterpret_cast<const unsigned*>(
                                 q_row + 16 * kk + 8))
                           : 0u;
  }
  const int klen = min(max(klen_raw, 0), max_blocks * block_size);
  const int nch = lane_chunks(klen);
  if ((int)blockIdx.z >= nch) return;
  const int pos_end = min(pos0 + kChunk, klen);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* pages =
      reinterpret_cast<__nv_bfloat16*>(smem_raw) + warp * L::kWarpElems;

  // Copy page i of this warp, one commit group a page (empty past
  // kv_len), every page of the chunk in flight at once.
  const size_t pos_stride = (size_t)num_kv_heads * D;
  auto copy_page = [&](int i) {
    const int pstart = pos0 + (warp + i * kWarps) * kPage;
    if (pstart < pos_end) {
      __nv_bfloat16* ks = pages + i * 2 * L::kPageElems;
      __nv_bfloat16* vs = ks + L::kPageElems;
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        const int c = lane + 32 * j;
        const int r = c / kParts;
        const int part = c % kParts;
        const int pos = pstart + r;
        const bool valid = pos < pos_end;
        const int phys = min(max(entry[i][j], 0), num_blocks - 1);
        const int row = page_is_block ? r : pos % block_size;
        const size_t off =
            valid ? ((size_t)phys * block_size + row) * pos_stride +
                        (size_t)h * D + part * 8
                  : 0;
        cp_async16_zfill(ks + r * L::kRow + part * 8, k_pool + off, valid);
        cp_async16_zfill(vs + r * L::kRow + part * 8, v_pool + off, valid);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kPagesPerWarp; ++i) copy_page(i);

  // This thread's heads are the columns c0 and c0 + 1 of S^T and O^T; its
  // positions the rows r0 and r0 + 8 of S^T, its d the rows r0 and r0 + 8
  // of each 16-row tile of O^T.
  const int r0 = lane / 4;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[kK][4];
#pragma unroll
  for (int dt = 0; dt < kK; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  // ldmatrix rows: K (A of S^T, x4 = rows 0-7 / 8-15 at k 0-7, then at k
  // 8-15) and V (A of O^T by .trans, x4 = d 0-7 / 8-15 at positions 0-7,
  // then at positions 8-15)
  const int k_row = (lane % 8) + ((lane / 8) & 1) * 8;
  const int k_col = (lane / 16) * 8;
  const int v_row = (lane % 8) + (lane / 16) * 8;
  const int v_col = ((lane / 8) & 1) * 8;

#pragma unroll
  for (int i = 0; i < kPagesPerWarp; ++i) {
    const int pstart = pos0 + (warp + i * kWarps) * kPage;
    if (pstart >= pos_end) break;  // warp-uniform; later pages too
    cp_async_wait_dyn(kPagesPerWarp - 1 - i);  // page i's group is done
    __syncwarp();
    const __nv_bfloat16* ks = pages + i * 2 * L::kPageElems;
    const __nv_bfloat16* vs = ks + L::kPageElems;

    // two accumulators over the k steps: half the dependent chain
    float sk[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, ks + k_row * L::kRow + kk * 16 + k_col);
      mma_bf16(sk[kk & 1], a, qf[kk][0], qf[kk][1]);
    }
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = sk[0][e] + sk[1][e];
    // page row 0 is below pos_end, so each column's max is finite
    const bool v0 = pstart + r0 < pos_end;
    const bool v1 = pstart + r0 + 8 < pos_end;
    s[0] = v0 ? s[0] * scale : -INFINITY;
    s[1] = v0 ? s[1] * scale : -INFINITY;
    s[2] = v1 ? s[2] * scale : -INFINITY;
    s[3] = v1 ? s[3] * scale : -INFINITY;
    float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    const float p0 = expf(s[0] - mn0), p1 = expf(s[1] - mn1);
    const float p2 = expf(s[2] - mn0), p3 = expf(s[3] - mn1);
    l0 = l0 * c0 + p0 + p2;  // this thread's rows; summed over rows at the end
    l1 = l1 * c1 + p1 + p3;
#pragma unroll
    for (int dt = 0; dt < kK; ++dt) {
      o[dt][0] *= c0;
      o[dt][1] *= c1;
      o[dt][2] *= c0;
      o[dt][3] *= c1;
    }
    // P^T as the B operand, p = hi + lo in two bf16 terms: the accumulator
    // holds rows (positions) r0, r0 + 8 and columns (heads) c0, c0 + 1;
    // movmatrix.trans turns each 8x8 half into the B fragment
    const float h0 = bf16_round(p0), h1 = bf16_round(p1);
    const float h2 = bf16_round(p2), h3 = bf16_round(p3);
    const unsigned bh0 = movmatrix_trans(pack_bf16(h0, h1));
    const unsigned bh1 = movmatrix_trans(pack_bf16(h2, h3));
    const unsigned bl0 = movmatrix_trans(pack_bf16(p0 - h0, p1 - h1));
    const unsigned bl1 = movmatrix_trans(pack_bf16(p2 - h2, p3 - h3));
#pragma unroll
    for (int dt = 0; dt < kK; ++dt) {
      unsigned a[4];
      ldmatrix_x4_trans(a, vs + v_row * L::kRow + dt * 16 + v_col);
      mma_bf16(o[dt], a, bh0, bh1);
      mma_bf16(o[dt], a, bl0, bl1);
    }
  }

  // Merge the warps: l over this thread's rows, then over the warp's rows
  // (the lanes of one lane % 4 hold the same heads); each warp's state to
  // shared memory over its own pages, which it has read (no CTA barrier
  // until every warp's state is written).
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __shared__ float wm[kWarps][kMaxGroup], wl[kWarps][kMaxGroup];
  constexpr int kStateStride = L::kWarpElems / 2;  // floats a warp's pages
  float* ws = reinterpret_cast<float*>(smem_raw);  // [warp][kMaxGroup][D]
  const int hc = 2 * (lane % 4);
  if (lane < 4) {
    wm[warp][hc] = m0;
    wm[warp][hc + 1] = m1;
    wl[warp][hc] = l0;
    wl[warp][hc + 1] = l1;
  }
  __syncwarp();  // every lane's ldmatrix of the warp's pages is done
  float* w_o = ws + warp * kStateStride;
#pragma unroll
  for (int dt = 0; dt < kK; ++dt) {
    const int d = dt * 16 + r0;
    w_o[hc * D + d] = o[dt][0];
    w_o[(hc + 1) * D + d] = o[dt][1];
    w_o[hc * D + d + 8] = o[dt][2];
    w_o[(hc + 1) * D + d + 8] = o[dt][3];
  }
  __syncthreads();
  // The CTA's state, four outputs of one head a thread: the output where
  // the lane has one chunk, else the chunk's state in the workspace.
  const int n = group * D;
  __nv_bfloat16* out_row =
      out + ((size_t)b * num_heads + (size_t)h * group) * D;
  const ChunkStates st = chunk_states(partial, n, group, num_kv_heads);
  for (int e = 4 * tid; e < n; e += 4 * kWarps * 32) {
    const int g = e / D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][g]);
    float lsum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mx != -INFINITY) {  // -inf only for a lane with no position
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(wm[w][g] - mx);
        const float4 v =
            *reinterpret_cast<const float4*>(ws + w * kStateStride + e);
        lsum += wl[w][g] * wt;
        a.x += v.x * wt;
        a.y += v.y * wt;
        a.z += v.z * wt;
        a.w += v.w * wt;
      }
    }
    if (nch == 1) {
      const float den = fmaxf(lsum, 1e-30f);
      store(a.x / den, out_row + e);
      store(a.y / den, out_row + e + 1);
      store(a.z / den, out_row + e + 2);
      store(a.w / den, out_row + e + 3);
    } else {
      *reinterpret_cast<float4*>(st.acc + (size_t)blockIdx.z * n + e) = a;
      if (e % D == 0)
        *reinterpret_cast<float2*>(st.ml + (blockIdx.z * group + g) * 2) =
            make_float2(mx, lsum);
    }
  }
  if (nch > 1)
    count_and_merge(st, n, D, group, nch, out_row, counters, num_kv_heads);
}

// ---- float32: FFMA ------------------------------------------------------

template <int D>
struct F32Layout {
  static constexpr int kRow = D + 4;  // padded row, elements (+16 B)
  static constexpr int kKV = 2 * 2 * kF32Tile * kRow;  // [stage][k|v][pos]
  static constexpr size_t kBytes =
      sizeof(float) * (kKV + kMaxGroup * D + kMaxGroup * kF32Tile +
                       3 * kMaxGroup);
};

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    paged_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k_pool,
                               const float* __restrict__ v_pool,
                               const int32_t* __restrict__ block_tables,
                               const int32_t* __restrict__ kv_len,
                               float* __restrict__ out,
                               float* __restrict__ partial,
                               int* __restrict__ counters, int num_kv_heads,
                               int group, int num_blocks, int block_size,
                               int max_blocks, float scale) {
  using L = F32Layout<D>;
  constexpr int TP = kF32Tile;
  constexpr int ROW = L::kRow;
  constexpr int CPR = D / 4;                      // 16-byte chunks a row
  constexpr int kSub = kF32Threads / TP;          // score pass: head groups
  constexpr int kHeadsPer = (kMaxGroup + kSub - 1) / kSub;
  constexpr int kGStride = kF32Threads / D;       // p.v pass: head stride
  constexpr int kOutPer = (kMaxGroup + kGStride - 1) / kGStride;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int pos0 = blockIdx.z * kChunk;
  const int klen = min(max(kv_len[b], 0), max_blocks * block_size);
  const int nch = lane_chunks(klen);
  if ((int)blockIdx.z >= nch) return;
  const int pos_end = min(pos0 + kChunk, klen);
  const int ntiles = (max(pos_end - pos0, 0) + TP - 1) / TP;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kv_s = reinterpret_cast<float*>(smem_raw);
  float* q_s = kv_s + L::kKV;         // [G][D]
  float* p_s = q_s + kMaxGroup * D;   // [G][TP] scores, then weights
  float* m_s = p_s + kMaxGroup * TP;  // [G] running max
  float* l_s = m_s + kMaxGroup;       // [G] running sum
  float* c_s = l_s + kMaxGroup;       // [G] this tile's rescale factor

  const int tid = threadIdx.x;
  const int num_heads = num_kv_heads * group;
  const float* q_row = q + ((size_t)b * num_heads + (size_t)h * group) * D;
  for (int i = tid; i < group * D; i += kF32Threads) q_s[i] = q_row[i];
  if (tid < kMaxGroup) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int32_t* bt = block_tables + (size_t)b * max_blocks;
  const size_t pos_stride = (size_t)num_kv_heads * D;

  // Copy tile t's K and V rows into stage `stage`; positions past the
  // chunk's end are zero-filled (their weight is 0, and 0 * garbage could
  // be NaN).
  auto load_tile = [&](int t, int stage) {
    float* ks = kv_s + (size_t)stage * 2 * TP * ROW;
    float* vs = ks + TP * ROW;
    for (int c = tid; c < TP * CPR; c += kF32Threads) {
      const int p = c / CPR;
      const int part = c % CPR;
      const int pos = pos0 + t * TP + p;
      const bool valid = pos < pos_end;
      size_t off = 0;
      if (valid) {
        const int phys = min(max(bt[pos / block_size], 0), num_blocks - 1);
        off = ((size_t)phys * block_size + pos % block_size) * pos_stride +
              (size_t)h * D + part * 4;
      }
      cp_async16_zfill(ks + p * ROW + part * 4, k_pool + off, valid);
      cp_async16_zfill(vs + p * ROW + part * 4, v_pool + off, valid);
    }
    cp_async_commit();
  };

  // p.v pass: this thread's column d for heads g0, g0 + kGStride, ...
  // When D does not divide the CTA (D = 80: 3 x 80 = 240 of 256 threads)
  // the threads past kGStride * D get no head (g0 = kMaxGroup, so every
  // g >= group) instead of repeating heads of the first threads.
  const int d = tid % D;
  const int g0 = tid < kGStride * D ? tid / D : kMaxGroup;
  float acc[kOutPer];
#pragma unroll
  for (int i = 0; i < kOutPer; ++i) acc[i] = 0.f;

  if (ntiles > 0) load_tile(0, 0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) {
      load_tile(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = kv_s + (size_t)stage * 2 * TP * ROW;
    const float* vs = ks + TP * ROW;

    // 1. scores: thread (p, sub) for heads sub, sub + kSub, ...
    {
      const int p = tid % TP;
      const int sub = tid / TP;
      float dot[kHeadsPer];
#pragma unroll
      for (int i = 0; i < kHeadsPer; ++i) dot[i] = 0.f;
#pragma unroll 4
      for (int part = 0; part < CPR; ++part) {
        const float4 kf =
            *reinterpret_cast<const float4*>(ks + p * ROW + part * 4);
#pragma unroll
        for (int i = 0; i < kHeadsPer; ++i) {
          const int g = sub + i * kSub;
          if (g < group) {
            const float4 qv =
                *reinterpret_cast<const float4*>(q_s + g * D + part * 4);
            dot[i] += qv.x * kf.x + qv.y * kf.y + qv.z * kf.z + qv.w * kf.w;
          }
        }
      }
      const bool valid = pos0 + t * TP + p < pos_end;
#pragma unroll
      for (int i = 0; i < kHeadsPer; ++i) {
        const int g = sub + i * kSub;
        if (g < group) p_s[g * TP + p] = valid ? dot[i] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // 2. online softmax: one warp per head.  The tile holds at least one
    // position below pos_end, so its max is finite and masked weights 0.
    {
      const int warp = tid / 32;
      const int lane = tid % 32;
      for (int g = warp; g < group; g += kF32Threads / 32) {
        float* sg = p_s + g * TP;
        float mx = sg[lane];  // TP = 32: one position a lane
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        const float w = expf(sg[lane] - m_new);
        sg[lane] = w;
        float sum = w;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          c_s[g] = corr;
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
        }
      }
    }
    __syncthreads();

    // 3. p.v: thread owns column d of heads g0, g0 + kGStride, ...
#pragma unroll
    for (int i = 0; i < kOutPer; ++i) {
      const int g = g0 + i * kGStride;
      if (g < group) acc[i] *= c_s[g];
    }
    for (int p = 0; p < TP; p += 4) {
      const float v0 = vs[(p + 0) * ROW + d];
      const float v1 = vs[(p + 1) * ROW + d];
      const float v2 = vs[(p + 2) * ROW + d];
      const float v3 = vs[(p + 3) * ROW + d];
#pragma unroll
      for (int i = 0; i < kOutPer; ++i) {
        const int g = g0 + i * kGStride;
        if (g < group) {
          const float4 w = *reinterpret_cast<const float4*>(p_s + g * TP + p);
          acc[i] += w.x * v0 + w.y * v1 + w.z * v2 + w.w * v3;
        }
      }
    }
    __syncthreads();  // this stage and p_s are rewritten after this
  }

  // The output where the lane has one chunk, else the chunk's state in
  // the workspace (m_s and l_s are final: the barrier above).
  float* out_row = out + ((size_t)b * num_heads + (size_t)h * group) * D;
  if (nch == 1) {
#pragma unroll
    for (int i = 0; i < kOutPer; ++i) {
      const int g = g0 + i * kGStride;
      if (g < group) out_row[g * D + d] = acc[i] / fmaxf(l_s[g], 1e-30f);
    }
    return;
  }
  const int n = group * D;
  const ChunkStates st = chunk_states(partial, n, group, num_kv_heads);
#pragma unroll
  for (int i = 0; i < kOutPer; ++i) {
    const int g = g0 + i * kGStride;
    if (g < group) st.acc[(size_t)blockIdx.z * n + g * D + d] = acc[i];
  }
  if (tid < group) {
    st.ml[(blockIdx.z * group + tid) * 2] = m_s[tid];
    st.ml[(blockIdx.z * group + tid) * 2 + 1] = l_s[tid];
  }
  count_and_merge(st, n, D, group, nch, out_row, counters, num_kv_heads);
}

// Chunks of kChunk positions that cover the table: the grid's z.
int num_chunks(int block_size, int max_blocks) {
  return (int)(((long long)max_blocks * block_size + kChunk - 1) / kChunk);
}

// One launch of kernel `fn` with `smem` dynamic bytes, the attribute set
// once per instantiation.
template <typename Fn, typename T>
int launch(Fn fn, size_t smem, int threads, bool& configured, const T* q,
           const T* k_pool, const T* v_pool, const int32_t* block_tables,
           const int32_t* kv_len, T* out, float* partial, int* counters,
           int batch, int num_kv_heads, int group, int num_blocks,
           int block_size, int max_blocks, float scale,
           cudaStream_t stream) {
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  fn<<<dim3(num_kv_heads, batch, num_chunks(block_size, max_blocks)),
       dim3(threads), smem, stream>>>(q, k_pool, v_pool, block_tables,
                                      kv_len, out, partial, counters,
                                      num_kv_heads, group, num_blocks,
                                      block_size, max_blocks, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dim(int dtype, const void* q, const void* k_pool,
               const void* v_pool, const int32_t* block_tables,
               const int32_t* kv_len, void* out, float* partial,
               int* counters, int batch, int num_kv_heads, int group,
               int num_blocks, int block_size, int max_blocks, float scale,
               cudaStream_t stream) {
  if (dtype == 0) {
    static bool configured = false;
    return launch(paged_attention_f32_kernel<D>, F32Layout<D>::kBytes,
                  kF32Threads, configured, static_cast<const float*>(q),
                  static_cast<const float*>(k_pool),
                  static_cast<const float*>(v_pool), block_tables, kv_len,
                  static_cast<float*>(out), partial, counters, batch,
                  num_kv_heads, group, num_blocks, block_size, max_blocks,
                  scale, stream);
  }
  static bool configured = false;
  using B16 = __nv_bfloat16;
  return launch(paged_attention_bf16_kernel<D>, Bf16Layout<D>::kBytes,
                kWarps * 32, configured, static_cast<const B16*>(q),
                static_cast<const B16*>(k_pool),
                static_cast<const B16*>(v_pool), block_tables, kv_len,
                static_cast<B16*>(out), partial, counters, batch,
                num_kv_heads, group, num_blocks, block_size, max_blocks,
                scale, stream);
}

__global__ void empty_kernel() {}

}  // namespace

// One empty kernel on `stream`, launched as paged_attention_launch
// launches: the floor under a call's time.
extern "C" int paged_attention_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

// Floats of workspace that paged_attention_launch needs for these
// arguments (0 when the table fits one chunk), or -1 for bad geometry.
extern "C" long long paged_attention_workspace(int batch, int num_heads,
                                               int num_kv_heads,
                                               int head_dim, int block_size,
                                               int max_blocks) {
  if (batch <= 0 || num_kv_heads <= 0 || num_heads % num_kv_heads != 0 ||
      block_size <= 0 || max_blocks <= 0)
    return -1;
  const int chunks = num_chunks(block_size, max_blocks);
  if (chunks == 1) return 0;
  return (long long)batch * num_heads * chunks * (head_dim + 2);
}

// dtype: 0 = float32, 1 = bfloat16.  `workspace` holds at least
// paged_attention_workspace(...) floats (may be null when that is 0);
// `counters` holds batch * num_kv_heads int32 zeros, and the kernel
// leaves them zero.  Calls that share `counters` must not overlap (one
// stream).  Returns 0 on success, a cudaError_t from the launch, or a
// negative code for arguments the kernel does not take (-1 bad geometry,
// -2 unsupported head_dim, -3 unsupported dtype, -4 missing workspace or
// counters).
extern "C" int paged_attention_launch(int dtype, const void* q,
                                      const void* k_pool, const void* v_pool,
                                      const void* block_tables,
                                      const void* kv_len, void* out,
                                      void* workspace, void* counters,
                                      int batch, int num_heads,
                                      int num_kv_heads, int head_dim,
                                      int num_blocks, int block_size,
                                      int max_blocks, float scale,
                                      void* stream) {
  if (batch <= 0 || num_kv_heads <= 0 || num_heads % num_kv_heads != 0 ||
      num_heads / num_kv_heads > kMaxGroup || num_blocks <= 0 ||
      block_size <= 0 || max_blocks <= 0)
    return -1;
  if (dtype != 0 && dtype != 1) return -3;
  if (counters == nullptr ||
      (num_chunks(block_size, max_blocks) > 1 && workspace == nullptr))
    return -4;
  const int group = num_heads / num_kv_heads;
  float* partial = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  const int32_t* bt = static_cast<const int32_t*>(block_tables);
  const int32_t* kl = static_cast<const int32_t*>(kv_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(DIM)                                                   \
  return launch_dim<DIM>(dtype, q, k_pool, v_pool, bt, kl, out, partial, \
                         cnt, batch, num_kv_heads, group, num_blocks,    \
                         block_size, max_blocks, scale, s)
  switch (head_dim) {
    case 16: PA_LAUNCH(16);
    case 32: PA_LAUNCH(32);
    case 64: PA_LAUNCH(64);
    case 80: PA_LAUNCH(80);
    case 128: PA_LAUNCH(128);
    default: return -2;
  }
#undef PA_LAUNCH
}
