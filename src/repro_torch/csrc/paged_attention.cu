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
// acc / max(l, 1e-30).
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
// over 3.35 TB/s.
//
// What the simple design does about it:
// * One CTA (256 threads) per (kv head, lane, split) covers the whole GQA
//   group G = H/KV, so each K/V row is read from HBM once for all G query
//   heads (G = 4 for granite-8b), never once per q head.
// * Each lane reads only the positions below kv_len, so only the blocks
//   below ceil(kv_len/bs), read on the device: unallocated and sentinel
//   blocks cost no bytes.
// * The positions are walked in tiles (64 positions in bf16, 32 in
//   float32).  A tile's K and V rows are copied into shared memory with
//   16-byte cp.async, every thread issuing its share, and the CTA's next
//   tile is in flight while the current one is computed (two stages).
// * B * KV CTAs alone leave most SMs idle at decode batch sizes (64 CTAs
//   at 8 lanes of granite-8b, 132 SMs), so each lane's tiles are dealt
//   round-robin to `splits` CTAs (about two CTAs per SM in all); each
//   split keeps its own softmax state and a second small kernel merges
//   them.  At large batch there is one split and no merge.
// * Scores are plain dot products, one thread per (position, head) from
//   shared memory (rows padded by 16 bytes, so the threads of a warp hit
//   distinct banks); one warp per head does the online-softmax update; in
//   p.v each thread owns one column d for its heads, so a V element is read
//   once for all of them.  No cross-lane reduction sits on the hot loop.
// * D is a template parameter, one of 16, 32, 64, 80 and 128 (80 is
//   zamba2-2.7b's shared attention).  A row is D / 8 (bf16) or D / 4
//   (float32) 16-byte chunks and a padded shared row stays a multiple of
//   16 bytes for all of them; only the p.v pass's thread-to-column map
//   needs D to divide the CTA, and threads past the last whole multiple
//   of D sit that pass out.
// * No tensor cores and no TMA: those are for a later, faster version.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError(); it allocates nothing (the caller passes the
// workspace of the split softmax states) and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 8;
constexpr int kMaxSplits = 16;

// 16-byte chunks of a row: N elements of T, converted to float.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  static constexpr int kTile = 32;  // positions per tile
  __device__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr int kTile = 64;
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory layout, in one place for the kernel and the launch.
template <typename T, int D>
struct Layout {
  static constexpr int kTile = Chunk<T>::kTile;
  static constexpr int kRow = D + 16 / sizeof(T);  // padded row, elements
  static constexpr int kKV = 2 * 2 * kTile * kRow;  // [stage][k|v][pos][row]
  static constexpr size_t kBytes =
      sizeof(T) * kKV +
      sizeof(float) * (kMaxGroup * D + kMaxGroup * kTile + 3 * kMaxGroup);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pool,
                           const T* __restrict__ v_pool,
                           const int32_t* __restrict__ block_tables,
                           const int32_t* __restrict__ kv_len,
                           T* __restrict__ out,
                           float* __restrict__ partial, int num_kv_heads,
                           int group, int num_blocks, int block_size,
                           int max_blocks, float scale) {
  using L = Layout<T, D>;
  constexpr int TP = L::kTile;
  constexpr int ROW = L::kRow;
  constexpr int CN = Chunk<T>::N;
  constexpr int CPR = D / CN;                    // chunks per row
  constexpr int kSub = kThreads / TP;            // score pass: head groups
  constexpr int kHeadsPer = (kMaxGroup + kSub - 1) / kSub;
  constexpr int kGStride = kThreads / D;         // p.v pass: head stride
  constexpr int kOutPer = (kMaxGroup + kGStride - 1) / kGStride;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);
  float* q_s = reinterpret_cast<float*>(kv_s + L::kKV);  // [G][D]
  float* p_s = q_s + kMaxGroup * D;   // [G][TP] scores, then weights
  float* m_s = p_s + kMaxGroup * TP;  // [G] running max
  float* l_s = m_s + kMaxGroup;       // [G] running sum
  float* c_s = l_s + kMaxGroup;       // [G] this tile's rescale factor

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int num_heads = num_kv_heads * group;
  const T* q_row = q + ((size_t)b * num_heads + (size_t)h * group) * D;
  for (int i = tid; i < group * D; i += kThreads) q_s[i] = to_float(q_row[i]);
  if (tid < kMaxGroup) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  int klen = kv_len[b];
  klen = min(max(klen, 0), max_blocks * block_size);
  const int ntiles = (klen + TP - 1) / TP;
  const int32_t* bt = block_tables + (size_t)b * max_blocks;
  const size_t pos_stride = (size_t)num_kv_heads * D;

  // Copy tile t's K and V rows into stage `stage`; positions past klen
  // are zero-filled (their weight is 0, and 0 * garbage could be NaN).
  auto load_tile = [&](int t, int stage) {
    T* ks = kv_s + (size_t)stage * 2 * TP * ROW;
    T* vs = ks + TP * ROW;
    for (int c = tid; c < TP * CPR; c += kThreads) {
      const int p = c / CPR;
      const int part = c % CPR;
      const int pos = t * TP + p;
      T* kd = ks + p * ROW + part * CN;
      T* vd = vs + p * ROW + part * CN;
      if (pos < klen) {
        int phys = bt[pos / block_size];
        phys = min(max(phys, 0), num_blocks - 1);
        const size_t off =
            ((size_t)phys * block_size + pos % block_size) * pos_stride +
            (size_t)h * D + part * CN;
        cp_async16(kd, k_pool + off);
        cp_async16(vd, v_pool + off);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
      }
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

  // split z of the lane takes tiles z, z + splits, ...
  if (split < ntiles) load_tile(split, 0);
  __syncthreads();
  for (int t = split, it = 0; t < ntiles; t += splits, ++it) {
    const int stage = it & 1;
    if (t + splits < ntiles) {
      load_tile(t + splits, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = kv_s + (size_t)stage * 2 * TP * ROW;
    const T* vs = ks + TP * ROW;

    // 1. scores: thread (p, sub) for heads sub, sub + kSub, ...
    {
      const int p = tid % TP;
      const int sub = tid / TP;
      float dot[kHeadsPer];
#pragma unroll
      for (int i = 0; i < kHeadsPer; ++i) dot[i] = 0.f;
#pragma unroll 4
      for (int part = 0; part < CPR; ++part) {
        float kf[CN];
        Chunk<T>::load(ks + p * ROW + part * CN, kf);
#pragma unroll
        for (int i = 0; i < kHeadsPer; ++i) {
          const int g = sub + i * kSub;
          if (g < group) {
            const float4* qg =
                reinterpret_cast<const float4*>(q_s + g * D + part * CN);
#pragma unroll
            for (int e = 0; e < CN / 4; ++e) {
              const float4 qv = qg[e];
              dot[i] += qv.x * kf[4 * e] + qv.y * kf[4 * e + 1] +
                        qv.z * kf[4 * e + 2] + qv.w * kf[4 * e + 3];
            }
          }
        }
      }
      const bool valid = t * TP + p < klen;
#pragma unroll
      for (int i = 0; i < kHeadsPer; ++i) {
        const int g = sub + i * kSub;
        if (g < group) p_s[g * TP + p] = valid ? dot[i] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // 2. online softmax: one warp per head.  The tile holds at least one
    // position below klen, so its max is finite and masked weights are 0.
    {
      const int warp = tid / 32;
      const int lane = tid % 32;
      for (int g = warp; g < group; g += kThreads / 32) {
        float* sg = p_s + g * TP;
        float mx = -INFINITY;
        for (int p = lane; p < TP; p += 32) mx = fmaxf(mx, sg[p]);
        mx = warp_max(mx);
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int p = lane; p < TP; p += 32) {
          const float w = expf(sg[p] - m_new);
          sg[p] = w;
          sum += w;
        }
        sum = warp_sum(sum);
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
      const float v0 = to_float(vs[(p + 0) * ROW + d]);
      const float v1 = to_float(vs[(p + 1) * ROW + d]);
      const float v2 = to_float(vs[(p + 2) * ROW + d]);
      const float v3 = to_float(vs[(p + 3) * ROW + d]);
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

  if (splits == 1) {
    T* out_row = out + ((size_t)b * num_heads + (size_t)h * group) * D;
#pragma unroll
    for (int i = 0; i < kOutPer; ++i) {
      const int g = g0 + i * kGStride;
      if (g < group)
        store(acc[i] / fmaxf(l_s[g], 1e-30f), out_row + g * D + d);
    }
    return;
  }
  // this split's softmax state, merged by combine_kernel: acc
  // [B][KV][splits][G][D], then (m, l) [B][KV][splits][G][2]
  const size_t unit = ((size_t)b * num_kv_heads + h) * splits + split;
  float* acc_out = partial + unit * group * D;
#pragma unroll
  for (int i = 0; i < kOutPer; ++i) {
    const int g = g0 + i * kGStride;
    if (g < group) acc_out[g * D + d] = acc[i];
  }
  float* ml_out = partial + (size_t)gridDim.y * num_kv_heads * splits *
                                group * D + unit * group * 2;
  if (tid < group) {
    ml_out[2 * tid] = m_s[tid];
    ml_out[2 * tid + 1] = l_s[tid];
  }
}

// Merge the splits of each (kv head, lane): out = sum_s acc_s e^(m_s - M)
// / max(sum_s l_s e^(m_s - M), 1e-30), M = max_s m_s.  A split that got
// no tile has m = -inf and weighs 0; a lane with no position gives 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ partial, T* __restrict__ out,
                   int batch, int num_kv_heads, int group, int head_dim,
                   int splits) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t unit0 = ((size_t)b * num_kv_heads + h) * splits;
  const float* acc = partial + unit0 * group * head_dim;
  const float* ml = partial +
                    (size_t)batch * num_kv_heads * splits * group * head_dim +
                    unit0 * group * 2;
  T* out_row =
      out + ((size_t)b * num_kv_heads * group + (size_t)h * group) * head_dim;
  for (int o = threadIdx.x; o < group * head_dim; o += blockDim.x) {
    const int g = o / head_dim;
    float mx = -INFINITY;
    for (int z = 0; z < splits; ++z) mx = fmaxf(mx, ml[(z * group + g) * 2]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
      for (int z = 0; z < splits; ++z) {
        const float w = expf(ml[(z * group + g) * 2] - mx);
        lsum += ml[(z * group + g) * 2 + 1] * w;
        a += acc[(size_t)z * group * head_dim + o] * w;
      }
    }
    store(a / fmaxf(lsum, 1e-30f), out_row + o);
  }
}

// Splits per lane: enough CTAs for about two per SM, but no more splits
// than the table has tiles.  One rule for the launch and the workspace.
int num_splits(int dtype, int batch, int num_kv_heads, int block_size,
               int max_blocks) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;
  }
  const int tile = dtype == 0 ? Chunk<float>::kTile
                              : Chunk<__nv_bfloat16>::kTile;
  const int tiles = (max_blocks * block_size + tile - 1) / tile;
  const int ctas = batch * num_kv_heads;
  int splits = (2 * sms + ctas - 1) / ctas;
  if (splits > tiles) splits = tiles;
  if (splits > kMaxSplits) splits = kMaxSplits;
  return splits < 1 ? 1 : splits;
}

template <typename T, int D>
int launch_dim(const T* q, const T* k_pool, const T* v_pool,
               const int32_t* block_tables, const int32_t* kv_len, T* out,
               float* partial, int splits, int batch, int num_kv_heads,
               int group, int num_blocks, int block_size, int max_blocks,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, D>::kBytes;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  paged_attention_kernel<T, D>
      <<<dim3(num_kv_heads, batch, splits), dim3(kThreads), smem, stream>>>(
          q, k_pool, v_pool, block_tables, kv_len, out, partial, num_kv_heads,
          group, num_blocks, block_size, max_blocks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  combine_kernel<T><<<dim3(num_kv_heads, batch), dim3(kThreads), 0, stream>>>(
      partial, out, batch, num_kv_heads, group, D, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* q, const void* k_pool, const void* v_pool,
                 const void* block_tables, const void* kv_len, void* out,
                 float* partial, int splits, int batch, int num_kv_heads,
                 int group, int head_dim, int num_blocks, int block_size,
                 int max_blocks, float scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pool);
  const T* vp = static_cast<const T*>(v_pool);
  const int32_t* bt = static_cast<const int32_t*>(block_tables);
  const int32_t* kl = static_cast<const int32_t*>(kv_len);
  T* op = static_cast<T*>(out);
#define PA_LAUNCH(DIM)                                                      \
  return launch_dim<T, DIM>(qp, kp, vp, bt, kl, op, partial, splits, batch, \
                            num_kv_heads, group, num_blocks, block_size,    \
                            max_blocks, scale, stream)
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

}  // namespace

// Floats of workspace that paged_attention_launch needs for these
// arguments (0 when a lane is not split), or -1 for bad geometry.
extern "C" long long paged_attention_workspace(int dtype, int batch,
                                               int num_heads, int num_kv_heads,
                                               int head_dim, int block_size,
                                               int max_blocks) {
  if (batch <= 0 || num_kv_heads <= 0 || num_heads % num_kv_heads != 0 ||
      block_size <= 0 || max_blocks <= 0)
    return -1;
  const int splits =
      num_splits(dtype, batch, num_kv_heads, block_size, max_blocks);
  if (splits == 1) return 0;
  return (long long)batch * num_heads * splits * (head_dim + 2);
}

// dtype: 0 = float32, 1 = bfloat16.  `workspace` holds at least
// paged_attention_workspace(...) floats (may be null when that is 0).
// Returns 0 on success, a cudaError_t from a launch, or a negative code
// for arguments the kernel does not take (-1 bad geometry, -2 unsupported
// head_dim, -3 unsupported dtype, -4 missing workspace).
extern "C" int paged_attention_launch(int dtype, const void* q,
                                      const void* k_pool, const void* v_pool,
                                      const void* block_tables,
                                      const void* kv_len, void* out,
                                      void* workspace, int batch,
                                      int num_heads, int num_kv_heads,
                                      int head_dim, int num_blocks,
                                      int block_size, int max_blocks,
                                      float scale, void* stream) {
  if (batch <= 0 || num_kv_heads <= 0 || num_heads % num_kv_heads != 0 ||
      num_heads / num_kv_heads > kMaxGroup || num_blocks <= 0 ||
      block_size <= 0 || max_blocks <= 0)
    return -1;
  const int group = num_heads / num_kv_heads;
  const int splits =
      num_splits(dtype, batch, num_kv_heads, block_size, max_blocks);
  if (splits > 1 && workspace == nullptr) return -4;
  float* partial = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(q, k_pool, v_pool, block_tables, kv_len, out,
                               partial, splits, batch, num_kv_heads, group,
                               head_dim, num_blocks, block_size, max_blocks,
                               scale, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k_pool, v_pool, block_tables,
                                       kv_len, out, partial, splits, batch,
                                       num_kv_heads, group, head_dim,
                                       num_blocks, block_size, max_blocks,
                                       scale, s);
  return -3;
}
