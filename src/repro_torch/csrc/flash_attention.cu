// Flash attention (blockwise softmax attention with GQA, causal or not),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   repro/kernels/flash_attention/kernel.py:25  _flash_kernel (body)
//   repro/kernels/flash_attention/kernel.py:69  flash_attention (entry)
//
// What it computes (the same function, not the TPU's blocks carried
// over), for every batch b, query head h and query row i, over the key
// rows j of kv head h / (H / KV):
//
//   s_j = (q_i . k_j) * scale            scale = D^-1/2, float32
//   causal: s_j = -1e30 where j > i
//   online softmax over key tiles: running max m (from -1e30), sum l and
//   accumulator acc, all float32; per tile m' = max(m, max_j s_j),
//   p_j = exp(s_j - m'), l = l * exp(m - m') + sum_j p_j,
//   acc = acc * exp(m - m') + sum_j p_j v_j (p float32, as in the TPU
//   kernel and the plain version)
//   o_i = acc / max(l, 1e-30), cast to the input type
//
//   q (B, H, Sq, D), k and v (B, KV, Sk, D), o (B, H, Sq, D), each read
//   through its own (batch, seq, head) strides with D contiguous, so the
//   model's (B, S, H, D) tensors are read and written without a
//   transpose.  float or bf16; D a multiple of 16 up to 128.
//
// Bound: operations.  A call does 4 * D flops per (query row, key row)
// pair it attends (q.k and p.v), over S (S + 1) / 2 pairs a head when
// causal, against 2 (Sq H + Sk KV) D elements moved: at granite-8b's
// 16384-token prefill (H 32, KV 8, D 128, bf16) 2.2e12 flop against
// 0.34 GB, 2.2236 ms at the 989 TFLOP/s of the bf16 tensor cores and
// 0.1 ms at 3.35 TB/s.
//
// Why p is split.  wgmma multiplies bf16 operands, and p.v with p
// rounded to bf16 once (as SDPA does) is 1.6e-2 off the TPU kernel's
// float32 p.  So p is split into hi = bf16(p) and lo = bf16(p - hi)
// (p - hi is exact in float32), both multiplied against v into one
// float32 accumulator: |p - (hi + lo)| <= 2^-16 p, below a bf16 ulp,
// and the output stays within one bf16 ulp of the plain version.  q.k
// loses nothing (bf16 products are exact in float32).  The price is
// p.v twice: 1.5x the tensor-core work, a floor of 1.5 x 2.2236 = 3.34
// ms at granite-8b's shape.
//
// bf16, what the design does about the bound:
// * Tensor cores for both products: s = q.k^T is wgmma m64n128k16 with
//   both operands in shared memory (K-major); o += p.v is wgmma with p
//   from registers (the score accumulator after the softmax, converted in
//   place into the bf16 A fragments hi and lo, two wgmma into the same
//   accumulator, so rescaling by alpha touches one accumulator) and v as
//   a transposed (MN-major) B operand in its stored (key, D) layout.
// * One CTA of three warpgroups per (b, h, 128-row query tile): one
//   thread of warpgroup 0 issues every copy, warpgroups 1 and 2 each own
//   64 query rows; setmaxnreg moves the producer's registers to them
//   (240 a consumer thread: s, o and hi/lo fit without spills).
// * A consumer issues q.k of key tile n and p.v of tile n - 1 together
//   and runs the softmax of tile n while p.v holds the tensor cores, so
//   the exp2 and split work overlaps its own products (and the other
//   consumer's).
// * K and V tiles of 128 rows come by TMA into a ring of 2 stages with
//   full and empty mbarriers, K and V apart: a K stage is refilled once
//   its q.k is done, a V stage once its p.v is, so the next tiles are
//   in flight a whole iteration ahead; q by TMA once per CTA.  The
//   tensor maps address the (B, S, H, D) tensors through their strides,
//   are built on the host (cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint, no -lcuda) and passed as __grid_constant__
//   parameters.  TMA zero-fills rows past Sq and Sk; keys past Sk and
//   past the diagonal still get -1e30.
// * Shared tiles are cut into slabs of W columns, each row one swizzle
//   span: 128 B where D is a multiple of 64 (D = 128), 64 B where of 32,
//   else 32 B (D = 80: five 16-column slabs).
// * The softmax runs in registers on the accumulator layout (a row's
//   scores on the 4 threads of a quad, reduced by two shuffles), in log2
//   units (scale * log2 e folded into exp2f, within float32 rounding).
// * GQA is an index (a CTA reads its kv head h / (H / KV)); causal key
//   tiles past the diagonal are skipped, the diagonal tile is masked, and
//   CTAs of the longest query tiles are issued first.
//
// float32 (the first design, kept for the float32 prefill path: TF32
// would not hold its 2e-5 tolerance): one CTA of 256 threads per (b, h,
// 64-row query tile), 64-row key tiles through shared memory, float32
// FFMA, each thread a 4 x 4 block of the score tile, the probabilities
// back through shared memory into the key tile's space.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx)
constexpr int kTile = 64;      // query rows and key rows of a tile
constexpr int kPad = 68;       // padded row of a transposed tile, floats
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_b, q_s, q_h;  // strides, in elements
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_s, o_h;
  int group;      // H / KV
  int sq, sk;
  int n_qtiles;
  int causal;
  float scale;
};

// 16 bytes of T as floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Reductions over the 16 threads of one row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows r0 .. r0+63 of a (rows, D) matrix with row stride rs, as floats,
// transposed: dst[d * kPad + rr]; rows at or past `rows` read as 0.
// Consecutive threads take consecutive rows, so the scalar stores of a
// warp fall on distinct banks.
template <typename T, int D>
__device__ __forceinline__ void fill_transposed(float* dst,
                                                const T* __restrict__ src,
                                                long long rs, int r0,
                                                int rows) {
  constexpr int N = Vec<T>::N;
  for (int e = threadIdx.x; e < kTile * (D / N); e += kThreads) {
    const int rr = e % kTile, c = e / kTile;
    const int r = r0 + rr;
    float f[N];
    if (r < rows) {
      Vec<T>::load(src + r * rs + c * N, f);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) dst[(c * N + i) * kPad + rr] = f[i];
  }
}

// The same rows as floats, row-major: dst[rr * D + d].
template <typename T, int D>
__device__ __forceinline__ void fill_rows(float* dst,
                                          const T* __restrict__ src,
                                          long long rs, int r0, int rows) {
  constexpr int N = Vec<T>::N;
  for (int e = threadIdx.x; e < kTile * (D / N); e += kThreads) {
    const int rr = e / (D / N), c = e % (D / N);
    const int r = r0 + rr;
    float f[N];
    if (r < rows) {
      Vec<T>::load(src + r * rs + c * N, f);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + rr * D + c * N);
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      out[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2],
                           f[4 * i + 3]);
  }
}

// Shared-memory floats of one CTA: the query tile, the key tile (its
// space reused by the probabilities, so at least kTile rows of it) and
// the value tile.
template <int D>
constexpr int smem_floats() {
  return D * kPad + (D > kTile ? D : kTile) * kPad + kTile * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int J = D / 16;            // output columns of a thread
  float* Qs = smem;                    // [D][kPad]     Qs[d][ii] = q[i0+ii][d]
  float* Ks = Qs + D * kPad;           // [D][kPad]     Ks[d][jj] = k[j0+jj][d]
  float* Ps = Ks;                      // [kTile][kPad] Ps[jj][ii] = p[ii][jj]
  float* Vs = Ks + (D > kTile ? D : kTile) * kPad;  // [kTile][D]

  const int tid = threadIdx.x;
  const int tx = tid % 16;             // keys tx*4 .., out columns tx + 16c
  const int ty = tid / 16;             // query rows ty*4 ..
  const int it = p.n_qtiles - 1 - blockIdx.x;   // longest first
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / p.group;
  const int i0 = it * kTile;
  const T* q = static_cast<const T*>(p.q) + bb * p.q_b + hh * p.q_h;
  const T* k = static_cast<const T*>(p.k) + bb * p.k_b + kvh * p.k_h;
  const T* v = static_cast<const T*>(p.v) + bb * p.v_b + kvh * p.v_h;
  T* o = static_cast<T*>(p.o) + bb * p.o_b + hh * p.o_h;

  fill_transposed<T, D>(Qs, q, p.q_s, i0, p.sq);

  float m[4], l[4], acc[4][J];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < J; ++c) acc[a][c] = 0.f;
  }

  // causal: key tile jt holds a key at or before some row of this query
  // tile iff jt * 64 <= i0 + 63, i.e. jt <= it; later tiles are skipped
  int n_kt = (p.sk + kTile - 1) / kTile;
  if (p.causal && n_kt > it + 1) n_kt = it + 1;

  for (int jt = 0; jt < n_kt; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();  // the previous tile's Ps and Vs are consumed
    fill_transposed<T, D>(Ks, k, p.k_s, j0, p.sk);
    fill_rows<T, D>(Vs, v, p.v_s, j0, p.sk);
    __syncthreads();

    // s = q . k on this thread's rows ty*4 + a and keys tx*4 + c
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 q4 = ld4(Qs + d * kPad + ty * 4);
      const float4 k4 = ld4(Ks + d * kPad + tx * 4);
      const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
      const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

    // scale, mask (the diagonal tile; keys past Sk in a ragged last
    // tile), then the online-softmax update of each row
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty * 4 + a;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx * 4 + c;
        float x = s[a][c] * p.scale;
        if ((p.causal && j > i) || j >= p.sk) x = kNegInf;
        s[a][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = expf(s[a][c] - m_new);
        sum += s[a][c];
      }
      const float alpha = expf(m[a] - m_new);
      l[a] = l[a] * alpha + row_sum(sum);
#pragma unroll
      for (int c = 0; c < J; ++c) acc[a][c] *= alpha;
      m[a] = m_new;
    }
    __syncthreads();  // every thread has read Ks: Ps may take its place
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(Ps + (tx * 4 + c) * kPad + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // acc += p . v on rows ty*4 + a, columns tx + 16 c
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      const float4 p4 = ld4(Ps + jj * kPad + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      const float* vrow = Vs + jj * D + tx;
#pragma unroll
      for (int c = 0; c < J; ++c) {
        const float x = vrow[16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pv[a], x, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
    if (i >= p.sq) continue;
    const float denom = fmaxf(l[a], 1e-30f);
    T* orow = o + i * p.o_s;
#pragma unroll
    for (int c = 0; c < J; ++c) store(acc[a][c] / denom, orow + tx + 16 * c);
  }
}

// ------------------------------------------------------------------
// bf16: wgmma on bf16 operands with float32 sums, K and V by TMA
// ------------------------------------------------------------------

constexpr int kRowsWg = 64;                   // query rows of a consumer
constexpr int kConsumers = 2;                 // consumer warpgroups
constexpr int kBlockM = kRowsWg * kConsumers; // query rows of a CTA
constexpr int kBlockN = 128;                  // key rows of a tile
constexpr int kStages = 2;                    // K and V tiles in flight
constexpr int kWgThreads = 128 * (1 + kConsumers);
constexpr float kLog2e = 1.4426950408889634f;
// setmaxnreg: the producer warpgroup gives its registers to the
// consumers; 168 a thread at launch (65536 / 384), 24 x 128 + 240 x 256
// = 168 x 384 after.
#define FLASH_PRODUCER_REGS "24"
#define FLASH_CONSUMER_REGS "240"

// A D-wide bf16 tile in shared memory is cut into slabs of W columns;
// a slab row is one swizzle span (W * 2 bytes): 128 B where D is a
// multiple of 64, 64 B where of 32, else 32 B (D = 80: five 16-column
// slabs).  TMA writes the swizzle and wgmma reads it through the same
// layout type.
template <int D>
struct Swizzle {
  static constexpr int W = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
  static constexpr int kRowBytes = 2 * W;
  static constexpr int kLayout = W == 64 ? 1 : (W == 32 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kTma =
      W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
              : (W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                         : CU_TENSOR_MAP_SWIZZLE_32B);
};

// Byte offsets from a 1024-aligned base: Q, the K ring, the V ring, the
// barriers (q full; k full, v full, k empty and v empty per stage).
template <int D>
struct Smem {
  static constexpr int kTile = kBlockN * D * 2;
  static constexpr int kK = kBlockM * D * 2;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the completion of the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One TMA box of a (D, S, heads, batch) tensor map into shared memory;
// its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of a wgmma result above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, float32, N / 2 registers a thread) = [d +] a . b, a and b
// K-major in shared memory (scale_d = 0: d = a . b).
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                         int scale_d);
// d += a . b with a (64 x 16) from registers (4 bf16 pairs a thread) and
// b MN-major in shared memory (the stored (key, D) layout of v).
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Two float32 weights as two bf16 pairs: hi = bf16(p), lo = bf16(p - hi)
// (p - hi is exact in float32), so |p - (hi + lo)| <= 2^-16 p.
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// s = q . k^T: a warpgroup's 64 query rows (from q0) against the keys of
// a K tile (from kb), both K-major, 16 columns of D a step.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBlockN / 2],
                                         uint32_t q0, uint32_t kb) {
  using Sw = Swizzle<D>;
  constexpr int RB = Sw::kRowBytes;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int slab = kk * 16 / Sw::W, col = kk * 16 % Sw::W;
    wgmma_ss<kBlockN>(
        s, wg_desc(q0 + slab * kBlockM * RB + col * 2, 0, 8 * RB,
                   Sw::kLayout),
        wg_desc(kb + slab * kBlockN * RB + col * 2, 0, 8 * RB, Sw::kLayout),
        kk > 0);
  }
}

// o += hi . v + lo . v into the one accumulator; v (from vb) is read
// MN-major (transposed B), 16 key rows a step, slab to slab by the
// leading byte offset.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&hi)[kBlockN / 16][4],
                                         const uint32_t (&lo)[kBlockN / 16][4],
                                         uint32_t vb) {
  using Sw = Swizzle<D>;
  constexpr int RB = Sw::kRowBytes;
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint64_t vdesc =
        wg_desc(vb + kk * 16 * RB, kBlockN * RB, 8 * RB, Sw::kLayout);
    wgmma_rs<D>(o, hi[kk], vdesc);
    wgmma_rs<D>(o, lo[kk], vdesc);
  }
}

// The online softmax of one score tile in registers: scale to log2 units,
// mask keys past Sk and (causal) past row i, then for rows g (h = 0) and
// g + 8 (h = 1), whose scores sit on the 4 threads of a quad, the new
// max, p = exp2(s - m) in place, l (this thread's columns, summed at the
// end) and the rescale factor alpha.
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float sl2,
                                             bool edge, int r0, int j0,
                                             int t, int sk, int causal) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = r0 + 8 * h;
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[4 * n + 2 * h + e] * sl2;
        if (edge) {
          const int j = j0 + 8 * n + 2 * t + e;
          if ((causal && j > i) || j >= sk) x = kNegInf;
        }
        s[4 * n + 2 * h + e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    alpha[h] = exp2f(m[h] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = exp2f(s[4 * n + 2 * h + e] - m_new);
        s[4 * n + 2 * h + e] = pe;
        sum += pe;
      }
    l[h] = l[h] * alpha[h] + sum;
    m[h] = m_new;
  }
}

// o *= alpha per row (p.v of the tiles before is in it), then p as hi + lo
// A fragments (the accumulator layout of two 8-key column groups is the
// A layout of 16 keys).
template <int D>
__device__ __forceinline__ void rescale_split(
    float (&o)[D / 2], const float (&alpha)[2], const float (&s)[kBlockN / 2],
    uint32_t (&hi)[kBlockN / 16][4], uint32_t (&lo)[kBlockN / 16][4]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[4 * n + 2 * h] *= alpha[h];
      o[4 * n + 2 * h + 1] *= alpha[h];
    }
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_p(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], hi[kk][r],
              lo[kk][r]);
}

// One CTA per (query tile of kBlockM rows, head, batch): warpgroup 0 is
// the producer (one thread issues every TMA copy), warpgroups 1 and 2
// the consumers, 64 query rows each.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const Params p) {
  using Sw = Swizzle<D>;
  using L = Smem<D>;
  constexpr int RB = Sw::kRowBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_k = bar_q + 8;                  // [kStages]
  const uint32_t bar_v = bar_k + 8 * kStages;        // [kStages]
  const uint32_t bar_ke = bar_v + 8 * kStages;       // [kStages]
  const uint32_t bar_ve = bar_ke + 8 * kStages;      // [kStages]

  const int it = p.n_qtiles - 1 - blockIdx.x;        // longest first
  const int hh = blockIdx.y, bb = blockIdx.z, kvh = hh / p.group;
  const int i0 = it * kBlockM;
  // causal: key tiles past the query tile's last row are skipped
  int n_kt = (p.sk + kBlockN - 1) / kBlockN;
  if (p.causal) n_kt = min(n_kt, (i0 + kBlockM - 1) / kBlockN + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ke + 8 * s, 128 * kConsumers);
      mbar_init(bar_ve + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: Q once, then the K and V tiles through the ring; a K
    // stage is refilled once all 256 consumer threads have finished its
    // q.k, a V stage once they have finished its p.v
    asm volatile("setmaxnreg.dec.sync.aligned.u32 " FLASH_PRODUCER_REGS
                 ";\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kBlockM * D * 2);
      for (int s = 0; s < D / Sw::W; ++s)
        tma_load(base + s * kBlockM * RB, &tm_q, bar_q, s * Sw::W, i0, hh,
                 bb);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        const uint32_t prev = ((kt / kStages) & 1) ^ 1;
        const uint32_t kd = base + L::kK + st * L::kTile;
        const uint32_t vd = base + L::kV + st * L::kTile;
        mbar_wait(bar_ke + 8 * st, prev);
        mbar_expect_tx(bar_k + 8 * st, L::kTile);
        for (int s = 0; s < D / Sw::W; ++s)
          tma_load(kd + s * kBlockN * RB, &tm_k, bar_k + 8 * st, s * Sw::W,
                   kt * kBlockN, kvh, bb);
        mbar_wait(bar_ve + 8 * st, prev);
        mbar_expect_tx(bar_v + 8 * st, L::kTile);
        for (int s = 0; s < D / Sw::W; ++s)
          tma_load(vd + s * kBlockN * RB, &tm_v, bar_v + 8 * st, s * Sw::W,
                   kt * kBlockN, kvh, bb);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 " FLASH_CONSUMER_REGS
                 ";\n");
    const int c = threadIdx.x / 128 - 1;             // rows 64c .. 64c+63
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;            // fragment row, pair
    constexpr int NS = kBlockN / 2;                  // score registers
    constexpr int NO = D / 2;                        // output registers
    constexpr int KP = kBlockN / 16;                 // k-steps of p.v
    float o[NO];
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const float sl2 = p.scale * kLog2e;              // log2 units
    const int r0 = i0 + c * kRowsWg + warp * 16 + g; // row of h = 0
    const uint32_t q0 = base + c * kRowsWg * RB;
    mbar_wait(bar_q, 0);

    // Iteration kt issues q.k of tile kt and p.v of tile kt - 1 as two
    // wgmma groups, then runs the softmax of tile kt while p.v still
    // holds the tensor cores; the rescale by alpha waits for p.v.
    float s[NS], alpha[2];
    uint32_t hi[KP][4], lo[KP][4];
    const auto stage = [](int kt) { return kt % kStages; };
    const auto parity = [](int kt) { return (uint32_t)((kt / kStages) & 1); };
    const auto kbuf = [&](int kt) {
      return base + L::kK + stage(kt) * L::kTile;
    };
    const auto vbuf = [&](int kt) {
      return base + L::kV + stage(kt) * L::kTile;
    };
    const auto edge = [&](int kt) {   // the diagonal tile; keys past Sk
      const int j0 = kt * kBlockN;
      return (p.causal && j0 + kBlockN - 1 > i0 + c * kRowsWg) ||
             j0 + kBlockN > p.sk;
    };
    mbar_wait(bar_k, 0);
    wg_fence();
    issue_qk<D>(s, q0, kbuf(0));
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    mbar_arrive(bar_ke);
    softmax_tile(s, m, l, alpha, sl2, edge(0), r0, 0, t, p.sk, p.causal);
    rescale_split<D>(o, alpha, s, hi, lo);
    for (int kt = 1; kt < n_kt; ++kt) {
      mbar_wait(bar_k + 8 * stage(kt), parity(kt));
      mbar_wait(bar_v + 8 * stage(kt - 1), parity(kt - 1));
      wg_fence();
      issue_qk<D>(s, q0, kbuf(kt));
      wg_commit();
      issue_pv<D>(o, hi, lo, vbuf(kt - 1));
      wg_commit();
      wg_wait<1>();                    // q.k of tile kt is done
      fence_regs(s);
      mbar_arrive(bar_ke + 8 * stage(kt));
      softmax_tile(s, m, l, alpha, sl2, edge(kt), r0, kt * kBlockN, t, p.sk,
                   p.causal);
      wg_wait<0>();                    // p.v of tile kt - 1 is done
      fence_regs(o);
      mbar_arrive(bar_ve + 8 * stage(kt - 1));
      rescale_split<D>(o, alpha, s, hi, lo);
    }
    mbar_wait(bar_v + 8 * stage(n_kt - 1), parity(n_kt - 1));
    wg_fence();
    issue_pv<D>(o, hi, lo, vbuf(n_kt - 1));
    wg_commit();
    wg_wait<0>();
    fence_regs(o);

    // o / max(l, 1e-30), rounded to bf16 once
    using bf16 = __nv_bfloat16;
    bf16* out = static_cast<bf16*>(p.o) + bb * p.o_b + hh * p.o_h;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int i = r0 + 8 * h;
      if (i >= p.sq) continue;
      const float denom = fmaxf(l[h], 1e-30f);
      bf16* orow = out + i * p.o_s + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(o[4 * n + 2 * h] / denom,
                                  o[4 * n + 2 * h + 1] / denom);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A bf16 (batch, seq, heads, D) view with D contiguous, as a 4-d tensor
// map (D, seq, heads, batch) whose box is W columns by `rows` rows; rows
// past `seq` read as zero.  A dimension of size 1 gets a packed stride
// (it is never stepped).  Returns 0, or -2 if the encoder refuses it.
int make_map(CUtensorMap* map, const void* ptr, int d, int seq, int heads,
             int batch, long long s_s, long long s_h, long long s_b,
             int rows, int w, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  const long long size[3] = {seq, heads, batch};
  long long stride[3] = {s_s, s_h, s_b};
  long long packed = d;
  for (int i = 0; i < 3; ++i) {
    if (size[i] == 1) stride[i] = packed;
    packed = stride[i] * size[i] > packed ? stride[i] * size[i] : packed;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)stride[0] * 2,
                                 (cuuint64_t)stride[1] * 2,
                                 (cuuint64_t)stride[2] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)w, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

// One cudaFuncSetAttribute per kernel instantiation, then the launch.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, int bytes, dim3 grid, int threads,
                  cudaStream_t stream, bool& configured, Args... args) {
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  kernel<<<grid, dim3(threads), bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(Params p, int heads, int kv, int batch, cudaStream_t stream) {
  static bool configured = false;
  if constexpr (sizeof(T) == 4) {
    p.n_qtiles = (p.sq + kTile - 1) / kTile;
    return launch_kernel(flash_attention_kernel<float, D>,
                         smem_floats<D>() * (int)sizeof(float),
                         dim3(p.n_qtiles, heads, batch), kThreads, stream,
                         configured, p);
  } else {
    using Sw = Swizzle<D>;
    CUtensorMap tq, tk, tv;
    if (make_map(&tq, p.q, D, p.sq, heads, batch, p.q_s, p.q_h, p.q_b,
                 kBlockM, Sw::W, Sw::kTma) ||
        make_map(&tk, p.k, D, p.sk, kv, batch, p.k_s, p.k_h, p.k_b, kBlockN,
                 Sw::W, Sw::kTma) ||
        make_map(&tv, p.v, D, p.sk, kv, batch, p.v_s, p.v_h, p.v_b, kBlockN,
                 Sw::W, Sw::kTma))
      return -2;
    p.n_qtiles = (p.sq + kBlockM - 1) / kBlockM;
    return launch_kernel(flash_attention_bf16_kernel<D>, Smem<D>::kBytes,
                         dim3(p.n_qtiles, heads, batch), kWgThreads, stream,
                         configured, tq, tk, tv, p);
  }
}

template <typename T>
int launch_d(int d, const Params& p, int heads, int kv, int batch,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, heads, kv, batch, stream);
    case 32: return launch<T, 32>(p, heads, kv, batch, stream);
    case 48: return launch<T, 48>(p, heads, kv, batch, stream);
    case 64: return launch<T, 64>(p, heads, kv, batch, stream);
    case 80: return launch<T, 80>(p, heads, kv, batch, stream);
    case 96: return launch<T, 96>(p, heads, kv, batch, stream);
    case 112: return launch<T, 112>(p, heads, kv, batch, stream);
    case 128: return launch<T, 128>(p, heads, kv, batch, stream);
    default: return -1;
  }
}

}  // namespace

// dtype 0 = float, 1 = bf16.  Strides in elements, (batch, seq, head) for
// each of q, k, v and o.  Returns 0 on success, a cudaError_t from the
// launch, -1 for arguments the kernel does not take (empty or too large
// dimensions, H not a multiple of KV, D not a multiple of 16 in [16, 128],
// an unknown dtype), or -2 where cuTensorMapEncodeTiled refuses a TMA
// descriptor.
extern "C" int flash_attention_launch(
    int dtype, const void* q, const void* k, const void* v, void* o, int b,
    int h, int kv, int sq, int sk, int d, long long q_b, long long q_s,
    long long q_h, long long k_b, long long k_s, long long k_h,
    long long v_b, long long v_s, long long v_h, long long o_b,
    long long o_s, long long o_h, int causal, float scale, void* stream) {
  if (b <= 0 || h <= 0 || kv <= 0 || sq <= 0 || sk <= 0 || h % kv ||
      b > 65535 || h > 65535)
    return -1;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_b = q_b;
  p.q_s = q_s;
  p.q_h = q_h;
  p.k_b = k_b;
  p.k_s = k_s;
  p.k_h = k_h;
  p.v_b = v_b;
  p.v_s = v_s;
  p.v_h = v_h;
  p.o_b = o_b;
  p.o_s = o_s;
  p.o_h = o_h;
  p.group = h / kv;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(d, p, h, kv, b, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(d, p, h, kv, b, s);
  return -1;
}
