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
//   acc = acc * exp(m - m') + sum_j p_j v_j (p stays float32)
//   o_i = acc / max(l, 1e-30), cast to the input type
//
//   q (B, H, Sq, D), k and v (B, KV, Sk, D), o (B, H, Sq, D), each read
//   through its own (batch, seq, head) strides with D contiguous, so the
//   model's (B, S, H, D) tensors are read and written without a
//   transpose.  T = float or __nv_bfloat16; D a multiple of 16 up to 128.
//
// Bound: operations.  A call does 4 * D flops per (query row, key row)
// pair it attends (q.k and p.v), over S^2 / 2 pairs when causal, against
// 2 (Sq H + Sk KV) D elements moved: at granite-8b's 16384-token prefill
// (H 32, KV 8, D 128, bf16) 2.2e12 flop against 0.34 GB, about 2.2 ms at
// the 989 TFLOP/s of bf16 tensor cores and 0.1 ms at 3.35 TB/s.
//
// What this first, simple design does about it:
// * One CTA of 256 threads per (b, h, 64-row query tile); the key rows
//   go through shared memory in 64-row tiles.  The TPU kernel carries
//   its softmax state in VMEM from one grid step to the next; here the
//   key tiles are a loop inside the CTA and the state (m, l and a 4-row
//   slice of acc per thread) lives in registers.
// * GQA is an index: a CTA reads its kv head h / (H / KV) directly, and
//   no repeated K / V is ever materialised.
// * Causal key tiles past the diagonal are skipped, not masked (the loop
//   ends at the query tile's own index); the diagonal tile is masked.
//   CTAs of the longest query tiles are issued first.
// * Products are float32 FFMA in both types: bf16 inputs are widened as
//   they are copied into shared memory, so p stays float32 in p.v as in
//   the TPU kernel, and float32 never goes through TF32.  Each thread
//   owns a 4 x 4 block of the 64 x 64 score tile, fed by two 16-byte
//   shared reads per 16 FFMAs; the probabilities go back through shared
//   memory, transposed, into the space of the key tile (no longer read
//   by then), and each thread accumulates its 4 rows at D / 16 columns.
// * Row max and row sum are reduced across the 16 threads of a row with
//   warp shuffles.
// * Tensor cores (mma / wgmma with bf16 operands), TMA and a pipeline
//   of key tiles are for a later, faster version.
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError(); it allocates nothing and does not synchronise.

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

// 16 bytes of T as floats: 4 (float) or 8 (bf16).
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

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
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

__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

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

template <typename T, int D>
int launch(const Params& p, int heads, int batch, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(p.n_qtiles, heads, batch);
  flash_attention_kernel<T, D><<<grid, dim3(kThreads), bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const Params& p, int heads, int batch,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, heads, batch, stream);
    case 32: return launch<T, 32>(p, heads, batch, stream);
    case 48: return launch<T, 48>(p, heads, batch, stream);
    case 64: return launch<T, 64>(p, heads, batch, stream);
    case 80: return launch<T, 80>(p, heads, batch, stream);
    case 96: return launch<T, 96>(p, heads, batch, stream);
    case 112: return launch<T, 112>(p, heads, batch, stream);
    case 128: return launch<T, 128>(p, heads, batch, stream);
    default: return -1;
  }
}

}  // namespace

// dtype 0 = float, 1 = bf16.  Strides in elements, (batch, seq, head) for
// each of q, k, v and o.  Returns 0 on success, a cudaError_t from the
// launch, or -1 for arguments the kernel does not take (empty or too large
// dimensions, H not a multiple of KV, D not a multiple of 16 in [16, 128],
// an unknown dtype).
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
  p.n_qtiles = (sq + kTile - 1) / kTile;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(d, p, h, b, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(d, p, h, b, s);
  return -1;
}
