// Backward of the prefill attention of flash_attention.cu, for Hopper
// (sm_90a).  With s_ij = scale q_i . k_j over the live keys (j <
// min(lengths[b], Sk), and j <= i when causal), P = softmax_j(s), O = P V
// and dO the gradient of the output:
//
//     P_ij = exp(s_ij - lse_i)          (lse from the forward, natural log)
//     D_i  = sum_d dO_id O_id
//     dV   = P^T dO                      dP = dO V^T
//     dS   = P o (dP - D)                dQ = scale dS K
//     dK   = scale dS^T Q, summed over the query heads of each kv head
//
//   q, out, dout     (B, QH, Sq, D)   f32 or bf16, D in {16, 32, 64, 128}
//   k, v             (B, KVH, Sk, D)  same dtype, QH a multiple of KVH
//   lse              (B, QH, Sq)      f32, +inf on a row with no live key
//   lengths (B,) int32 or null; delta (B, QH, Sq) f32 scratch
//   dq (like q), dk and dv (like k)   the inputs' dtype
//
// No TPU kernel is replaced: the reference has no custom VJP for its
// Pallas kernel (src/repro/kernels/flash_attention/kernel.py) and JAX
// differentiates the plain route.  The port's forward is a CUDA kernel
// whose output carries no autograd graph, so training on the card needs
// this kernel (FlashAttentionFn in ops.py).
//
// What bounds it: operations.  Five products the size of the forward's
// two (S and dP recomputed, dV, dK, dQ), 2.5x the forward's flops — 32.2
// GFLOP per layer at tiny-lm's training shape (8 x 12/4 x 1024 x 64,
// causal) — against reading q, k, v, out, dout once and writing three
// gradients.  This first design runs every product on f32 FMAs on the CUDA
// cores (67 TFLOP/s), in f32 whatever the input dtype; the forward's
// 3xTF32 wgmma route is later work.  What the design does about the bound:
//
//   * each thread holds a 4 x 4 (or 4 x D/16) block of every product in
//     registers and reads its operands from shared memory as 16-byte
//     vectors, so that a k step of 4 costs 8 vector loads for 64 FMAs;
//     shared rows are padded by 4 floats, and the threads that read
//     different rows of an operand read consecutive rows, so the loads run
//     without bank conflicts (two wavefronts, or one broadcast);
//   * P is recomputed from lse as exp2(s scale log2(e) - lse log2(e)) and
//     never stored in device memory;
//   * every output is written once, by one CTA, in a fixed order of sums:
//     no atomics, the same bits on every run.  That takes two kernels
//     after a pre-pass for D:
//       - dK/dV: one CTA per (batch, kv head, tile of 64 keys) walks the
//         G query heads of its group and their 64-row query tiles,
//         skipping the tiles wholly above the diagonal, and keeps dK and dV
//         in registers until the end; key tiles past lengths[b] write 0;
//       - dQ: one CTA per (batch, q head, tile of 64 queries) walks the key
//         tiles up to min(lengths[b], Sk), and to the diagonal when causal;
//     the tiles with the most work start first (the first key tiles, the
//     last query tiles).
//
// Masking: a key that is masked (past the length, past Sk, above the
// diagonal) or a query row past Sq gets P = 0 exactly, by a select, not
// through the exponent; so a row with no live key (lse = +inf) contributes
// nothing and gives dQ = 0, never NaN.  The causal convention is the
// forward's: key j is live for query i when j <= i, also when Sq != Sk.
//
// Plain C interface, loaded with ctypes: the launch takes raw device
// pointers and the stream, launches its three kernels on that stream, does
// not synchronise, allocates nothing, and returns the first CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;              // query rows per tile
constexpr int kBK = 64;              // keys per tile
constexpr int kPad = 4;              // floats of padding per shared row
constexpr int kLdP = kBK + kPad;     // row stride of the P and dS tiles
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Four consecutive elements as floats (16-byte aligned for f32, 8 for
// bf16: rows of D >= 16 elements keep that from a 16-byte aligned base).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// W consecutive floats of shared memory.
template <int W>
__device__ __forceinline__ void lds(float (&x)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}

// The d columns a thread owns in a (rows x D) product: E groups of W
// consecutive columns, d = W lo + 16 W e + f (lo = tid % 16), so that the
// 16 threads of a row read 16 consecutive vectors.
template <int D>
struct Cols {
  static constexpr int W = D >= 64 ? 4 : D / 16;
  static constexpr int E = D / 16 / W;
  static constexpr int N = D / 16;          // columns per thread
  __device__ __forceinline__ static int col(int lo, int e) {
    return W * lo + 16 * W * e;
  }
};

// rows x D elements of a (n_rows, D) row-major tensor from row r0 into
// shared memory as f32 with row stride D + kPad; rows past n_rows are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n_rows, int rows) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows) x = ld4(src + static_cast<int64_t>(r0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * (D + kPad) + c) = x;
  }
}

// acc[r][c] += sum_d A[hi + 16 r][d] B[lo + 16 c][d]: both operands (64 x
// D, stride D + kPad) read along d.  S = Q K^T and dP = dO V^T.
template <int D>
__device__ __forceinline__ void prod_nt(float (&acc)[4][4], const float* a,
                                        const float* b, int hi, int lo) {
  constexpr int LD = D + kPad;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[r] = *reinterpret_cast<const float4*>(a + (hi + 16 * r) * LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      y[c] = *reinterpret_cast<const float4*>(b + (lo + 16 * c) * LD + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = fmaf(x[r].x, y[c].x, acc[r][c]);
        acc[r][c] = fmaf(x[r].y, y[c].y, acc[r][c]);
        acc[r][c] = fmaf(x[r].z, y[c].z, acc[r][c]);
        acc[r][c] = fmaf(x[r].w, y[c].w, acc[r][c]);
      }
  }
}

// acc[jj][n] += sum_i A[i][4 hi + jj] B[i][col n]: A (kBQ x kBK, stride
// kLdP) read along its rows' keys, B (kBQ x D) along d.  dV = P^T dO and
// dK = dS^T Q, summed over the tile's query rows.
template <int D>
__device__ __forceinline__ void prod_tn(float (&acc)[4][D / 16],
                                        const float* a, const float* b,
                                        int hi, int lo) {
  using C = Cols<D>;
  constexpr int LD = D + kPad;
#pragma unroll 4
  for (int i = 0; i < kBQ; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(a + i * kLdP + 4 * hi);
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < C::E; ++e) {
      float y[C::W];
      lds<C::W>(y, b + i * LD + C::col(lo, e));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int f = 0; f < C::W; ++f)
          acc[jj][e * C::W + f] = fmaf(xs[jj], y[f], acc[jj][e * C::W + f]);
    }
  }
}

// acc[r][n] += sum_j A[hi + 16 r][j] B[j][col n]: A (kBQ x kBK, stride
// kLdP) read along j, B (kBK x D) along d.  dQ = dS K.
template <int D>
__device__ __forceinline__ void prod_nn(float (&acc)[4][D / 16],
                                        const float* a, const float* b,
                                        int hi, int lo) {
  using C = Cols<D>;
  constexpr int LD = D + kPad;
#pragma unroll 2
  for (int j = 0; j < kBK; j += 4) {
    float4 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      x[r] = *reinterpret_cast<const float4*>(a + (hi + 16 * r) * kLdP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int e = 0; e < C::E; ++e) {
        float y[C::W];
        lds<C::W>(y, b + (j + jj) * LD + C::col(lo, e));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float xr = jj == 0 ? x[r].x : jj == 1 ? x[r].y
                         : jj == 2 ? x[r].z : x[r].w;
#pragma unroll
          for (int f = 0; f < C::W; ++f)
            acc[r][e * C::W + f] = fmaf(xr, y[f], acc[r][e * C::W + f]);
        }
      }
    }
  }
}

// The scores of the thread's 4 x 4 block (rows hi + 16 r, keys lo + 16 c)
// turned into P and dS: P = exp2(s scale log2(e) - lse log2(e)) on live
// entries and exactly 0 elsewhere, dS = P (dP - D).  Writes dS (and P when
// p_out is not null) to shared memory.
__device__ __forceinline__ void probs(const float (&s)[4][4],
                                      const float (&dp)[4][4],
                                      const float* lse2, const float* dlt,
                                      float* p_out, float* ds_out, int hi,
                                      int lo, int q0, int k0, int seq_q,
                                      int klen, int causal, float c2) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = hi + 16 * r, qpos = q0 + i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = lo + 16 * c, kpos = k0 + j;
      const bool live = qpos < seq_q && kpos < klen && (!causal || kpos <= qpos);
      const float p = live ? exp2f(fmaf(s[r][c], c2, -lse2[i])) : 0.f;
      if (p_out != nullptr) p_out[i * kLdP + j] = p;
      ds_out[i * kLdP + j] = p * (dp[r][c] - dlt[i]);
    }
  }
}

// lse (in base 2) and D of query rows q0 .. q0 + kBQ - 1; 0 past Sq.
__device__ __forceinline__ void load_rows(float* lse2, float* dlt,
                                          const float* lse, const float* delta,
                                          int q0, int seq_q) {
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const bool ok = q0 + i < seq_q;
    lse2[i] = ok ? lse[q0 + i] * kLog2e : 0.f;
    dlt[i] = ok ? delta[q0 + i] : 0.f;
  }
}

// D_i = sum_d dO_id O_id in f32, one warp per row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_delta_kernel(const T* __restrict__ out,
                                 const T* __restrict__ dout,
                                 float* __restrict__ delta, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s = fmaf(to_f32(out[row * D + d]), to_f32(dout[row * D + d]), s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) delta[row] = s;
}

template <int D>
struct SmemKV {
  static constexpr int kTile = 64 * (D + kPad);       // floats, q/k/v/dO
  static constexpr int kP = kBQ * kLdP;               // floats, P or dS
  // dK/dV: K, V, Q, dO, P, dS, lse, D
  static constexpr int kBytesKV = (4 * kTile + 2 * kP + 2 * kBQ) * 4;
  // dQ: Q, dO, K, V, dS, lse, D
  static constexpr int kBytesQ = (4 * kTile + kP + 2 * kBQ) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ lengths,
    T* __restrict__ dk, T* __restrict__ dv, int batch, int qh, int kvh,
    int seq_q, int seq_k, float scale, int causal) {
  using C = Cols<D>;
  using S = SmemKV<D>;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + S::kTile;
  float* qs = vs + S::kTile;
  float* dos = qs + S::kTile;
  float* ps = dos + S::kTile;
  float* dss = ps + S::kP;
  float* lse2 = dss + S::kP;
  float* dlt = lse2 + kBQ;

  const int tid = threadIdx.x, hi = tid / 16, lo = tid % 16;
  const int n_bh = batch * kvh;
  const int bh = blockIdx.x % n_bh;
  const int kt = blockIdx.x / n_bh;       // first (longest) key tiles first
  const int hk = bh % kvh, b = bh / kvh;
  const int group = qh / kvh;
  const int k0 = kt * kBK;
  int klen = seq_k;
  if (lengths != nullptr) klen = max(0, min(klen, lengths[b]));
  const int64_t koff = (static_cast<int64_t>(b) * kvh + hk) * seq_k * D;

  float adk[4][C::N], adv[4][C::N];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int n = 0; n < C::N; ++n) adk[jj][n] = adv[jj][n] = 0.f;

  if (k0 < klen) {
    load_tile<T, D>(ks, k + koff, k0, seq_k, kBK);
    load_tile<T, D>(vs, v + koff, k0, seq_k, kBK);
    const float c2 = scale * kLog2e;
    const int n_qt = (seq_q + kBQ - 1) / kBQ;
    // a query tile wholly above the diagonal (last row < k0) has no live
    // entry; kBQ == kBK, so those are the tiles before k0 / kBQ
    const int qt0 = causal ? k0 / kBQ : 0;
    for (int g = 0; g < group; ++g) {
      const int64_t row0 =
          (static_cast<int64_t>(b) * qh + hk * group + g) * seq_q;
      for (int qt = qt0; qt < n_qt; ++qt) {
        const int q0 = qt * kBQ;
        __syncthreads();                  // the last tile's reads are done
        load_tile<T, D>(qs, q + row0 * D, q0, seq_q, kBQ);
        load_tile<T, D>(dos, dout + row0 * D, q0, seq_q, kBQ);
        load_rows(lse2, dlt, lse + row0, delta + row0, q0, seq_q);
        __syncthreads();
        float s[4][4], dp[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
        prod_nt<D>(s, qs, ks, hi, lo);
        prod_nt<D>(dp, dos, vs, hi, lo);
        probs(s, dp, lse2, dlt, ps, dss, hi, lo, q0, k0, seq_q, klen, causal,
              c2);
        __syncthreads();
        prod_tn<D>(adv, ps, dos, hi, lo);
        prod_tn<D>(adk, dss, qs, hi, lo);
      }
    }
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int key = k0 + 4 * hi + jj;
    if (key >= seq_k) continue;
    T* gk = dk + koff + static_cast<int64_t>(key) * D;
    T* gv = dv + koff + static_cast<int64_t>(key) * D;
#pragma unroll
    for (int e = 0; e < C::E; ++e)
#pragma unroll
      for (int f = 0; f < C::W; ++f) {
        const int d = C::col(lo, e) + f;
        store(gk + d, adk[jj][e * C::W + f] * scale);
        store(gv + d, adv[jj][e * C::W + f]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ lengths,
    T* __restrict__ dq, int batch, int qh, int kvh, int seq_q, int seq_k,
    int n_qt, float scale, int causal) {
  using C = Cols<D>;
  using S = SmemKV<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + S::kTile;
  float* ks = dos + S::kTile;
  float* vs = ks + S::kTile;
  float* dss = vs + S::kTile;
  float* lse2 = dss + S::kP;
  float* dlt = lse2 + kBQ;

  const int tid = threadIdx.x, hi = tid / 16, lo = tid % 16;
  const int n_bh = batch * qh;
  const int bh = blockIdx.x % n_bh;
  const int qt = n_qt - 1 - blockIdx.x / n_bh;   // last (longest) first
  const int h = bh % qh, b = bh / qh;
  const int hk = h / (qh / kvh);
  const int q0 = qt * kBQ;
  int klen = seq_k;
  if (lengths != nullptr) klen = max(0, min(klen, lengths[b]));
  const int kend = causal ? min(klen, q0 + kBQ) : klen;
  const int n_tiles = (kend + kBK - 1) / kBK;
  const int64_t row0 = (static_cast<int64_t>(b) * qh + h) * seq_q;
  const int64_t koff = (static_cast<int64_t>(b) * kvh + hk) * seq_k * D;
  const float c2 = scale * kLog2e;

  float acc[4][C::N];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < C::N; ++n) acc[r][n] = 0.f;

  if (n_tiles > 0) {
    load_tile<T, D>(qs, q + row0 * D, q0, seq_q, kBQ);
    load_tile<T, D>(dos, dout + row0 * D, q0, seq_q, kBQ);
    load_rows(lse2, dlt, lse + row0, delta + row0, q0, seq_q);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                      // the last tile's reads are done
    load_tile<T, D>(ks, k + koff, k0, seq_k, kBK);
    load_tile<T, D>(vs, v + koff, k0, seq_k, kBK);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    prod_nt<D>(s, qs, ks, hi, lo);
    prod_nt<D>(dp, dos, vs, hi, lo);
    probs(s, dp, lse2, dlt, nullptr, dss, hi, lo, q0, k0, seq_q, klen, causal,
          c2);
    __syncthreads();
    prod_nn<D>(acc, dss, ks, hi, lo);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + hi + 16 * r;
    if (row >= seq_q) continue;
    T* g = dq + (row0 + row) * D;
#pragma unroll
    for (int e = 0; e < C::E; ++e)
#pragma unroll
      for (int f = 0; f < C::W; ++f)
        store(g + C::col(lo, e) + f, acc[r][e * C::W + f] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   const int32_t* lengths, float* delta, void* dq, void* dk,
                   void* dv, int64_t batch, int64_t qh, int64_t kvh,
                   int64_t seq_q, int64_t seq_k, float scale, int causal,
                   cudaStream_t stream) {
  using S = SmemKV<D>;
  const int64_t rows = batch * qh * seq_q;
  const int64_t n_qt = (seq_q + kBQ - 1) / kBQ;
  const int64_t n_kt = (seq_k + kBK - 1) / kBK;
  const int64_t rows_per_cta = kThreads / 32;
  if ((rows + rows_per_cta - 1) / rows_per_cta > 2147483647LL ||
      n_qt * qh * batch > 2147483647LL || n_kt * kvh * batch > 2147483647LL)
    return cudaErrorInvalidValue;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);

  flash_attention_bwd_delta_kernel<T, D>
      <<<static_cast<unsigned>((rows + rows_per_cta - 1) / rows_per_cta),
         kThreads, 0, stream>>>(static_cast<const T*>(out), tdo, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (n_kt > 0) {
    err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kBytesKV);
    if (err != cudaSuccess) return err;
    flash_attention_bwd_dkdv_kernel<T, D>
        <<<static_cast<unsigned>(n_kt * kvh * batch), kThreads, S::kBytesKV,
           stream>>>(tq, tk, tv, tdo, lse, delta, lengths,
                     static_cast<T*>(dk), static_cast<T*>(dv),
                     static_cast<int>(batch), static_cast<int>(qh),
                     static_cast<int>(kvh), static_cast<int>(seq_q),
                     static_cast<int>(seq_k), scale, causal);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::kBytesQ);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dq_kernel<T, D>
      <<<static_cast<unsigned>(n_qt * qh * batch), kThreads, S::kBytesQ,
         stream>>>(tq, tk, tv, tdo, lse, delta, lengths, static_cast<T*>(dq),
                   static_cast<int>(batch), static_cast<int>(qh),
                   static_cast<int>(kvh), static_cast<int>(seq_q),
                   static_cast<int>(seq_k), static_cast<int>(n_qt), scale,
                   causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* out, const void* dout, const float* lse,
                     const int32_t* lengths, float* delta, void* dq, void* dk,
                     void* dv, int64_t batch, int64_t qh, int64_t kvh,
                     int64_t seq_q, int64_t seq_k, int64_t head_dim,
                     float scale, int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, out, dout, lse, lengths, delta, dq, dk,
                           dv, batch, qh, kvh, seq_q, seq_k, scale, causal,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, out, dout, lse, lengths, delta, dq, dk,
                           dv, batch, qh, kvh, seq_q, seq_k, scale, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, dout, lse, lengths, delta, dq, dk,
                           dv, batch, qh, kvh, seq_q, seq_k, scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, dout, lse, lengths, delta, dq, dk,
                            dv, batch, qh, kvh, seq_q, seq_k, scale, causal,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  delta is (B, QH, Sq) f32 scratch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, const int32_t* lengths, float* delta,
    void* dq, void* dk, void* dv, int64_t batch, int64_t qh, int64_t kvh,
    int64_t seq_q, int64_t seq_k, int64_t head_dim, float scale,
    int64_t causal, int64_t dtype, void* stream) {
  if (batch <= 0 || qh <= 0 || seq_q <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (kvh <= 0 || qh % kvh != 0 || seq_q > 2147483647LL ||
      seq_k > 2147483647LL || seq_k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal != 0;
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_d<float>(
          q, k, v, out, dout, lse, lengths, delta, dq, dk, dv, batch, qh,
          kvh, seq_q, seq_k, head_dim, scale, c, s));
    case 1:
      return static_cast<int>(launch_d<__nv_bfloat16>(
          q, k, v, out, dout, lse, lengths, delta, dq, dk, dv, batch, qh,
          kvh, seq_q, seq_k, head_dim, scale, c, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
