// Tiled prefill attention, causal or full, GQA-aware, for Hopper (sm_90a):
//
//     out[b, h, i, :] = softmax_j(scale q[b, h, i, :] . k[b, hk, j, :])
//                       v[b, hk, j, :],   hk = h / group
//
// over the keys j < min(lengths[b], Sk), and j <= i when causal.
//
//   q   (B, QH, Sq, D)   f32 or bf16, D in {16, 32, 64, 128}
//   k/v (B, KVH, Sk, D)  same dtype, QH a multiple of KVH
//   lengths (B,) int32 or null (every key live)
//   out (B, QH, Sq, D)   q's dtype
//
// Replaces the Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py, body `_flash_kernel`),
// whose grid (B, QH, Sq/bq, Sk/bk) carries the online softmax of one q
// block across its k blocks in VMEM scratch, skips k blocks above the
// diagonal and past lengths[b], and asserts that the blocks divide S.
//
// On the H100 prefill attention is bound by arithmetic (2 * 2 * Sq * Sk *
// D * QH flops, halved by the causal mask, against Sq + 2 Sk rows of
// bytes): this kernel runs it as f32 FMAs on CUDA cores, whose published
// rate is 67 TFLOP/s, with no tensor cores yet.  The design:
//
//   * one CTA of 256 threads per (q tile of kBQ = 64 rows, q head, batch);
//     the kv head is h / group; the k loop inside the CTA takes the place
//     of the Pallas grid's sequential k dimension;
//   * the q tile (pre-scaled in f32, as the Pallas kernel scales q) and
//     each k tile are staged TRANSPOSED in shared memory ([d][row], rows
//     padded to 68 floats), so a thread's 4 rows and 4 keys are one
//     float4 each: a 4 x 4 register block of scores costs 2 shared loads
//     per 16 FMAs.  v is staged [key][d];
//   * thread (ty, tx) = (tid / 16, tid % 16) owns query rows 4 ty .. 4 ty
//     + 3 (their running max, sum and an acc slice of D / 16 columns in
//     registers) and keys 4 tx .. 4 tx + 3 of each tile; a row's max and
//     sum reduce over the 16 lanes that share ty, with warp shuffles;
//   * the k loop stops at min(lengths[b], Sk) and, when causal, after the
//     tile that holds the diagonal of the q tile's last row;
//   * ragged edges are masked here, so S need not be a multiple of a tile:
//     q rows past Sq load 0 and are not stored, keys past Sk load 0 and
//     are masked.
//
// Masking uses -1e30 as the Pallas kernel does.  The running max of every
// row turns real in the first k tile, which is what keeps a masked score
// at exp(-1e30 - m) = 0: the k loop starts at key 0, and key 0 is live for
// every row of every q tile whenever the loop runs at all (the loop runs
// only when min(lengths[b], Sk) >= 1, and causal keeps j = 0 <= i for
// every row i).  When no key is live the loop does not run, l stays 0 and
// the output is acc / max(l, 1e-30) = 0, as the Pallas kernel gives.
//
// Plain C interface, loaded with ctypes: the launch takes raw device
// pointers and the stream, launches on that stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;              // query rows per CTA
constexpr int kBK = 64;              // keys per tile (== kBQ: see above)
constexpr int kLdt = kBQ + 4;        // row stride of the transposed tiles
constexpr float kNegInf = -1e30f;    // the Pallas kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N consecutive floats of shared memory, with the widest aligned loads.
template <int N>
__device__ __forceinline__ void load_cols(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      o[c] = t.x;
      o[c + 1] = t.y;
      o[c + 2] = t.z;
      o[c + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x;
    o[1] = t.y;
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) o[c] = p[c];
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * D * kLdt + kBK * D + kBK * kLdt);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ lengths,
                       T* __restrict__ out, int qh, int kvh, int seq_q,
                       int seq_k, float scale, int causal) {
  constexpr int CPT = D / 16;           // acc columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;                     // D x kLdt: q tile, transposed
  float* kT = qT + D * kLdt;            // D x kLdt: k tile, transposed
  float* vs = kT + D * kLdt;            // kBK x D
  float* pT = vs + kBK * D;             // kBK x kLdt: p, transposed

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (qh / kvh);
  int klen = seq_k;
  if (lengths != nullptr) klen = max(0, min(klen, lengths[b]));
  const int kend = causal ? min(klen, q0 + kBQ) : klen;

  const int64_t qoff = (static_cast<int64_t>(b) * qh + h) * seq_q * D;
  const int64_t koff = (static_cast<int64_t>(b) * kvh + hk) * seq_k * D;
  const T* qb = q + qoff;
  const T* kb = k + koff;
  const T* vb = v + koff;
  T* ob = out + qoff;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D, row = q0 + r;
    qT[d * kLdt + r] =
        row < seq_q ? to_f32(qb[static_cast<int64_t>(row) * D + d]) * scale
                    : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                    // the previous tile is consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D, key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < seq_k) {
        kv = to_f32(kb[static_cast<int64_t>(key) * D + d]);
        vv = to_f32(vb[static_cast<int64_t>(key) * D + d]);
      }
      kT[d * kLdt + r] = kv;
      vs[r * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa =
          *reinterpret_cast<const float4*>(qT + d * kLdt + ty * 4);
      const float4 ka =
          *reinterpret_cast<const float4*>(kT + d * kLdt + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool live = kpos < klen && (!causal || kpos <= qpos);
        s[i][j] = live ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_cur = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_cur);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_cur;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(pT + (tx * 4 + j) * kLdt + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    const int nk = min(kBK, kend - k0);  // later keys have p = 0
    for (int kk = 0; kk < nk; ++kk) {
      const float4 pa =
          *reinterpret_cast<const float4*>(pT + kk * kLdt + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      float vv[CPT];
      load_cols<CPT>(vs + kk * D + tx * CPT, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      ob[static_cast<int64_t>(row) * D + tx * CPT + c] =
          from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* lengths, void* out, int64_t batch,
                   int64_t qh, int64_t kvh, int64_t seq_q, int64_t seq_k,
                   float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>((seq_q + kBQ - 1) / kBQ),
            static_cast<unsigned>(qh), static_cast<unsigned>(batch));
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out),
      static_cast<int>(qh), static_cast<int>(kvh), static_cast<int>(seq_q),
      static_cast<int>(seq_k), scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int32_t* lengths, void* out, int64_t batch,
                     int64_t qh, int64_t kvh, int64_t seq_q, int64_t seq_k,
                     int64_t head_dim, float scale, int causal,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, out, batch, qh, kvh, seq_q,
                           seq_k, scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, lengths, out, batch, qh, kvh, seq_q,
                           seq_k, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, batch, qh, kvh, seq_q,
                           seq_k, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, batch, qh, kvh, seq_q,
                            seq_k, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int32_t* lengths,
                                      void* out, int64_t batch, int64_t qh,
                                      int64_t kvh, int64_t seq_q,
                                      int64_t seq_k, int64_t head_dim,
                                      float scale, int64_t causal,
                                      int64_t dtype, void* stream) {
  if (batch <= 0 || qh <= 0 || seq_q <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (kvh <= 0 || qh % kvh != 0 || batch > 65535 || qh > 65535 ||
      seq_q > 2147483647LL || seq_k > 2147483647LL || seq_k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c = causal != 0;
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_d<float>(q, k, v, lengths, out, batch,
                                              qh, kvh, seq_q, seq_k,
                                              head_dim, scale, c, s));
    case 1:
      return static_cast<int>(launch_d<__nv_bfloat16>(
          q, k, v, lengths, out, batch, qh, kvh, seq_q, seq_k, head_dim,
          scale, c, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
