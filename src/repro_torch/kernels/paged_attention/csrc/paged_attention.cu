// One-token GQA decode attention over a paged KV cache, for Hopper (sm_90a):
//
//     out[b, h, g, :] = softmax_t(scale q[b, h, g, :] . K[b, t, h, :])
//                       V[b, t, h, :]
//
// over the first lengths[b] logical tokens t of sequence b, token t living
// at row t % page of page block_tables[b, t / page] of the pool.
//
//   q            (B, KVH, G, D)     f32 or bf16 (the caller's (B, QH, D))
//   k/v_pages    (P, page, KVH, D)  same dtype
//   block_tables (B, maxp) int32,  lengths (B,) int32
//   out          (B, KVH, G, D)     q's dtype
//
// Replaces the Pallas TPU kernel `paged_attention_kernel`
// (src/repro/kernels/paged_attention/kernel.py, body `_paged_attn_kernel`).
// There the block table rides in SMEM by scalar prefetch, a BlockSpec
// index_map picks the page each grid step DMAs, and the grid walks all
// maxp pages, skipping the compute of dead ones.
//
// On the H100 decode attention is bound by HBM bytes: every live K and V
// element is read once and used for G multiply-adds.  At G = 3 that is
// well under one flop per byte, far below the card's ridge.  The design:
//
//   * one CTA per (kv head, sequence); the CTA copies the live part of
//     block_tables[b, .] into shared memory once, and walks only the live
//     tokens t < min(length, maxp * page), never a dead page;
//   * each step stages kTokens = 64 logical tokens of K and V in shared
//     memory (crossing page boundaries: every token's row is found through
//     the staged table) with 16-byte loads for f32 (8-byte for bf16), K
//     rows padded by 4 floats so the float4 dot products do not conflict
//     on banks;
//   * software pipelining: a chunk's loads go to registers and are issued
//     before the previous chunk's arithmetic, so they are in flight while
//     it runs; only the store to shared memory waits for them;
//   * the G query rows, pre-scaled in f32 as the Pallas kernel does, and
//     their running max m, sum l and accumulator acc stay in shared
//     memory in f32 (the online softmax of the Pallas kernel, one chunk
//     of tokens at a time);
//   * every staged token is live, so each chunk has a real maximum and
//     the first chunk replaces the -1e30 initial max (alpha = 0);
//   * a sequence with length 0 walks no token: l = 0 and the output is
//     acc / max(l, 1e-30) = 0, the Pallas kernel's answer.
//
// Still simple: f32 FMAs on CUDA cores, no TMA, and no split of a long
// sequence over several CTAs, so 8 sequences x 4 kv heads fill only 32 of
// the 132 SMs (a later PR splits the sequence, flash-decoding style).
// The table must fit in shared memory next to the tiles (maxp up to
// about 40000 pages); the launch refuses a larger one.
//
// Plain C interface, loaded with ctypes: the launch takes raw device
// pointers and the stream, launches on that stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTokens = 64;          // logical tokens staged per step
constexpr float kNegInf = -1e30f;    // the Pallas kernel's mask value
constexpr size_t kMaxSmem = 227 * 1024;

// Four consecutive elements as loaded from device memory, and as floats.
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ float4 f32() const { return v; }
};
template <>
struct Raw4<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ float4 f32() const {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

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

template <int D>
size_t smem_bytes(int64_t group, int64_t max_pages) {
  return sizeof(float) * (kTokens * (D + 4) + kTokens * D + 2 * group * D +
                          group * kTokens + 3 * group) +
         sizeof(int32_t) * max_pages;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int32_t* __restrict__ block_tables,
                       const int32_t* __restrict__ lengths,
                       T* __restrict__ out, int kvh, int group, int page_size,
                       int max_pages, float scale) {
  constexpr int KS = D + 4;                 // padded K row stride
  constexpr int VPR = D / 4;                // 4-element vectors per row
  constexpr int VPT = kTokens * VPR / kThreads;   // per thread per chunk
  static_assert(VPT >= 1 && kTokens * VPR % kThreads == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  const int G = group;
  float* k_s = smem;                        // kTokens x (D + 4)
  float* v_s = k_s + kTokens * KS;          // kTokens x D
  float* q_s = v_s + kTokens * D;           // G x D, pre-scaled
  float* acc_s = q_s + G * D;               // G x D
  float* p_s = acc_s + G * D;               // G x kTokens: scores, probs
  float* m_s = p_s + G * kTokens;           // G
  float* l_s = m_s + G;                     // G
  float* alpha_s = l_s + G;                 // G
  int32_t* bt_s = reinterpret_cast<int32_t*>(alpha_s + G);  // live pages

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  constexpr int kWarps = kThreads / 32;

  int length = lengths[b];
  length = max(0, min(length, max_pages * page_size));
  const int32_t* bt = block_tables + static_cast<int64_t>(b) * max_pages;
  const int64_t qbase = (static_cast<int64_t>(b) * kvh + h) * G * D;

  const int live_pages = (length + page_size - 1) / page_size;
  for (int i = tid; i < live_pages; i += kThreads) bt_s[i] = bt[i];
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_f32(q[qbase + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  // this thread's share of a chunk: VPT vectors of K and of V
  Raw4<T> kr[VPT], vr[VPT];
  auto issue = [&](int t0) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = tid + j * kThreads, t = v / VPR, c = (v % VPR) * 4;
      const int pos = t0 + t;
      if (pos < length) {
        const int64_t row = static_cast<int64_t>(bt_s[pos / page_size]) *
                                page_size + pos % page_size;
        const int64_t src = (row * kvh + h) * D + c;
        kr[j].load(k_pages + src);
        vr[j].load(v_pages + src);
      }
    }
  };
  auto stage = [&](int n) {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = tid + j * kThreads, t = v / VPR, c = (v % VPR) * 4;
      if (t < n) {
        *reinterpret_cast<float4*>(k_s + t * KS + c) = kr[j].f32();
        *reinterpret_cast<float4*>(v_s + t * D + c) = vr[j].f32();
      }
    }
  };

  if (length > 0) issue(0);
  for (int t0 = 0; t0 < length; t0 += kTokens) {
    const int n = min(kTokens, length - t0);
    stage(n);                               // waits for this chunk's loads
    __syncthreads();
    if (t0 + kTokens < length) issue(t0 + kTokens);   // in flight below
    // scores of the G rows against the n staged tokens
    for (int i = tid; i < G * n; i += kThreads) {
      const int g = i / n, t = i - g * n;
      const float4* qr = reinterpret_cast<const float4*>(q_s + g * D);
      const float4* kr4 = reinterpret_cast<const float4*>(k_s + t * KS);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < VPR; ++d4) {
        const float4 a = qr[d4], c = kr4[d4];
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
      p_s[g * kTokens + t] = s;
    }
    __syncthreads();
    // online softmax, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* row = p_s + g * kTokens;
      float mx = kNegInf;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, row[t]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float p = expf(row[t] - m_cur);
        row[t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_cur;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p V
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pr = p_s + g * kTokens;
      float a = acc_s[i] * alpha_s[g];
      for (int t = 0; t < n; ++t) a = fmaf(pr[t], v_s[t * D + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    out[qbase + i] = from_f32<T>(acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int32_t* block_tables, const int32_t* lengths,
                   void* out, int64_t batch, int64_t kvh, int64_t group,
                   int64_t page_size, int64_t max_pages, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(group, max_pages);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(kvh), static_cast<unsigned>(batch));
  paged_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_tables, lengths,
      static_cast<T*>(out), static_cast<int>(kvh), static_cast<int>(group),
      static_cast<int>(page_size), static_cast<int>(max_pages), scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k_pages, const void* v_pages,
                     const int32_t* block_tables, const int32_t* lengths,
                     void* out, int64_t batch, int64_t kvh, int64_t group,
                     int64_t head_dim, int64_t page_size, int64_t max_pages,
                     float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k_pages, v_pages, block_tables, lengths, out,
                           batch, kvh, group, page_size, max_pages, scale,
                           stream);
    case 32:
      return launch<T, 32>(q, k_pages, v_pages, block_tables, lengths, out,
                           batch, kvh, group, page_size, max_pages, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k_pages, v_pages, block_tables, lengths, out,
                           batch, kvh, group, page_size, max_pages, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k_pages, v_pages, block_tables, lengths, out,
                            batch, kvh, group, page_size, max_pages, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim in {16, 32, 64, 128}.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int32_t* block_tables, const int32_t* lengths, void* out,
    int64_t batch, int64_t kvh, int64_t group, int64_t head_dim,
    int64_t page_size, int64_t max_pages, float scale, int64_t dtype,
    void* stream) {
  if (batch <= 0 || kvh <= 0 || group <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (batch > 65535 || kvh > 2147483647LL || page_size <= 0 ||
      max_pages <= 0 || max_pages * page_size > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_d<float>(
          q, k_pages, v_pages, block_tables, lengths, out, batch, kvh, group,
          head_dim, page_size, max_pages, scale, s));
    case 1:
      return static_cast<int>(launch_d<__nv_bfloat16>(
          q, k_pages, v_pages, block_tables, lengths, out, batch, kvh, group,
          head_dim, page_size, max_pages, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
