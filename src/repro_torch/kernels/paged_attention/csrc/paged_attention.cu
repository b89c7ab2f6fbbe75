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
//   scratch      m, l (B, KVH, n_part, G) and acc (B, KVH, n_part, G, D),
//                f32, n_part = ceil(maxp * page / T)
//
// Replaces the Pallas TPU kernel `paged_attention_kernel`
// (src/repro/kernels/paged_attention/kernel.py, body `_paged_attn_kernel`).
// There the block table rides in SMEM by scalar prefetch, a BlockSpec
// index_map picks the page each grid step DMAs, and the grid walks all
// maxp pages, skipping the compute of dead ones.
//
// On the H100 decode attention is bound by HBM bytes: every live K and V
// element is read once and used for G multiply-adds.  At G = 3 that is
// well under one flop per byte, far below the card's ridge, so tensor
// cores would not help: the arithmetic is f32 FMAs on CUDA cores, and the
// design is about keeping enough bytes in flight on every SM.  One call
// of the op is two launches on the caller's stream:
//
//   1. the partition kernel, grid (n_part, KVH, B).  Each CTA owns T
//      logical tokens [p T, (p + 1) T) of one (kv head, sequence) and
//      serves all G q heads of that kv head, so each K/V byte is read
//      once.  It stages its partition's slice of the block table in
//      shared memory (so the table's width is not limited by shared
//      memory) while it reads the length, and exits at once when the
//      partition starts past it.  Its tokens stream in chunks of kTokens =
//      64 through a ring of kStages = 2 chunk buffers filled by 16-byte
//      `cp.async.cg` copies, the next chunk in flight while one is
//      computed (all CTAs' first chunks are requested first, so they land
//      early and the arithmetic overlaps the rest of the stream).  Every
//      token's row is found through the staged table, so a chunk may
//      cross page boundaries.  Each of the 8
//      warps takes 8 tokens of a chunk, 4 lanes a token, and keeps its own
//      online softmax (running max m, sum l and accumulator acc, in f32,
//      in shared memory) for each of the G rows, so no block barrier falls
//      inside a chunk; q is pre-scaled in f32 as the Pallas kernel does.
//      A warp's dead tokens (past the length) weigh 0.  At the end the
//      warps' states are folded in warp order, and the CTA writes its m, l
//      and unnormalised acc to the scratch.
//   2. the combine kernel, grid (KVH, B, ceil(G D / 256)), launched
//      with programmatic dependent launch so that it is scheduled while
//      the partition grid runs and waits for its end on the device
//      (griddepcontrol), folds the live partitions of each row in
//      partition order:
//          m = max_p m_p,  l = sum_p l_p e^(m_p - m),
//          out = sum_p acc_p e^(m_p - m) / max(l, 1e-30).
//      No float atomics: the result is the same bits from run to run.  A
//      partition with no live token contributes nothing (it is not
//      read); a sequence with length 0 has none, so l = 0 and the output
//      is acc / max(l, 1e-30) = 0, the Pallas kernel's answer.
//
// At tiny-lm's decode shape (8 sequences of up to 2048 tokens, 4 kv
// heads) T = 128 gives about 380 CTAs of 73 KB of shared memory, three per
// SM: every SM streams, where one CTA per (kv head, sequence) kept 32 SMs
// busy.
//
// Plain C interface, loaded with ctypes: the launch takes raw device
// pointers and the stream, launches on that stream, does not synchronise,
// allocates nothing (the wrapper passes the scratch), and returns the
// first error of either launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTokens = 64;          // logical tokens per chunk
constexpr int kThreads = 4 * kTokens;        // 4 lanes a token
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = 8;                  // tokens a warp takes
constexpr int kMinBlocks = 768 / kThreads;   // CTAs an SM must hold
constexpr int kStages = 2;           // chunk buffers in the cp.async ring
constexpr int kGB = 4;               // q rows a warp works on together
constexpr int kCombineBatch = 8;     // partitions a combine step loads
constexpr float kNegInf = -1e30f;    // the Pallas kernel's mask value
constexpr size_t kMaxSmem = 227 * 1024;

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

// The dot product of one 16-byte chunk of a K row (in registers) with the
// matching f32 q elements.
template <typename T>
__device__ __forceinline__ float dot_chunk(const float* q, uint4 k, float s);
template <>
__device__ __forceinline__ float dot_chunk<float>(const float* q, uint4 k,
                                                  float s) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  s = fmaf(a.x, __uint_as_float(k.x), s);
  s = fmaf(a.y, __uint_as_float(k.y), s);
  s = fmaf(a.z, __uint_as_float(k.z), s);
  return fmaf(a.w, __uint_as_float(k.w), s);
}
template <>
__device__ __forceinline__ float dot_chunk<__nv_bfloat16>(const float* q,
                                                          uint4 k, float s) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&k);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(x[i]);
    s = fmaf(q[2 * i], f.x, s);
    s = fmaf(q[2 * i + 1], f.y, s);
  }
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A K or V row in 16-byte chunks, and where chunk c of token t sits: with
// 8 or more chunks a row, odd tokens swap the halves of every 8, so the
// 8 lanes that read two neighbouring tokens' chunks hit 8 different bank
// groups.
template <typename T, int D>
struct Row {
  static constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  __device__ __forceinline__ static int chunk(int t, int c) {
    return kChunks >= 8 ? c ^ ((t & 1) << 2) : c;
  }
};

template <typename T, int D>
size_t smem_bytes(int64_t group, int64_t table_slots) {
  return sizeof(T) * kStages * kTokens * 2 * D +
         sizeof(float) * group * (D + kWarps * (D + 2)) +
         sizeof(int32_t) * table_slots;
}

// Pages a partition of T tokens can touch: T / page + 1, or T + 1 for a
// page of one token; one more for a partition that starts mid-page.
int64_t table_slots(int64_t part_tokens, int64_t page_size) {
  return part_tokens / page_size + 2;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? kMinBlocks : 1)
paged_attention_part_kernel(const T* __restrict__ q,
                            const T* __restrict__ k_pages,
                            const T* __restrict__ v_pages,
                            const int32_t* __restrict__ block_tables,
                            const int32_t* __restrict__ lengths,
                            float* __restrict__ part_m,
                            float* __restrict__ part_l,
                            float* __restrict__ part_acc, int kvh, int group,
                            int page_size, int max_pages, int part_tokens,
                            float scale) {
  using R = Row<T, D>;
  constexpr int CPR = R::kChunks, EPC = R::kElems;
  constexpr int DPL = (D + 31) / 32;            // acc columns per lane
  constexpr int NCH = (CPR + 3) / 4;            // K chunks per lane
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = group;
  T* k_s = reinterpret_cast<T*>(smem);          // kStages x kTokens x D
  T* v_s = k_s + kStages * kTokens * D;         // kStages x kTokens x D
  float* q_s = reinterpret_cast<float*>(v_s + kStages * kTokens * D);
  float* wm = q_s + G * D;                      // kWarps x G running max
  float* wl = wm + kWarps * G;                  // kWarps x G running sum
  float* wacc = wl + kWarps * G;                // kWarps x G x D
  int32_t* bt_s = reinterpret_cast<int32_t*>(wacc + kWarps * G * D);

  const int part = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // every CTA of this grid is resident: the combine grid may launch now
  // (it waits for this grid's end before it reads a partial)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // The partition's slice of the table and q are known before its length
  // is: all three loads are in flight together.
  const int n_tok = max_pages * page_size;
  const int t_begin = part * part_tokens;
  const int first_page = t_begin / page_size;
  const int n_pages =
      (min(t_begin + part_tokens, n_tok) - 1) / page_size - first_page + 1;
  const int32_t* bt = block_tables + static_cast<int64_t>(b) * max_pages;
  for (int i = tid; i < n_pages; i += kThreads) bt_s[i] = bt[first_page + i];
  const int64_t qbase = (static_cast<int64_t>(b) * kvh + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = to_f32(q[qbase + i]) * scale;
  const int length = max(0, min(lengths[b], n_tok));
  if (t_begin >= length) return;                // nothing live here
  const int t_end = min(t_begin + part_tokens, length);
  for (int i = tid; i < kWarps * G * D; i += kThreads) wacc[i] = 0.f;
  for (int i = tid; i < kWarps * G; i += kThreads) {
    wm[i] = kNegInf;
    wl[i] = 0.f;
  }
  __syncthreads();                              // bt_s, before the copies

  const int n_chunks = (t_end - t_begin + kTokens - 1) / kTokens;
  // Copy chunk c into ring slot c % kStages; always commit a group (empty
  // past the last chunk).  One chunk is copied ahead of the one computed:
  // with every CTA's first chunks requested first, they land early and
  // their arithmetic overlaps the copies of the next ones.
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int t0 = t_begin + c * kTokens;
      const int n = min(kTokens, t_end - t0);
      T* ks = k_s + (c % kStages) * kTokens * D;
      T* vs = v_s + (c % kStages) * kTokens * D;
      // kThreads / kTokens = 4 threads a token, one page lookup each
      const int t = tid / 4, pos = t0 + t;
      if (t < n) {
        const int64_t row =
            static_cast<int64_t>(bt_s[pos / page_size - first_page]) *
                page_size + pos % page_size;
        const T* kr = k_pages + (row * kvh + h) * D;
        const T* vr = v_pages + (row * kvh + h) * D;
        for (int e = tid % 4; e < CPR; e += 4) {
          cp_async16(ks + t * D + R::chunk(t, e) * EPC, kr + e * EPC);
          cp_async16(vs + t * D + e * EPC, vr + e * EPC);
        }
      }
    }
    cp_async_commit();
  };
  issue(0);

  // Warp w takes tokens 8 w .. 8 w + 7 of every chunk, 4 lanes a token,
  // and keeps its own online softmax (wm, wl, wacc) for each of the G
  // rows; no block barrier inside a chunk.
  const int tt = lane / 4, qq = lane % 4;
  float* my_m = wm + warp * G;
  float* my_l = wl + warp * G;
  float* my_acc = wacc + warp * G * D;
  for (int c = 0; c < n_chunks; ++c) {
    const int n = min(kTokens, t_end - (t_begin + c * kTokens));
    const T* ks = k_s + (c % kStages) * kTokens * D;
    const T* vs = v_s + (c % kStages) * kTokens * D;
    cp_async_wait<0>();                         // chunk c has landed
    __syncthreads();                            // ... for every thread, and
                                                // chunk c - 1 is consumed
    issue(c + 1);                               // in flight while c runs
    const int t = warp * kPerWarp + tt;         // this lane's token
    const bool live = t < n;
    uint4 kc[NCH];                              // this lane's K chunks
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int e = qq + 4 * j;
      kc[j] = e < CPR ? *reinterpret_cast<const uint4*>(
                            ks + t * D + R::chunk(t, e) * EPC)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int g0 = 0; g0 < G; g0 += kGB) {
      float s[kGB], p[kGB], m_cur[kGB], alpha[kGB], sum[kGB];
#pragma unroll
      for (int u = 0; u < kGB; ++u) {
        const float* qr = q_s + min(g0 + u, G - 1) * D;
        float x = 0.f;
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          const int e = qq + 4 * j;
          if (e < CPR) x = dot_chunk<T>(qr + e * EPC, kc[j], x);
        }
        s[u] = x;
      }
#pragma unroll
      for (int u = 0; u < kGB; ++u) {
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], 1);
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], 2);
        s[u] = live ? s[u] : kNegInf;
      }
      float mx[kGB];
#pragma unroll
      for (int u = 0; u < kGB; ++u) mx[u] = s[u];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int u = 0; u < kGB; ++u)
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], o));
#pragma unroll
      for (int u = 0; u < kGB; ++u) {
        const float m_prev = my_m[min(g0 + u, G - 1)];
        m_cur[u] = fmaxf(m_prev, mx[u]);
        alpha[u] = expf(m_prev - m_cur[u]);
        p[u] = live ? expf(s[u] - m_cur[u]) : 0.f;
        sum[u] = p[u];
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int u = 0; u < kGB; ++u)
          sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], o);
      // acc = acc * alpha + p V over the warp's live tokens
      float a[kGB][DPL];
#pragma unroll
      for (int u = 0; u < kGB; ++u)
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          a[u][i] = d < D ? my_acc[min(g0 + u, G - 1) * D + d] * alpha[u]
                          : 0.f;
        }
#pragma unroll
      for (int w = 0; w < kPerWarp; ++w) {
        float pw[kGB];
#pragma unroll
        for (int u = 0; u < kGB; ++u)
          pw[u] = __shfl_sync(0xffffffffu, p[u], 4 * w);
        if (warp * kPerWarp + w < n) {
          const T* vr = vs + (warp * kPerWarp + w) * D;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) {
              const float x = to_f32(vr[d]);
#pragma unroll
              for (int u = 0; u < kGB; ++u) a[u][i] = fmaf(pw[u], x, a[u][i]);
            }
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kGB; ++u) {
        const int g = g0 + u;
        if (g < G) {
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) my_acc[g * D + d] = a[u][i];
          }
          if (lane == 0) {
            my_m[g] = m_cur[u];
            my_l[g] = my_l[g] * alpha[u] + sum[u];
          }
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();                              // every warp's state

  // the warps' states, folded in warp order, are the partition's partial
  const int64_t pbase =
      ((static_cast<int64_t>(b) * kvh + h) * gridDim.x + part) * G;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wm[w * G + g]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float x = expf(wm[w * G + g] - m);
      l += wl[w * G + g] * x;
      a += wacc[(w * G + g) * D + d] * x;
    }
    part_acc[pbase * D + i] = a;
    if (d == 0) {
      part_m[pbase + g] = m;
      part_l[pbase + g] = l;
    }
  }
}

// Folds the live partitions of each (sequence, kv head) in partition
// order, one output per thread: first the max over partitions (exact in
// any order), then, kCombineBatch partitions at a time, every load of the
// batch is issued before the terms are added in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine_kernel(const float* __restrict__ part_m,
                               const float* __restrict__ part_l,
                               const float* __restrict__ part_acc,
                               const int32_t* __restrict__ lengths,
                               T* __restrict__ out, int kvh, int group,
                               int head_dim, int page_size, int max_pages,
                               int part_tokens, int n_part) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = group, D = head_dim;
  const int i = blockIdx.z * kThreads + threadIdx.x;   // output (g, d)
  if (i >= G * D) return;
  const int g = i / D;
  const int length = max(0, min(lengths[b], max_pages * page_size));
  const int n_live = (length + part_tokens - 1) / part_tokens;
  const int64_t row = static_cast<int64_t>(b) * kvh + h;
  const float* pm = part_m + row * n_part * G + g;
  const float* pl = part_l + row * n_part * G + g;
  const float* pa = part_acc + row * n_part * G * D + i;
  // the partition grid has ended and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // up to kCombineBatch partitions take one round of loads; more take a
  // first pass for the max
  const bool one_batch = n_live <= kCombineBatch;
  float m = kNegInf;
  if (!one_batch) {
#pragma unroll 8
    for (int p = 0; p < n_live; ++p) m = fmaxf(m, pm[p * G]);
  }
  float l = 0.f, o = 0.f;
  for (int p0 = 0; p0 < n_live; p0 += kCombineBatch) {
    float mp[kCombineBatch], lp[kCombineBatch], ap[kCombineBatch];
#pragma unroll
    for (int j = 0; j < kCombineBatch; ++j) {
      const int p = p0 + j;
      const bool ok = p < n_live;
      mp[j] = ok ? pm[p * G] : kNegInf;
      lp[j] = ok ? pl[p * G] : 0.f;
      ap[j] = ok ? pa[static_cast<int64_t>(p) * G * D] : 0.f;
    }
    if (one_batch) {
#pragma unroll
      for (int j = 0; j < kCombineBatch; ++j) m = fmaxf(m, mp[j]);
    }
#pragma unroll
    for (int j = 0; j < kCombineBatch; ++j) {
      if (p0 + j < n_live) {
        const float w = expf(mp[j] - m);
        l += lp[j] * w;
        o += ap[j] * w;
      }
    }
  }
  out[row * G * D + i] = from_f32<T>(o / fmaxf(l, 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int32_t* block_tables, const int32_t* lengths,
                   void* out, float* part_m, float* part_l, float* part_acc,
                   int64_t batch, int64_t kvh, int64_t group,
                   int64_t page_size, int64_t max_pages, int64_t part_tokens,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      smem_bytes<T, D>(group, table_slots(part_tokens, page_size));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_part_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t n_part =
      (max_pages * page_size + part_tokens - 1) / part_tokens;
  dim3 grid(static_cast<unsigned>(n_part), static_cast<unsigned>(kvh),
            static_cast<unsigned>(batch));
  paged_attention_part_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_tables, lengths, part_m, part_l,
      part_acc, static_cast<int>(kvh), static_cast<int>(group),
      static_cast<int>(page_size), static_cast<int>(max_pages),
      static_cast<int>(part_tokens), scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Programmatic dependent launch: the combine grid is scheduled while
  // the partition grid runs and waits for its end in griddepcontrol.wait,
  // so the second launch costs no gap on the stream.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(kvh), static_cast<unsigned>(batch),
                     static_cast<unsigned>((group * D + kThreads - 1) /
                                           kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, paged_attention_combine_kernel<T>,
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), lengths, static_cast<T*>(out),
      static_cast<int>(kvh), static_cast<int>(group), D,
      static_cast<int>(page_size), static_cast<int>(max_pages),
      static_cast<int>(part_tokens), static_cast<int>(n_part));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k_pages, const void* v_pages,
                     const int32_t* block_tables, const int32_t* lengths,
                     void* out, float* part_m, float* part_l,
                     float* part_acc, int64_t batch, int64_t kvh,
                     int64_t group, int64_t head_dim, int64_t page_size,
                     int64_t max_pages, int64_t part_tokens, float scale,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k_pages, v_pages, block_tables, lengths, out,
                           part_m, part_l, part_acc, batch, kvh, group,
                           page_size, max_pages, part_tokens, scale, stream);
    case 32:
      return launch<T, 32>(q, k_pages, v_pages, block_tables, lengths, out,
                           part_m, part_l, part_acc, batch, kvh, group,
                           page_size, max_pages, part_tokens, scale, stream);
    case 64:
      return launch<T, 64>(q, k_pages, v_pages, block_tables, lengths, out,
                           part_m, part_l, part_acc, batch, kvh, group,
                           page_size, max_pages, part_tokens, scale, stream);
    case 128:
      return launch<T, 128>(q, k_pages, v_pages, block_tables, lengths, out,
                            part_m, part_l, part_acc, batch, kvh, group,
                            page_size, max_pages, part_tokens, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; head_dim in {16, 32, 64, 128};
// part_tokens a positive multiple of 64.  part_m / part_l hold B * KVH *
// n_part * G floats and part_acc B * KVH * n_part * G * D, with n_part =
// ceil(max_pages * page_size / part_tokens).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int32_t* block_tables, const int32_t* lengths, void* out,
    float* part_m, float* part_l, float* part_acc, int64_t batch,
    int64_t kvh, int64_t group, int64_t head_dim, int64_t page_size,
    int64_t max_pages, int64_t part_tokens, float scale, int64_t dtype,
    void* stream) {
  if (batch <= 0 || kvh <= 0 || group <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  if (batch > 65535 || kvh > 65535 || page_size <= 0 || max_pages <= 0 ||
      max_pages * page_size > 2147483647LL || part_tokens <= 0 ||
      part_tokens % kTokens != 0 || part_tokens > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_d<float>(
          q, k_pages, v_pages, block_tables, lengths, out, part_m, part_l,
          part_acc, batch, kvh, group, head_dim, page_size, max_pages,
          part_tokens, scale, s));
    case 1:
      return static_cast<int>(launch_d<__nv_bfloat16>(
          q, k_pages, v_pages, block_tables, lengths, out, part_m, part_l,
          part_acc, batch, kvh, group, head_dim, page_size, max_pages,
          part_tokens, scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
