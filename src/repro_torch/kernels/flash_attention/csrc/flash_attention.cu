// Tiled prefill attention, causal or full, GQA-aware, for Hopper (sm_90a),
// the f32 route (bf16: flash_attention_bf16.cu):
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
//   lse (B, QH, Sq)      f32 or null: each row's log-sum-exp of its scaled
//                        live scores, log sum_j exp(scale q . k_j), in
//                        natural log (the backward, flash_attention_bwd.cu,
//                        reads it); +inf for a row with no live key
//
// Replaces the Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py, body `_flash_kernel`),
// whose grid (B, QH, Sq/bq, Sk/bk) carries the online softmax of one q
// block across its k blocks in VMEM scratch, skips k blocks above the
// diagonal and past lengths[b], and asserts that the blocks divide S.
//
// On the H100 prefill attention is bound by arithmetic: 2 * 2 * Sq * Sk *
// D * QH flops, halved by the causal mask, against Sq + 2 Sk rows of
// bytes.  f32 FMAs on CUDA cores top out at 67 TFLOP/s; the tensor cores
// give 495 TFLOP/s dense in TF32, whose 10-bit mantissa alone would break
// the f32 contract (3e-5).  So both products run as 3xTF32 on the tensor
// cores: each f32 operand is split as x = big + small, both TF32 (each
// rounded to nearest, ties away from zero, as cvt.rna.tf32.f32 does), and
//
//     a . b ~ small_a . big_b + big_a . small_b + big_a . big_b
//
// is summed in the f32 accumulator; the dropped small . small term is
// about 2^-22 of the product.  The tensor cores' f32 accumulation loses
// more than an FMA's rounding to nearest at every MMA, at the scale of the
// accumulator (measured on the card, PERF.md).  So the small products of
// all of a tile's 8-key steps are issued before any big . big one (the
// accumulator is still small while two thirds of the MMAs add into it),
// and each tile's P V is summed in a fresh accumulator and added to the
// running one in f32; the error against f64 then stays at or below the
// plain f32 version's.  Three passes are still 7.4x the CUDA-core f32
// rate.  The
// instruction is Hopper's warpgroup MMA, `wgmma.mma_async` m64nNk8
// .f32.tf32.tf32, with the B operands (K, V) read from shared memory
// through descriptors and the A operands (q, P) from registers.  The
// design:
//
//   * one CTA of one warpgroup (four warps) per (q tile of kBQ = 64 rows,
//     q head, batch); warp w owns rows 16 w .. 16 w + 15 of every
//     accumulator.  The kv head is h / group; the k loop inside the CTA
//     takes the place of the Pallas grid's sequential k dimension.  The
//     grid is one dimension with the q tile slowest and the LAST q tiles
//     first, so under the causal mask the longest CTAs start first;
//   * q is loaded once, pre-scaled in f32 (as the Pallas kernel scales q)
//     and split: for D <= 64 straight into the warp's A fragments in
//     registers (Q K^T then reads only K from shared memory; two CTAs of
//     about 180 registers a thread share an SM), for D = 128 into two
//     K-major TF32 tiles in shared memory;
//   * K and V tiles of kBK = 32 keys stream through a two-slot ring of raw
//     tiles filled by 16-byte `cp.async` copies (keys past Sk zero-filled;
//     rows padded by 16 bytes so the split pass reads them without bank
//     conflicts), so two tiles are in flight while one is computed.  Each
//     landed tile is split once by the whole CTA into big and small TF32
//     tiles in wgmma's K-major interleaved layout (8-row x 16-byte core
//     matrices): K as it is ([key][d], d the MMA's k), V transposed
//     ([d][key], keys the MMA's k);
//   * S = Q K^T is a 64 x 32 f32 accumulator in registers (m64n32k8 from
//     shared memory).  Its layout gives each thread the scores of keys 2t
//     and 2t + 1 of every 8; the A fragment of P V (from registers) wants
//     keys t and t + 4.  Instead of moving P, the kernel relabels the k
//     index of P V: k = t stands for key 2t and k = t + 4 for key 2t + 1,
//     and the split pass stores V^T's keys in that order.  P never leaves
//     registers;
//   * the online softmax (running max m, sum l, rescale of acc) stays in
//     registers in f32; a row's max reduces over the 4 lanes that share
//     it; l is summed per lane and reduced once at the end; acc = alpha
//     acc + (the tile's P V) is one FMA per element;
//   * the k loop stops at min(lengths[b], Sk) and, when causal, after the
//     tile that holds the diagonal of the q tile's last row;
//   * ragged edges are masked here, so S need not be a multiple of a tile:
//     q rows past Sq load 0 and are not stored, keys past Sk load 0 and
//     are masked.
//
// bf16 has a route of its own, flash_attention_bf16.cu (bf16 MMAs, TMA
// tiles, a producer warp), to which flash_attention_launch dispatches
// dtype 1; this kernel's bf16 branches (kSplitKV false) are no longer
// instantiated.
//
// Masking uses -1e30 as the Pallas kernel does (q carries log2(e) in its
// scale, so scores are in base 2 and the softmax takes exp2; the function
// is the same).  The running max of every row turns real in the first k
// tile, which is what keeps a masked score at exp2(-1e30 - m) = 0: the k
// loop starts at key 0, and key 0 is live for every row of every q tile
// whenever the loop runs at all (the loop runs only when min(lengths[b],
// Sk) >= 1, and causal keeps j = 0 <= i for every row i).  When no key
// is live the loop does not run, l stays 0 and the output is acc / max(l,
// 1e-30) = 0, as the Pallas kernel gives.
//
// Plain C interface, loaded with ctypes: the launch takes raw device
// pointers and the stream, launches on that stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;        // one warpgroup
constexpr int kBQ = 64;              // query rows per CTA, 16 per warp
constexpr int kBK = 32;              // keys per tile
constexpr int kNT = kBK / 8;         // 8-key steps per tile
constexpr float kNegInf = -1e30f;    // the Pallas kernel's mask value

// For D <= 64 q's split A fragments stay in registers (D regs a thread),
// so Q K^T reads only K from shared memory; for D = 128 they would not
// fit, and q stays in shared memory.
template <int D>
__host__ __device__ constexpr bool q_in_regs() { return D <= 64; }

template <typename T, int D>
struct Smem {
  static constexpr int kRawLd = D + 16 / static_cast<int>(sizeof(T));
  static constexpr int kRaw = kBK * kRawLd;        // T elements, K or V
  static constexpr int kRawBytes = 2 * 2 * kRaw * static_cast<int>(sizeof(T));
  static constexpr int kTile = kBK * D;             // words, K or V split
  static constexpr int kQ = kBQ * D;                // words, q split
  // byte offsets, each a multiple of 1024
  static constexpr int kRawOff = 0;
  static constexpr int kKvOff = (kRawBytes + 1023) / 1024 * 1024;
  static constexpr int kQOff = kKvOff + 4 * kTile * 4;
  static constexpr int kBytes = kQOff + (q_in_regs<D>() ? 0 : 2 * kQ * 4);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, q_in_regs<D>() ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ lengths,
                       T* __restrict__ out, float* __restrict__ lse,
                       int batch, int qh, int kvh, int seq_q, int seq_k,
                       int n_qt, float scale, int causal) {
  using S = Smem<T, D>;
  constexpr int KS = D / 8;              // k steps of Q K^T
  constexpr int CH = D / 4;              // 16-byte chunks of a row of d
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte copy
  constexpr int LDR = S::kRawLd;
  constexpr bool kSplitKV = std::is_same<T, float>::value;
  extern __shared__ __align__(1024) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem + S::kRawOff);  // [slot][K, V][key][LDR]
  uint32_t* kb = reinterpret_cast<uint32_t*>(smem + S::kKvOff);
  uint32_t* ks = kb + S::kTile;          // K: kBK rows of d, K-major
  uint32_t* vb = ks + S::kTile;          // V^T: D rows of keys, K-major
  uint32_t* vs = vb + S::kTile;
  uint32_t* qb = reinterpret_cast<uint32_t*>(smem + S::kQOff);
  uint32_t* qs = qb + S::kQ;             // q: kBQ rows of d, K-major

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
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

  const int64_t qoff = (static_cast<int64_t>(b) * qh + h) * seq_q * D;
  const int64_t koff = (static_cast<int64_t>(b) * kvh + hk) * seq_k * D;
  const T* qg = q + qoff;
  const T* kg = k + koff;
  const T* vg = v + koff;
  T* og = out + qoff;

  // Copy tile t's raw K and V into ring slot t % 2; always commit a group
  // (empty past the last tile) so that wait_group counts stay uniform.
  auto issue = [&](int t) {
    if (t < n_tiles) {
      T* dst = raw + (t % 2) * 2 * S::kRaw;
      for (int i = tid; i < kBK * D / VEC; i += kThreads) {
        const int r = i / (D / VEC), e = (i % (D / VEC)) * VEC;
        const int key = t * kBK + r;
        const bool ok = key < seq_k;
        const int64_t src = ok ? static_cast<int64_t>(key) * D + e : 0;
        cp_async16(dst + r * LDR + e, kg + src, ok);
        cp_async16(dst + S::kRaw + r * LDR + e, vg + src, ok);
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  // q, pre-scaled in f32 and split.  The scale carries log2(e): scores
  // are in base 2 and the softmax uses exp2.
  const float qscale = scale * 1.4426950408889634f;
  const int qpos0 = q0 + warp * 16 + g, qpos1 = qpos0 + 8;
  uint32_t qhi[KS][4], qlo[KS][4];       // A fragments, D <= 64
  if constexpr (q_in_regs<D>()) {
    auto qval = [&](int row, int d) {
      return row < seq_q
                 ? to_f32(qg[static_cast<int64_t>(row) * D + d]) * qscale
                 : 0.f;
    };
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int c = 8 * s + tg;
      split(qval(qpos0, c), qhi[s][0], qlo[s][0]);
      split(qval(qpos1, c), qhi[s][1], qlo[s][1]);
      split(qval(qpos0, c + 4), qhi[s][2], qlo[s][2]);
      split(qval(qpos1, c + 4), qhi[s][3], qlo[s][3]);
    }
  } else {
    // 8 neighbouring threads take 8 rows of one 16-byte chunk, so the
    // stores fill whole 128-byte lines
    for (int i = tid; i < kBQ * CH; i += kThreads) {
      const int rest = i >> 3, c = rest % CH;
      const int r = (rest / CH) * 8 + (i & 7), row = q0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < seq_q) {
        x = ld4(qg + static_cast<int64_t>(row) * D + 4 * c);
        x = make_float4(x.x * qscale, x.y * qscale, x.z * qscale,
                        x.w * qscale);
      }
      uint4 hi, lo;
      split4(x, hi, lo);
      const int u = 4 * kmajor_unit<kBQ>(r, c);
      *reinterpret_cast<uint4*>(qb + u) = hi;
      *reinterpret_cast<uint4*>(qs + u) = lo;
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 2];                      // m64nD accumulator
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait1();                    // tile t has landed
    __syncthreads();                     // ... for every thread, and the
                                         // MMAs of tile t - 1 are done
    {
      const T* rk = raw + (t % 2) * 2 * S::kRaw;
      const T* rv = rk + S::kRaw;
      // K: 8 neighbouring threads take 8 keys of one chunk
      for (int i = tid; i < kBK * CH; i += kThreads) {
        const int rest = i >> 3, c = rest % CH;
        const int r = (rest / CH) * 8 + (i & 7);
        uint4 hi, lo;
        split4(ld4(rk + r * LDR + 4 * c), hi, lo);
        const int u = 4 * kmajor_unit<kBK>(r, c);
        *reinterpret_cast<uint4*>(kb + u) = hi;
        if constexpr (kSplitKV) *reinterpret_cast<uint4*>(ks + u) = lo;
      }
      // V^T: a thread takes 4 keys of one d, in the relabelled order:
      // chunk c of key step j holds keys 8 j + c, + 2, + 4, + 6
      for (int i = tid; i < D * kBK / 4; i += kThreads) {
        const int d = i % D, c = (i / D) & 1, j = i / (2 * D);
        const T* p = rv + (8 * j + c) * LDR + d;
        const float4 x = make_float4(to_f32(p[0]), to_f32(p[2 * LDR]),
                                     to_f32(p[4 * LDR]), to_f32(p[6 * LDR]));
        uint4 hi, lo;
        split4(x, hi, lo);
        const int u = 4 * kmajor_unit<D>(d, 2 * j + c);
        *reinterpret_cast<uint4*>(vb + u) = hi;
        if constexpr (kSplitKV) *reinterpret_cast<uint4*>(vs + u) = lo;
      }
    }
    fence_async_smem();
    __syncthreads();                     // split tiles ready, slot free
    issue(t + 2);

    // S = Q K^T, 3xTF32
    float sc[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KS; ++s) {      // the small products of every step
      const uint64_t b_hi = kmajor_desc<kBK>(kb, s);
      if constexpr (q_in_regs<D>()) {
        Wgmma<kBK>::rs(sc, qlo[s], b_hi);
        if constexpr (kSplitKV)
          Wgmma<kBK>::rs(sc, qhi[s], kmajor_desc<kBK>(ks, s));
      } else {
        Wgmma<kBK>::ss(sc, kmajor_desc<kBQ>(qs, s), b_hi);
        if constexpr (kSplitKV)
          Wgmma<kBK>::ss(sc, kmajor_desc<kBQ>(qb, s),
                         kmajor_desc<kBK>(ks, s));
      }
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {      // ... then the big ones
      const uint64_t b_hi = kmajor_desc<kBK>(kb, s);
      if constexpr (q_in_regs<D>())
        Wgmma<kBK>::rs(sc, qhi[s], b_hi);
      else
        Wgmma<kBK>::ss(sc, kmajor_desc<kBQ>(qb, s), b_hi);
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) reg_fence(sc[i]);

    // mask, online softmax; sc[4 j + e] is row (e < 2 ? g : g + 8) of the
    // warp's 16, key k0 + 8 j + 2 tg + (e & 1)
    const int k0 = t * kBK;
    float mx[2] = {kNegInf, kNegInf};
    // only the tiles at the length or across the diagonal need the mask
    if (k0 + kBK > klen || (causal && k0 + kBK - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * tg + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          const bool live = kpos < klen && (!causal || kpos <= qpos);
          float& x = sc[4 * j + e];
          x = live ? x : kNegInf;
        }
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_cur = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_cur);
      m[r] = m_cur;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }

    // acc = alpha acc + P V, 3xTF32.  The k index of the MMA is relabelled:
    // k = tg is key 8 j + 2 tg and k = tg + 4 is key 8 j + 2 tg + 1, which
    // is where the score accumulator holds them.  The tile's P V is summed
    // in a fresh accumulator and added to acc in f32, so the tensor cores'
    // own (not round-to-nearest) additions stop at the tile.
    uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      split(sc[4 * j + 0], ph[j][0], pl[j][0]);   // row g,     key 2 tg
      split(sc[4 * j + 2], ph[j][1], pl[j][1]);   // row g + 8, key 2 tg
      split(sc[4 * j + 1], ph[j][2], pl[j][2]);   // row g,     key 2 tg + 1
      split(sc[4 * j + 3], ph[j][3], pl[j][3]);   // row g + 8, key 2 tg + 1
    }
    float pv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kNT; ++j) {     // the small products first
      Wgmma<D>::rs(pv, pl[j], kmajor_desc<D>(vb, j));
      if constexpr (kSplitKV)
        Wgmma<D>::rs(pv, ph[j], kmajor_desc<D>(vs, j));
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)      // ... then the big ones
      Wgmma<D>::rs(pv, ph[j], kmajor_desc<D>(vb, j));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      reg_fence(pv[i]);
      acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        reg_fence(ph[j][e]);
        reg_fence(pl[j][e]);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // The row's log-sum-exp in natural log: m and l are in base 2 (q carries
  // log2(e)), so lse = (m + log2 l) ln 2.  l is 0 only when the k loop did
  // not run (no live key); +inf then makes every exp(s - lse) of the
  // backward 0.
  if (lse != nullptr && tg == 0) {
    float* lg = lse + (static_cast<int64_t>(b) * qh + h) * seq_q;
    const float ln2 = 0.6931471805599453f, inf = __int_as_float(0x7f800000);
    if (qpos0 < seq_q)
      lg[qpos0] = l[0] > 0.f ? (m[0] + log2f(l[0])) * ln2 : inf;
    if (qpos1 < seq_q)
      lg[qpos1] = l[1] > 0.f ? (m[1] + log2f(l[1])) * ln2 : inf;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = fmaxf(l[r], 1e-30f);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * tg;
    if (qpos0 < seq_q)
      st2(og + static_cast<int64_t>(qpos0) * D + c, acc[4 * n] / l[0],
          acc[4 * n + 1] / l[0]);
    if (qpos1 < seq_q)
      st2(og + static_cast<int64_t>(qpos1) * D + c, acc[4 * n + 2] / l[1],
          acc[4 * n + 3] / l[1]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* lengths, void* out, float* lse,
                   int64_t batch, int64_t qh, int64_t kvh, int64_t seq_q,
                   int64_t seq_k, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int smem = Smem<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t n_qt = (seq_q + kBQ - 1) / kBQ;
  if (n_qt * qh * batch > 2147483647LL) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(n_qt * qh * batch));
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), lse,
      static_cast<int>(batch), static_cast<int>(qh), static_cast<int>(kvh),
      static_cast<int>(seq_q), static_cast<int>(seq_k),
      static_cast<int>(n_qt), scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int32_t* lengths, void* out, float* lse,
                     int64_t batch, int64_t qh, int64_t kvh, int64_t seq_q,
                     int64_t seq_k, int64_t head_dim, float scale,
                     int causal, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, out, lse, batch, qh, kvh, seq_q,
                           seq_k, scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, lengths, out, lse, batch, qh, kvh, seq_q,
                           seq_k, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, lse, batch, qh, kvh, seq_q,
                           seq_k, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, lse, batch, qh, kvh, seq_q,
                            seq_k, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The bf16 route (flash_attention_bf16.cu).
cudaError_t flash_attention_bf16_launch(
    const void* q, const void* k, const void* v, const int32_t* lengths,
    void* out, float* lse, int64_t batch, int64_t qh, int64_t kvh,
    int64_t seq_q, int64_t seq_k, int64_t head_dim, float scale, int causal,
    cudaStream_t stream);

// dtype: 0 = float32, 1 = bfloat16.  lse may be null.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int32_t* lengths,
                                      void* out, float* lse, int64_t batch,
                                      int64_t qh, int64_t kvh, int64_t seq_q,
                                      int64_t seq_k, int64_t head_dim,
                                      float scale, int64_t causal,
                                      int64_t dtype, void* stream) {
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
      return static_cast<int>(launch_d<float>(q, k, v, lengths, out, lse,
                                              batch, qh, kvh, seq_q, seq_k,
                                              head_dim, scale, c, s));
    case 1:
      return static_cast<int>(flash_attention_bf16_launch(
          q, k, v, lengths, out, lse, batch, qh, kvh, seq_q, seq_k, head_dim,
          scale, c, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
