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
// gradients.  Every product runs on the tensor cores as Hopper's warpgroup
// MMA (`wgmma.mma_async`, wgmma.cuh), one route per input type, chosen by
// the error it leaves against the plain f32 backward (emulated on the CPU,
// tests/test_torch_flash_bwd_split.py; S = 1024, bf16 limit two bf16 ulps
// plus 1e-4 of the largest gradient, f32 limit 1e-4 of it):
//
//   * bf16: m64nNk16 .f32.bf16.bf16.  S = Q K^T and dP = dO V^T take one
//     pass: their operands are the bf16 inputs, so every product is exact
//     in the f32 accumulator.  P and dS are f32; rounded once to bf16 for
//     dV = P^T dO, dK = dS^T Q and dQ = dS K (as FlashAttention does) they
//     miss the limit by 6.3-8.3x, so each is split as x = hi + lo, hi =
//     bf16(x), lo = bf16(x - hi), and those three products take two passes
//     (lo, then hi) against the same B tile: 0.40-0.48 of the limit, about
//     one bf16 ulp, as a plain f32 backward rounded once;
//   * f32: 3xTF32, as the forward: each operand split into big and small
//     TF32 values (cvt.rna), small . big + big . small + big . big, the
//     small products of a group issued before the big ones.  One TF32 pass
//     misses the limit by 3.0-6.3x; three passes keep 0.006-0.011 of it.
//
// The tensor cores' own f32 accumulation adds to these on the card, most
// in dK and dV, which sum over a whole walk: 0.33 of the f32 limit at
// tiny-lm's shape (chip_smoke.py phase 12, H100 80GB HBM3, 700 W).
//
// That is 10 bf16 passes or 21 TF32 passes of 2 Sq Sk D flops (S and dP
// are recomputed in both kernels below), against the function's 5 (bf16)
// or 15 (f32 at f32 accuracy): the design's own floor, twice the bound in
// bf16 and 1.4x it in f32, printed beside the bound by chip_smoke.py.
//
// The design, after the forward's:
//
//   * every output is written once, by one CTA, in a fixed order of sums:
//     no atomics, the same bits on every run.  A pre-pass computes D, then
//       - dK/dV: one CTA per (batch, kv head, key tile) walks the G query
//         heads of its group and their query tiles, skipping the tiles
//         wholly above the diagonal; the keys are the MMAs' M, so S^T = K
//         Q^T and dP^T = V dO^T land in accumulators whose rows are keys,
//         and P^T and dS^T feed dV += P^T dO and dK += dS^T Q as register
//         A fragments.  dK and dV stay in registers across the whole walk;
//         keys past lengths[b] get 0;
//       - dQ: one CTA per (batch, q head, query tile) walks the key tiles up
//         to min(lengths[b], Sk), and to the diagonal when causal: S = Q
//         K^T and dP = dO V^T, then dQ += dS K from registers;
//     the tiles with the most work start first (the first key tiles, the
//     last query tiles).  Each consumer warpgroup of a CTA owns 64 rows
//     (keys or queries; warp w rows 16 w .. 16 w + 15 of them): one
//     warpgroup a CTA in bf16, so that two or three CTAs share an SM; two
//     in f32 up to D = 64, sharing the streamed tiles and so halving the
//     split work per product (warpgroups());
//   * P and dS never leave registers.  In bf16 the m64nN accumulator
//     layout is the k16 A-fragment layout: adjacent column pairs pack into
//     one bf16x2.  In TF32 the forward's relabelling of k applies: k = tg
//     stands for column 2 tg and k = tg + 4 for column 2 tg + 1 of each 8,
//     and the B tile stores its k in that order;
//   * the streamed tiles (Q and dO rows with their lse and D in dK/dV; K
//     and V rows in dQ) come through a two-slot ring filled by 16-byte
//     `cp.async` copies (rows past the end zero-filled): the next tile's
//     copies are issued behind the step's first MMAs and land while the
//     step runs.  In bf16 they land in wgmma's K-major interleaved layout
//     and the MMAs read them in place: as the B of S and dP, and read
//     MN-major (the descriptor's transpose bit) as the B of dV, dK and dQ,
//     whose k runs along their rows.  In f32 they land raw and the CTA
//     splits them into big and small TF32 tiles, as they are and
//     transposed (wgmma takes only K-major TF32 operands).  The tile fixed
//     for the CTA (K and V, or Q and dO: the A of S and dP) is loaded once;
//   * the streamed tile has stream_rows() rows (64, or 32 and 16 where
//     registers or shared memory would not hold 64): dK and dV take D
//     accumulator registers a thread, so at D = 128 in bf16 the query tile
//     is 32 and the CTA stays within its registers without spilling (the
//     -Xptxas=-v build log, _build.log_path(), shows it);
//   * P is recomputed from lse as exp2(s scale log2(e) - lse log2(e)); the
//     live mask is taken only on the steps at Sq, at the length or across
//     the diagonal.
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

#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kWarpgroup = 128;      // threads
constexpr int kBM = 64;              // the MMAs' M: keys (dK/dV), queries (dQ)
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

// One route per input type: the elements of a 16-byte chunk of a K-major
// tile, the k of one MMA step, and the MMA of N columns.
template <typename T>
struct Route {                       // f32: 3xTF32, big and small tiles
  static constexpr int kEpc = 4;
  static constexpr int kK = 8;
  template <int N>
  using Mma = Wgmma<N>;
};
template <>
struct Route<__nv_bfloat16> {        // bf16: one tile
  static constexpr int kEpc = 8;
  static constexpr int kK = 16;
  template <int N>
  using Mma = WgmmaBf16<N>;
};

// Rows of the streamed tile: queries a step in dK/dV, keys in dQ.
template <typename T, int D>
__host__ __device__ constexpr int stream_rows() {
  return is_f32<T>() ? (D <= 32 ? 64 : D == 64 ? 32 : 16)
                     : (D <= 64 ? 64 : 32);
}

// Consumer warpgroups a CTA, each with its own 64 rows (keys in dK/dV,
// queries in dQ) and all sharing the streamed tiles.  Two in f32 up to D =
// 64, which halves the split work per product; one in bf16, which has no
// split and where two or three CTAs of one warpgroup share an SM and run
// out of step (two a CTA ran slower there), and in f32 at D = 128, where
// two would not fit in shared memory.
template <typename T, int D>
__host__ __device__ constexpr int warpgroups() {
  return is_f32<T>() && D <= 64 ? 2 : 1;
}

// Bytes of a K-major tile of R rows and W elements along k (both TF32
// tiles in f32, the small one right after the big one).
template <typename T>
__host__ __device__ constexpr int tile_bytes(int r, int w) {
  return is_f32<T>() ? 2 * 4 * r * w : 2 * r * w;
}

// 4 bytes global -> shared, or 4 zero bytes when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (a, b) = hi + lo, each packed as bf16x2 (a in the low half): hi rounds
// to nearest, lo is the rest rounded to nearest.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(
      __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

// Rows [0, R) of a row-major (rows, D) bf16 array into a K-major tile of R
// rows along d, by 16-byte cp.async copies from the NT threads of the CTA;
// rows at or past n are zero-filled.  8 neighbouring threads take 8 rows
// of one chunk: their shared stores fill a 128-byte line, and a warp
// reads 64 contiguous bytes of each of 8 rows.
template <int NT, int R, int D>
__device__ __forceinline__ void copy_rows(unsigned char* dst,
                                          const __nv_bfloat16* src, int n) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int it = 0; it < (R * CH + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (R * CH % NT != 0 && i >= R * CH) break;
    const int rest = i >> 3, c = rest % CH;
    const int r = (rest / CH) * 8 + (i & 7);
    const bool ok = r < n;
    cp_async16(dst + 16 * kmajor_unit<R>(r, c),
               src + (ok ? static_cast<int64_t>(r) * D + 8 * c : 0), ok);
  }
}

// Rows [0, R) of a row-major (rows, D) f32 array with row stride ld, split
// into big and small K-major TF32 tiles of R rows along d (the small one
// right after the big one); rows at or past n are 0.  The same thread
// mapping as copy_rows: the padded raw rows are read without bank
// conflicts.
template <int NT, int R, int D>
__device__ __forceinline__ void split_rows(unsigned char* dst,
                                           const float* src, int64_t ld,
                                           int n) {
  constexpr int CH = D / 4;
  uint4* u = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int it = 0; it < (R * CH + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (R * CH % NT != 0 && i >= R * CH) break;
    const int rest = i >> 3, c = rest % CH;
    const int r = (rest / CH) * 8 + (i & 7);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n) x = ld4(src + r * ld + 4 * c);
    uint4 hi, lo;
    split4(x, hi, lo);
    const int at = kmajor_unit<R>(r, c);
    u[at] = hi;
    u[at + R * D / 4] = lo;
  }
}

// The transpose of R raw f32 rows (row stride ld) split into big and small
// K-major TF32 tiles of D rows along the raw rows: each thread takes one d
// and one 16-byte chunk of rows, neighbouring threads neighbouring d.
// Chunk 2 j + h of row step j holds rows 8 j + h, + 2, + 4, + 6: the
// relabelled k of the TF32 A fragments (frags).
template <int NT, int R, int D>
__device__ __forceinline__ void split_cols(unsigned char* dst,
                                           const float* raw, int ld) {
  uint4* u = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int it = 0; it < (D * (R / 4) + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (D * (R / 4) % NT != 0 && i >= D * (R / 4)) break;
    const int d = i % D, c = i / D;
    const float* p = raw + (8 * (c >> 1) + (c & 1)) * ld + d;
    uint4 hi, lo;
    split4(make_float4(p[0], p[2 * ld], p[4 * ld], p[6 * ld]), hi, lo);
    const int at = kmajor_unit<D>(d, c);
    u[at] = hi;
    u[at + R * D / 4] = lo;
  }
}

// Raw f32 rows [0, R) of a (rows, D) array into a ring slot (row stride
// D + 4, padded against bank conflicts) by 16-byte cp.async copies; rows at
// or past n are zero-filled.
template <int NT, int R, int D>
__device__ __forceinline__ void copy_raw(float* dst, const float* src,
                                         int n) {
#pragma unroll
  for (int it = 0; it < (R * D / 4 + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (R * D / 4 % NT != 0 && i >= R * D / 4) break;
    const int r = i / (D / 4), e = (i % (D / 4)) * 4;
    const bool ok = r < n;
    cp_async16(dst + r * (D + 4) + e,
               src + (ok ? static_cast<int64_t>(r) * D + e : 0), ok);
  }
}

// The CTA's fixed operand, WG tiles of 64 rows from rows [0, n) of a
// row-major (rows, D) array (the A of S and dP, one tile a warpgroup):
// bf16 by cp.async (in the caller's commit group), f32 split in place.
template <typename T, int NT, int WG, int D>
__device__ __forceinline__ void load_fixed(unsigned char* dst, const T* src,
                                           int n) {
#pragma unroll
  for (int w = 0; w < WG; ++w) {
    unsigned char* tile = dst + w * tile_bytes<T>(kBM, D);
    // a tile wholly past n is zero-filled from a row that exists
    const T* rows = w * kBM < n ? src + static_cast<int64_t>(w) * kBM * D
                                : src;
    if constexpr (is_f32<T>())
      split_rows<NT, kBM, D>(tile, rows, D, n - w * kBM);
    else
      copy_rows<NT, kBM, D>(tile, rows, n - w * kBM);
  }
}

// acc += A B^T over k = KD, A a 64-row and B an N-row K-major tile (S and
// dP).  bf16: one pass.  f32: 3xTF32, the small products of every step
// issued before the big ones, while the fresh accumulator is small.
template <typename T, int N, int KD>
__device__ __forceinline__ void mma_ss(float (&acc)[N / 2],
                                       const unsigned char* a,
                                       const unsigned char* b) {
  using W = typename Route<T>::template Mma<N>;
  constexpr int KS = KD / Route<T>::kK;
  if constexpr (is_f32<T>()) {
    const unsigned char* as = a + 4 * kBM * KD;
    const unsigned char* bs = b + 4 * N * KD;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      W::ss(acc, kmajor_desc<kBM>(as, s), kmajor_desc<N>(b, s));
      W::ss(acc, kmajor_desc<kBM>(a, s), kmajor_desc<N>(bs, s));
    }
  }
#pragma unroll
  for (int s = 0; s < KS; ++s)
    W::ss(acc, kmajor_desc<kBM>(a, s), kmajor_desc<N>(b, s));
}

// The A fragments of an m64nN accumulator x = hi + lo, read as the A of a
// product over k = x's N columns.  bf16: k16 step s is columns 16 s .. 16 s
// + 15, which the accumulator holds in the A-fragment layout already, so
// column pairs pack into bf16x2.  f32: k8 step j is columns 8 j .. 8 j + 7
// with k relabelled (k = tg is column 2 tg, k = tg + 4 column 2 tg + 1).
template <typename T, int N>
__device__ __forceinline__ void frags(const float (&x)[N / 2],
                                      uint32_t (&hi)[N / Route<T>::kK][4],
                                      uint32_t (&lo)[N / Route<T>::kK][4]) {
  if constexpr (is_f32<T>()) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      split(x[4 * j + 0], hi[j][0], lo[j][0]);   // row g,     column 2 tg
      split(x[4 * j + 2], hi[j][1], lo[j][1]);   // row g + 8, column 2 tg
      split(x[4 * j + 1], hi[j][2], lo[j][2]);   // row g,     column 2 tg + 1
      split(x[4 * j + 3], hi[j][3], lo[j][3]);   // row g + 8, column 2 tg + 1
    }
  } else {
#pragma unroll
    for (int s = 0; s < N / 16; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16x2(x[8 * s + 2 * e], x[8 * s + 2 * e + 1], hi[s][e],
                     lo[s][e]);
  }
}

// acc += X B over k = KX, X = hi + lo in registers (frags), the lo passes
// first, then the hi ones.  bf16: b is the KX rows (k) by D (n) tile of
// the streamed operand as it landed, read MN-major.  f32: b is that tile
// transposed (split_cols: D rows along k), big and small: lo . big, hi .
// small, then hi . big.
template <typename T, int D, int KX>
__device__ __forceinline__ void mma_rs(
    float (&acc)[D / 2], const uint32_t (&hi)[KX / Route<T>::kK][4],
    const uint32_t (&lo)[KX / Route<T>::kK][4], const unsigned char* b) {
  using W = typename Route<T>::template Mma<D>;
  constexpr int KS = KX / Route<T>::kK;
  if constexpr (is_f32<T>()) {
    const unsigned char* bs = b + 4 * D * KX;
#pragma unroll
    for (int s = 0; s < KS; ++s) W::rs(acc, lo[s], kmajor_desc<D>(b, s));
#pragma unroll
    for (int s = 0; s < KS; ++s) W::rs(acc, hi[s], kmajor_desc<D>(bs, s));
#pragma unroll
    for (int s = 0; s < KS; ++s) W::rs(acc, hi[s], kmajor_desc<D>(b, s));
  } else {
#pragma unroll
    for (int s = 0; s < KS; ++s) W::rs_mn(acc, lo[s], mnmajor_desc<KX>(b, s));
#pragma unroll
    for (int s = 0; s < KS; ++s) W::rs_mn(acc, hi[s], mnmajor_desc<KX>(b, s));
  }
}

template <int N>
__device__ __forceinline__ void fence_all(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(x[i]);
}
template <int S>
__device__ __forceinline__ void fence_all(uint32_t (&x)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) reg_fence(x[s][e]);
}

// P and dS of one accumulator entry: p = exp2(s c2 - lse2) where live,
// exactly 0 elsewhere; returns p and turns dp into dS = p (dp - D).
__device__ __forceinline__ float probs(float s, float& dp, float lse2,
                                       float dlt, bool live, float c2) {
  const float p = live ? exp2f(fmaf(s, c2, -lse2)) : 0.f;
  dp = p * (dp - dlt);
  return p;
}

// The thread's two accumulator rows (row0, row1; those at or past n are
// skipped) of an m64nD product, scaled, into a (rows, D) array.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, const float (&acc)[D / 2],
                                           int row0, int row1, int n,
                                           float scale) {
  const int tg = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * tg;
    if (row0 < n)
      st2(base + static_cast<int64_t>(row0) * D + c, acc[4 * j] * scale,
          acc[4 * j + 1] * scale);
    if (row1 < n)
      st2(base + static_cast<int64_t>(row1) * D + c, acc[4 * j + 2] * scale,
          acc[4 * j + 3] * scale);
  }
}

// D_i = sum_d dO_id O_id in f32, one warp per row.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_attention_bwd_delta_kernel(const T* __restrict__ out,
                                 const T* __restrict__ dout,
                                 float* __restrict__ delta, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s = fmaf(to_f32(out[row * D + d]), to_f32(dout[row * D + d]), s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) delta[row] = s;
}

// Shared memory of the dK/dV kernel, byte offsets.  K and V (64 keys a
// warpgroup, the A of S^T and dP^T), then two ring slots, each a step's Q
// and dO rows and their lse and D.  In bf16 the rows land as K-major tiles
// that the MMAs read in place: the B of S^T and dP^T, and read MN-major
// the B of dK and dV.  In f32 they land raw, and the CTA splits them into
// Q and dO as rows (the B of S^T and dP^T) and transposed (the B of dK and
// dV).
template <typename T, int D>
struct SmemKV {
  static constexpr int WG = warpgroups<T, D>();
  static constexpr int R = stream_rows<T, D>();
  static constexpr int kRows = is_f32<T>() ? R * (D + 4) * 4
                                           : tile_bytes<T>(R, D);
  static constexpr int kK = 0;
  static constexpr int kV = kK + WG * tile_bytes<T>(kBM, D);
  static constexpr int kRing = kV + WG * tile_bytes<T>(kBM, D);
  static constexpr int kSlse = 2 * kRows;          // within a slot
  static constexpr int kSlot = kSlse + 2 * R * 4;  // ... lse, then D
  static constexpr int kQr = kRing + 2 * kSlot;    // f32: the split tiles
  static constexpr int kDor = kQr + tile_bytes<T>(R, D);
  static constexpr int kQc = kDor + tile_bytes<T>(R, D);
  static constexpr int kDoc = kQc + tile_bytes<T>(D, R);
  static constexpr int kBytes = is_f32<T>() ? kDoc + tile_bytes<T>(D, R)
                                            : kQr;
};

template <typename T, int D>
__global__ void __launch_bounds__(kWarpgroup * warpgroups<T, D>())
flash_attention_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ lengths,
    T* __restrict__ dk, T* __restrict__ dv, int batch, int qh, int kvh,
    int seq_q, int seq_k, float scale, int causal) {
  using S = SmemKV<T, D>;
  constexpr int WG = S::WG, NT = kWarpgroup * WG;
  constexpr int R = S::R, KS = R / Route<T>::kK;
  extern __shared__ __align__(1024) unsigned char smem[];

  const int tid = threadIdx.x, wg = WG > 1 ? tid / kWarpgroup : 0;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int n_bh = batch * kvh;
  const int bh = blockIdx.x % n_bh;
  const int kt = blockIdx.x / n_bh;       // first (longest) key tiles first
  const int hk = bh % kvh, b = bh / kvh;
  const int group = qh / kvh;
  const int k0 = kt * kBM * WG;           // the CTA's keys
  const int kw0 = k0 + kBM * wg;          // ... and this warpgroup's
  int klen = seq_k;
  if (lengths != nullptr) klen = max(0, min(klen, lengths[b]));
  const int64_t koff = (static_cast<int64_t>(b) * kvh + hk) * seq_k * D;
  const int kpos0 = kw0 + 16 * warp + g, kpos1 = kpos0 + 8;
  const float c2 = scale * kLog2e;
  const unsigned char* kw = smem + S::kK + wg * tile_bytes<T>(kBM, D);
  const unsigned char* vw = smem + S::kV + wg * tile_bytes<T>(kBM, D);

  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;

  // query tiles a head: a tile wholly above the diagonal (last row < k0)
  // has no live entry; R divides kBM, so those are the tiles before k0 / R
  const int qt0 = causal ? k0 / R : 0;
  const int per_head = max(0, (seq_q + R - 1) / R - qt0);
  const int n_steps = k0 < klen ? group * per_head : 0;

  // Copy step st's Q and dO rows, lse and D into ring slot st % 2; always
  // commit a group (empty past the last step) so that wait_group counts
  // stay uniform.
  auto issue = [&](int st) {
    if (st < n_steps) {
      const int q0 = (qt0 + st % per_head) * R;
      const int64_t row0 =
          (static_cast<int64_t>(b) * qh + hk * group + st / per_head) * seq_q +
          q0;
      unsigned char* slot = smem + S::kRing + (st % 2) * S::kSlot;
      if constexpr (is_f32<T>()) {
        copy_raw<NT, R, D>(reinterpret_cast<float*>(slot), q + row0 * D,
                           seq_q - q0);
        copy_raw<NT, R, D>(reinterpret_cast<float*>(slot + S::kRows),
                           dout + row0 * D, seq_q - q0);
      } else {
        copy_rows<NT, R, D>(slot, q + row0 * D, seq_q - q0);
        copy_rows<NT, R, D>(slot + S::kRows, dout + row0 * D, seq_q - q0);
      }
      float* rv = reinterpret_cast<float*>(slot + S::kSlse);
      for (int i = tid; i < R; i += NT) {
        const bool ok = q0 + i < seq_q;
        const int64_t src = ok ? row0 + i : 0;
        cp_async4(rv + i, lse + src, ok);
        cp_async4(rv + R + i, delta + src, ok);
      }
    }
    cp_async_commit();
  };

  if (n_steps > 0) {
    load_fixed<T, NT, WG, D>(smem + S::kK, k + koff + int64_t{k0} * D,
                             seq_k - k0);
    load_fixed<T, NT, WG, D>(smem + S::kV, v + koff + int64_t{k0} * D,
                             seq_k - k0);
    issue(0);                            // bf16: with K and V
  }
  for (int st = 0; st < n_steps; ++st) {
    const int q0 = (qt0 + st % per_head) * R;
    cp_async_wait0();                    // step st has landed
    fence_async_smem();                  // ... also for wgmma's reads
    __syncthreads();                     // ... for every thread, and step
                                         // st - 1 is done: its slot is free
    const unsigned char* slot = smem + S::kRing + (st % 2) * S::kSlot;
    const unsigned char *qr = slot, *dor = slot + S::kRows, *qc = qr,
                        *doc = dor;
    if constexpr (is_f32<T>()) {
      const float* rq = reinterpret_cast<const float*>(slot);
      const float* rdo = reinterpret_cast<const float*>(dor);
      split_rows<NT, R, D>(smem + S::kQr, rq, D + 4, R);
      split_rows<NT, R, D>(smem + S::kDor, rdo, D + 4, R);
      split_cols<NT, R, D>(smem + S::kQc, rq, D + 4);
      split_cols<NT, R, D>(smem + S::kDoc, rdo, D + 4);
      fence_async_smem();
      __syncthreads();                   // the split tiles are ready
      qr = smem + S::kQr;
      dor = smem + S::kDor;
      qc = smem + S::kQc;
      doc = smem + S::kDoc;
    }
    // S^T = K Q^T and dP^T = V dO^T: rows the warpgroup's keys, columns
    // the step's queries; the next step's copies go out behind them.  Of
    // two warpgroups one may have nothing to add: its keys all past the
    // length, or all after the step's last query.
    const bool idle =
        WG > 1 && (kw0 >= klen || (causal && kw0 > q0 + R - 1));
    float s[R / 2], dp[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) s[i] = dp[i] = 0.f;
    if (!idle) {
      wgmma_fence();
      mma_ss<T, R, D>(s, kw, qr);
      mma_ss<T, R, D>(dp, vw, dor);
      wgmma_commit();
    }
    issue(st + 1);
    if (idle) continue;
    wgmma_wait0();
    fence_all(s);
    fence_all(dp);

    // P^T and dS^T; s[i] is key kpos0 (+ 8 when bit 1 of i is set), query
    // column 8 (i / 4) + 2 tg + (i & 1), whose lse (base 2) and D are
    // l2[c] and dl[c], c = 2 (i / 4) + (i & 1).  Only the steps at Sq, at
    // the length or across the diagonal need the mask.
    const float* rv = reinterpret_cast<const float*>(slot + S::kSlse);
    float l2[R / 4], dl[R / 4];
#pragma unroll
    for (int j = 0; j < R / 8; ++j) {
      const float2 a = *reinterpret_cast<const float2*>(rv + 8 * j + 2 * tg);
      const float2 e =
          *reinterpret_cast<const float2*>(rv + R + 8 * j + 2 * tg);
      l2[2 * j] = a.x * kLog2e;
      l2[2 * j + 1] = a.y * kLog2e;
      dl[2 * j] = e.x;
      dl[2 * j + 1] = e.y;
    }
    if (q0 + R <= seq_q && kw0 + kBM <= klen &&
        (!causal || kw0 + kBM - 1 <= q0)) {
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        const int c = 2 * (i >> 2) + (i & 1);
        s[i] = probs(s[i], dp[i], l2[c], dl[c], true, c2);
      }
    } else {
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        const int c = 2 * (i >> 2) + (i & 1);
        const int qpos = q0 + 8 * (i >> 2) + 2 * tg + (i & 1);
        const int kpos = (i & 2) ? kpos1 : kpos0;
        const bool live = qpos < seq_q && kpos < klen &&
                          (!causal || kpos <= qpos);
        s[i] = probs(s[i], dp[i], l2[c], dl[c], live, c2);
      }
    }
    uint32_t ph[KS][4], pl[KS][4], dh[KS][4], dl2[KS][4];
    frags<T, R>(s, ph, pl);
    frags<T, R>(dp, dh, dl2);
    wgmma_fence();
    mma_rs<T, D, R>(adv, ph, pl, doc);
    mma_rs<T, D, R>(adk, dh, dl2, qc);
    wgmma_commit();
    wgmma_wait0();
    fence_all(adv);
    fence_all(adk);
    fence_all(ph);
    fence_all(pl);
    fence_all(dh);
    fence_all(dl2);
  }
  store_rows<T, D>(dk + koff, adk, kpos0, kpos1, seq_k, scale);
  store_rows<T, D>(dv + koff, adv, kpos0, kpos1, seq_k, 1.f);
}

// Shared memory of the dQ kernel, byte offsets.  Q and dO (64 queries a
// warpgroup, the A of S and dP), then two ring slots, each a key tile's K
// and V rows: in bf16 K-major tiles read in place (the B of S and dP, and
// K read MN-major the B of dQ); in f32 raw rows, split into K and V as
// rows and K transposed (the B of dQ).
template <typename T, int D>
struct SmemQ {
  static constexpr int WG = warpgroups<T, D>();
  static constexpr int R = stream_rows<T, D>();
  static constexpr int kRows = is_f32<T>() ? R * (D + 4) * 4
                                           : tile_bytes<T>(R, D);
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + WG * tile_bytes<T>(kBM, D);
  static constexpr int kRing = kDo + WG * tile_bytes<T>(kBM, D);
  static constexpr int kSlot = 2 * kRows;            // K, then V
  static constexpr int kKr = kRing + 2 * kSlot;      // f32: the split tiles
  static constexpr int kVr = kKr + tile_bytes<T>(R, D);
  static constexpr int kKc = kVr + tile_bytes<T>(R, D);
  static constexpr int kBytes = is_f32<T>() ? kKc + tile_bytes<T>(D, R)
                                            : kKr;
};

template <typename T, int D>
__global__ void __launch_bounds__(kWarpgroup * warpgroups<T, D>())
flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int32_t* __restrict__ lengths,
    T* __restrict__ dq, int batch, int qh, int kvh, int seq_q, int seq_k,
    int n_qt, float scale, int causal) {
  using S = SmemQ<T, D>;
  constexpr int WG = S::WG, NT = kWarpgroup * WG;
  constexpr int R = S::R, KS = R / Route<T>::kK;
  extern __shared__ __align__(1024) unsigned char smem[];

  const int tid = threadIdx.x, wg = WG > 1 ? tid / kWarpgroup : 0;
  const int warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int n_bh = batch * qh;
  const int bh = blockIdx.x % n_bh;
  const int qt = n_qt - 1 - blockIdx.x / n_bh;   // last (longest) first
  const int h = bh % qh, b = bh / qh;
  const int hk = h / (qh / kvh);
  const int q0 = qt * kBM * WG;                  // the CTA's queries
  const int qw0 = q0 + kBM * wg;                 // ... and this warpgroup's
  int klen = seq_k;
  if (lengths != nullptr) klen = max(0, min(klen, lengths[b]));
  const int kend = causal ? min(klen, q0 + kBM * WG) : klen;
  const int n_tiles = (kend + R - 1) / R;
  const int64_t row0 = (static_cast<int64_t>(b) * qh + h) * seq_q;
  const int64_t koff = (static_cast<int64_t>(b) * kvh + hk) * seq_k * D;
  const float c2 = scale * kLog2e;
  const int qpos0 = qw0 + 16 * warp + g, qpos1 = qpos0 + 8;
  const unsigned char* qw = smem + S::kQ + wg * tile_bytes<T>(kBM, D);
  const unsigned char* dow = smem + S::kDo + wg * tile_bytes<T>(kBM, D);
  // this thread's two rows' lse (base 2) and D; 0 past Sq
  const float lse0 = qpos0 < seq_q ? lse[row0 + qpos0] * kLog2e : 0.f;
  const float lse1 = qpos1 < seq_q ? lse[row0 + qpos1] * kLog2e : 0.f;
  const float dlt0 = qpos0 < seq_q ? delta[row0 + qpos0] : 0.f;
  const float dlt1 = qpos1 < seq_q ? delta[row0 + qpos1] : 0.f;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // Copy tile t's K and V rows into ring slot t % 2; always commit a group.
  auto issue = [&](int t) {
    if (t < n_tiles) {
      unsigned char* slot = smem + S::kRing + (t % 2) * S::kSlot;
      const int64_t off = koff + static_cast<int64_t>(t) * R * D;
      if constexpr (is_f32<T>()) {
        copy_raw<NT, R, D>(reinterpret_cast<float*>(slot), k + off,
                           seq_k - t * R);
        copy_raw<NT, R, D>(reinterpret_cast<float*>(slot + S::kRows),
                           v + off, seq_k - t * R);
      } else {
        copy_rows<NT, R, D>(slot, k + off, seq_k - t * R);
        copy_rows<NT, R, D>(slot + S::kRows, v + off, seq_k - t * R);
      }
    }
    cp_async_commit();
  };

  if (n_tiles > 0) {
    load_fixed<T, NT, WG, D>(smem + S::kQ, q + (row0 + q0) * D, seq_q - q0);
    load_fixed<T, NT, WG, D>(smem + S::kDo, dout + (row0 + q0) * D,
                             seq_q - q0);
    issue(0);                            // bf16: with Q and dO
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * R;
    cp_async_wait0();                    // tile t has landed
    fence_async_smem();                  // ... also for wgmma's reads
    __syncthreads();                     // ... for every thread, and tile
                                         // t - 1 is done: its slot is free
    const unsigned char* slot = smem + S::kRing + (t % 2) * S::kSlot;
    const unsigned char *kr = slot, *vr = slot + S::kRows, *kc = kr;
    if constexpr (is_f32<T>()) {
      const float* rk = reinterpret_cast<const float*>(kr);
      split_rows<NT, R, D>(smem + S::kKr, rk, D + 4, R);
      split_rows<NT, R, D>(smem + S::kVr, reinterpret_cast<const float*>(vr),
                           D + 4, R);
      split_cols<NT, R, D>(smem + S::kKc, rk, D + 4);
      fence_async_smem();
      __syncthreads();                   // the split tiles are ready
      kr = smem + S::kKr;
      vr = smem + S::kVr;
      kc = smem + S::kKc;
    }
    // S = Q K^T and dP = dO V^T: rows the warpgroup's queries, columns the
    // tile's keys; the next tile's copies go out behind them.  Of two
    // warpgroups one may have nothing to add: its rows all past Sq, or all
    // before the tile's first key.
    const bool idle =
        WG > 1 && (qw0 >= seq_q || (causal && k0 > qw0 + kBM - 1));
    float s[R / 2], dp[R / 2];
#pragma unroll
    for (int i = 0; i < R / 2; ++i) s[i] = dp[i] = 0.f;
    if (!idle) {
      wgmma_fence();
      mma_ss<T, R, D>(s, qw, kr);
      mma_ss<T, R, D>(dp, dow, vr);
      wgmma_commit();
    }
    issue(t + 1);
    if (idle) continue;
    wgmma_wait0();
    fence_all(s);
    fence_all(dp);

    // dS; s[i] is row qpos0 (+ 8 when bit 1 of i is set), key k0 + 8 (i /
    // 4) + 2 tg + (i & 1).  Only the tiles at Sq, at the length or across
    // the diagonal need the mask.
    if (qw0 + kBM <= seq_q && k0 + R <= klen &&
        (!causal || k0 + R - 1 <= qw0)) {
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        const bool hi = (i & 2) != 0;
        probs(s[i], dp[i], hi ? lse1 : lse0, hi ? dlt1 : dlt0, true, c2);
      }
    } else {
#pragma unroll
      for (int i = 0; i < R / 2; ++i) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * tg + (i & 1);
        const bool hi = (i & 2) != 0;
        const int qpos = hi ? qpos1 : qpos0;
        const bool live = qpos < seq_q && kpos < klen &&
                          (!causal || kpos <= qpos);
        probs(s[i], dp[i], hi ? lse1 : lse0, hi ? dlt1 : dlt0, live, c2);
      }
    }
    uint32_t dh[KS][4], dl[KS][4];
    frags<T, R>(dp, dh, dl);
    wgmma_fence();
    mma_rs<T, D, R>(acc, dh, dl, kc);
    wgmma_commit();
    wgmma_wait0();
    fence_all(acc);
    fence_all(dh);
    fence_all(dl);
  }
  store_rows<T, D>(dq + row0 * D, acc, qpos0, qpos1, seq_q, scale);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   const int32_t* lengths, float* delta, void* dq, void* dk,
                   void* dv, int64_t batch, int64_t qh, int64_t kvh,
                   int64_t seq_q, int64_t seq_k, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int kv_bytes = SmemKV<T, D>::kBytes;
  constexpr int q_bytes = SmemQ<T, D>::kBytes;
  const int64_t rows = batch * qh * seq_q;
  constexpr int WG = warpgroups<T, D>(), NT = kWarpgroup * WG;
  const int64_t n_qt = (seq_q + kBM * WG - 1) / (kBM * WG);
  const int64_t n_kt = (seq_k + kBM * WG - 1) / (kBM * WG);
  if ((rows + 7) / 8 > 2147483647LL || n_qt * qh * batch > 2147483647LL ||
      n_kt * kvh * batch > 2147483647LL)
    return cudaErrorInvalidValue;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);

  flash_attention_bwd_delta_kernel<T, D>
      <<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
          static_cast<const T*>(out), tdo, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (n_kt > 0) {
    err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kv_bytes);
    if (err != cudaSuccess) return err;
    flash_attention_bwd_dkdv_kernel<T, D>
        <<<static_cast<unsigned>(n_kt * kvh * batch), NT, kv_bytes,
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
                             q_bytes);
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dq_kernel<T, D>
      <<<static_cast<unsigned>(n_qt * qh * batch), NT, q_bytes,
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
