// flash_attention's forward for bf16 operands on Hopper (sm_90a): the
// function of flash_attention.cu (which dispatches here for dtype 1),
//
//     out[b, h, i, :] = softmax_j(scale q[b, h, i, :] . k[b, hk, j, :])
//                       v[b, hk, j, :],   hk = h / group
//
// over the keys j < min(lengths[b], Sk), and j <= i when causal; a row
// with no live key gives 0 (and lse +inf).  q (B, QH, Sq, D), k/v (B,
// KVH, Sk, D), out like q, all bf16, D in {16, 32, 64, 128}; lse (B, QH,
// Sq) f32 or null, each row's log sum_j exp(scale q . k_j) in natural log,
// which the backward (flash_attention_bwd.cu) reads.
//
// Replaces, for bf16, the Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py, body `_flash_kernel`).
//
// What bounds it: operations, 4 Sq Sk D flops a head (half that when
// causal) on the bf16 tensor cores, against Sq + 2 Sk rows of bytes.  The
// products run as Hopper's warpgroup MMA, `wgmma.mma_async` m64nNk16
// .f32.bf16.bf16 (wgmma.cuh), and the error each leaves was chosen on the
// CPU (tests/test_torch_flash_bf16_split.py, flash_attention_bf16_split in
// ref.py) against two bf16 ulps of the plain version:
//
//   * S = Q K^T takes one pass on the raw bf16 q and K: every product of
//     two bf16 values is exact in the f32 accumulator.  q is not scaled
//     first (a scaled q rounded to bf16 would move every score); the f32
//     scores are multiplied by scale log2(e) and the softmax takes exp2;
//   * P V takes two.  P is f32; rounded once to bf16 it misses two ulps by
//     10-17x, so it is split x = hi + lo, hi = bf16(x), lo = bf16(x - hi)
//     (round to nearest even), and both parts are multiplied against the
//     same V tile, lo first: 0.44-0.49 of the limit.  P stays in
//     registers: the m64nN f32 accumulator of S is the A-fragment layout
//     of a k16 MMA, so adjacent columns pack into one bf16x2 register;
//   * O accumulates in the P V MMA's own accumulator, rescaled by the
//     online softmax's exp2(m_old - m_new) in registers before each P V.
//
// That is 1 + 2 passes over the two products, 1.5x the function's bound:
// the design's floor, which chip_smoke.py prints beside the bound.
//
// The structure: one CTA per SM, each walking work items of 128 query
// rows of one q head (the last q tiles first, so that under the causal
// mask the longest items start first; CTA c takes items c, 2 G - 1 - c,
// 2 G + c, ... of G CTAs, which evens out their sums):
//
//   * a producer warp (warpgroup 0, which gives its registers to the
//     consumers with setmaxnreg) streams by TMA each item's q into one of
//     two q buffers and its K and V tiles of kBK keys into a ring of
//     stages() slots, with an mbarrier pair per buffer and slot: full (the
//     copy's bytes landed) and empty (both consumers are done with it).
//     The tensor maps run over (B KVH, Sk, D), so keys past Sk in a head
//     land as zeros; tiles land in the 128-byte swizzle (64- or 32-byte
//     for D = 32 or 16) that wgmma reads in place: K K-major as the B of
//     Q K^T, V MN-major as the B of P V.  K and V are never widened, split
//     or transposed;
//   * two consumer warpgroups of 64 rows each (warp w of one owns rows 16
//     w .. 16 w + 15 of its 64) walk the CTA's tiles as one stream, both
//     all of them (rows past Sq are computed and not stored: with Sq <= 64
//     one warpgroup's work is thrown away).  Each step issues the next
//     tile's Q K^T, of the same item or the next one, then the previous
//     tile's P V, and takes the next tile's exponentials while that P V
//     runs; an item's rows are written when its last P V is in, so one
//     item's end overlaps the next one's start.  The two take turns to
//     issue (ping-pong on two named barriers), so that one's exponentials
//     run under the other's MMAs.  Masking is done only on tiles at the
//     length or across the rows' diagonal.  No MMA is issued in a branch:
//     ptxas serializes every wgmma of a kernel that has one (C7520), and
//     two variants that had one ran 30-40% slower;
//   * ragged edges need no tile divisibility: q rows past Sq load zeros
//     and are not stored, keys past Sk load zeros and are masked.
//
// Masking uses -1e30 (the Pallas kernel's value).  The running max of
// every row turns real in the first tile: key 0 is live for every row
// whenever an item has any tile (min(lengths[b], Sk) >= 1, and
// causal keeps j = 0 <= i), so a masked score gives exp2(-1e30 - m) = 0.
// An item with no live key has no tile: its rows are written as 0 and
// lse +inf.  No atomics: the same inputs give the same bits on every call.
//
// Plain C interface (flash_attention_launch in flash_attention.cu): the
// launch encodes the tensor maps on the host (cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point, so the library needs
// no -lcuda), launches on the caller's stream, does not synchronise,
// allocates nothing, and returns the first CUDA error.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarpgroup = 128;
constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kThreads = (1 + kConsumers) * kWarpgroup;
constexpr int kBQ = 64 * kConsumers;             // query rows per item
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Keys per tile.  At D = 128 a consumer holds S (64 registers a thread),
// P's two parts (64) and O (64) of 128 keys beside each other within its
// 240 registers without a spill, and 128 keys ran 3-6% faster there than
// 64 (PERF.md).
constexpr int kBK = 128;

// Swizzle width in bytes: a row of d, at most 128 bytes (D = 128 lands as
// two column blocks of 64).
template <int D>
__host__ __device__ constexpr int swizzle_bytes() {
  return 2 * D < 128 ? 2 * D : 128;
}

// K/V ring slots: three, or two at D = 128, where two q buffers and three
// slots of 128 keys would not fit in shared memory.
template <int D>
__host__ __device__ constexpr int stages() { return D == 128 ? 2 : 3; }

template <int D>
struct Smem {
  static constexpr int kQ = kBQ * D * 2;               // q, both halves
  static constexpr int kTile = kBK * D * 2;            // K or V
  static constexpr int kRing = 2 * kQ;                 // after two q buffers
  static constexpr int kBar = kRing + stages<D>() * 2 * kTile;
  // q full and empty per q buffer; K full, V full and empty per slot
  static constexpr int kBytes = kBar + 8 * (4 + 3 * stages<D>());
  static constexpr int kAlloc = kBytes + 1024;          // to align the base
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-d tensor map (d, row, head) into shared memory, its bytes
// counted on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int d, int row, int head,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d), "r"(row), "r"(head),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (a, b) = hi + lo, each packed as bf16x2 (a in the low half).
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(
      __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const int32_t* __restrict__ lengths, bf16* __restrict__ out,
                  float* __restrict__ lse, int batch, int qh, int kvh,
                  int seq_q, int seq_k, int n_qt, float scale, int causal) {
  using S = Smem<D>;
  constexpr int kStages = stages<D>();
  constexpr int SW = swizzle_bytes<D>();
  constexpr int KS = D / 16;             // k16 steps of Q K^T
  constexpr int PS = kBK / 16;           // k16 steps of P V
  constexpr int NB = 2 * D / SW;         // column blocks of a row of d
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = base + S::kRing;
  auto q_buf = [&](int r) { return base + (r & 1) * S::kQ; };
  // barriers: q full and q empty per q buffer, then per slot K full, V
  // full and empty
  const uint32_t bar = base + S::kBar;
  auto q_full = [&](int r) { return bar + 8 * (r & 1); };
  auto q_empty = [&](int r) { return bar + 8 * (2 + (r & 1)); };
  auto k_full = [&](int s) { return bar + 8 * (4 + s); };
  auto v_full = [&](int s) { return bar + 8 * (4 + kStages + s); };
  auto empty = [&](int s) { return bar + 8 * (4 + 2 * kStages + s); };
  auto k_tile = [&](int s) { return ring + s * 2 * S::kTile; };
  auto v_tile = [&](int s) { return ring + s * 2 * S::kTile + S::kTile; };

  // The CTA's work items (one q tile of one q head each), in round r the
  // item r G + c, or r G + G - 1 - c in odd rounds (G CTAs, this is c):
  // items run longest first (the last q tiles), and the snake order evens
  // out the CTAs' sums.
  const int n_bh = batch * qh;
  const int n_items = n_qt * n_bh;
  auto item_of = [&](int r) {
    const int G = gridDim.x, c = blockIdx.x;
    return r * G + ((r & 1) ? G - 1 - c : c);
  };
  struct Item {
    int bh, b, hk, q0, klen, n_tiles;
  };
  auto decode = [&](int r) {
    const int i = item_of(r);
    Item it;
    it.bh = i % n_bh;
    it.b = it.bh / qh;
    it.hk = (it.bh % qh) / (qh / kvh);
    it.q0 = (n_qt - 1 - i / n_bh) * kBQ;
    it.klen = seq_k;
    if (lengths != nullptr) it.klen = max(0, min(seq_k, lengths[it.b]));
    const int kend =
        causal ? min(it.klen, min(it.q0 + kBQ, seq_q)) : it.klen;
    it.n_tiles = (kend + kBK - 1) / kBK;
    return it;
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / kWarpgroup == 0) {
    // the producer: one thread of warp 0 issues every copy; item r's q
    // goes to q buffer r % 2, the CTA's tile g (counted over its items) to
    // ring slot g % kStages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      int g = 0;
      for (int r = 0; item_of(r) < n_items; ++r) {
        const Item it = decode(r);
        if (r >= 2) mbar_wait(q_empty(r), ((r >> 1) - 1) & 1);
        mbar_expect_tx(q_full(r), S::kQ);
        for (int c = 0; c < NB; ++c)
          tma_load(q_buf(r) + c * kBQ * SW, &qmap, c * SW / 2, it.q0, it.bh,
                   q_full(r));
        const int head = it.b * kvh + it.hk;
        for (int t = 0; t < it.n_tiles; ++t, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(empty(s), (g / kStages - 1) & 1);
          mbar_expect_tx(k_full(s), S::kTile);
          for (int c = 0; c < NB; ++c)
            tma_load(k_tile(s) + c * kBK * SW, &kmap, c * SW / 2, t * kBK,
                     head, k_full(s));
          mbar_expect_tx(v_full(s), S::kTile);
          for (int c = 0; c < NB; ++c)
            tma_load(v_tile(s) + c * kBK * SW, &vmap, c * SW / 2, t * kBK,
                     head, v_full(s));
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = threadIdx.x / kWarpgroup - 1;   // consumer 0 or 1
  const int tid = threadIdx.x % kWarpgroup;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const bool signal = tid == 0;
  const float c = scale * kLog2e;

  // descriptors: q's half (K-major, A of Q K^T), K (K-major, B of Q K^T),
  // V (MN-major, B of P V); a k16 step is 32 bytes along a K-major row,
  // into the next column block every SW / 32 steps, and 16 rows of V
  auto qk_step = [&](uint32_t tile, int rows, int s) {
    return tile + (s / (SW / 32)) * rows * SW + (s % (SW / 32)) * 32;
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 2], sc[kBK / 2];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t ph[PS][4], pl[PS][4];

  // S = Q K^T of item r's q and ring tile gt into sc (issued, not waited
  // for)
  auto issue_qk = [&](int r, int gt) {
    const int s = gt % kStages;
    const uint32_t q_half = q_buf(r) + cw * 64 * SW;
    mbar_wait(k_full(s), (gt / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KS; ++j)
      WgmmaBf16<kBK>::ss(
          sc, swizzle_desc<SW>(qk_step(q_half, kBQ, j), 16, 8 * SW),
          swizzle_desc<SW>(qk_step(k_tile(s), kBK, j), 16, 8 * SW), j > 0);
    wgmma_commit();
  };
  // O += (lo + hi) V of ring tile gt (issued, not waited for)
  auto issue_pv = [&](int gt) {
    const int s = gt % kStages;
    mbar_wait(v_full(s), (gt / kStages) & 1);
    auto v_step = [&](int j) {
      return swizzle_desc<SW>(v_tile(s) + j * 16 * SW, kBK * SW, 8 * SW);
    };
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < PS; ++j) WgmmaBf16<D>::rs_mn(o, pl[j], v_step(j));
#pragma unroll
    for (int j = 0; j < PS; ++j) WgmmaBf16<D>::rs_mn(o, ph[j], v_step(j));
    wgmma_commit();
  };
  auto split_p = [&]() {
#pragma unroll
    for (int j = 0; j < PS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16x2(sc[8 * j + 2 * e], sc[8 * j + 2 * e + 1], ph[j][e],
                     pl[j][e]);
  };
  auto fence_pv = [&]() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) reg_fence(o[i]);
#pragma unroll
    for (int j = 0; j < PS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        reg_fence(ph[j][e]);
        reg_fence(pl[j][e]);
      }
  };
  // mask, online softmax of the item's tile t (keys t kBK ...) in sc, for
  // rows qpos0 (and qpos1 = qpos0 + 8) of the rows from r0; returns P in
  // sc and the rescale factor of the rows' running sums and outputs
  auto softmax = [&](int t, int klen, int r0, int qpos0,
                     float (&alpha)[2]) {
    const int qpos1 = qpos0 + 8;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) reg_fence(sc[i]);
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] *= c;
    // sc[i] is row ((i >> 1) & 1 ? g + 8 : g) of the warp's 16, key k0 +
    // 8 (i >> 2) + 2 tg + (i & 1)
    const int k0 = t * kBK;
    if (k0 + kBK > klen || (causal && k0 + kBK - 1 > r0)) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int kpos = k0 + 8 * (i >> 2) + 2 * tg + (i & 1);
        const int qpos = (i >> 1) & 1 ? qpos1 : qpos0;
        const bool live = kpos < klen && (!causal || kpos <= qpos);
        sc[i] = live ? sc[i] : kNegInf;
      }
    }
    // row maxima and sums over four independent chains a row (element i
    // is chain (i & 1) + 2 ((i >> 2) & 1) of its row), so that the warp is
    // not held by one long dependent chain
    float mx[2][4], ls[2][4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        mx[rr][u] = kNegInf;
        ls[rr][u] = 0.f;
      }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      float& x = mx[(i >> 1) & 1][(i & 1) + 2 * ((i >> 2) & 1)];
      x = fmaxf(x, sc[i]);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float x =
          fmaxf(fmaxf(mx[rr][0], mx[rr][1]), fmaxf(mx[rr][2], mx[rr][3]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[rr], x);
      alpha[rr] = fast_exp2(m[rr] - m_new);
      m[rr] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      sc[i] = fast_exp2(sc[i] - m[(i >> 1) & 1]);
      ls[(i >> 1) & 1][(i & 1) + 2 * ((i >> 2) & 1)] += sc[i];
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      l[rr] = fmaf(l[rr], alpha[rr],
                   (ls[rr][0] + ls[rr][1]) + (ls[rr][2] + ls[rr][3]));
  };
  // write a row pair with no live key: 0, and lse +inf
  auto zero_rows = [&](int bh, int qpos0) {
    const float inf = __int_as_float(0x7f800000);
    bf16* og = out + static_cast<int64_t>(bh) * seq_q * D;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qpos = qpos0 + 8 * e;
      if (qpos >= seq_q) continue;
      if (lse != nullptr && tg == 0)
        lse[static_cast<int64_t>(bh) * seq_q + qpos] = inf;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        st2(og + static_cast<int64_t>(qpos) * D + 8 * n + 2 * tg, 0.f, 0.f);
    }
  };
  // write an item's rows from O and its rows' m and l
  auto epilogue = [&](int bh, int qpos0, const float (&mm)[2],
                      const float (&ll)[2]) {
    const int qpos1 = qpos0 + 8;
    float lr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      lr[rr] = ll[rr] + __shfl_xor_sync(0xffffffffu, ll[rr], 1);
      lr[rr] += __shfl_xor_sync(0xffffffffu, lr[rr], 2);
    }
    // lse in natural log: m and l are in base 2 (the scores carry log2(e))
    if (lse != nullptr && tg == 0) {
      float* lg = lse + static_cast<int64_t>(bh) * seq_q;
      const float ln2 = 0.6931471805599453f;
      const float inf = __int_as_float(0x7f800000);
      if (qpos0 < seq_q)
        lg[qpos0] = lr[0] > 0.f ? (mm[0] + log2f(lr[0])) * ln2 : inf;
      if (qpos1 < seq_q)
        lg[qpos1] = lr[1] > 0.f ? (mm[1] + log2f(lr[1])) * ln2 : inf;
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) lr[rr] = 1.f / fmaxf(lr[rr], 1e-30f);
    bf16* og = out + static_cast<int64_t>(bh) * seq_q * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int cc = 8 * n + 2 * tg;
      if (qpos0 < seq_q)
        st2(og + static_cast<int64_t>(qpos0) * D + cc, o[4 * n] * lr[0],
            o[4 * n + 1] * lr[0]);
      if (qpos1 < seq_q)
        st2(og + static_cast<int64_t>(qpos1) * D + cc, o[4 * n + 2] * lr[1],
            o[4 * n + 3] * lr[1]);
    }
  };

  // The CTA's tiles are one stream, and both consumers walk all of it
  // (rows past Sq are computed and not stored): each step issues the next
  // tile's Q K^T, of the same item or the next, and the previous tile's
  // P V, and takes the next tile's exponentials while that P V runs; an
  // item's rows are written when its last P V is in.  The consumers take
  // turns to issue their MMAs (ping-pong on named barriers 1 and 2, one
  // per consumer), so that one's exponentials run under the other's MMAs.
  auto turn = [&]() {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
  };
  auto pass = [&]() {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
  };
  // the stream's cursor: item r (it), its tile t, its first ring tile g0
  int r = 0, t = 0, g0 = 0;
  Item it;
  // enter item r: wait for its q; an item without a tile releases its q
  // buffer and writes its rows (no live key) at once
  auto enter = [&]() {
    it = decode(r);
    mbar_wait(q_full(r), (r >> 1) & 1);
    if (it.n_tiles == 0) {
      if (signal) mbar_arrive(q_empty(r));
      zero_rows(it.bh, it.q0 + 64 * cw + warp * 16 + g);
    }
  };
  // move the cursor to the next tile of the stream; false at its end
  auto advance = [&]() {
    ++t;
    while (t >= it.n_tiles) {
      g0 += it.n_tiles;
      ++r;
      t = 0;
      if (item_of(r) >= n_items) return false;
      enter();
    }
    return true;
  };
  bool more = item_of(0) < n_items;
  if (more) {
    enter();
    t = -1;
    more = advance();
  }
  if (!more) return;
  if (cw == 1) pass();                             // consumer 0 goes first

  // the first step: Q K^T alone
  int r0 = it.q0 + 64 * cw;                        // this warpgroup's rows
  int qpos0 = r0 + warp * 16 + g;
  float alpha[2];
  turn();
  issue_qk(r, g0 + t);
  pass();
  wgmma_wait0();
  if (t == it.n_tiles - 1 && signal) mbar_arrive(q_empty(r));
  softmax(t, it.klen, r0, qpos0, alpha);
  split_p();
  int pv_gt = g0 + t, pv_bh = it.bh, pv_qpos0 = qpos0;  // the pending P V
  float pv_m[2], pv_l[2];
  while (advance()) {
    const bool fresh = t == 0;                     // a new item's rows
    r0 = it.q0 + 64 * cw;
    qpos0 = r0 + warp * 16 + g;
    turn();
    issue_qk(r, g0 + t);                           // tensor cores: S of t
    issue_pv(pv_gt);                               // ... then the last P V
    pass();
    wgmma_wait1();                                 // S of t is in
    if (t == it.n_tiles - 1 && signal) mbar_arrive(q_empty(r));
    if (fresh) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        pv_m[rr] = m[rr];
        pv_l[rr] = l[rr];
        m[rr] = kNegInf;
        l[rr] = 0.f;
      }
    }
    softmax(t, it.klen, r0, qpos0, alpha);         // while P V runs
    wgmma_wait0();
    fence_pv();
    if (signal) mbar_arrive(empty(pv_gt % kStages));
    if (fresh) epilogue(pv_bh, pv_qpos0, pv_m, pv_l);
    // a new item starts from O = 0, a tile of the same item rescales it
    const float f0 = fresh ? 0.f : alpha[0], f1 = fresh ? 0.f : alpha[1];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i >> 1) & 1 ? f1 : f0;
    split_p();
    pv_gt = g0 + t;
    pv_bh = it.bh;
    pv_qpos0 = qpos0;
  }
  // the last P V
  turn();
  issue_pv(pv_gt);
  if (cw == 0) pass();                             // the last turn is 1's
  wgmma_wait0();
  fence_pv();
  if (signal) mbar_arrive(empty(pv_gt % kStages));
  epilogue(pv_bh, pv_qpos0, m, l);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (once).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over (heads, rows, D) bf16, boxes of SW bytes of d by box_rows
// rows of one head, in the swizzle wgmma reads; rows past `rows` read 0.
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int64_t heads, int64_t rows,
              int box_rows) {
  constexpr int SW = swizzle_bytes<D>();
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(2 * D),
                                 static_cast<cuuint64_t>(2 * D * rows)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(SW / 2),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* lengths, void* out, float* lse,
                   int64_t batch, int64_t qh, int64_t kvh, int64_t seq_q,
                   int64_t seq_k, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int smem = Smem<D>::kAlloc;
  const int64_t n_qt = (seq_q + kBQ - 1) / kBQ;
  if (n_qt * qh * batch > 2147483647LL) return cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  // with no key at all no tile is loaded: the maps then stand on q
  const bool keys = seq_k > 0;
  if (!make_map<D>(&qmap, q, batch * qh, seq_q, kBQ) ||
      !make_map<D>(&kmap, keys ? k : q, keys ? batch * kvh : batch * qh,
                   keys ? seq_k : seq_q, kBK) ||
      !make_map<D>(&vmap, keys ? v : q, keys ? batch * kvh : batch * qh,
                   keys ? seq_k : seq_q, kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  // one CTA per SM (their shared memory and registers allow no second),
  // each walking its work items
  int dev = 0, n_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t n_items = n_qt * qh * batch;
  dim3 grid(static_cast<unsigned>(n_items < n_sm ? n_items : n_sm));
  flash_bf16_kernel<D><<<grid, kThreads, smem, stream>>>(
      qmap, kmap, vmap, lengths, static_cast<bf16*>(out), lse,
      static_cast<int>(batch), static_cast<int>(qh), static_cast<int>(kvh),
      static_cast<int>(seq_q), static_cast<int>(seq_k),
      static_cast<int>(n_qt), scale, causal);
  return cudaGetLastError();
}

}  // namespace

// flash_attention_launch (flash_attention.cu) calls this for dtype 1,
// with its arguments checked there.
cudaError_t flash_attention_bf16_launch(
    const void* q, const void* k, const void* v, const int32_t* lengths,
    void* out, float* lse, int64_t batch, int64_t qh, int64_t kvh,
    int64_t seq_q, int64_t seq_k, int64_t head_dim, float scale, int causal,
    cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<16>(q, k, v, lengths, out, lse, batch, qh, kvh, seq_q,
                        seq_k, scale, causal, stream);
    case 32:
      return launch<32>(q, k, v, lengths, out, lse, batch, qh, kvh, seq_q,
                        seq_k, scale, causal, stream);
    case 64:
      return launch<64>(q, k, v, lengths, out, lse, batch, qh, kvh, seq_q,
                        seq_k, scale, causal, stream);
    case 128:
      return launch<128>(q, k, v, lengths, out, lse, batch, qh, kvh, seq_q,
                         seq_k, scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
