// The RWKV-6 wkv recurrence's per-thread arithmetic, written once for the
// CUDA kernel (csrc/wkv6.cu) and a plain C++ build (no __CUDACC__), where
// host loops run the same functions over a block's threads
// (tests/wkv6_host.cpp):
//
//     y_t[j] = sum_i r_t[i] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])
//     S_t[i, j] = w_t[i] S_{t-1}[i, j] + k_t[i] v_t[j]
//
// per head (b, h) of K <= HS rows.  The state is cut into 4 x 4 blocks,
// one a thread: thread (g, p) holds rows 4p .. 4p + 3 of columns 4g ..
// 4g + 3 in registers, and u's entries of its rows.  Each step it reads
// its rows' r, k, w and its columns' v (four 16-byte shared loads for 16
// state words), computes its columns' partial sums of y_t over its rows,
// and the partial sums of a column's HS / 4 parts are combined pairwise
// (`combine`; on the card by a reduce-scatter of butterfly shuffles,
// which gives every column these bits).  y reads the state BEFORE the
// step's update; a step whose valid flag is 0 leaves S as it is, while
// its y still takes the bonus u k v of its own (unmasked) k and v, as the
// reference does (src/repro/models/rwkv.py:130-138: y from `state + u
// kv`, then `where(m, new_state, state)`).  The arithmetic per step is
// the plain version's up to rounding: the bonus as (u k) v inside one
// fused multiply-add, the update as one fused multiply-add, y's sum over i
// in another order.
//
// HS is the padded head size (16, 32 or 64): rows past K hold S = 0 and
// r = k = w = u = 0, so they stay 0 and add nothing to y; columns past K
// are computed on zeros and never stored.
//
// A step's r_t, k_t, v_t and w_t are the head's, shared by its threads:
// `stage_tile` copies those of a tile of steps into the block's shared
// words (`Shape`'s layout: eight threads of a quarter warp read eight
// consecutive 16-byte words).  Only the K live entries are copied (the
// caller zeroes the rest once), through `copy(dst, src)` (an async copy
// on the card, an assignment in the host build).

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define WKV_FN __device__ __forceinline__
#else
#define WKV_FN inline
#endif

namespace wkv6 {

// steps of r, k, v, w staged at a time (two tiles in flight)
constexpr int kTile = 16;
// the largest head a block takes
constexpr int kMaxHead = 64;
// one launch's int64 operands, in this order (kernel.py's OPERANDS)
enum Operand : int64_t {
  kOpS0,        // (B, H, K, K) f32, the state before the first step
  kOpR,         // (B, S, H, K) f32
  kOpK,         // (B, S, H, K) f32
  kOpV,         // (B, S, H, K) f32
  kOpW,         // (B, S, H, K) f32, the decays
  kOpU,         // (H, K) f32, the bonus
  kOpValid,     // (B, S) one byte a step, or 0: every step valid
  kOpSOut,      // (B, H, K, K) f32, the state after the last step
  kOpY,         // (B, S, H, K) f32
  kOpBatch,
  kOpSteps,
  kOpHeads,
  kOpHeadSize,
  kOpCount
};

struct Args {
  const float* s0;
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const uint8_t* valid;
  float* s_out;
  float* y;
  int64_t B, S, H, K;
};

inline Args unpack(const int64_t* o) {
  Args a;
  a.s0 = reinterpret_cast<const float*>(o[kOpS0]);
  a.r = reinterpret_cast<const float*>(o[kOpR]);
  a.k = reinterpret_cast<const float*>(o[kOpK]);
  a.v = reinterpret_cast<const float*>(o[kOpV]);
  a.w = reinterpret_cast<const float*>(o[kOpW]);
  a.u = reinterpret_cast<const float*>(o[kOpU]);
  a.valid = reinterpret_cast<const uint8_t*>(o[kOpValid]);
  a.s_out = reinterpret_cast<float*>(o[kOpSOut]);
  a.y = reinterpret_cast<float*>(o[kOpY]);
  a.B = o[kOpBatch];
  a.S = o[kOpSteps];
  a.H = o[kOpHeads];
  a.K = o[kOpHeadSize];
  return a;
}

// four consecutive words (16-byte aligned): one 16-byte shared load on
// the card
#ifdef __CUDACC__
WKV_FN void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
#else
inline void load4(const float* p, float (&o)[4]) {
  for (int e = 0; e < 4; ++e) o[e] = p[e];
}
#endif

// The shape of a head of HS entries: a thread owns a kBlock x kBlock
// block of the state, rows kBlock p .., columns kBlock g ..; kParts =
// HS / kBlock row blocks (parts) and as many column groups, kThreads
// threads a block (thread g kParts + p).  A staged step holds the r, k, w
// and v rows, HS words each, at kRowR .. kRowV.
constexpr int kBlock = 4;
constexpr int kRowR = 0, kRowK = 1, kRowW = 2, kRowV = 3;

template <int HS>
struct Shape {
  static constexpr int kParts = HS / kBlock;
  static constexpr int kThreads = kParts * kParts;
  static constexpr int kStepWords = 4 * HS;
};

// r, k, v, w of steps t0 .. t0 + n - 1 of head bh = b * H + h into tile
// (kStepWords a step), by thread tid of nt (nt a multiple of HS): the
// thread copies entry tid % HS of every (nt / HS)-th row from row tid /
// HS, and nothing past K
template <int HS, typename Copy>
WKV_FN void stage_tile(const Args& a, int64_t bh, int64_t t0, int64_t n,
                       float* tile, int tid, int nt, Copy copy) {
  const int i = tid % HS;
  if (i >= a.K) return;
  const int64_t b = bh / a.H, h = bh % a.H;
  const int64_t step = a.H * a.K;
  const int64_t at = ((b * a.S + t0) * a.H + h) * a.K + i;
  for (int row = tid / HS; row < 4 * n; row += nt / HS) {
    const int c = row % 4;
    const float* src = c == kRowR ? a.r : c == kRowK ? a.k
                     : c == kRowW ? a.w : a.v;
    copy(tile + row * HS + i, src + at + (row / 4) * step);
  }
}

// the valid flag of step t of row b (1 when there is no mask)
WKV_FN uint8_t flag(const Args& a, int64_t b, int64_t t) {
  return a.valid == nullptr ? 1 : a.valid[b * a.S + t];
}

// thread (g, p)'s block of head bh's state, s[q][c] = S[kBlock p + q,
// kBlock g + c], and u's entries of its rows; zero past K
WKV_FN void load_block(const Args& a, int64_t bh, int g, int p,
                       float (&s)[kBlock][kBlock], float (&u)[kBlock]) {
#pragma unroll
  for (int q = 0; q < kBlock; ++q) {
    const int64_t i = kBlock * p + q;
    u[q] = i < a.K ? a.u[(bh % a.H) * a.K + i] : 0.0f;
#pragma unroll
    for (int c = 0; c < kBlock; ++c) {
      const int64_t j = kBlock * g + c;
      s[q][c] = i < a.K && j < a.K ? a.s0[(bh * a.K + i) * a.K + j] : 0.0f;
    }
  }
}

WKV_FN void store_block(const Args& a, int64_t bh, int g, int p,
                        const float (&s)[kBlock][kBlock]) {
#pragma unroll
  for (int q = 0; q < kBlock; ++q) {
    const int64_t i = kBlock * p + q;
#pragma unroll
    for (int c = 0; c < kBlock; ++c) {
      const int64_t j = kBlock * g + c;
      if (i < a.K && j < a.K) a.s_out[(bh * a.K + i) * a.K + j] = s[q][c];
    }
  }
}

// one step of thread (g, p): each of its columns' partial y over its rows
// from the state before the update (each word's term read before that
// word's update), then the update (on a valid step).  row is the staged
// step; y[c] = sum_q r[q] (S[q][c] + (u[q] k[q]) v[c]), in row order.
template <int HS>
WKV_FN void block_step(float (&s)[kBlock][kBlock], const float (&u)[kBlock],
                       const float* row, int g, int p, bool valid,
                       float (&y)[kBlock]) {
  float r[kBlock], k[kBlock], w[kBlock], v[kBlock];
  load4(row + kRowR * HS + kBlock * p, r);
  load4(row + kRowK * HS + kBlock * p, k);
  load4(row + kRowW * HS + kBlock * p, w);
  load4(row + kRowV * HS + kBlock * g, v);
#pragma unroll
  for (int c = 0; c < kBlock; ++c) y[c] = 0.0f;
#pragma unroll
  for (int q = 0; q < kBlock; ++q) {
    const float uk = u[q] * k[q];
#pragma unroll
    for (int c = 0; c < kBlock; ++c) {
      y[c] = fmaf(r[q], fmaf(uk, v[c], s[q][c]), y[c]);
    }
  }
  if (valid) {
#pragma unroll
    for (int q = 0; q < kBlock; ++q) {
#pragma unroll
      for (int c = 0; c < kBlock; ++c) {
        s[q][c] = fmaf(w[q], s[q][c], k[q] * v[c]);
      }
    }
  }
}

// y of a column from its parts' partial sums yp[0 .. n), summed in
// place: pairs of neighbours, then pairs of those, up to one sum (n a
// power of two), the order of the card's butterflies
WKV_FN float combine(float* yp, int n) {
  for (int w = 1; w < n; w *= 2) {
    for (int i = 0; i < n; i += 2 * w) yp[i] = yp[i] + yp[i + w];
  }
  return yp[0];
}

// column group g's steps t0 .. t0 + n - 1 over a staged tile and its
// flags, the group's parts in turn each step and each column's y
// combined from them (the host build's walk; the kernel runs one part a
// thread and combines by shuffles); y written for live columns.
template <int HS>
WKV_FN void tile_steps(const Args& a, int64_t bh, int g, int64_t t0,
                       int64_t n, const float* tile, const uint8_t* ok,
                       float (&s)[HS / kBlock][kBlock][kBlock],
                       const float (&u)[HS / kBlock][kBlock]) {
  constexpr int P = Shape<HS>::kParts;
  const int64_t b = bh / a.H, h = bh % a.H;
  for (int64_t jj = 0; jj < n; ++jj) {
    float yp[kBlock][P];
    for (int p = 0; p < P; ++p) {
      float y[kBlock];
      block_step<HS>(s[p], u[p], tile + jj * Shape<HS>::kStepWords, g, p,
                     ok[jj] != 0, y);
      for (int c = 0; c < kBlock; ++c) yp[c][p] = y[c];
    }
    for (int c = 0; c < kBlock; ++c) {
      const int64_t j = kBlock * g + c;
      if (j < a.K) {
        a.y[((b * a.S + t0 + jj) * a.H + h) * a.K + j] = combine(yp[c], P);
      }
    }
  }
}

// the padded head size a launch of K takes, 0 past kMaxHead
inline int padded_head(int64_t k) {
  return k <= 16 ? 16 : k <= 32 ? 32 : k <= 64 ? 64 : 0;
}

}  // namespace wkv6
