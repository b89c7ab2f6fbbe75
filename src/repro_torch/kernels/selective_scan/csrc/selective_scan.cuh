// The selective scan's per-thread arithmetic, written once for the CUDA
// kernel (csrc/selective_scan.cu) and a plain C++ build (no __CUDACC__),
// where host loops run the same functions over a block's channels
// (tests/selective_scan_host.cpp):
//
//     h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t,   y_t = h_t . C_t
//
// per channel (b, d), with h and A[d, :] of N <= NS states.  A step whose
// `valid` flag is 0 leaves h as it is and still writes y_t = h . C_t, as
// the reference does (src/repro/models/mamba.py:135-150: a = 1, bx = 0 on
// padded steps).  The arithmetic per step is the plain version's:
// `exp(dt * A)` with expf (within an ulp or two of torch.exp), `(dt * x) *
// B`, and the update as one fused multiply-add; only the order of y's
// sum over the states differs.
//
// NS is the padded state count (a power of two, 4..32): states past N
// hold h = 0, A = 0 and B = C = 0, so they stay 0 and add nothing to y.
//
// A block's channels share b, so they share B_t, C_t and the valid flags:
// `stage_tile` copies those of a tile of steps into the block's shared
// words, bc[j][0][:] = B_{t0+j}, bc[j][1][:] = C_{t0+j} (zero past N),
// ok[j] = valid[b, t0+j] (1 when there is no mask), each thread `tid` of
// `nt` copying every nt-th word; the host build calls it with tid 0 of 1.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define SS_FN __device__ __forceinline__
#else
#define SS_FN inline
#endif

namespace selective_scan {

// channels a block
constexpr int kThreads = 128;
// steps whose B_t, C_t are staged at a time
constexpr int kTile = 64;
// steps whose dt and x loads a thread issues together (divides kTile)
constexpr int kGroup = 4;
// the most states a channel takes
constexpr int kMaxState = 32;

// one launch's int64 operands, in this order (kernel.py's OPERANDS)
enum Operand : int64_t {
  kOpH0,        // (B, D, N) f32, the state before the first step
  kOpDt,        // (B, S, D) f32
  kOpX,         // (B, S, D) f32
  kOpBm,        // (B, S, N) f32 at strides (bm_b, bm_s, 1)
  kOpCm,        // (B, S, N) f32 at strides (cm_b, cm_s, 1)
  kOpA,         // (D, N) f32
  kOpValid,     // (B, S) one byte a step, or 0: every step valid
  kOpHOut,      // (B, D, N) f32, the state after the last step
  kOpY,         // (B, S, D) f32
  kOpBatch,
  kOpSteps,
  kOpChannels,
  kOpStates,
  kOpBmB,
  kOpBmS,
  kOpCmB,
  kOpCmS,
  kOpCount
};

struct Args {
  const float* h0;
  const float* dt;
  const float* x;
  const float* bm;
  const float* cm;
  const float* a;
  const uint8_t* valid;
  float* h_out;
  float* y;
  int64_t B, S, D, N;
  int64_t bm_b, bm_s, cm_b, cm_s;
};

inline Args unpack(const int64_t* o) {
  Args a;
  a.h0 = reinterpret_cast<const float*>(o[kOpH0]);
  a.dt = reinterpret_cast<const float*>(o[kOpDt]);
  a.x = reinterpret_cast<const float*>(o[kOpX]);
  a.bm = reinterpret_cast<const float*>(o[kOpBm]);
  a.cm = reinterpret_cast<const float*>(o[kOpCm]);
  a.a = reinterpret_cast<const float*>(o[kOpA]);
  a.valid = reinterpret_cast<const uint8_t*>(o[kOpValid]);
  a.h_out = reinterpret_cast<float*>(o[kOpHOut]);
  a.y = reinterpret_cast<float*>(o[kOpY]);
  a.B = o[kOpBatch];
  a.S = o[kOpSteps];
  a.D = o[kOpChannels];
  a.N = o[kOpStates];
  a.bm_b = o[kOpBmB];
  a.bm_s = o[kOpBmS];
  a.cm_b = o[kOpCmB];
  a.cm_s = o[kOpCmS];
  return a;
}

// four consecutive staged words (16-byte aligned): one 16-byte shared
// load on the card
#ifdef __CUDACC__
SS_FN void load4(const float* p, float (&o)[4]) {
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

// B_t, C_t and the valid flags of steps t0 .. t0 + n - 1 of row b into
// bc (n * 2 * NS words) and ok (n bytes)
template <int NS>
SS_FN void stage_tile(const Args& a, int64_t b, int64_t t0, int64_t n,
                      float* bc, uint8_t* ok, int64_t tid, int64_t nt) {
  for (int64_t e = tid; e < n * 2 * NS; e += nt) {
    const int64_t j = e / (2 * NS), c = (e / NS) % 2, i = e % NS;
    float v = 0.0f;
    if (i < a.N) {
      v = c == 0 ? a.bm[b * a.bm_b + (t0 + j) * a.bm_s + i]
                 : a.cm[b * a.cm_b + (t0 + j) * a.cm_s + i];
    }
    bc[e] = v;
  }
  for (int64_t j = tid; j < n; j += nt) {
    ok[j] = a.valid == nullptr ? 1 : a.valid[b * a.S + t0 + j];
  }
}

// channel (b, d)'s state and A row, zero past N
template <int NS>
SS_FN void load_channel(const Args& a, int64_t b, int64_t d, float (&h)[NS],
                        float (&A)[NS]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    h[i] = i < a.N ? a.h0[(b * a.D + d) * a.N + i] : 0.0f;
    A[i] = i < a.N ? a.a[d * a.N + i] : 0.0f;
  }
}

template <int NS>
SS_FN void store_channel(const Args& a, int64_t b, int64_t d,
                         const float (&h)[NS]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (i < a.N) a.h_out[(b * a.D + d) * a.N + i] = h[i];
  }
}

// one step of one channel: the update (on a valid step), then y = h . C
// in four interleaved partial sums; bt and ct are the step's staged rows
template <int NS>
SS_FN float step(float (&h)[NS], const float (&A)[NS], float dt, float x,
                 const float* bt, const float* ct, bool valid) {
  if (valid) {
    const float dx = dt * x;
#pragma unroll
    for (int i = 0; i < NS; i += 4) {
      float b4[4];
      load4(bt + i, b4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[i + e] = fmaf(expf(dt * A[i + e]), h[i + e], dx * b4[e]);
      }
    }
  }
  float y[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NS; i += 4) {
    float c4[4];
    load4(ct + i, c4);
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = fmaf(h[i + e], c4[e], y[e]);
  }
  return (y[0] + y[1]) + (y[2] + y[3]);
}

// channel (b, d)'s steps t0 .. t0 + n - 1 over a staged tile, y written
// (the host build's walk; the kernel issues each group's dt and x loads a
// group ahead and calls `step` itself)
template <int NS>
SS_FN void tile_steps(const Args& a, int64_t b, int64_t d, int64_t t0,
                      int64_t n, const float* bc, const uint8_t* ok,
                      float (&h)[NS], const float (&A)[NS]) {
  const int64_t base = b * a.S * a.D + d;
  for (int64_t j = 0; j < n; ++j) {
    const int64_t at = base + (t0 + j) * a.D;
    a.y[at] = step<NS>(h, A, a.dt[at], a.x[at], bc + j * 2 * NS,
                       bc + j * 2 * NS + NS, ok[j] != 0);
  }
}

// the padded state count a launch of N states takes, 0 past kMaxState
inline int padded_states(int64_t n) {
  return n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : n <= 32 ? 32 : 0;
}

}  // namespace selective_scan
