// Mamba's selective scan for Hopper (sm_90a), one launch per layer call:
//
//     h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t,   y_t = h_t . C_t
//
// over the S steps of (B, S, D) inputs, from the state h (B, D, N); a step
// whose valid flag is 0 leaves h as it is (its y still reads h).  Returns
// the last state and y (B, S, D), all f32.
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// `lax.scan` device program (src/repro/models/mamba.py:150, the step scan,
// and :163, the checkpointed scan over chunks of 256 steps), and its
// docstring names a chunked selective-scan kernel as the fast path on real
// hardware.  Before this kernel the port drove it from the host, one
// `addcmul_` launch a step plus a few launches a chunk.
//
// Design: one thread per channel (b, d), 128 channels of one row b a
// block.  A thread keeps its N <= 32 states and A[d, :] in registers and
// walks t in order; dt[b, t, d] and x[b, t, d] are read coalesced along d,
// a group of kGroup steps' loads issued a group ahead of their use.  B_t,
// C_t and the valid flags, the same for every channel of the row, are
// staged in shared memory kTile steps at a time and read as broadcasts.
// The per-step arithmetic is in selective_scan.cuh (the host tests build
// it with g++).
//
// What bounds it on the H100: at Jamba's prefill (B 8, S 1024, D 8192, N
// 16) it reads dt and x (537 MB) and writes y (268 MB), 0.24 ms at 3.35
// TB/s, and takes an exp per state on each valid step, 1.07e9 when every
// step is valid, one MUFU.EX2 each at 16 a clock per SM (0.26 ms at the
// boost clock); expf's range reduction and the FMAs around it put the
// instruction issue of such a run near 0.4 ms.  Padded steps skip the
// update, so the row with the most valid steps sets the time of a ragged
// batch.  The steps of a channel are dependent, but its 16 states give
// each step 16 independent chains.
//
// Plain C interface, loaded with ctypes: `selective_scan_launch` takes one
// host array of int64 operands (selective_scan.cuh's Operand order) and
// the stream, launches on that stream, does not synchronise, allocates
// nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "selective_scan.cuh"

namespace {

using namespace selective_scan;

// dt and x of steps t .. t + kGroup - 1 of one channel (0 past S)
__device__ __forceinline__ void load_group(const float* dtp, const float* xp,
                                           int64_t t, int64_t S, int64_t D,
                                           float (&dv)[kGroup],
                                           float (&xv)[kGroup]) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const bool in = t + u < S;
    dv[u] = in ? __ldg(dtp + (t + u) * D) : 0.0f;
    xv[u] = in ? __ldg(xp + (t + u) * D) : 0.0f;
  }
}

template <int NS>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const Args a) {
  __shared__ __align__(16) float bc[kTile * 2 * NS];
  __shared__ uint8_t ok[kTile];
  const int64_t b = blockIdx.y;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  const bool live = d < a.D;
  const int64_t dd = live ? d : 0;
  float h[NS], A[NS];
  load_channel<NS>(a, b, dd, h, A);
  const int64_t base = b * a.S * a.D + dd;
  const float* dtp = a.dt + base;
  const float* xp = a.x + base;
  float* yp = a.y + base;
  float dc[kGroup], xc[kGroup];
  load_group(dtp, xp, 0, a.S, a.D, dc, xc);
  for (int64_t t = 0; t < a.S; t += kGroup) {
    const int64_t j0 = t % kTile;
    if (j0 == 0) {
      __syncthreads();               // every thread is done with the tile
      const int64_t n = a.S - t < kTile ? a.S - t : kTile;
      stage_tile<NS>(a, b, t, n, bc, ok, threadIdx.x, kThreads);
      __syncthreads();
    }
    float dn[kGroup], xn[kGroup];
    load_group(dtp, xp, t + kGroup, a.S, a.D, dn, xn);
    if (live) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (t + u < a.S) {
          const int64_t j = j0 + u;
          yp[(t + u) * a.D] = step<NS>(h, A, dc[u], xc[u], bc + j * 2 * NS,
                                       bc + j * 2 * NS + NS, ok[j] != 0);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      dc[u] = dn[u];
      xc[u] = xn[u];
    }
  }
  if (live) store_channel<NS>(a, b, d, h);
}

template <int NS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((a.D + kThreads - 1) / kThreads),
                  static_cast<unsigned>(a.B));
  selective_scan_kernel<NS><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 0, or the CUDA error of the launch (cudaErrorInvalidValue for operands
// the kernel does not take)
int selective_scan_launch(const int64_t* ops, int64_t n_ops, void* stream) {
  if (n_ops != kOpCount) return cudaErrorInvalidValue;
  const Args a = unpack(ops);
  if (a.B <= 0 || a.S <= 0 || a.D <= 0 || a.B > 65535 ||
      (a.D + kThreads - 1) / kThreads > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_states(a.N)) {
    case 4: return launch<4>(a, s);
    case 8: return launch<8>(a, s);
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
