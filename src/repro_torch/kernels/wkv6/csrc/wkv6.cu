// RWKV-6's wkv recurrence for Hopper (sm_90a), one launch per layer call:
//
//     y_t[j] = sum_i r_t[i] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])
//     S_t[i, j] = w_t[i] S_{t-1}[i, j] + k_t[i] v_t[j]
//
// over the S steps of (B, S, H, K) inputs from the state (B, H, K, K); a
// step whose valid flag is 0 leaves S as it is.  Returns the last state
// and y (B, S, H, K), all f32.
//
// Replaces no Pallas kernel: the reference runs the time mix as a
// `lax.scan` device program (src/repro/models/rwkv.py:142, the step scan,
// and :157, the checkpointed scan over chunks of 256 steps).  Before this
// kernel the port drove it from the host, one `addcmul_` launch a step
// plus a few launches a chunk.
//
// Design: one block of (HS / 4)^2 threads per head (b, h), HS >= K (256
// threads at RWKV-6's heads of 64), thread (g, p) holding the 4 x 4 block
// of the state at rows 4p, columns 4g in registers, and every thread
// walks t in order; each step the HS / 4 row blocks' partial sums of a
// column group's y_t meet by a reduce-scatter of butterfly shuffles, after
// which four lanes store one column each.  r_t, k_t, v_t and w_t of kTile
// steps are copied into shared memory with cp.async, the next tile's
// copies in flight while the current tile is computed (two buffers); the
// valid flags of the next tile are loaded into a register a tile ahead.
// The per-step arithmetic is in wkv6.cuh (the host tests build it with
// g++).
//
// What bounds it on the H100: at RWKV-6's prefill (B 8, S 1024, H 32, K
// 64) it reads r, k, v, w (268 MB) and writes y (67 MB), 0.1 ms at 3.35
// TB/s, and does 5 flops a state word a step, 5.2 GFLOP of f32 (67
// TFLOP/s: 0.08 ms).  The 1024 steps of a head are dependent, so the time
// is one block's walk: per step and thread four 16-byte shared reads, 16
// state words' arithmetic and the reduce-scatter's four shuffles, with
// 2048 warps on the card to overlap them.  Designs that gave a thread one
// column (all 64 rows, or a quarter of them) read three shared words per
// state word a step instead of one, and one of 16 x 4 words left a
// single warp per scheduler; each was slower at this shape.  The staging
// keeps its index arithmetic in 32 bits and constant divisors: with
// 64-bit divisions per copied word it cost as much as the steps.
//
// Plain C interface, loaded with ctypes: `wkv6_launch` takes one host
// array of int64 operands (wkv6.cuh's Operand order) and the stream,
// launches on that stream, does not synchronise, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6.cuh"

namespace {

using namespace wkv6;

struct AsyncCopy {
  __device__ __forceinline__ void operator()(float* dst,
                                             const float* src) const {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  }
};

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the column of its group whose y part p holds after `reduce_scatter`,
// or -1 (a copy that another part stores)
__device__ __forceinline__ int stored_column(int p) {
  return p < 4 ? (p & 1) * 2 + (p >> 1) : -1;
}

// each column's y from the partial sums `y` of the P parts of a column
// group (P consecutive lanes, p = lane % P): two butterflies that halve
// the columns a lane holds (xor 1, xor 2), then plain butterflies over
// the rest of the parts (xor 4, xor 8), so lane p ends with column
// stored_column(p & 3) summed in combine's order (every lane of a pair
// adds the same two values)
template <int P>
__device__ __forceinline__ float reduce_scatter(const float (&y)[kBlock],
                                                int p, unsigned lanes) {
  const bool odd = p & 1, hi = p & 2;
  const float z0 = (odd ? y[2] : y[0]) +
                   __shfl_xor_sync(lanes, odd ? y[0] : y[2], 1);
  const float z1 = (odd ? y[3] : y[1]) +
                   __shfl_xor_sync(lanes, odd ? y[1] : y[3], 1);
  float f = (hi ? z1 : z0) + __shfl_xor_sync(lanes, hi ? z0 : z1, 2);
#pragma unroll
  for (int m = 4; m < P; m *= 2) f += __shfl_xor_sync(lanes, f, m);
  return f;
}

template <int HS>
__global__ void __launch_bounds__(Shape<HS>::kThreads)
wkv6_kernel(const Args a) {
  using L = Shape<HS>;
  constexpr int P = L::kParts;
  __shared__ __align__(16) float tile[2][kTile * L::kStepWords];
  __shared__ uint8_t ok[2][kTile];
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x;
  const int g = tid / P, p = tid % P;
  const unsigned lanes = L::kThreads >= 32 ? 0xffffffffu
                                           : (1u << L::kThreads) - 1;
  // the rows' padding past K stays 0: the copies write only live entries
  for (int e = tid; e < 2 * kTile * L::kStepWords; e += L::kThreads) {
    (&tile[0][0])[e] = 0.0f;
  }
  float s[kBlock][kBlock], u[kBlock];
  load_block(a, bh, g, p, s, u);
  __syncthreads();
  const int64_t tiles = (a.S + kTile - 1) / kTile;
  const AsyncCopy copy;
  stage_tile<HS>(a, bh, 0, a.S < kTile ? a.S : kTile, tile[0], tid,
                 L::kThreads, copy);
  commit();
  if (tid < kTile && tid < a.S) ok[0][tid] = flag(a, b, tid);
  const int col = stored_column(p);
  const int64_t j = kBlock * g + col;
  for (int64_t k = 0; k < tiles; ++k) {
    const int buf = static_cast<int>(k & 1);
    const int64_t t0 = k * kTile;
    const int64_t n = a.S - t0 < kTile ? a.S - t0 : kTile;
    uint8_t next = 1;
    if (k + 1 < tiles) {
      const int64_t t1 = t0 + kTile;
      const int64_t n1 = a.S - t1 < kTile ? a.S - t1 : kTile;
      stage_tile<HS>(a, bh, t1, n1, tile[buf ^ 1], tid, L::kThreads, copy);
      commit();
      if (tid < n1) next = flag(a, b, t1 + tid);
      wait_groups<1>();                // this tile's copies have landed
    } else {
      wait_groups<0>();
    }
    __syncthreads();
    float* yo = a.y + ((b * a.S + t0) * a.H + h) * a.K + j;
    for (int64_t jj = 0; jj < n; ++jj) {
      float y[kBlock];
      block_step<HS>(s, u, tile[buf] + jj * L::kStepWords, g, p,
                     ok[buf][jj] != 0, y);
      const float f = reduce_scatter<P>(y, p, lanes);
      if (col >= 0 && j < a.K) yo[jj * a.H * a.K] = f;
    }
    if (k + 1 < tiles && tid < kTile) ok[buf ^ 1][tid] = next;
    __syncthreads();                   // before the next copies reuse buf
  }
  store_block(a, bh, g, p, s);
}

template <int HS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  wkv6_kernel<HS><<<static_cast<unsigned>(a.B * a.H), Shape<HS>::kThreads,
                    0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// 0, or the CUDA error of the launch (cudaErrorInvalidValue for operands
// the kernel does not take)
int wkv6_launch(const int64_t* ops, int64_t n_ops, void* stream) {
  if (n_ops != kOpCount) return cudaErrorInvalidValue;
  const Args a = unpack(ops);
  if (a.B <= 0 || a.S <= 0 || a.H <= 0 || a.B * a.H > 2147483647LL) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (padded_head(a.K)) {
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
