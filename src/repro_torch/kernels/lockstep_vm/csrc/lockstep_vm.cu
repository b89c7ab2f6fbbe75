// The lockstep Tiara engine on Hopper (sm_90a): one launch runs a whole
// wave, from the first macro-step to the last, on the card.
//
// Replaces, on the port's main path, the JAX engine's one device program
// per wave: the `lax.while_loop` of `src/repro/core/vm.py` (the dense
// engine's run at :1122, its nested loop pops at :548 and :567), whose
// MEMCPY is the window form of the Pallas kernel `tiara_gather_kernel`
// (`src/repro/kernels/tiara_gather/kernel.py:28`).  The port's host loop
// (`core/vm.py`, `_Engine.run_host_loop`) is its plain version: it ends
// every macro-step in a host read of a few flags and launches dozens of
// small kernels a step, `tiara_gather`'s window form among them, so a
// wave of a few hundred macro-steps costs hundreds of milliseconds of
// host time.  Here no host read happens until the caller retires the
// wave.
//
// What bounds it on this card: neither bytes nor operations.  A
// macro-step is a chain of dependent loads (the lane's pc, its
// instruction, its registers, the word a LOAD reads) and a few block
// barriers, so a step costs a few microseconds of latency whatever the
// wave's bytes.  The design keeps that chain short and runs the wave's
// lanes side by side:
//
//   * ONE thread block of kThreads threads, lanes over threads (lane b
//     is owned by thread b % kThreads), barriers between the phases of a
//     macro-step (see lockstep_vm.cuh for the phases and the exactness
//     argument);
//   * lane state (pc, loop stack, in-flight counter, footprints) lives
//     in a global scratch tensor that stays in L1/L2; the outputs (ret,
//     status, steps, regs, fault) are written in place;
//   * the conflict sweep compares footprints pairwise over tiles staged
//     in shared memory; conflicting lanes replay one by one in lane
//     order, thread 0 stepping and the block copying;
//   * MEMCPY windows are copied by the whole block with 16-byte vectors,
//     four in flight a thread: `tiara_gather`'s window copy, now inside
//     the wave instead of one launch per macro-step.
//
// Plain C interface, loaded with ctypes: the launch takes one host array
// of int64 operands (lockstep_vm.cuh's Hdr order: device pointers and
// sizes) and the stream, launches on that stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so a refused launch
// is reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lockstep_vm.cuh"

namespace {

using namespace lockstep_vm;

constexpr int kMaxThreads = 1024;

struct CudaBlock {
  int64_t* stage_;
  int* ncopy_;
  int64_t* desc_;
  __device__ __forceinline__ int64_t tid() const { return threadIdx.x; }
  __device__ __forceinline__ int64_t nt() const { return blockDim.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ int sync_or(int p) const {
    return __syncthreads_or(p);
  }
  __device__ __forceinline__ int64_t claim(int* c) const {
    return atomicAdd(c, 1);
  }
  __device__ __forceinline__ int64_t* stage() const { return stage_; }
  __device__ __forceinline__ int* ncopy() const { return ncopy_; }
  __device__ __forceinline__ int64_t* desc() const { return desc_; }
};

__global__ void __launch_bounds__(kMaxThreads, 1)
lockstep_vm_kernel(const Wave w) {
  extern __shared__ __align__(16) int64_t stage[];
  __shared__ int ncopy;
  __shared__ __align__(16) int64_t desc[kDescWords];
  CudaBlock k{stage, &ncopy, desc};
  run_wave(w, k);
}

}  // namespace

// hdr: H_COUNT int64 operands in lockstep_vm.cuh's Hdr order (host
// memory); threads: the block's size, a multiple of 32 up to 1024.
extern "C" int lockstep_vm_launch(const int64_t* hdr, int64_t n_hdr,
                                  int64_t threads, void* stream) {
  if (n_hdr != H_COUNT || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Wave w = unpack(hdr);
  if (w.B <= 0) return static_cast<int>(cudaSuccess);
  if (w.max_window < 1 || w.max_window > 4096 || w.n_dev < 1 ||
      w.n_instr < 1 || w.n_regions < 1 || w.n_ops < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t words = w.max_window > 4 * threads ? w.max_window
                                                   : 4 * threads;
  const size_t smem = static_cast<size_t>(words) * sizeof(int64_t);
  lockstep_vm_kernel<<<1, static_cast<unsigned>(threads), smem,
                       static_cast<cudaStream_t>(stream)>>>(w);
  return static_cast<int>(cudaGetLastError());
}
