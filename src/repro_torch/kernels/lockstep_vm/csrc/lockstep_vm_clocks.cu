// The lockstep_vm kernel built again with per-phase clocks, for
// measurement only (the main path never loads this entry): thread 0 adds
// clock64() differences per phase of every macro-step (lockstep_vm.cuh's
// K_* words) and writes them at the end of the wave.
//
// Beside it, a pointer chase: one thread follows `steps` dependent loads
// through a buffer (`buf[i]` is the next index), so the wall of the launch
// over `steps` is the card's load-to-use latency for a word that no cache
// holds when the buffer is far larger than L2 and the chain jumps at
// random.

#define LSVM_PHASE_CLOCKS 1
#define LSVM_ENTRY lockstep_vm_launch_clocks
#include "lockstep_vm.cu"

namespace {

__global__ void pointer_chase_kernel(const int64_t* buf, int64_t start,
                                     int64_t steps, int64_t* out) {
  int64_t i = start;
  const long long t0 = clock64();
  for (int64_t s = 0; s < steps; ++s) i = buf[i];
  out[0] = clock64() - t0;
  out[1] = i;
}

}  // namespace

// out: two int64 on the card (the chase's cycles, the last index).
extern "C" int lockstep_vm_pointer_chase(const int64_t* buf, int64_t start,
                                         int64_t steps, int64_t* out,
                                         void* stream) {
  pointer_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, start, steps, out);
  return static_cast<int>(cudaGetLastError());
}
