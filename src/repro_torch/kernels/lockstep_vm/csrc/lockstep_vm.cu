// The lockstep Tiara engine on Hopper (sm_90a): one launch runs a whole
// wave, from the first macro-step to the last, on the card.
//
// Replaces, on the port's main path, the JAX engines' one device program
// per wave: the `lax.while_loop` of `src/repro/core/vm.py` (the dense
// engine's run at :1122, its nested loop pops at :548 and :567; the
// sharded engine's at :1297, inside `shard_map` at :1306 and `jax.jit` at
// :1314), whose MEMCPY is the window form of the Pallas kernel
// `tiara_gather_kernel` (`src/repro/kernels/tiara_gather/kernel.py:28`).
// The sharded wave runs here when every shard's row lies on this card:
// the kernel addresses the pool through a table of row addresses, so the
// shards' rows stay separate buffers, and runs the live lanes in arrival
// order, which is the sharded engine's contract.  The port's host loops
// (`core/vm.py`, `_Engine.run_host_loop` and
// `_ShardedEngine.run_host_loop`) are its plain versions: they end every
// macro-step in a host read of a few flags and launch dozens of small
// kernels a step, `tiara_gather`'s window form among them (the sharded one
// also makes its collectives).  Here no host read happens until the
// caller retires the wave.
//
// What bounds it on this card: neither bytes nor operations.  A
// macro-step is a chain of dependent accesses (the lane's pc, its
// instruction, its registers, the word a LOAD reads) and a few block
// barriers, so a step costs latency whatever the wave's bytes.  The design
// keeps that chain on chip and short (lockstep_vm.cuh has the phases and
// the exactness argument):
//
//   * ONE thread block runs the algorithm, lanes over threads (lane b
//     owned by thread b % threads); a wave whose lanes' owners all sit in
//     warp 0 runs its decode, sweep and free steps in that warp and meets
//     the block at two barriers a macro-step;
//   * the instruction store, the region table and the lanes' state live
//     in shared memory as far as the 227 KB allow (`make_plan`), the rest
//     in the global scratch; outputs are written once, at the end;
//   * the conflict sweep is pairwise inside warp 0 or a sorted sweep over
//     the block; serial lanes replay in one warp, beside the copies;
//   * queued MEMCPY windows are copied in 4 KiB units claimed by warps
//     (16-byte vectors) and by one producer thread through a ring of
//     shared slots with the bulk copy engine (cp.async.bulk, completing
//     on mbarriers), several units in flight;
//   * a wave of at least 256 lanes whose windows are queued runs on a
//     cluster of 8 blocks: the 7 others claim copy units from block 0's
//     queue through distributed shared memory (`mapa`) between two
//     cluster barriers a macro-step, so its copies run on 8 SMs.
//
// Two builds of the block: up to 256 threads, with the decoded operands
// kept in registers from the footprint phase to the step phase; up to
// 512 threads (at most 128 registers a thread), decoding them again.  (A
// 1024-thread build, at 64 registers, spilled eight times the bytes and
// ran the waves of 512 to 1500 lanes slower on an H100.)
//
// Plain C interface, loaded with ctypes: the launch takes one host array
// of int64 operands (lockstep_vm.cuh's Hdr order: device pointers and
// sizes) and the stream, launches on that stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so a refused launch
// is reported at once.  `lockstep_vm_clocks.cu` builds the same source
// again with per-phase clocks, under another entry.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lockstep_vm.cuh"

#ifndef LSVM_ENTRY
#define LSVM_ENTRY lockstep_vm_launch
#endif

namespace {

using namespace lockstep_vm;

// the shared memory a block may take on Hopper (227 KB)
constexpr int64_t kSmemBytes = 232448;

struct CudaBlock {
  int64_t* smem_;
  __device__ __forceinline__ int64_t tid() const { return threadIdx.x; }
  __device__ __forceinline__ int64_t nt() const { return blockDim.x; }
  __device__ __forceinline__ int64_t ws() const { return 32; }
  __device__ __forceinline__ int64_t warp_size() const { return 32; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
  __device__ __forceinline__ void warp_sync() const { __syncwarp(); }
  __device__ __forceinline__ uint64_t warp_ballot(bool p) const {
    return __ballot_sync(0xffffffffu, p);
  }
  __device__ __forceinline__ int64_t warp_bcast(int64_t x) const {
    return __shfl_sync(0xffffffffu, static_cast<long long>(x), 0);
  }
  __device__ __forceinline__ int64_t warp_shfl(int64_t x, int from) const {
    return __shfl_sync(0xffffffffu, static_cast<long long>(x), from);
  }
  __device__ __forceinline__ uint64_t warp_or(uint64_t x) const {
    return __reduce_or_sync(0xffffffffu, static_cast<unsigned>(x));
  }
  __device__ __forceinline__ uint64_t warp_incl_sum(uint64_t x) const {
    const int lane = static_cast<int>(threadIdx.x % 32);
    for (int d = 1; d < 32; d <<= 1) {
      const uint64_t y = __shfl_up_sync(
          0xffffffffu, static_cast<unsigned long long>(x), d);
      if (lane >= d) x += y;
    }
    return x;
  }
  __device__ __forceinline__ uint64_t atomic_add(uint64_t* p,
                                                 uint64_t x) const {
    return atomicAdd(reinterpret_cast<unsigned long long*>(p),
                     static_cast<unsigned long long>(x));
  }
  __device__ __forceinline__ void fetch_or(uint64_t* p, uint64_t x) const {
    atomicOr(reinterpret_cast<unsigned long long*>(p),
             static_cast<unsigned long long>(x));
  }
  __device__ __forceinline__ int64_t* smem() const { return smem_; }

  // --- the cluster (a wave's copy helpers) ---
  __device__ __forceinline__ int64_t cluster_rank() const {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
  }
  __device__ __forceinline__ int64_t cluster_size() const {
    unsigned n;
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
    return n;
  }
  __device__ __forceinline__ void cluster_sync() const {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
  __device__ __forceinline__ int64_t* leader_smem() const {
    uint64_t out;
    asm volatile("mapa.u64 %0, %1, 0;\n"
                 : "=l"(out) : "l"(reinterpret_cast<uint64_t>(smem_)));
    return reinterpret_cast<int64_t*>(out);
  }
  __device__ __forceinline__ int64_t clock() const { return clock64(); }

  // --- the bulk copy engine (one producer thread) ---
  static __device__ __forceinline__ uint32_t sa(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
  }
  __device__ __forceinline__ void bulk_init(uint64_t* bar) const {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(sa(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __device__ __forceinline__ void bulk_load(int64_t* dst, const int64_t* src,
                                            int64_t bytes,
                                            uint64_t* bar) const {
    const uint32_t b = sa(bar), n = static_cast<uint32_t>(bytes);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(n) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(sa(dst)), "l"(src), "r"(n), "r"(b) : "memory");
  }
  __device__ __forceinline__ void bulk_wait(uint64_t* bar,
                                            int parity) const {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n"
        :: "r"(sa(bar)), "r"(parity) : "memory");
  }
  __device__ __forceinline__ void bulk_store(int64_t* dst,
                                             const int64_t* src,
                                             int64_t bytes) const {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group "
                 "[%0], [%1], %2;\n"
                 :: "l"(dst), "r"(sa(src)),
                    "r"(static_cast<uint32_t>(bytes)) : "memory");
  }
  __device__ __forceinline__ void bulk_commit() const {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  __device__ __forceinline__ void bulk_wait_read() const {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
  __device__ __forceinline__ void bulk_wait_all() const {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  __device__ __forceinline__ void proxy_fence() const {
    asm volatile("fence.proxy.async;\n" ::: "memory");
  }
};

template <int kThreads, bool Keep>
__global__ void __launch_bounds__(kThreads, 1)
lockstep_vm_kernel(const Wave w, const Plan plan, int64_t* clocks) {
  extern __shared__ __align__(16) int64_t smem[];
  CudaBlock k{smem};
  run_wave<Keep>(w, plan, k, clocks);
}

template <int kThreads, bool Keep>
cudaError_t launch(const Wave& w, int64_t threads, cudaStream_t stream,
                   int64_t* clocks) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        lockstep_vm_kernel<kThreads, Keep>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const Plan plan = make_plan(w, threads, 32, kSmemBytes / 8);
  if (plan.stage < 0) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(plan.words) * sizeof(int64_t);
  const unsigned cluster =
      static_cast<unsigned>(cluster_for(w.B, w.max_window));
  if (cluster == 1) {
    lockstep_vm_kernel<kThreads, Keep>
        <<<1, static_cast<unsigned>(threads), smem, stream>>>(w, plan,
                                                              clocks);
    return cudaGetLastError();
  }
  // a cluster of `cluster` blocks, one wave: block 0 runs it, the others
  // help with its copies
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, lockstep_vm_kernel<kThreads, Keep>, w,
                            plan, clocks);
}

}  // namespace

// hdr: H_COUNT int64 operands in lockstep_vm.cuh's Hdr order (host
// memory); threads: the block's size, a multiple of 32 up to 512;
// (the clocks build) clocks: kClockWords int64 on the card.
extern "C" int LSVM_ENTRY(const int64_t* hdr, int64_t n_hdr, int64_t threads,
                          void* stream
#ifdef LSVM_PHASE_CLOCKS
                          , int64_t* clocks
#endif
                          ) {
#ifndef LSVM_PHASE_CLOCKS
  int64_t* clocks = nullptr;
#endif
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = threads <= 256
                            ? launch<256, true>(w, threads, s, clocks)
                            : launch<kMaxThreads, false>(w, threads, s,
                                                         clocks);
  return static_cast<int>(e);
}
