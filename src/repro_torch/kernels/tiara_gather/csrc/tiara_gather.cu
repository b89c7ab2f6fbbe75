// Double-indirection window gather for Hopper (sm_90a):
//
//     out[i, w] = pool[base + ((table[id] * stride + w) & mask)],
//                 id = ids ? ids[i] : i, base = bases ? bases[id] : 0,
//                 mask = masks ? masks[id] : the scalar mask,  0 <= w < width
//
// pool is flat, table (T,) int32 or int64, ids (n,) int32 or null (entry i
// is id i: the engines' callers), bases and masks (T,) int64 or null, out
// (n, width).  Three callers:
//
//   * the row gather `out[i, :] = pool[table[ids[i]], :]` of a (N, R) pool:
//     stride = width = R, mask = -1 (no wrap), bases = null;
//   * the compiled gather chain's memcpy and every traced MEMCPY: the pool
//     is the whole engine buffer, bases[i] the region's start on the
//     request's home device, table[i] the translated word offset (any
//     alignment), stride = 1, width = the row's words and mask the
//     region's mask, so each word wraps inside the region exactly as the
//     interpreter's MEMCPY does; no ids;
//   * the lockstep engine's host loop and the sharded engine's owner
//     reads: one window per lane, each lane in its own source region, so
//     bases and masks are per lane, and the offsets are int64, as a region
//     may hold 2^31 words or more; no ids.
//
// Replaces the Pallas TPU kernel `tiara_gather_kernel`
// (src/repro/kernels/tiara_gather/kernel.py), which resolves both
// indirection levels inside a BlockSpec index_map and DMAs one row per
// grid step.  On the H100 the work is pure data movement, so it is bound
// by HBM bytes for long windows and by the latency of its dependent loads
// (ids -> table -> pool) for the resolvers' one-word windows, never by
// arithmetic.  The algorithm is in tiara_gather.cuh; this file launches
// it:
//
//   * the small regime (width <= kSmallMaxWidth): one thread per (entry,
//     word) over ceil(n * width / 256) blocks of 256, no tile dimension;
//   * the stream regime: a persistent grid of kBlocksPerSm blocks per SM
//     (capped by the copy units), each walking a contiguous run of units,
//     indices loaded a batch ahead into shared memory, aligned interiors
//     through a ring of kRingSlots slots of 8 KiB with cp.async.bulk
//     (global -> shared on an mbarrier, shared -> global in a bulk group),
//     the rest by warps in 16-byte vectors or element by element.
//
// The caller picks the regime (the wrapper does, from width).
//
// Precondition: every ids[i] lies in [0, T) and every pool index above in
// the pool.  The caller guarantees it (the engines mask each offset with
// the region's mask, so it stays inside the region); the kernel does not
// clamp.
//
// Plain C interface, loaded with ctypes: the launch takes one host array
// of int64 operands (tiara_gather.cuh's Operand order: device pointers and
// sizes) and the stream, launches on that stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so a refused launch is
// reported at once.  `tiara_gather_empty` launches an empty kernel of the
// same library (the launch floor the measurements stand beside), and
// `tiara_gather_config` reports the launch's constants.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tiara_gather.cuh"

namespace {

using namespace tiara_gather;

struct CudaBlock {
  int64_t* smem_;
  __device__ __forceinline__ int64_t tid() const { return threadIdx.x; }
  __device__ __forceinline__ int64_t nt() const { return kThreads; }
  __device__ __forceinline__ int64_t ws() const { return 32; }
  __device__ __forceinline__ int64_t cta() const { return blockIdx.x; }
  __device__ __forceinline__ bool sync_or(bool p) const {
    return __syncthreads_or(p) != 0;
  }
  __device__ __forceinline__ int64_t* smem() const { return smem_; }

  // --- the bulk copy engine (thread 0) ---
  static __device__ __forceinline__ uint32_t sa(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
  }
  __device__ __forceinline__ void bulk_init(uint64_t* bar) const {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(sa(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  template <typename T>
  __device__ __forceinline__ void bulk_load(int64_t* dst, const T* src,
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
        "TG_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra TG_DONE;\n"
        "bra TG_WAIT;\n"
        "TG_DONE:\n"
        "}\n"
        :: "r"(sa(bar)), "r"(parity) : "memory");
  }
  template <typename T>
  __device__ __forceinline__ void bulk_store(T* dst, const int64_t* src,
                                             int64_t bytes) const {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group "
                 "[%0], [%1], %2;\n"
                 :: "l"(dst), "r"(sa(src)),
                    "r"(static_cast<uint32_t>(bytes)) : "memory");
  }
  __device__ __forceinline__ void bulk_commit() const {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  template <int N>
  __device__ __forceinline__ void bulk_wait_read() const {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N)
                 : "memory");
  }
  __device__ __forceinline__ void bulk_wait_all() const {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  __device__ __forceinline__ void proxy_fence() const {
    asm volatile("fence.proxy.async;\n" ::: "memory");
  }
};

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
tiara_gather_small_kernel(const Args<T, I> a) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (g < a.n * a.width) small_word(a, g);
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
tiara_gather_stream_kernel(const Args<T, I> a, const Plan p) {
  extern __shared__ __align__(128) int64_t smem[];
  CudaBlock k{smem};
  stream_cta(a, p, k);
}

__global__ void tiara_gather_empty_kernel() {}

// the shared memory of a stream block, in bytes (smem_words' layout)
constexpr int64_t kSmemBytes =
    (16 + kRingSlots * (kUnitBytes / 8) + 2 * kThreads * kUnitWords) * 8;

// each device's SM count (asked once per device)
int sm_count(int dev) {
  static int counts[64] = {};
  if (dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess) {
      return 0;
    }
    counts[dev] = n;
  }
  return counts[dev];
}

template <typename T, typename I>
cudaError_t launch(const Args<T, I>& a, int64_t regime,
                   cudaStream_t stream) {
  if (regime == 0) {
    const int64_t blocks = (a.n * a.width + kThreads - 1) / kThreads;
    if (blocks > 2147483647LL) return cudaErrorInvalidValue;
    tiara_gather_small_kernel<T, I>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  // the dynamic shared memory above 48 KB, once per device
  static uint64_t ready = 0;
  int dev = 0;
  const cudaError_t ge = cudaGetDevice(&dev);
  if (ge != cudaSuccess) return ge;
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (!(ready & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        tiara_gather_stream_kernel<T, I>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (e != cudaSuccess) return e;
    ready |= bit;
  }
  const int sms = sm_count(dev);
  if (sms <= 0) return cudaErrorInvalidDevice;
  const Plan p = make_plan(a.n, a.width, static_cast<int64_t>(sizeof(T)),
                           kBlocksPerSm * sms, kUnitBytes, kRingSlots);
  tiara_gather_stream_kernel<T, I>
      <<<static_cast<unsigned>(p.blocks), kThreads,
         static_cast<size_t>(kSmemBytes), stream>>>(a, p);
  return cudaGetLastError();
}

template <typename I>
int launch_elem(const int64_t* a, cudaStream_t s) {
  const int64_t regime = a[A_REGIME];
  switch (a[A_ELEM_BYTES]) {
    case 8:
      return static_cast<int>(launch(unpack<uint64_t, I>(a), regime, s));
    case 4:
      return static_cast<int>(launch(unpack<uint32_t, I>(a), regime, s));
    case 2:
      return static_cast<int>(launch(unpack<uint16_t, I>(a), regime, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// a: A_COUNT int64 operands in tiara_gather.cuh's Operand order (host
// memory); n_operands must be A_COUNT.
extern "C" int tiara_gather_launch(const int64_t* a, int64_t n_operands,
                                   void* stream) {
  if (n_operands != A_COUNT) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = a[A_N], width = a[A_WIDTH], regime = a[A_REGIME];
  if (n <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  if (n > 2147483647LL || (regime != 0 && regime != 1) ||
      (regime == 0 && width > kSmallMaxWidth)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a[A_TABLE_BYTES]) {
    case 4: return launch_elem<int32_t>(a, s);
    case 8: return launch_elem<int64_t>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// An empty kernel of this library on `stream`: the launch floor.
extern "C" int tiara_gather_empty(void* stream) {
  tiara_gather_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The launch's constants: threads a block, the small regime's widest
// window, a unit's bytes, ring slots, blocks per SM, a stream block's
// shared memory in bytes.
extern "C" void tiara_gather_config(int64_t* out) {
  out[0] = kThreads;
  out[1] = kSmallMaxWidth;
  out[2] = kUnitBytes;
  out[3] = kRingSlots;
  out[4] = kBlocksPerSm;
  out[5] = kSmemBytes;
}
