// Double-indirection window gather for Hopper (sm_90a):
//
//     out[i, w] = pool[base + ((table[id] * stride + w) & mask)],
//                 id = ids[i], base = bases ? bases[id] : 0,
//                 mask = masks ? masks[id] : the scalar mask,  0 <= w < width
//
// pool is flat, table (T,) int32 or int64, ids (n,) int32, bases and masks
// (T,) int64 or null, out (n, width).  Three callers:
//
//   * the row gather `out[i, :] = pool[table[ids[i]], :]` of a (N, R) pool:
//     stride = width = R, mask = -1 (no wrap), bases = null;
//   * the compiled gather chain's memcpy: the pool is the whole engine
//     buffer, bases[id] the pool region's start on the request's home
//     device, table[id] the translated word offset (any alignment),
//     stride = 1, width = the row's words and mask the region's mask, so
//     each word wraps inside the region exactly as the interpreter's
//     MEMCPY does;
//   * the lockstep engine's MEMCPY: one window per lane of the wave, each
//     lane in its own source region, so bases and masks are per lane
//     (stride = 1, width = the wave's widest MEMCPY), and the offsets are
//     int64, as a region may hold 2^31 words or more.
//
// Replaces the Pallas TPU kernel `tiara_gather_kernel`
// (src/repro/kernels/tiara_gather/kernel.py), which resolves both
// indirection levels inside a BlockSpec index_map and DMAs one row per
// grid step.  On the H100 the work is pure data movement (n windows read,
// n written), so it is bound by HBM bytes, never by arithmetic:
//
//   * one CTA per (request, window tile): blockIdx.x is the request, the
//     tile loop over blockIdx.y covers the window;
//   * the indices are loaded once per CTA as scalars (the Pallas scalar
//     prefetch becomes dependent global loads);
//   * a window that does not wrap is copied with 16-byte uint4 vectors
//     when its source, destination and length allow it (every row of the
//     stock translation tables), else word by word; a wrapping window is
//     copied word by word.  The choice is per CTA, uniform across it.
//
// Precondition: every ids[i] lies in [0, T) and every pool index above in
// the pool.  The caller guarantees it (the gather chain masks each offset
// with the region's mask, so it stays inside the region); the kernel does
// not clamp.
//
// Plain C interface, loaded with ctypes: the launch takes raw device
// pointers and the stream, launches on that stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so a refused launch is
// reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
gather_window_kernel(const T* __restrict__ pool,
                     const I* __restrict__ table,
                     const int32_t* __restrict__ ids,
                     const int64_t* __restrict__ bases,
                     const int64_t* __restrict__ masks,
                     T* __restrict__ out, int64_t width, int64_t stride,
                     int64_t mask) {
  const int64_t req = blockIdx.x;
  const int32_t id = ids[req];
  const int64_t base = bases == nullptr ? 0 : bases[id];
  const uint64_t umask =
      static_cast<uint64_t>(masks == nullptr ? mask : masks[id]);
  const uint64_t off =
      static_cast<uint64_t>(static_cast<int64_t>(table[id]) * stride) & umask;
  T* dst = out + req * width;
  const int64_t first = static_cast<int64_t>(blockIdx.y) * blockDim.x +
                        threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.y) * blockDim.x;
  if (off + static_cast<uint64_t>(width - 1) <= umask) {
    const T* src = pool + (base + static_cast<int64_t>(off));
    const int64_t bytes = width * static_cast<int64_t>(sizeof(T));
    const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                            reinterpret_cast<uintptr_t>(dst);
    if (bytes % 16 == 0 && align % 16 == 0) {
      const uint4* s = reinterpret_cast<const uint4*>(src);
      uint4* d = reinterpret_cast<uint4*>(dst);
      for (int64_t v = first; v < bytes / 16; v += step) d[v] = s[v];
    } else {
      for (int64_t w = first; w < width; w += step) dst[w] = src[w];
    }
  } else {
    for (int64_t w = first; w < width; w += step) {
      dst[w] = pool[base + static_cast<int64_t>(
                               (off + static_cast<uint64_t>(w)) & umask)];
    }
  }
}

template <typename T, typename I>
cudaError_t launch(const void* pool, const I* table,
                   const int32_t* ids, const int64_t* bases,
                   const int64_t* masks, void* out, int64_t n_req,
                   int64_t width, int64_t stride, int64_t mask,
                   cudaStream_t stream) {
  // enough tiles for the vector copy; the word loops stride over the rest
  const int64_t vecs = (width * static_cast<int64_t>(sizeof(T)) + 15) / 16;
  int64_t tiles = (vecs + kThreads - 1) / kThreads;
  if (tiles > 65535) tiles = 65535;
  if (tiles < 1) tiles = 1;
  dim3 grid(static_cast<unsigned>(n_req), static_cast<unsigned>(tiles));
  gather_window_kernel<T, I><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(pool), table, ids, bases, masks,
      static_cast<T*>(out), width, stride, mask);
  return cudaGetLastError();
}

template <typename I>
int launch_elem(const void* pool, const I* table, const int32_t* ids,
                const int64_t* bases, const int64_t* masks, void* out,
                int64_t n_req, int64_t width, int64_t stride, int64_t mask,
                int64_t elem_bytes, cudaStream_t s) {
  switch (elem_bytes) {
    case 8:
      return static_cast<int>(launch<uint64_t, I>(
          pool, table, ids, bases, masks, out, n_req, width, stride, mask,
          s));
    case 4:
      return static_cast<int>(launch<uint32_t, I>(
          pool, table, ids, bases, masks, out, n_req, width, stride, mask,
          s));
    case 2:
      return static_cast<int>(launch<uint16_t, I>(
          pool, table, ids, bases, masks, out, n_req, width, stride, mask,
          s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// table_bytes is 4 (int32 table) or 8 (int64); elem_bytes the pool's.
extern "C" int tiara_gather_launch(const void* pool, const void* table,
                                   int64_t table_bytes, const int32_t* ids,
                                   const int64_t* bases,
                                   const int64_t* masks, void* out,
                                   int64_t n_req, int64_t width,
                                   int64_t stride, int64_t mask,
                                   int64_t elem_bytes, void* stream) {
  if (n_req <= 0 || width <= 0) return static_cast<int>(cudaSuccess);
  if (n_req > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_bytes) {
    case 4:
      return launch_elem(pool, static_cast<const int32_t*>(table), ids,
                         bases, masks, out, n_req, width, stride, mask,
                         elem_bytes, s);
    case 8:
      return launch_elem(pool, static_cast<const int64_t*>(table), ids,
                         bases, masks, out, n_req, width, stride, mask,
                         elem_bytes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
