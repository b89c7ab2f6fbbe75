// The tiara_gather kernel's algorithm (tiara_gather.cuh) run on the host:
// the small regime's threads one after another (each is independent), and
// each block of the stream regime's persistent grid as `threads`
// std::threads that meet at a std::barrier where the kernel calls
// __syncthreads_or(), in warps of `ws`; the bulk copy engine is memcpy.
// The blocks run one after another, each on fresh shared memory of the
// words the kernel's plan asks for.  The grid's size, a unit's bytes and
// the ring's slots are arguments, so small inputs can cut windows into
// several units, runs of units across blocks and batches mid-window, and
// wrap the ring many times.
//
// The test suite compiles it with g++ into a shared library and calls it
// on numpy buffers (tests/test_torch_tiara_gather_host.py):
//
//     g++ -std=c++20 -O1 -shared -fPIC -pthread -I<csrc> -o lib.so this.cpp

#include <atomic>
#include <barrier>
#include <cstring>
#include <thread>
#include <vector>

#include "tiara_gather.cuh"

namespace {

using namespace tiara_gather;

struct Shared {
  Shared(int64_t n, int64_t words)
      : nt(n), bar(static_cast<std::ptrdiff_t>(n)),
        buf(static_cast<size_t>(words) + 2) {}
  int64_t nt;
  std::barrier<> bar;
  std::atomic<uint64_t> acc[3] = {0, 0, 0};
  std::vector<int64_t> buf;
  int64_t* smem() {
    const uintptr_t p = reinterpret_cast<uintptr_t>(buf.data());
    return reinterpret_cast<int64_t*>((p + 15) & ~uintptr_t(15));
  }
};

struct HostBlock {
  Shared* s;
  int64_t me;
  int64_t ws_;
  int64_t block;
  int ors = 0;
  int64_t tid() const { return me; }
  int64_t nt() const { return s->nt; }
  int64_t ws() const { return ws_; }
  int64_t cta() const { return block; }
  // the barrier's OR rotates over three words: word i is cleared after
  // every thread has read it and before any can write it again
  bool sync_or(bool p) {
    const int i = ors++ % 3;
    if (p) s->acc[i].fetch_or(1);
    s->bar.arrive_and_wait();
    const bool r = s->acc[i].load() != 0;
    if (me == 0) s->acc[(i + 2) % 3].store(0);
    return r;
  }
  int64_t* smem() { return s->smem(); }
  void bulk_init(uint64_t*) {}
  template <typename T>
  void bulk_load(int64_t* dst, const T* src, int64_t bytes, uint64_t*) {
    std::memcpy(dst, src, static_cast<size_t>(bytes));
  }
  void bulk_wait(uint64_t*, int) {}
  template <typename T>
  void bulk_store(T* dst, const int64_t* src, int64_t bytes) {
    std::memcpy(dst, src, static_cast<size_t>(bytes));
  }
  void bulk_commit() {}
  template <int N>
  void bulk_wait_read() {}
  void bulk_wait_all() {}
  void proxy_fence() {}
};

template <typename T, typename I>
void run(const Args<T, I>& a, int64_t regime, int64_t threads, int64_t ws,
         int64_t blocks_max, int64_t unit_bytes, int64_t slots) {
  if (regime == 0) {
    for (int64_t g = 0; g < a.n * a.width; ++g) small_word(a, g);
    return;
  }
  const Plan p = make_plan(a.n, a.width, static_cast<int64_t>(sizeof(T)),
                           blocks_max, unit_bytes, slots);
  for (int64_t b = 0; b < p.blocks; ++b) {
    Shared shared(threads, smem_words(p, threads));
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < threads; ++t) {
      pool.emplace_back([&, t] {
        HostBlock k{&shared, t, ws, b};
        stream_cta(a, p, k);
      });
    }
    for (auto& th : pool) th.join();
  }
}

template <typename I>
int run_elem(const int64_t* a, int64_t threads, int64_t ws,
             int64_t blocks_max, int64_t unit_bytes, int64_t slots) {
  const int64_t regime = a[A_REGIME];
  switch (a[A_ELEM_BYTES]) {
    case 8:
      run(unpack<uint64_t, I>(a), regime, threads, ws, blocks_max,
          unit_bytes, slots);
      return 0;
    case 4:
      run(unpack<uint32_t, I>(a), regime, threads, ws, blocks_max,
          unit_bytes, slots);
      return 0;
    case 2:
      run(unpack<uint16_t, I>(a), regime, threads, ws, blocks_max,
          unit_bytes, slots);
      return 0;
    default:
      return 1;
  }
}

}  // namespace

// The kernel's launch on host buffers, with the card's launch operands
// (`a`: A_COUNT int64 in tiara_gather.cuh's Operand order, host addresses)
// plus the stream regime's shape: `threads` a block in warps of `ws`
// (threads a multiple of ws), at most `blocks_max` blocks, units of
// `unit_bytes` (a multiple of 16), `slots` ring slots (at least
// kStoreLag + 1, at most 64).  Returns 0, or 1 for bad arguments.
extern "C" int tiara_gather_host_run(const int64_t* a, int64_t n_operands,
                                     int64_t threads, int64_t ws,
                                     int64_t blocks_max, int64_t unit_bytes,
                                     int64_t slots) {
  if (n_operands != A_COUNT) return 1;
  const int64_t regime = a[A_REGIME];
  if (a[A_N] <= 0 || a[A_WIDTH] <= 0) return 0;
  if ((regime != 0 && regime != 1) || threads < 1 || ws < 1 ||
      threads % ws != 0 || blocks_max < 1 || unit_bytes < 16 ||
      unit_bytes % 16 != 0 || unit_bytes < a[A_ELEM_BYTES] ||
      slots < kStoreLag + 1 || slots > 64) {
    return 1;
  }
  switch (a[A_TABLE_BYTES]) {
    case 4: return run_elem<int32_t>(a, threads, ws, blocks_max, unit_bytes,
                                     slots);
    case 8: return run_elem<int64_t>(a, threads, ws, blocks_max, unit_bytes,
                                     slots);
    default: return 1;
  }
}
