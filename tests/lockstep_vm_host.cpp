// The lockstep_vm kernel's wave algorithm (lockstep_vm.cuh) run on the
// host: `threads` std::threads play the CUDA block's threads and meet at
// a std::barrier where the kernel calls __syncthreads().  Shared memory
// is one vector the threads share.  The test suite compiles it with g++
// into a shared library and runs it on CPU tensors packed by
// `repro_torch.kernels.lockstep_vm.kernel.pack`, the kernel's own
// operand header, so the same source and the same packing are held to
// the host loop without a card.
//
//     g++ -std=c++20 -O1 -shared -fPIC -pthread -I<csrc> -o lib.so this.cpp

#include <atomic>
#include <barrier>
#include <thread>
#include <vector>

#include "lockstep_vm.cuh"

namespace {

using namespace lockstep_vm;

struct Shared {
  explicit Shared(int64_t n, int64_t words)
      : nt(n), bar(static_cast<std::ptrdiff_t>(n)), stage(words) {}
  int64_t nt;
  std::barrier<> bar;
  std::vector<int64_t> stage;
  int ncopy = 0;
  int64_t desc[kDescWords] = {};
  std::atomic<int> acc[3] = {0, 0, 0};
};

struct HostBlock {
  Shared* s;
  int64_t me;
  int calls = 0;
  int64_t tid() const { return me; }
  int64_t nt() const { return s->nt; }
  void sync() { s->bar.arrive_and_wait(); }
  // three slots: slot i is cleared after every thread has read it and
  // before any thread can write it again
  int sync_or(int p) {
    const int i = calls++ % 3;
    if (p) s->acc[i].fetch_or(1);
    s->bar.arrive_and_wait();
    const int r = s->acc[i].load();
    if (me == 0) s->acc[(i + 2) % 3].store(0);
    return r;
  }
  int64_t claim(int* c) {
    return std::atomic_ref<int>(*c).fetch_add(1);
  }
  int64_t* stage() { return s->stage.data(); }
  int* ncopy() { return &s->ncopy; }
  int64_t* desc() { return s->desc; }
};

}  // namespace

extern "C" int lockstep_vm_host_run(const int64_t* hdr, int64_t n_hdr,
                                    int64_t threads) {
  if (n_hdr != H_COUNT || threads < 1) return 1;
  const Wave w = unpack(hdr);
  if (w.B <= 0) return 0;
  const int64_t words = w.max_window > 4 * threads ? w.max_window
                                                   : 4 * threads;
  Shared shared(threads, words);
  std::vector<std::thread> pool;
  for (int64_t t = 0; t < threads; ++t) {
    pool.emplace_back([&shared, &w, t] {
      HostBlock k{&shared, t};
      run_wave(w, k);
    });
  }
  for (auto& th : pool) th.join();
  return 0;
}
