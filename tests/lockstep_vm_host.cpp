// The lockstep_vm kernel's wave algorithm (lockstep_vm.cuh) run on the
// host: `threads` std::threads play the CUDA block's threads and meet at
// a std::barrier where the kernel calls __syncthreads(); groups of `ws`
// of them play its warps, each group with a barrier of its own for
// __syncwarp() and its ballots, broadcasts, shuffles and sums; the bulk
// copy engine is memcpy; a cluster is several such blocks whose threads
// all meet at one more barrier, block 0's shared memory in reach of all.
// Shared memory is one buffer the threads share, of the words the
// kernel's own plan asks for within `smem_words`, so a small budget sends
// lane state to the global scratch as a long wave does on the card.
// The test suite compiles it with g++ into a shared library and runs it on
// CPU tensors packed by `repro_torch.kernels.lockstep_vm.kernel.pack`, the
// kernel's own operand header, so the same source and the same packing
// are held to the host loop without a card.
//
//     g++ -std=c++20 -O1 -shared -fPIC -pthread -I<csrc> -o lib.so this.cpp
//
// (-DLSVM_PHASE_CLOCKS builds the per-phase clock words too; the host's
// clock is 0, so only the step and serial-lane counts are filled.)

#include <atomic>
#include <barrier>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#include "lockstep_vm.cuh"

namespace {

using namespace lockstep_vm;

struct Warp {
  explicit Warp(int64_t n) : bar(static_cast<std::ptrdiff_t>(n)) {}
  std::barrier<> bar;
  std::atomic<uint64_t> acc[3] = {0, 0, 0};
  std::atomic<uint64_t> ors[3] = {0, 0, 0};
  int64_t val[3] = {0, 0, 0};
  int64_t box[2][64] = {};
};

struct Shared {
  Shared(int64_t n, int64_t w, int64_t words)
      : nt(n), ws(w), bar(static_cast<std::ptrdiff_t>(n)),
        buf(static_cast<size_t>(words) + 2) {
    for (int64_t t = 0; t < n; t += w) {
      warps.emplace_back(new Warp(n - t < w ? n - t : w));
    }
  }
  int64_t nt, ws;
  std::barrier<> bar;
  std::vector<std::unique_ptr<Warp>> warps;
  std::vector<int64_t> buf;
  int64_t* smem() {
    const uintptr_t p = reinterpret_cast<uintptr_t>(buf.data());
    return reinterpret_cast<int64_t*>((p + 15) & ~uintptr_t(15));
  }
};

// A cluster of host blocks: one barrier for all their threads.
struct Cluster {
  Cluster(int64_t blocks, int64_t threads, int64_t ws, int64_t words)
      : bar(static_cast<std::ptrdiff_t>(blocks * threads)) {
    for (int64_t r = 0; r < blocks; ++r) {
      members.emplace_back(new Shared(threads, ws, words));
    }
  }
  std::barrier<> bar;
  std::vector<std::unique_ptr<Shared>> members;
};

struct HostBlock {
  Shared* s;
  int64_t me;
  Cluster* c = nullptr;
  int64_t rank = 0;
  int ballots = 0;
  int bcasts = 0;
  int shfls = 0;
  int reds = 0;
  int64_t tid() const { return me; }
  int64_t nt() const { return s->nt; }
  int64_t ws() const { return s->ws; }
  int64_t warp_size() const {
    const int64_t first = (me / s->ws) * s->ws;
    return s->nt - first < s->ws ? s->nt - first : s->ws;
  }
  Warp& warp() { return *s->warps[static_cast<size_t>(me / s->ws)]; }
  int64_t lane() const { return me % s->ws; }
  void sync() { s->bar.arrive_and_wait(); }
  void warp_sync() { warp().bar.arrive_and_wait(); }
  // the warp's ballots and its broadcasts each rotate over three slots of
  // their own: slot i of the ballots is cleared after every thread of the
  // warp has read it and before any can write it again
  uint64_t warp_ballot(bool p) {
    Warp& w = warp();
    const int i = ballots++ % 3;
    if (p) w.acc[i].fetch_or(uint64_t(1) << lane());
    w.bar.arrive_and_wait();
    const uint64_t r = w.acc[i].load();
    if (lane() == 0) w.acc[(i + 2) % 3].store(0);
    return r;
  }
  int64_t warp_bcast(int64_t x) {
    Warp& w = warp();
    const int i = bcasts++ % 3;
    if (lane() == 0) w.val[i] = x;
    w.bar.arrive_and_wait();
    return w.val[i];
  }
  // a lane's value lands in its slot of one of two boxes: a box is
  // written again only after every lane has passed the next exchange's
  // barrier, so after it read this one
  uint64_t warp_or(uint64_t x) {
    Warp& w = warp();
    const int i = reds++ % 3;
    if (x) w.ors[i].fetch_or(x);
    w.bar.arrive_and_wait();
    const uint64_t r = w.ors[i].load();
    if (lane() == 0) w.ors[(i + 2) % 3].store(0);
    return r;
  }
  // the shuffles and the prefix sums share the two boxes
  uint64_t warp_incl_sum(uint64_t x) {
    Warp& w = warp();
    const int i = shfls++ % 2;
    w.box[i][lane()] = static_cast<int64_t>(x);
    w.bar.arrive_and_wait();
    uint64_t r = 0;
    for (int64_t j = 0; j <= lane(); ++j) {
      r += static_cast<uint64_t>(w.box[i][j]);
    }
    return r;
  }
  int64_t warp_shfl(int64_t x, int from) {
    Warp& w = warp();
    const int i = shfls++ % 2;
    w.box[i][lane()] = x;
    w.bar.arrive_and_wait();
    return w.box[i][from];
  }
  uint64_t atomic_add(uint64_t* p, uint64_t x) {
    return std::atomic_ref<uint64_t>(*p).fetch_add(x);
  }
  void fetch_or(uint64_t* p, uint64_t x) {
    std::atomic_ref<uint64_t>(*p).fetch_or(x);
  }
  int64_t* smem() { return s->smem(); }
  int64_t clock() { return 0; }
  int64_t cluster_rank() const { return rank; }
  int64_t cluster_size() const {
    return c ? static_cast<int64_t>(c->members.size()) : 1;
  }
  void cluster_sync() { c->bar.arrive_and_wait(); }
  int64_t* leader_smem() { return c ? c->members[0]->smem() : smem(); }
  void bulk_init(uint64_t*) {}
  void bulk_load(int64_t* dst, const int64_t* src, int64_t bytes,
                 uint64_t*) {
    std::memcpy(dst, src, static_cast<size_t>(bytes));
  }
  void bulk_wait(uint64_t*, int) {}
  void bulk_store(int64_t* dst, const int64_t* src, int64_t bytes) {
    std::memcpy(dst, src, static_cast<size_t>(bytes));
  }
  void bulk_commit() {}
  void bulk_wait_read() {}
  void bulk_wait_all() {}
  void proxy_fence() {}
};

template <class Fn>
void on_threads(Shared& shared, int64_t threads, Fn fn) {
  std::vector<std::thread> pool;
  for (int64_t t = 0; t < threads; ++t) {
    pool.emplace_back([&shared, &fn, t] {
      HostBlock k{&shared, t};
      fn(k);
    });
  }
  for (auto& th : pool) th.join();
}

template <class Fn>
void on_cluster(Cluster& cl, int64_t threads, Fn fn) {
  std::vector<std::thread> pool;
  for (int64_t r = 0; r < static_cast<int64_t>(cl.members.size()); ++r) {
    for (int64_t t = 0; t < threads; ++t) {
      pool.emplace_back([&cl, &fn, r, t] {
        HostBlock k{cl.members[static_cast<size_t>(r)].get(), t, &cl, r};
        fn(k);
      });
    }
  }
  for (auto& th : pool) th.join();
}

}  // namespace

// One wave: `threads` host threads in warps of `ws` (at most 64), shared
// memory of at most `smem_words` words, `keep` as the kernel's template
// choice, on a cluster of `cluster` blocks (0: as many as the kernel's
// launch picks, cluster_for); `clocks` (kClockWords int64, may be null)
// gets the clock words in a -DLSVM_PHASE_CLOCKS build.  Returns 0, or 1
// for bad arguments and 2 for a budget that cannot hold the staging
// window.
extern "C" int lockstep_vm_host_run(const int64_t* hdr, int64_t n_hdr,
                                    int64_t threads, int64_t ws,
                                    int64_t smem_words, int64_t keep,
                                    int64_t* clocks, int64_t cluster) {
  if (n_hdr != H_COUNT || threads < 1 || threads > kMaxThreads || ws < 1 ||
      ws > 64 || cluster < 0 || cluster > kClusterMax) {
    return 1;
  }
  const Wave w = unpack(hdr);
  if (w.B <= 0) return 0;
  const Plan plan = make_plan(w, threads, ws, smem_words);
  if (plan.stage < 0) return 2;
  if (cluster == 0) cluster = cluster_for(w.B, w.max_window);
  Cluster cl(cluster, threads, ws, plan.words);
  on_cluster(cl, threads, [&](HostBlock& k) {
    if (keep) run_wave<true>(w, plan, k, clocks);
    else run_wave<false>(w, plan, k, clocks);
  });
  return 0;
}

// Where a wave's plan keeps each part: `out` gets the plan's words, ring
// slots, staging, code and table offsets, then one offset a part (-1: the
// global scratch), 5 + kParts words.
extern "C" void lockstep_vm_host_plan(const int64_t* hdr, int64_t threads,
                                      int64_t ws, int64_t smem_words,
                                      int64_t* out) {
  const Plan p = make_plan(unpack(hdr), threads, ws, smem_words);
  out[0] = p.words;
  out[1] = p.ring;
  out[2] = p.stage;
  out[3] = p.code;
  out[4] = p.tabs;
  for (int q = 0; q < kParts; ++q) out[5 + q] = p.part[q];
}

// The conflict sweep alone, over the footprints `iv` (B rows of read
// start, read end, write start, write end; an end at or below its start
// is an empty window), as (a) and (b) of a macro-step mark lanes:
// `serial[b]` is 1 when lane b's own windows meet or the sweep (`sorted`:
// the block's sorted sweep on `threads` host threads, else the pairwise
// one) finds another lane's window meeting it.
extern "C" void lockstep_vm_host_sweep(const int64_t* iv, int64_t B,
                                       int64_t threads, int64_t ws,
                                       int64_t sorted, int64_t* serial) {
  const int64_t N = sort_size(B);
  std::vector<int64_t> foot(4 * B), sort(2 * N), scan(3 * kMaxThreads),
      ctl(kCtlWords * B);
  View v{};
  v.flo = foot.data();
  v.fhi = foot.data() + 2 * B;
  v.skey = sort.data();
  v.sid = sort.data() + N;
  v.scan = scan.data();
  v.ctl = ctl.data();
  v.B = B;
  v.N = N;
  v.nt = threads;
  for (int64_t b = 0; b < B; ++b) {
    int64_t r_lo = iv[4 * b], r_hi = iv[4 * b + 1];
    int64_t w_lo = iv[4 * b + 2], w_hi = iv[4 * b + 3];
    if (r_hi <= r_lo) { r_lo = kBig; r_hi = -kBig; }
    if (w_hi <= w_lo) { w_lo = kBig; w_hi = -kBig; }
    v.flo[2 * b] = r_lo;
    v.fhi[2 * b] = r_hi;
    v.flo[2 * b + 1] = w_lo;
    v.fhi[2 * b + 1] = w_hi;
    ctl[L_FLAG * B + b] = meet(w_lo, w_hi, r_lo, r_hi) ? kSerial : kFree;
  }
  if (sorted) {
    Shared shared(threads, ws, 0);
    on_threads(shared, threads, [&](HostBlock& k) {
      sweep_sorted(k, v);
    });
    for (int64_t b = 0; b < B; ++b) {
      if (v.flo[2 * b] | v.flo[2 * b + 1]) ctl[L_FLAG * B + b] = kSerial;
    }
  } else {
    std::vector<int64_t> hit(B);
    for (int64_t b = 0; b < B; ++b) {
      for (int64_t j = 0; j < B; ++j) hit[b] |= pair_hits(v, b, j);
    }
    for (int64_t b = 0; b < B; ++b) {
      if (hit[b]) ctl[L_FLAG * B + b] = kSerial;
    }
  }
  for (int64_t b = 0; b < B; ++b) serial[b] = ctl[L_FLAG * B + b] == kSerial;
}
