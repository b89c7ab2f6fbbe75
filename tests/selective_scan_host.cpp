// The selective scan kernel's arithmetic (selective_scan.cuh) run on the
// host: each block of `threads` channels of one row walks the steps tile by
// tile as the kernel does, `stage_tile` copying the tile's B_t, C_t and
// valid flags into the block's shared words (thread 0 of 1), then each
// channel of the block running the tile's steps (`tile_steps`, which calls
// the kernel's `step`).  The tile's length is an argument, so short inputs
// cut the steps into several tiles and a last partial one.
//
// The test suite compiles it with g++ into a shared library and calls it
// on numpy buffers (tests/test_torch_scan_host.py):
//
//     g++ -std=c++17 -O1 -shared -fPIC -I<csrc> -o lib.so this.cpp

#include <vector>

#include "selective_scan.cuh"

namespace {

using namespace selective_scan;

template <int NS>
void run(const Args& a, int64_t threads, int64_t tile) {
  std::vector<float> bc(static_cast<size_t>(tile * 2 * NS));
  std::vector<uint8_t> ok(static_cast<size_t>(tile));
  std::vector<float> h(static_cast<size_t>(threads * NS));
  std::vector<float> A(static_cast<size_t>(threads * NS));
  for (int64_t b = 0; b < a.B; ++b) {
    for (int64_t d0 = 0; d0 < a.D; d0 += threads) {
      const int64_t nd = a.D - d0 < threads ? a.D - d0 : threads;
      for (int64_t c = 0; c < nd; ++c) {
        load_channel<NS>(a, b, d0 + c,
                         *reinterpret_cast<float(*)[NS]>(&h[c * NS]),
                         *reinterpret_cast<float(*)[NS]>(&A[c * NS]));
      }
      for (int64_t t0 = 0; t0 < a.S; t0 += tile) {
        const int64_t n = a.S - t0 < tile ? a.S - t0 : tile;
        stage_tile<NS>(a, b, t0, n, bc.data(), ok.data(), 0, 1);
        for (int64_t c = 0; c < nd; ++c) {
          tile_steps<NS>(a, b, d0 + c, t0, n, bc.data(), ok.data(),
                         *reinterpret_cast<float(*)[NS]>(&h[c * NS]),
                         *reinterpret_cast<float(*)[NS]>(&A[c * NS]));
        }
      }
      for (int64_t c = 0; c < nd; ++c) {
        store_channel<NS>(a, b, d0 + c,
                          *reinterpret_cast<float(*)[NS]>(&h[c * NS]));
      }
    }
  }
}

}  // namespace

// The kernel's launch on host buffers, with the card's launch operands
// (`ops`: kOpCount int64 in selective_scan.cuh's Operand order, host
// addresses), `threads` channels a block and tiles of `tile` steps.
// Returns 0, or 1 for operands the kernel does not take.
extern "C" int selective_scan_host_run(const int64_t* ops, int64_t n_ops,
                                       int64_t threads, int64_t tile) {
  if (n_ops != kOpCount || threads < 1 || tile < 1) return 1;
  const Args a = unpack(ops);
  if (a.B <= 0 || a.S <= 0 || a.D <= 0) return 1;
  switch (padded_states(a.N)) {
    case 4: run<4>(a, threads, tile); return 0;
    case 8: run<8>(a, threads, tile); return 0;
    case 16: run<16>(a, threads, tile); return 0;
    case 32: run<32>(a, threads, tile); return 0;
    default: return 1;
  }
}
