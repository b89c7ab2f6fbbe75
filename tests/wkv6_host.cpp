// The wkv6 kernel's arithmetic (wkv6.cuh) run on the host: each head's
// block walks the steps tile by tile as the kernel does, `stage_tile`
// copying the tile's r, k, v and w rows into the block's shared words in
// the kernel's layout (the block's threads one after another, an
// assignment for the async copy;
// the padding past K zeroed once, as the kernel zeroes it), the tile's
// flags staged beside them, then each of the block's column groups
// running the tile's steps over its row blocks (`tile_steps`, which calls
// the kernel's `block_step` and `combine`).  The tile's length is an
// argument, so short inputs cut the steps into several tiles and a last
// partial one.
//
// The test suite compiles it with g++ into a shared library and calls it
// on numpy buffers (tests/test_torch_scan_host.py):
//
//     g++ -std=c++17 -O1 -shared -fPIC -I<csrc> -o lib.so this.cpp

#include <vector>

#include "wkv6.cuh"

namespace {

using namespace wkv6;

struct Assign {
  void operator()(float* dst, const float* src) const { *dst = *src; }
};

template <int HS>
void run(const Args& a, int64_t tile_n) {
  using L = Shape<HS>;
  constexpr int P = L::kParts;
  using Group = float[P][kBlock][kBlock];
  std::vector<float> tile(static_cast<size_t>(tile_n * L::kStepWords));
  std::vector<uint8_t> ok(static_cast<size_t>(tile_n));
  std::vector<Group> s(P);
  float u[P][kBlock];
  for (int64_t bh = 0; bh < a.B * a.H; ++bh) {
    const int64_t b = bh / a.H;
    for (auto& x : tile) x = 0.0f;
    for (int g = 0; g < P; ++g) {
      for (int p = 0; p < P; ++p) load_block(a, bh, g, p, s[g][p], u[p]);
    }
    for (int64_t t0 = 0; t0 < a.S; t0 += tile_n) {
      const int64_t n = a.S - t0 < tile_n ? a.S - t0 : tile_n;
      for (int tid = 0; tid < L::kThreads; ++tid) {
        stage_tile<HS>(a, bh, t0, n, tile.data(), tid, L::kThreads,
                       Assign{});
      }
      for (int64_t jj = 0; jj < n; ++jj) ok[jj] = flag(a, b, t0 + jj);
      for (int g = 0; g < P; ++g) {
        tile_steps<HS>(a, bh, g, t0, n, tile.data(), ok.data(), s[g], u);
      }
    }
    for (int g = 0; g < P; ++g) {
      for (int p = 0; p < P; ++p) store_block(a, bh, g, p, s[g][p]);
    }
  }
}

}  // namespace

// The kernel's launch on host buffers, with the card's launch operands
// (`ops`: kOpCount int64 in wkv6.cuh's Operand order, host addresses) and
// tiles of `tile` steps.  Returns 0, or 1 for operands the kernel does
// not take.
extern "C" int wkv6_host_run(const int64_t* ops, int64_t n_ops,
                             int64_t tile) {
  if (n_ops != kOpCount || tile < 1) return 1;
  const Args a = unpack(ops);
  if (a.B <= 0 || a.S <= 0 || a.H <= 0) return 1;
  switch (padded_head(a.K)) {
    case 16: run<16>(a, tile); return 0;
    case 32: run<32>(a, tile); return 0;
    case 64: run<64>(a, tile); return 0;
    default: return 1;
  }
}
