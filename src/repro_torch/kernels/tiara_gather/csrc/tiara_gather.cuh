// The tiara_gather algorithm, written once for any "block" of cooperating
// threads:
//
//     out[i, w] = pool[base + ((table[id] * stride + w) & mask)],
//                 id = ids ? ids[i] : i, base = bases ? bases[id] : 0,
//                 mask = masks ? masks[id] : the scalar mask,  0 <= w < width
//
// Every output element is a copy of one pool element, so the result is the
// plain version's bit for bit whatever the order of the copies.  Two
// regimes, chosen by the caller from (n, width):
//
//   * the small regime (width <= kSmallMaxWidth): one thread per (entry,
//     word), `small_word`; each thread loads the indices it needs itself,
//     so the chain is ids (when given) -> table, bases and masks side by
//     side -> the pool word;
//   * the stream regime (longer windows): a persistent grid, `stream_cta`.
//     Each window is cut into copy units of at most `unit_elems` elements
//     (one ring slot), the n * cpe units are split into one contiguous run
//     per block, and a block walks its run in batches of nt() units, one
//     unit a thread.  A batch's indices are loaded into shared memory a
//     batch ahead of its copies, the ids two batches ahead, every load of a
//     batch in flight together.  A unit whose window neither wraps its
//     region nor is misaligned against its destination (mod 16 bytes)
//     sends its aligned interior through the bulk copy engine: thread 0
//     loads it into a ring slot (completing on the slot's mbarrier) and
//     stores it from there (a bulk group), several units in flight; the
//     unit's first and last few elements, and every other unit, are copied
//     by the other warps: 16-byte vectors, four in flight a thread, where
//     source and destination agree mod 16, element by element otherwise
//     and where the window wraps.
//
// Integer index arithmetic is done in uint64_t, so it wraps as the hardware
// does; a mask of all ones (~0) in a unit's shared words marks a window
// that does not wrap.
//
// `Block` supplies tid(), nt(), ws() (the warp's width), cta() (the block's
// index in the grid), sync_or(bool) (a block barrier that returns whether
// any thread passed true), smem(), and the bulk copy hooks (bulk_init, bulk_load,
// bulk_wait, bulk_store, bulk_commit, bulk_wait_read<N>, bulk_wait_all,
// proxy_fence).  `csrc/tiara_gather.cu` instantiates it with a CUDA thread
// block; the header also compiles as plain C++ (no __CUDACC__), where host
// threads meeting at barriers and memcpy for the bulk copies run the same
// code (`tests/tiara_gather_host.cpp`).

#pragma once

#include <stdint.h>

// TG_FN marks the code the CUDA kernels run: device functions under nvcc,
// plain functions in the C++ build; TG_HD what the launch (host) uses too.
#ifdef __CUDACC__
#define TG_FN __device__ __forceinline__
#define TG_HD __host__ __device__ inline
#else
#define TG_FN inline
#define TG_HD inline
#endif

namespace tiara_gather {

// threads of a block, in both regimes
constexpr int64_t kThreads = 256;
// windows of at most this many elements take the small regime
constexpr int64_t kSmallMaxWidth = 32;
// a copy unit's bytes: one slot of the bulk copy ring
constexpr int64_t kUnitBytes = 8192;
// slots of the bulk copy ring of a block
constexpr int64_t kRingSlots = 8;
// stores a slot's refill lets stay in flight (cp.async.bulk.wait_group.read)
constexpr int kStoreLag = 2;
// blocks of the persistent grid per SM
constexpr int64_t kBlocksPerSm = 2;
// a unit's aligned interior goes through the bulk copy engine from this
// many bytes on
constexpr int64_t kBulkMinBytes = 128;

// a unit's words in shared memory: destination element of the window's
// first element, source base, masked source offset, source mask (~0: no
// wrap), the unit's window elements [w0, w1), its bulk interior [a0, a1)
// (a0 = -1: no bulk copy)
enum : int64_t {
  U_DST = 0, U_BASE, U_OFF, U_MASK, U_W0, U_W1, U_A0, U_A1, kUnitWords
};

#ifdef __CUDACC__
typedef uint4 vec16_t;
#else
struct alignas(16) vec16_t {
  uint64_t x, y;
};
#endif

// One launch's operands, packed by the wrapper as int64 in this order
// (kernel.py's OPERANDS): pointers are device addresses (host addresses in
// the plain C++ build), 0 for an absent ids, bases or masks; table_bytes 4
// or 8, elem_bytes the pool's, regime 0 (small) or 1 (stream).
enum Operand : int64_t {
  A_POOL = 0, A_TABLE, A_TABLE_BYTES, A_IDS, A_BASES, A_MASKS, A_OUT, A_N,
  A_WIDTH, A_STRIDE, A_MASK, A_ELEM_BYTES, A_REGIME, A_COUNT
};

template <typename T, typename I>
struct Args {
  const T* pool;
  const I* table;
  const int32_t* ids;      // null: entry i is id i
  const int64_t* bases;    // null: every base is 0
  const int64_t* masks;    // null: every mask is `mask`
  T* out;
  int64_t n;
  int64_t width;
  int64_t stride;
  int64_t mask;
};

template <typename T, typename I>
TG_HD Args<T, I> unpack(const int64_t* a) {
  return Args<T, I>{reinterpret_cast<const T*>(a[A_POOL]),
                    reinterpret_cast<const I*>(a[A_TABLE]),
                    reinterpret_cast<const int32_t*>(a[A_IDS]),
                    reinterpret_cast<const int64_t*>(a[A_BASES]),
                    reinterpret_cast<const int64_t*>(a[A_MASKS]),
                    reinterpret_cast<T*>(a[A_OUT]), a[A_N], a[A_WIDTH],
                    a[A_STRIDE], a[A_MASK]};
}

// The stream regime's cut of one launch (made on the host).
struct Plan {
  int64_t unit_elems;   // elements of a unit
  int64_t cpe;          // units per window
  int64_t units;        // n * cpe
  int64_t blocks;       // the grid
  int64_t slots;        // ring slots
  int64_t slot_words;   // int64 words of a slot
};

TG_HD Plan make_plan(int64_t n, int64_t width, int64_t elem_bytes,
                     int64_t blocks_max, int64_t unit_bytes, int64_t slots) {
  Plan p;
  p.unit_elems = unit_bytes / elem_bytes;
  p.cpe = (width + p.unit_elems - 1) / p.unit_elems;
  p.units = n * p.cpe;
  p.blocks = p.units < blocks_max ? p.units : blocks_max;
  p.slots = slots;
  p.slot_words = unit_bytes / 8;
  return p;
}

// shared memory of a block of `nt` threads: the ring's mbarriers (16 words,
// so the slots start 128-byte aligned), its slots, then two batches of
// unit words
TG_HD int64_t mbar_words() { return 16; }
TG_HD int64_t smem_words(const Plan& p, int64_t nt) {
  return mbar_words() + p.slots * p.slot_words + 2 * nt * kUnitWords;
}

struct Src {
  int64_t base;
  uint64_t off;
  uint64_t mask;
};

template <typename T, typename I>
TG_FN Src source(const Args<T, I>& a, int64_t id) {
  Src s;
  s.mask = static_cast<uint64_t>(a.masks ? a.masks[id] : a.mask);
  s.base = a.bases ? a.bases[id] : 0;
  s.off = static_cast<uint64_t>(static_cast<int64_t>(a.table[id]) *
                                a.stride) & s.mask;
  return s;
}

// --- the small regime: thread g copies element g of the (n, width) output -
template <typename T, typename I>
TG_FN void small_word(const Args<T, I>& a, int64_t g) {
  int64_t e, w;
  if (a.width == 1) {
    e = g;
    w = 0;
  } else if (a.n * a.width <= 0xffffffffLL) {
    // 32-bit division where it suffices (64-bit `/` runs in software)
    const uint32_t q = static_cast<uint32_t>(g) /
                       static_cast<uint32_t>(a.width);
    e = q;
    w = g - e * a.width;
  } else {
    e = g / a.width;
    w = g - e * a.width;
  }
  const int64_t id = a.ids ? a.ids[e] : e;
  const Src s = source(a, id);
  a.out[g] = a.pool[s.base + static_cast<int64_t>(
                                 (s.off + static_cast<uint64_t>(w)) & s.mask)];
}

// --- the stream regime ------------------------------------------------------

// the entry of unit u (u < u1), and its id; e = -1 past the run
template <typename T, typename I>
TG_FN void unit_entry(const Args<T, I>& a, const Plan& p, int64_t u,
                      int64_t u1, int64_t& e, int64_t& id) {
  if (u >= u1) {
    e = -1;
    id = 0;
    return;
  }
  e = p.cpe == 1 ? u : u / p.cpe;
  id = a.ids ? a.ids[e] : e;
}

// unit u's shared words, from its entry e and source s
template <typename T, typename I>
TG_FN void write_unit(const Args<T, I>& a, const Plan& p, int64_t* q,
                      int64_t u, int64_t e, const Src& s) {
  const int64_t w0 = (u - e * p.cpe) * p.unit_elems;
  const int64_t w1 = w0 + p.unit_elems < a.width ? w0 + p.unit_elems
                                                  : a.width;
  const bool wraps = s.off + static_cast<uint64_t>(a.width - 1) > s.mask;
  q[U_DST] = e * a.width;
  q[U_BASE] = s.base;
  q[U_OFF] = static_cast<int64_t>(s.off);
  q[U_MASK] = wraps ? static_cast<int64_t>(s.mask) : -1;
  q[U_W0] = w0;
  q[U_W1] = w1;
  q[U_A0] = -1;
  q[U_A1] = -1;
  if (wraps) return;
  const uintptr_t src = reinterpret_cast<uintptr_t>(
      a.pool + (s.base + static_cast<int64_t>(s.off) + w0));
  const uintptr_t dst = reinterpret_cast<uintptr_t>(a.out + (e * a.width + w0));
  if ((src ^ dst) & 15) return;
  const int64_t sz = static_cast<int64_t>(sizeof(T));
  const int64_t a0 = w0 + static_cast<int64_t>((16 - (src & 15)) & 15) / sz;
  if (a0 >= w1) return;
  const int64_t a1 = a0 + ((w1 - a0) * sz / 16) * 16 / sz;
  if ((a1 - a0) * sz < kBulkMinBytes) return;
  q[U_A0] = a0;
  q[U_A1] = a1;
}

// elements [w0, w1) of a window that does not wrap, by the `g` threads of
// a warp, this thread being `t` of them
template <typename T>
TG_FN void copy_flat(const T* src, T* dst, int64_t n, int64_t t,
                     int64_t g) {
  const uintptr_t s0 = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d0 = reinterpret_cast<uintptr_t>(dst);
  if (((s0 ^ d0) & 15) == 0) {
    const int64_t sz = static_cast<int64_t>(sizeof(T));
    int64_t head = static_cast<int64_t>((16 - (s0 & 15)) & 15) / sz;
    if (head > n) head = n;
    const int64_t per = 16 / sz;
    const int64_t nv = (n - head) / per;
    const int64_t tail0 = head + nv * per;
    // the head's and the tail's elements first, one a thread
    for (int64_t i = t; i < head; i += g) dst[i] = src[i];
    for (int64_t i = tail0 + t; i < n; i += g) dst[i] = src[i];
    const vec16_t* s2 = reinterpret_cast<const vec16_t*>(src + head);
    vec16_t* d2 = reinterpret_cast<vec16_t*>(dst + head);
    int64_t i = t;
    for (; i + 3 * g < nv; i += 4 * g) {
      const vec16_t v0 = s2[i], v1 = s2[i + g], v2 = s2[i + 2 * g],
                    v3 = s2[i + 3 * g];
      d2[i] = v0;
      d2[i + g] = v1;
      d2[i + 2 * g] = v2;
      d2[i + 3 * g] = v3;
    }
    for (; i < nv; i += g) d2[i] = s2[i];
  } else {
    for (int64_t i = t; i < n; i += g) dst[i] = src[i];
  }
}

// a warp's share of one unit: the edges of a bulk unit, or all of another
template <typename T, typename I>
TG_FN void copy_unit(const Args<T, I>& a, const int64_t* q, int64_t t,
                     int64_t g) {
  const int64_t w0 = q[U_W0], w1 = q[U_W1];
  const int64_t base = q[U_BASE];
  const uint64_t off = static_cast<uint64_t>(q[U_OFF]);
  const uint64_t mask = static_cast<uint64_t>(q[U_MASK]);
  T* dst = a.out + q[U_DST];
  if (mask != ~uint64_t(0)) {
    // a window that wraps its region, element by element
    for (int64_t w = w0 + t; w < w1; w += g) {
      dst[w] = a.pool[base + static_cast<int64_t>(
                                 (off + static_cast<uint64_t>(w)) & mask)];
    }
    return;
  }
  const T* src = a.pool + (base + static_cast<int64_t>(off));
  const int64_t a0 = q[U_A0];
  if (a0 < 0) {
    copy_flat(src + w0, dst + w0, w1 - w0, t, g);
    return;
  }
  const int64_t a1 = q[U_A1];
  const int64_t nh = a0 - w0;
  for (int64_t i = t; i < nh + (w1 - a1); i += g) {
    const int64_t w = i < nh ? w0 + i : a1 + (i - nh);
    dst[w] = src[w];
  }
}

// The producer's state across batches (thread 0's registers): chunks
// loaded into the ring and stored from it so far, and each slot's
// mbarrier phase.
struct Ring {
  int64_t loaded;
  int64_t stored;
  uint64_t phase;
};

// thread 0: the bulk interiors of the batch's units, in unit order, through
// the ring: a slot is refilled once `kStoreLag` newer stores were issued
// after its own (`bulk_wait_read<kStoreLag>`), so about slots - kStoreLag - 1
// loads and kStoreLag + 1 stores are in flight
template <typename T, typename I, class Block>
TG_FN void produce(Block& k, const Args<T, I>& a, const Plan& p,
                   const int64_t* batch, int64_t cnt, uint64_t* mbar,
                   int64_t* ring, Ring& r) {
  const int64_t S = p.slots;
  int64_t lj = 0, sj = 0;
  while (lj < cnt && batch[lj * kUnitWords + U_A0] < 0) ++lj;
  while (sj < cnt && batch[sj * kUnitWords + U_A0] < 0) ++sj;
  while (sj < cnt) {
    while (lj < cnt && r.loaded - r.stored <= S - 1 - kStoreLag) {
      const int64_t* q = batch + lj * kUnitWords;
      const int64_t s = r.loaded % S;
      if (r.loaded >= S) k.template bulk_wait_read<kStoreLag>();
      const int64_t a0 = q[U_A0];
      const T* src = a.pool + (q[U_BASE] + q[U_OFF] + a0);
      k.bulk_load(ring + s * p.slot_words, src,
                  (q[U_A1] - a0) * static_cast<int64_t>(sizeof(T)),
                  mbar + s);
      ++r.loaded;
      do ++lj; while (lj < cnt && batch[lj * kUnitWords + U_A0] < 0);
    }
    const int64_t* q = batch + sj * kUnitWords;
    const int64_t s = r.stored % S;
    const uint64_t bit = uint64_t(1) << s;
    k.bulk_wait(mbar + s, (r.phase & bit) ? 1 : 0);
    r.phase ^= bit;
    const int64_t a0 = q[U_A0];
    k.bulk_store(a.out + (q[U_DST] + a0), ring + s * p.slot_words,
                 (q[U_A1] - a0) * static_cast<int64_t>(sizeof(T)));
    k.bulk_commit();
    ++r.stored;
    do ++sj; while (sj < cnt && batch[sj * kUnitWords + U_A0] < 0);
  }
}

// One block of the persistent grid: its run of units, batch by batch.
template <typename T, typename I, class Block>
TG_FN void stream_cta(const Args<T, I>& a, const Plan& p, Block& k) {
  const int64_t nt = k.nt(), t = k.tid(), ws = k.ws();
  const int64_t nw = (nt + ws - 1) / ws, warp = t / ws, lane = t % ws;
  const int64_t cta = k.cta();
  const int64_t u0 = cta * p.units / p.blocks;
  const int64_t u1 = (cta + 1) * p.units / p.blocks;
  int64_t* sm = k.smem();
  uint64_t* mbar = reinterpret_cast<uint64_t*>(sm);
  int64_t* ring = sm + mbar_words();
  int64_t* ubuf = ring + p.slots * p.slot_words;
  if (t == 0) {
    for (int64_t s = 0; s < p.slots; ++s) k.bulk_init(mbar + s);
  }
  // batch 0's units, and batch 1's ids
  int64_t e, id, e1, id1;
  unit_entry(a, p, u0 + t, u1, e, id);
  unit_entry(a, p, u0 + nt + t, u1, e1, id1);
  bool bulk = false;
  if (e >= 0) {
    const Src s = source(a, id);
    write_unit(a, p, ubuf + t * kUnitWords, u0 + t, e, s);
    bulk = ubuf[t * kUnitWords + U_A0] >= 0;
  }
  bool any_bulk = k.sync_or(bulk);
  Ring r{0, 0, 0};
  if (t == 0) k.proxy_fence();
  const int64_t nb = (u1 - u0 + nt - 1) / nt;
  for (int64_t b = 0; b < nb; ++b) {
    // batch b + 1's sources from the ids loaded a batch ago, and batch
    // b + 2's ids: in flight while batch b is copied
    const int64_t un = u0 + (b + 1) * nt + t;
    const int64_t en = e1;
    Src sn{0, 0, 0};
    if (en >= 0) sn = source(a, id1);
    unit_entry(a, p, u0 + (b + 2) * nt + t, u1, e1, id1);
    const int64_t* cur = ubuf + (b & 1) * nt * kUnitWords;
    const int64_t first = u0 + b * nt;
    const int64_t cnt = u1 - first < nt ? u1 - first : nt;
    // warp 0 is the producer's while the batch has bulk units (thread 0
    // produces; with one warp only, the warp then copies its share too)
    const bool split = any_bulk && nw > 1;
    if (any_bulk && t == 0) produce(k, a, p, cur, cnt, mbar, ring, r);
    const int64_t c0 = split ? 1 : 0;
    if (warp >= c0) {
      for (int64_t j = warp - c0; j < cnt; j += nw - c0) {
        copy_unit(a, cur + j * kUnitWords, lane, ws < nt ? ws : nt);
      }
    }
    bulk = false;
    if (en >= 0) {
      int64_t* q = ubuf + ((b + 1) & 1) * nt * kUnitWords + t * kUnitWords;
      write_unit(a, p, q, un, en, sn);
      bulk = q[U_A0] >= 0;
    }
    // a batch's slot words are rewritten two batches later, after this
    // barrier and the next
    any_bulk = k.sync_or(bulk);
  }
  if (t == 0) {
    k.bulk_wait_all();
    k.proxy_fence();
  }
}

}  // namespace tiara_gather
