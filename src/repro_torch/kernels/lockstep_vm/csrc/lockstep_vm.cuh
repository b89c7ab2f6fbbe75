// The lockstep Tiara engine's whole-wave algorithm, written once for any
// "block" of cooperating threads.
//
// `run_wave<Block>` executes one wave of B requests against the shared
// pool from the first macro-step to the last, exactly as the port's host
// loop (`core/vm.py`, `_Engine.run_host_loop`) does.  The pool is n_dev
// device rows reached through a table of row addresses (H_ROWS): the rows
// of one flat buffer for the dense engine, one buffer per shard for the
// sharded engine, whose wave (its lanes in arrival order) is the dense
// engine's over the same rows:
//
//   * every macro-step, each live request executes its current
//     instruction, and request i observes every memory effect of the
//     requests j < i of the same macro-step (lane-order sequential
//     execution, the `pyvm` oracle's semantics);
//   * a step's lanes whose footprints touch no other lane's ("free"
//     lanes) commute with everything, so they run at once; the others
//     ("serial" lanes) then run one after another in lane order.  A lane
//     is serial when its write window meets another lane's read or write
//     window, when its read window meets another lane's write window, or
//     when its own read and write windows meet (a MEMCPY whose source and
//     destination meet: a memmove).  With the sweep off
//     (`static_noconflict`, or one lane) only the last test is made.
//
// A macro-step has five phases:
//
//   (a) the lanes' owners decode each live lane's instruction once and
//       write its footprint (the host loop's `lane_intervals`);
//   (b) the conflict sweep: pairwise inside one warp when every lane's
//       owner is in warp 0, else a sorted sweep in O(B log B) (the host
//       loop's `_sweep_conflict`, made per lane): the 2B read and write
//       windows sorted by start (a bitonic sort, its stages inside a warp
//       done in registers with shuffles), exclusive prefix maxima of the
//       ends and suffix minima of the write starts; a write window is
//       serial when any other window meets it, a read window when a write
//       window does.  Its serial set contains the pairwise set and adds
//       only lanes whose own windows meet, which (a) serializes anyway.
//       A step without a write window has no conflict and skips it;
//   (c) the owners step their free lanes with the operands decoded in
//       (a); a free MEMCPY of at most kInlineWords words is copied by its
//       owner at once, a longer one is queued (one atomic per warp);
//   (d) the queued windows are copied in units of kUnitWords words,
//       claimed by warps (16-byte vectors where a window neither wraps
//       its region nor is misaligned against its source, word by word
//       otherwise) and by one producer thread with the bulk copy engine
//       (global -> a ring of shared slots -> global, completing on an
//       mbarrier) for long aligned windows;
//   (e) at the same time, one warp replays the serial lanes in lane
//       order, staging each MEMCPY's source window in shared memory
//       before it writes (memmove semantics) and meeting at warp
//       barriers only.  (d) and (e) touch disjoint words: a free lane's
//       windows meet no other lane's.
//
// A wave of many lanes with long windows may run on a thread block
// cluster: block 0 runs the algorithm above; the other blocks only help
// with (d), claiming copy units from block 0's queue through distributed
// shared memory between two cluster barriers a macro-step.
//
// Lane state (pc, fuel, loop stack, registers, ...), the instruction
// store and the region table live in shared memory as far as the block's
// budget allows (`make_plan`) and in the global scratch beyond it; the
// same code runs on either through generic pointers.  The outputs are
// written once, at the end of the wave.
//
// Integer arithmetic is done in uint64_t, so it wraps as the hardware
// does (signed overflow is undefined in C++); comparisons are signed.
//
// `Block` supplies tid(), nt(), ws() (the warp's width), warp_size() (the
// threads of the caller's warp), sync(), warp_sync(), warp_ballot(bool) (a
// bit per thread of the warp), warp_bcast(int64) (lane 0's value),
// warp_shfl(int64, lane) (that lane's value), warp_or(u32) and
// warp_incl_sum(u64) (over the warp's threads),
// atomic_add(u64*, u64) and fetch_or(u64*, u64), smem(), the bulk
// copy hooks (bulk_init, bulk_load, bulk_wait, bulk_store, bulk_commit,
// bulk_wait_read, bulk_wait_all, proxy_fence), clock() and the cluster's
// cluster_rank(), cluster_size(), cluster_sync() and leader_smem() (block
// 0's shared memory, as this block addresses it).
// `csrc/lockstep_vm.cu` instantiates it with a CUDA thread block; the
// header also compiles as plain C++ (no __CUDACC__), where host threads
// meeting at barriers, host "warps" with barriers of their own and
// memcpy for the bulk copies run the same code
// (`tests/lockstep_vm_host.cpp`).

#pragma once

#include <stdint.h>

// LSVM_FN marks the code the CUDA kernel runs: device functions under
// nvcc, plain functions in the C++ build.
// LSVM_HD marks what both the launch (host) and the kernel use.  (Every
// device function is inlined: out of line, the decoded step went through
// local memory and the waves ran slower on an H100.)
#ifdef __CUDACC__
#define LSVM_FN __device__ __forceinline__
#define LSVM_HD __host__ __device__ inline
#define LSVM_UNROLL _Pragma("unroll")
#else
#define LSVM_FN inline
#define LSVM_HD inline
#define LSVM_UNROLL
#endif

namespace lockstep_vm {

// --- the ISA (core/isa.py) ---------------------------------------------
enum : int64_t {
  F_OP = 0, F_DST, F_A, F_B, F_C, F_D, F_E, F_FLAGS, F_IMM, F_IMM2,
  kInstrWidth
};
enum : int64_t {
  OP_NOP = 0, OP_MOVI, OP_ALU, OP_LOAD, OP_STORE, OP_MEMCPY, OP_CAS,
  OP_CAA, OP_JUMP, OP_LOOP, OP_WAIT, OP_RET
};
enum : int64_t {
  ALU_EQ = 8, ALU_NE = 9, ALU_LT = 10, ALU_ALWAYS = 15
};
enum : int64_t {
  FLAG_IMMB = 1, FLAG_ASYNC = 2, FLAG_DEV_REG = 4, FLAG_LEN_REG = 8,
  FLAG_MREG = 8, FLAG_DSTDEV_REG = 16, FLAG_SRCDEV_REG = 32,
  FLAG_THR_REG = 64
};
constexpr int64_t kRegs = 16;
constexpr int64_t kDepth = 8;
constexpr int64_t kMaxInflight = 32;
constexpr int64_t kErrReg = 15;
constexpr int64_t kDevLocal = -1;
constexpr int64_t kStatusProtFault = 125;
constexpr int64_t kStatusFellOff = 126;
constexpr int64_t kStatusFuel = 127;
constexpr int64_t kBig = int64_t(1) << 62;

// --- one launch's operands ----------------------------------------------
// The host packs these as one int64 header (kernel.py's HEADER, same
// order); pointers are device addresses (host addresses in the plain C++
// build).  The pool is addressed only through H_ROWS, a table of n_dev
// row addresses, one device row of pool_words words each: the rows of one
// flat buffer (the dense engine's, whose sink word past the last row only
// its host loop writes) or one buffer per shard (the sharded engine's on
// one card).  The kernel writes no word outside the rows: a suppressed
// write is not made.
enum Hdr : int64_t {
  H_CODE = 0, H_N_INSTR, H_RBASE, H_RMASK, H_N_REGIONS, H_SLOT_START,
  H_SLOT_END, H_SLOT_FUEL, H_N_OPS, H_INPUTS, H_N_PARAMS, H_B, H_N_DEV,
  H_POOL_WORDS, H_MAX_WINDOW, H_PROTECT, H_SWEEP, H_ROWS, H_RET, H_STATUS,
  H_STEPS, H_REGS, H_FAULT, H_SCRATCH, H_COUNT
};

// per-lane control words; lane state is a structure of arrays: word f of
// lane b at [f * B + b] (control, then the 16 registers, then the loop
// stack's 3 * kDepth words)
enum : int64_t {
  L_PC = 0, L_END, L_FUEL, L_PC0, L_LSP, L_INFLIGHT, L_HALTED, L_STEPS,
  L_HOME, L_FLAG, L_RET, L_STATUS, kCtlWords
};
constexpr int64_t kStackWords = 3 * kDepth;
constexpr int64_t kLaneWords = kCtlWords + kRegs + kStackWords;
// a queued window copy: the address of the source region's first word,
// masked source offset, source mask, the address of the destination
// region's first word, masked destination offset, destination mask,
// words, its first copy unit
enum : int64_t {
  C_SROW = 0, C_SOFF, C_SMASK, C_DROW, C_DOFF, C_DMASK, C_LEN, C_UNIT0,
  kDescWords
};
// lane flags within a macro-step
enum : int64_t { kIdle = 0, kFree = 1, kSerial = 2 };

// a queued window is copied in units of this many words (4 KiB: one slot
// of the bulk copy ring)
constexpr int64_t kUnitWords = 512;
// a free lane copies a window of at most this many words itself in (c)
constexpr int64_t kInlineWords = 8;
// the bulk copy engine takes aligned windows of at least this many words
constexpr int64_t kBulkMinWords = 128;
// slots of the bulk copy ring
constexpr int64_t kRingMax = 8;
// the block's most threads (the sorted sweep's scan takes a slot each)
constexpr int64_t kMaxThreads = 512;

// the block's shared control words (the head of shared memory)
// (the step's words come twice, by the step's parity: the words of step
// s + 1 are cleared during step s, after every thread has read them)
enum : int64_t {
  M_FLAGS = 0,          // the step's live and serial bits
  M_QBULK = 1,          // queued bulk windows: (count << 32) | units
  M_QVEC,               // queued other windows: (count << 32) | units
  M_UBULK,              // the next bulk unit to copy
  M_UVEC,               // the next other unit to copy
  kStepWords,
  M_PARITY = 2 * kStepWords,   // the ring's mbarrier phases, a bit a slot
  M_DONE,               // the wave is over (read by a cluster's helpers)
  M_SDESC = 16,         // the serial warp's window (kDescWords)
  M_MBAR = 24,          // the ring's mbarriers (kRingMax)
  M_RDST = 32,          // each ring slot's destination (kRingMax)
  M_RBYTES = 40,        // each ring slot's bytes (kRingMax)
  kMiscWords = 48
};
enum : uint64_t { kLive = 1, kAnySerial = 2, kWrites = 4 };

struct Wave {
  const int64_t* code;
  int64_t n_instr;
  const int64_t* rbase;
  const int64_t* rmask;
  int64_t n_regions;
  const int64_t* slot_start;
  const int64_t* slot_end;
  const int64_t* slot_fuel;
  int64_t n_ops;
  const int64_t* params;   // (B, n_params)
  const int64_t* op_sel;   // (B,)
  const int64_t* homes;    // (B,)
  const int64_t* failed;   // (n_dev,), 0 or 1
  int64_t n_params;
  int64_t B;
  int64_t n_dev;
  int64_t pool_words;
  int64_t max_window;
  int64_t protect;
  int64_t sweep;
  int64_t* const* rows;    // (n_dev,) row addresses, pool_words words each
  int64_t* ret;            // (B,)
  int64_t* status;         // (B,)
  int64_t* steps;          // (B,)
  int64_t* regs;           // (B, 16)
  int64_t* fault;          // (B, 4)
  int64_t* scratch;        // scratch_words(B)
};

inline Wave unpack(const int64_t* h) {
  Wave w;
  w.code = reinterpret_cast<const int64_t*>(h[H_CODE]);
  w.n_instr = h[H_N_INSTR];
  w.rbase = reinterpret_cast<const int64_t*>(h[H_RBASE]);
  w.rmask = reinterpret_cast<const int64_t*>(h[H_RMASK]);
  w.n_regions = h[H_N_REGIONS];
  w.slot_start = reinterpret_cast<const int64_t*>(h[H_SLOT_START]);
  w.slot_end = reinterpret_cast<const int64_t*>(h[H_SLOT_END]);
  w.slot_fuel = reinterpret_cast<const int64_t*>(h[H_SLOT_FUEL]);
  w.n_ops = h[H_N_OPS];
  w.n_params = h[H_N_PARAMS];
  w.B = h[H_B];
  w.n_dev = h[H_N_DEV];
  // the inputs tensor: params (B, n_params), op_sel (B), homes (B),
  // failed (n_dev)
  const int64_t* in = reinterpret_cast<const int64_t*>(h[H_INPUTS]);
  w.params = in;
  w.op_sel = in + w.B * w.n_params;
  w.homes = w.op_sel + w.B;
  w.failed = w.homes + w.B;
  w.pool_words = h[H_POOL_WORDS];
  w.max_window = h[H_MAX_WINDOW];
  w.protect = h[H_PROTECT];
  w.sweep = h[H_SWEEP];
  w.rows = reinterpret_cast<int64_t* const*>(h[H_ROWS]);
  w.ret = reinterpret_cast<int64_t*>(h[H_RET]);
  w.status = reinterpret_cast<int64_t*>(h[H_STATUS]);
  w.steps = reinterpret_cast<int64_t*>(h[H_STEPS]);
  w.regs = reinterpret_cast<int64_t*>(h[H_REGS]);
  w.fault = reinterpret_cast<int64_t*>(h[H_FAULT]);
  w.scratch = reinterpret_cast<int64_t*>(h[H_SCRATCH]);
  return w;
}

// --- where a launch keeps its state ---------------------------------------
// The sorted sweep's size: the 2B windows padded to a power of two.
LSVM_HD int64_t sort_size(int64_t B) {
  int64_t n = 2;
  while (n < 2 * B) n <<= 1;
  return n;
}

// The global scratch, in words: every part of the state, whether or not
// the plan keeps it in shared memory (kernel.py's scratch_words).
enum Part : int { P_CTL = 0, P_REGS, P_STACK, P_FOOT, P_SORT, P_SCAN,
                  P_DESC, kParts };
LSVM_HD int64_t part_words(int part, int64_t B) {
  switch (part) {
    case P_CTL: return kCtlWords * B;
    case P_REGS: return kRegs * B;
    case P_STACK: return kStackWords * B;
    case P_FOOT: return 4 * B;
    case P_SORT: return 2 * sort_size(B);
    case P_SCAN: return 3 * kMaxThreads;
    default: return kDescWords * B;
  }
}
LSVM_HD int64_t scratch_words(int64_t B) {
  int64_t n = 0;
  for (int p = 0; p < kParts; ++p) n += part_words(p, B);
  return n;
}

// Every lane's owner is in warp 0: the pairwise sweep inside one warp.
LSVM_HD bool small_wave(int64_t B, int64_t nt, int64_t ws) {
  return (B < nt ? B : nt) <= ws;
}

// Which parts live in shared memory (their word offset there) and which
// in the global scratch (-1), in order of how often a step touches them;
// `budget` is the block's shared memory in words.
struct Plan {
  int64_t words;           // shared words the plan uses
  int64_t ring;            // bulk copy ring slots (0: no bulk copies)
  int64_t stage;           // the serial warp's staging window
  int64_t code, tabs;      // instruction store; rbase, rmask, failed, rows
  int64_t part[kParts];
  int64_t ring_at;
};

inline Plan make_plan(const Wave& w, int64_t nt, int64_t ws,
                      int64_t budget) {
  Plan p;
  int64_t at = kMiscWords;
  // 16-byte aligned pieces
  auto take = [&](int64_t n) -> int64_t {
    n = (n + 1) & ~int64_t(1);
    if (at + n > budget) return -1;
    const int64_t o = at;
    at += n;
    return o;
  };
  for (int q = 0; q < kParts; ++q) p.part[q] = -1;
  p.stage = take(w.max_window);
  const bool sorted = w.sweep && !small_wave(w.B, nt, ws);
  p.code = take(w.n_instr * kInstrWidth);
  p.tabs = take(2 * w.n_regions + 2 * w.n_dev);
  p.part[P_CTL] = take(part_words(P_CTL, w.B));
  p.part[P_FOOT] = take(part_words(P_FOOT, w.B));
  if (sorted) {
    p.part[P_SORT] = take(part_words(P_SORT, w.B));
    p.part[P_SCAN] = take(3 * nt);
  }
  p.part[P_REGS] = take(part_words(P_REGS, w.B));
  p.part[P_DESC] = take(part_words(P_DESC, w.B));
  p.ring = 0;
  p.ring_at = -1;
  if (nt / ws >= 2) {
    for (int64_t r = kRingMax; r >= 2 && p.ring_at < 0; --r) {
      p.ring_at = take(r * kUnitWords);
      if (p.ring_at >= 0) p.ring = r;
    }
  }
  p.part[P_STACK] = take(part_words(P_STACK, w.B));
  p.words = at;
  return p;
}

// The blocks of a wave's cluster: helpers for (d) when the wave has many
// lanes whose windows are queued (longer than the inline copies).
constexpr int64_t kClusterMinLanes = 256;
constexpr int64_t kClusterMax = 8;
LSVM_HD int64_t cluster_for(int64_t B, int64_t max_window) {
  return B >= kClusterMinLanes && max_window > kInlineWords ? kClusterMax
                                                           : 1;
}

// The plan's pointers for one launch (`smem` is the block's shared
// memory, or null where the plan keeps nothing there).
struct View {
  const int64_t* code;
  const int64_t* rbase;
  const int64_t* rmask;
  const int64_t* failed;
  int64_t* const* rows;    // (n_dev,) the pool's row addresses
  int64_t* ctl;            // (kCtlWords, B)
  int64_t* regs;           // (16, B)
  int64_t* stack;          // (3 * kDepth, B)
  int64_t* flo;            // (2B,): window 2b is lane b's read, 2b+1 its write
  int64_t* fhi;            // (2B,)
  int64_t* skey;           // (N,) the sorted windows' starts
  int64_t* sid;            // (N,) and their numbers
  int64_t* scan;           // (3, nt) the sweep's scan
  int64_t* desc;           // (B, kDescWords) the queued windows
  int64_t* stage;          // the serial warp's staging window
  int64_t* ring;           // (ring, kUnitWords) the bulk copy ring
  int64_t ring_slots;
  uint64_t* misc;          // kMiscWords
  int64_t B, N, nt;
};

LSVM_FN View view_of(const Wave& w, const Plan& p, int64_t* smem,
                     int64_t nt) {
  View v;
  int64_t* base[kParts];
  int64_t g = 0;
  for (int q = 0; q < kParts; ++q) {
    base[q] = p.part[q] >= 0 ? smem + p.part[q] : w.scratch + g;
    g += part_words(q, w.B);
  }
  v.code = p.code >= 0 ? smem + p.code : w.code;
  v.rbase = p.tabs >= 0 ? smem + p.tabs : w.rbase;
  v.rmask = p.tabs >= 0 ? smem + p.tabs + w.n_regions : w.rmask;
  v.failed = p.tabs >= 0 ? smem + p.tabs + 2 * w.n_regions : w.failed;
  v.rows = p.tabs >= 0 ? reinterpret_cast<int64_t* const*>(
                             smem + p.tabs + 2 * w.n_regions + w.n_dev)
                       : w.rows;
  v.ctl = base[P_CTL];
  v.regs = base[P_REGS];
  v.stack = base[P_STACK];
  v.flo = base[P_FOOT];
  v.fhi = base[P_FOOT] + 2 * w.B;
  v.N = sort_size(w.B);
  v.skey = base[P_SORT];
  v.sid = base[P_SORT] + v.N;
  v.scan = base[P_SCAN];
  v.desc = base[P_DESC];
  v.stage = smem + p.stage;
  v.ring = p.ring > 0 ? smem + p.ring_at : nullptr;
  v.ring_slots = p.ring;
  v.misc = reinterpret_cast<uint64_t*>(smem);
  v.B = w.B;
  v.nt = nt;
  return v;
}

// --- wrapping int64 arithmetic --------------------------------------------
LSVM_FN int64_t wadd(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) +
                              static_cast<uint64_t>(b));
}
LSVM_FN int64_t wsub(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) -
                              static_cast<uint64_t>(b));
}
LSVM_FN int64_t wmul(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) *
                              static_cast<uint64_t>(b));
}
LSVM_FN int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
LSVM_FN int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}
LSVM_FN int64_t clampi(int64_t a, int64_t lo, int64_t hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}
// Python's (and torch.remainder's) modulo: the sign of the divisor (a
// device number already in range skips the 64-bit division, which the
// card does in software)
LSVM_FN int64_t pymod(int64_t a, int64_t n) {
  if (static_cast<uint64_t>(a) < static_cast<uint64_t>(n)) return a;
  const int64_t r = a % n;
  return r < 0 ? r + n : r;
}

// a queued window's region start, kept as a word of its descriptor
LSVM_FN int64_t addr_word(const int64_t* p) {
  return static_cast<int64_t>(reinterpret_cast<uintptr_t>(p));
}
LSVM_FN int64_t* word_addr(int64_t a) {
  return reinterpret_cast<int64_t*>(static_cast<uintptr_t>(a));
}

// the 16-entry ALU table of vm.py's `_alu_table`, indexed by the clamped
// opcode (14 and 15 pass `a` through); a chain of selects, so lanes with
// different opcodes do not diverge
LSVM_FN int64_t alu(int64_t op, int64_t a, int64_t b) {
  const unsigned sh = static_cast<unsigned>(b & 63);
  const uint64_t ua = static_cast<uint64_t>(a);
  const int64_t o = clampi(op, 0, 15);
  int64_t r = a;
  r = o == 0 ? wadd(a, b) : r;
  r = o == 1 ? wsub(a, b) : r;
  r = o == 2 ? wmul(a, b) : r;
  r = o == 3 ? (a & b) : r;
  r = o == 4 ? (a | b) : r;
  r = o == 5 ? (a ^ b) : r;
  r = o == 6 ? static_cast<int64_t>(ua << sh) : r;
  r = o == 7 ? static_cast<int64_t>(ua >> sh) : r;
  r = o == 8 ? int64_t(a == b) : r;
  r = o == 9 ? int64_t(a != b) : r;
  r = o == 10 ? int64_t(a < b) : r;
  r = o == 11 ? int64_t(a >= b) : r;
  r = o == 12 ? imin(a, b) : r;
  r = o == 13 ? imax(a, b) : r;
  return r;
}

// --- decode ---------------------------------------------------------------
// Everything a step needs from the lane's instruction and its register
// file as the step finds it (vm.py's `reads` and `_decode`).
struct Dec {
  int64_t pc, op, dstf, df, flags, imm, imm2;
  int64_t rA, rB, rC, rD, rDST, rERR;
  // word ops
  int64_t w_dev, w_off, w_addr, w_flt, w_fdev;
  // memcpy
  int64_t m_ddev, m_sdev, m_dbase, m_sbase, m_dmask, m_smask, m_soff,
      m_doff, m_fail, m_flt, m_faddr, m_fdev, ln;
};

LSVM_FN int64_t dev_of(const Wave& w, int64_t reg, int64_t fld, bool via,
                       int64_t home) {
  const int64_t d = via ? reg : fld;
  return d == kDevLocal ? home : pymod(d, w.n_dev);
}

LSVM_FN bool dev_oob(const Wave& w, int64_t reg, bool via) {
  return via && reg != kDevLocal && (reg < 0 || reg >= w.n_dev);
}

LSVM_FN bool failed_dev(const Wave& w, const View& v, int64_t d) {
  return v.failed[clampi(d, 0, w.n_dev - 1)] != 0;
}

LSVM_FN void decode(const Wave& w, const View& v, int64_t b, Dec& d) {
  const int64_t B = v.B;
  const int64_t* R = v.regs + b;
  d.pc = v.ctl[L_PC * B + b];
  const int64_t* row = v.code + clampi(d.pc, 0, w.n_instr - 1) * kInstrWidth;
  d.op = row[F_OP];
  d.dstf = row[F_DST];
  const int64_t af = row[F_A], bf = row[F_B], cf = row[F_C];
  d.df = row[F_D];
  const int64_t ef = row[F_E];
  d.flags = row[F_FLAGS];
  d.imm = row[F_IMM];
  d.imm2 = row[F_IMM2];
  d.rA = R[(af & 15) * B];
  d.rB = R[(bf & 15) * B];
  d.rC = R[(cf & 15) * B];
  d.rD = R[(d.df & 15) * B];
  const int64_t rE = R[(ef & 15) * B];
  d.rDST = R[(d.dstf & 15) * B];
  const int64_t rIMM2 = R[(d.imm2 & 15) * B];
  d.rERR = R[kErrReg * B];
  const int64_t home = v.ctl[L_HOME * B + b];
  const int64_t flags = d.flags;

  // word ops (LOAD/STORE/CAS/CAA)
  const int64_t w_rid = clampi(af, 0, w.n_regions - 1);
  const bool w_via = (flags & FLAG_DEV_REG) != 0;
  d.w_dev = dev_of(w, rE, ef, w_via, home);
  d.w_off = wadd(d.rB, d.imm);
  const int64_t w_mask = v.rmask[w_rid];
  d.w_addr = wadd(v.rbase[w_rid], d.w_off & w_mask);
  // memcpy operands
  const int64_t m_drid = clampi(af, 0, w.n_regions - 1);
  const int64_t m_srid = clampi(d.df, 0, w.n_regions - 1);
  const bool via_d = (flags & FLAG_DSTDEV_REG) != 0;
  const bool via_s = (flags & FLAG_SRCDEV_REG) != 0;
  d.m_ddev = dev_of(w, d.rDST, d.dstf, via_d, home);
  d.m_sdev = dev_of(w, d.rC, cf, via_s, home);
  d.m_dbase = v.rbase[m_drid];
  d.m_sbase = v.rbase[m_srid];
  d.m_dmask = v.rmask[m_drid];
  d.m_smask = v.rmask[m_srid];
  const int64_t cap = d.imm;
  int64_t ln = (flags & FLAG_LEN_REG) ? imin(imax(rIMM2, 0), cap) : cap;
  ln = imin(imin(ln, wadd(d.m_dmask, 1)), wadd(d.m_smask, 1));
  d.m_fail = failed_dev(w, v, d.m_ddev) || failed_dev(w, v, d.m_sdev);
  d.m_soff = rE;
  d.m_doff = d.rB;
  d.w_flt = 0;
  d.w_fdev = d.w_dev;
  d.m_flt = 0;
  d.m_faddr = 0;
  d.m_fdev = 0;
  if (w.protect) {
    // pyvm's order of priority: a wild device register, an out-of-region
    // offset or window, a failed device
    const bool w_oob_dev = dev_oob(w, rE, w_via);
    d.w_flt = w_oob_dev || d.w_off != (d.w_off & w_mask) ||
              failed_dev(w, v, d.w_dev);
    d.w_fdev = w_oob_dev ? rE : d.w_dev;
    const bool oob_dd = dev_oob(w, d.rDST, via_d);
    const bool oob_sd = dev_oob(w, d.rC, via_s);
    const bool d_oob = d.m_doff != (d.m_doff & d.m_dmask) ||
                       wadd(d.m_doff, ln) > wadd(d.m_dmask, 1);
    const bool s_oob = d.m_soff != (d.m_soff & d.m_smask) ||
                       wadd(d.m_soff, ln) > wadd(d.m_smask, 1);
    d.m_flt = ln > 0 && (oob_dd || oob_sd || d_oob || s_oob);
    d.m_faddr = (oob_dd || (!oob_sd && d_oob)) ? d.m_doff : d.m_soff;
    d.m_fdev = oob_dd ? d.rDST
                      : (oob_sd ? d.rC : (d_oob ? d.m_ddev : d.m_sdev));
    d.m_fail = d.m_fail && !d.m_flt;
    if (d.m_flt) ln = 0;
  }
  if (d.m_fail) ln = 0;
  d.ln = ln;
}

// --- footprints (vm.py's `lane_intervals`), flat dev * P + addr words -----
// iv: read window [iv[0], iv[1]), write window [iv[2], iv[3]); an empty
// window is [kBig, -kBig).  Every opcode's windows are computed and the
// lane's selected (no divergence between lanes).  The footprints are only
// compared, never dereferenced, so they keep the flat coordinates whatever
// the rows' addresses.
LSVM_FN void intervals(const Wave& w, const Dec& d, int64_t* iv) {
  const int64_t P = w.pool_words;
  const bool is_load = d.op == OP_LOAD;
  const bool is_word_w = d.op == OP_STORE || d.op == OP_CAS ||
                         d.op == OP_CAA;
  const bool is_mcpy = d.op == OP_MEMCPY;
  const int64_t wf = wadd(wmul(d.w_dev, P), d.w_addr);
  const int64_t s_size = wadd(d.m_smask, 1);
  const int64_t s_start = d.m_soff & d.m_smask;
  const bool s_wrap = wadd(s_start, d.ln) > s_size;
  const int64_t mr_lo = wadd(wadd(wmul(d.m_sdev, P), d.m_sbase),
                             s_wrap ? 0 : s_start);
  const int64_t mr_hi = wadd(mr_lo, s_wrap ? s_size : d.ln);
  const int64_t d_size = wadd(d.m_dmask, 1);
  const int64_t d_start = d.m_doff & d.m_dmask;
  const bool d_wrap = wadd(d_start, d.ln) > d_size;
  const int64_t mw_lo = wadd(wadd(wmul(d.m_ddev, P), d.m_dbase),
                             d_wrap ? 0 : d_start);
  const int64_t mw_hi = wadd(mw_lo, d_wrap ? d_size : d.ln);
  int64_t r_lo = is_load ? wf : (is_mcpy ? mr_lo : kBig);
  int64_t r_hi = is_load ? wadd(wf, 1) : (is_mcpy ? mr_hi : -kBig);
  int64_t w_lo = is_word_w ? wf : (is_mcpy ? mw_lo : kBig);
  int64_t w_hi = is_word_w ? wadd(wf, 1) : (is_mcpy ? mw_hi : -kBig);
  // a zero-length window is empty, not a point
  const bool r_empty = r_hi <= r_lo, w_empty = w_hi <= w_lo;
  iv[0] = r_empty ? kBig : r_lo;
  iv[1] = r_empty ? -kBig : r_hi;
  iv[2] = w_empty ? kBig : w_lo;
  iv[3] = w_empty ? -kBig : w_hi;
}

LSVM_FN bool meet(int64_t alo, int64_t ahi, int64_t blo, int64_t bhi) {
  return (alo < bhi) & (blo < ahi);
}

// --- one lane's step, all but a long MEMCPY's window copy -----------------
// The word ops read and write the pool here; a MEMCPY that copies leaves
// its window in `cp` (C_LEN > 0) for the caller to copy.  Lanes of one
// warp run different opcodes, so the step computes every channel and
// selects: the only branches are the halt and the rare loop-stack walks.
LSVM_FN void execute(const Wave& w, const View& v, int64_t b, const Dec& d,
                       int64_t* cp) {
  const int64_t B = v.B;
  int64_t* C = v.ctl + b;
  int64_t* R = v.regs + b;
  const int64_t P = w.pool_words;
  const int64_t op = d.op;
  const bool is_movi = op == OP_MOVI, is_alu = op == OP_ALU;
  const bool is_load = op == OP_LOAD, is_store = op == OP_STORE;
  const bool is_mcpy = op == OP_MEMCPY;
  const bool is_cas = op == OP_CAS, is_atom = is_cas || op == OP_CAA;
  const bool is_jump = op == OP_JUMP, is_loop = op == OP_LOOP;
  const bool is_wait = op == OP_WAIT, is_ret = op == OP_RET;
  const int64_t flags = d.flags;

  const bool flt = w.protect &&
                   ((d.w_flt && (is_load || is_store || is_atom)) ||
                    (d.m_flt && is_mcpy));

  // LOAD / CAS / CAA read the word (vm.py's `_DenseOps.readv` clamps)
  int64_t w_old = 0;
  if (is_load || is_atom) {
    w_old = v.rows[clampi(d.w_dev, 0, w.n_dev - 1)][clampi(d.w_addr, 0,
                                                            P - 1)];
  }
  // the register write channel
  const int64_t alu_v = alu(d.df, d.rA, (flags & FLAG_IMMB) ? d.imm : d.rB);
  const int64_t err_v = d.m_fail ? (d.rERR | 1) : d.rERR;
  const int64_t val = is_movi ? d.imm
                      : is_alu ? alu_v
                      : (is_load || is_atom) ? w_old : err_v;
  if ((is_movi || is_alu || is_load || is_atom || is_mcpy) && !flt) {
    R[(is_mcpy ? kErrReg : (d.dstf & 15)) * B] = val;
  }
  // STORE / CAS / CAA write the word
  const int64_t hit = w_old == d.rC;
  const int64_t wval = is_store ? d.rDST
                                : (hit ? (is_cas ? d.rD : wadd(w_old, d.rD))
                                       : w_old);
  // (a word outside the pool's rows, from a home past the last device, is
  // never written)
  if ((is_store || is_atom) && !flt && d.w_dev >= 0 && d.w_dev < w.n_dev &&
      d.w_addr >= 0 && d.w_addr < P) {
    v.rows[d.w_dev][d.w_addr] = wval;
  }
  // MEMCPY: the window (words past max_window are never copied; a
  // destination region outside the pool's rows is never written)
  const int64_t n = imin(d.ln, w.max_window);
  const bool dst_in = d.m_ddev >= 0 && d.m_ddev < w.n_dev &&
                      d.m_dbase >= 0 && d.m_dbase + d.m_dmask < P;
  const bool copies = is_mcpy && !flt && n > 0 && dst_in;
  cp[C_SROW] = addr_word(v.rows[clampi(d.m_sdev, 0, w.n_dev - 1)] +
                         d.m_sbase);
  cp[C_SOFF] = d.m_soff & d.m_smask;
  cp[C_SMASK] = d.m_smask;
  cp[C_DROW] = dst_in ? addr_word(v.rows[d.m_ddev] + d.m_dbase) : 0;
  cp[C_DOFF] = d.m_doff & d.m_dmask;
  cp[C_DMASK] = d.m_dmask;
  cp[C_LEN] = copies ? n : 0;
  // the in-flight counter
  int64_t inflight = C[L_INFLIGHT * B];
  const int64_t thr = (flags & FLAG_THR_REG) ? d.rA : d.imm;
  inflight = (is_mcpy && !flt && (flags & FLAG_ASYNC))
                 ? imin(inflight + 1, kMaxInflight) : inflight;
  inflight = is_wait ? imin(inflight, imax(thr, 0)) : inflight;
  C[L_INFLIGHT * B] = inflight;
  C[L_STEPS * B] = C[L_STEPS * B] + 1;

  // RET / protection fault
  if (is_ret || flt) {
    C[L_HALTED * B] = 1;
    C[L_RET * B] = is_ret ? d.rA : C[L_RET * B];
    C[L_STATUS * B] = is_ret ? d.imm : kStatusProtFault;
    if (flt) {
      int64_t* F = w.fault + b * 4;
      F[0] = d.pc;
      F[1] = op;
      F[2] = is_mcpy ? d.m_faddr : d.w_off;
      F[3] = is_mcpy ? d.m_fdev : d.w_fdev;
    }
    return;
  }

  // control flow and the depth-8 loop stack
  const int64_t pc = d.pc;
  int64_t* S = v.stack + b;           // frame word j at S[j * B]
  int64_t lsp = C[L_LSP * B];
  const int64_t lhs = d.rA;
  const int64_t rhs = (flags & FLAG_IMMB) ? d.imm : d.rB;
  const int64_t cond = d.df;
  const bool take = is_jump &&
                    (cond == ALU_ALWAYS ? true
                     : cond == ALU_EQ   ? lhs == rhs
                     : cond == ALU_NE   ? lhs != rhs
                     : cond == ALU_LT   ? lhs < rhs
                                        : lhs >= rhs);
  const int64_t m = (flags & FLAG_MREG) ? imin(imax(d.rB, 0), d.imm)
                                        : d.imm;
  const bool skip = is_loop && m <= 0;
  if (is_loop && !skip) {
    const int64_t sp = clampi(lsp, 0, kDepth - 1);
    S[(3 * sp + 0) * B] = wadd(pc, 1);
    S[(3 * sp + 1) * B] = wadd(pc, d.imm2);
    S[(3 * sp + 2) * B] = m;
    lsp = lsp + 1;
  }
  int64_t pc_new = (take || skip) ? wadd(wadd(pc, 1), d.imm2) : wadd(pc, 1);
  if (take) {
    // a taken jump pops every frame whose body it escaped (once the top
    // frame's body holds the target, no deeper frame is looked at)
    for (int k = 0; k < kDepth && lsp > 0; ++k) {
      if (S[(3 * clampi(lsp - 1, 0, kDepth - 1) + 1) * B] >= pc_new) break;
      lsp = lsp - 1;
    }
  } else if (lsp > 0 &&
             pc_new == wadd(S[(3 * clampi(lsp - 1, 0, kDepth - 1) + 1) * B],
                            1)) {
    // a normal advance past a body's end iterates or pops the frames
    // whose body just ended
    for (int k = 0; k < kDepth; ++k) {
      if (lsp <= 0) break;
      int64_t* top = S + 3 * clampi(lsp - 1, 0, kDepth - 1) * B;
      if (pc_new != wadd(top[1 * B], 1)) break;
      const int64_t rem = top[2 * B] - 1;
      if (rem > 0) {
        top[2 * B] = rem;
        pc_new = top[0];
        break;
      }
      lsp = lsp - 1;
    }
  }
  C[L_PC * B] = pc_new;
  C[L_LSP * B] = lsp;
}

// --- window copies ----------------------------------------------------------
#ifdef __CUDACC__
typedef ulonglong2 vec16_t;
#else
struct alignas(16) vec16_t {
  unsigned long long x, y;
};
#endif

LSVM_FN bool wraps(const int64_t* cp) {
  return cp[C_SOFF] + (cp[C_LEN] - 1) > cp[C_SMASK] ||
         cp[C_DOFF] + (cp[C_LEN] - 1) > cp[C_DMASK];
}

// Copy words [w0, w1) of one window with the `g` threads of a group, this
// thread being `t` of them: the source and destination do not overlap.
LSVM_FN void copy_range(const int64_t* cp, int64_t w0, int64_t w1,
                        int64_t t, int64_t g) {
  const int64_t soff = cp[C_SOFF], smask = cp[C_SMASK];
  const int64_t doff = cp[C_DOFF], dmask = cp[C_DMASK];
  const int64_t* srow = word_addr(cp[C_SROW]);
  int64_t* drow = word_addr(cp[C_DROW]);
  if (!wraps(cp)) {
    const int64_t* src = srow + soff + w0;
    int64_t* dst = drow + doff + w0;
    const int64_t n = w1 - w0;
    // one word first where both windows start 8 bytes past a 16-byte
    // boundary, then 16-byte vectors, then the last word
    const int64_t head = (reinterpret_cast<uintptr_t>(src) & 15) ? 1 : 0;
    const bool vec = ((reinterpret_cast<uintptr_t>(src + head) |
                       reinterpret_cast<uintptr_t>(dst + head)) & 15) == 0;
    if (vec && n > head) {
      if (head && t == 0) dst[0] = src[0];
      const int64_t nv = (n - head) / 2;
      const vec16_t* s2 = reinterpret_cast<const vec16_t*>(src + head);
      vec16_t* d2 = reinterpret_cast<vec16_t*>(dst + head);
      int64_t i = t;
      for (; i + 3 * g < nv; i += 4 * g) {
        const vec16_t a0 = s2[i], a1 = s2[i + g], a2 = s2[i + 2 * g],
                      a3 = s2[i + 3 * g];
        d2[i] = a0;
        d2[i + g] = a1;
        d2[i + 2 * g] = a2;
        d2[i + 3 * g] = a3;
      }
      for (; i < nv; i += g) d2[i] = s2[i];
      if (((n - head) & 1) && t == 0) dst[n - 1] = src[n - 1];
    } else {
      for (int64_t i = t; i < n; i += g) dst[i] = src[i];
    }
  } else {
    // a window that wraps its region, word by word
    for (int64_t i = w0 + t; i < w1; i += g) {
      drow[(doff + i) & dmask] = srow[(soff + i) & smask];
    }
  }
}

// The queued window holding copy unit `u`: bulk windows fill the queue
// from its front, the others from its back, each in the order of their
// first units.
LSVM_FN const int64_t* find_unit(const View& v, bool bulk, int64_t count,
                                 int64_t u) {
  int64_t lo = 0, hi = count - 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) / 2;
    const int64_t slot = bulk ? mid : v.B - 1 - mid;
    if (v.desc[slot * kDescWords + C_UNIT0] <= u) lo = mid;
    else hi = mid - 1;
  }
  return v.desc + (bulk ? lo : v.B - 1 - lo) * kDescWords;
}

// (c): a free lane's short window, copied by its owner at once; every
// load issued together, masked past the window's end
LSVM_FN void copy_inline(const int64_t* cp) {
  const int64_t n = cp[C_LEN];
  const int64_t* srow = word_addr(cp[C_SROW]);
  int64_t* drow = word_addr(cp[C_DROW]);
  const int64_t soff = cp[C_SOFF], smask = cp[C_SMASK];
  const int64_t doff = cp[C_DOFF], dmask = cp[C_DMASK];
  int64_t word[kInlineWords];
  LSVM_UNROLL
  for (int i = 0; i < kInlineWords; ++i) {
    if (i < n) word[i] = srow[(soff + i) & smask];
  }
  LSVM_UNROLL
  for (int i = 0; i < kInlineWords; ++i) {
    if (i < n) drow[(doff + i) & dmask] = word[i];
  }
}

// (c): the warp's longer windows queued for (d), with one atomic per
// queue and warp: each window's place and first unit come from a prefix
// sum over the warp (same-address atomics from every lane would
// serialize).  Every thread of the warp calls it; `cp[C_LEN]` is 0 for a
// thread with nothing to queue.
template <class Block>
LSVM_FN void enqueue(Block& k, const View& v, uint64_t* S,
                     const int64_t* cp) {
  const int64_t n = cp[C_LEN];
  const bool want = n > kInlineWords;
  if (!k.warp_or(want)) return;
  const int last = static_cast<int>(k.warp_size()) - 1;
  const uintptr_t s = reinterpret_cast<uintptr_t>(
      word_addr(cp[C_SROW]) + cp[C_SOFF]);
  const uintptr_t d = reinterpret_cast<uintptr_t>(
      word_addr(cp[C_DROW]) + cp[C_DOFF]);
  const bool bulk = want && v.ring_slots >= 2 && n >= kBulkMinWords &&
                    !wraps(cp) && ((s ^ d) & 15) == 0;
  // (count << 32) | units, in each queue
  const uint64_t mine = want ? (uint64_t(1) << 32) |
                                   static_cast<uint64_t>(
                                       (n + kUnitWords - 1) / kUnitWords)
                             : 0;
  const uint64_t pb = bulk ? mine : 0, pv = bulk ? 0 : mine;
  const uint64_t ib = k.warp_incl_sum(pb), iv = k.warp_incl_sum(pv);
  const uint64_t tb = static_cast<uint64_t>(k.warp_shfl(ib, last));
  const uint64_t tv = static_cast<uint64_t>(k.warp_shfl(iv, last));
  uint64_t ob = 0, ov = 0;
  if (k.tid() % k.ws() == 0) {
    if (tb) ob = k.atomic_add(S + M_QBULK, tb);
    if (tv) ov = k.atomic_add(S + M_QVEC, tv);
  }
  ob = static_cast<uint64_t>(k.warp_shfl(ob, 0));
  ov = static_cast<uint64_t>(k.warp_shfl(ov, 0));
  if (!want) return;
  const uint64_t at = bulk ? ob + ib - pb : ov + iv - pv;
  const int64_t idx = static_cast<int64_t>(at >> 32);
  int64_t* q = v.desc + (bulk ? idx : v.B - 1 - idx) * kDescWords;
  for (int j = 0; j < C_UNIT0; ++j) q[j] = cp[j];
  q[C_UNIT0] = static_cast<int64_t>(at & 0xffffffffu);
}

// (d): the producer thread's share, through the bulk copy ring: up to
// `ring` units in flight, each loaded into its slot (completing on the
// slot's mbarrier) and stored from it; a unit's unaligned first and last
// words are copied by the thread itself.
template <class Block>
LSVM_FN void produce(Block& k, const View& v, uint64_t* S, int64_t nb,
                     int64_t nbu) {
  uint64_t* M = v.misc;
  int64_t* rdst = reinterpret_cast<int64_t*>(M + M_RDST);
  int64_t* rbytes = reinterpret_cast<int64_t*>(M + M_RBYTES);
  k.proxy_fence();
  for (;;) {
    int64_t got = 0;
    for (; got < v.ring_slots; ++got) {
      const int64_t u = static_cast<int64_t>(k.atomic_add(S + M_UBULK, 1));
      if (u >= nbu) break;
      const int64_t* cp = find_unit(v, true, nb, u);
      int64_t w0 = (u - cp[C_UNIT0]) * kUnitWords;
      int64_t w1 = imin(w0 + kUnitWords, cp[C_LEN]);
      const int64_t* src = word_addr(cp[C_SROW]) + cp[C_SOFF];
      int64_t* dst = word_addr(cp[C_DROW]) + cp[C_DOFF];
      if (reinterpret_cast<uintptr_t>(src + w0) & 15) {
        dst[w0] = src[w0];
        ++w0;
      }
      if ((w1 - w0) & 1) {
        dst[w1 - 1] = src[w1 - 1];
        --w1;
      }
      rdst[got] = reinterpret_cast<int64_t>(dst + w0);
      rbytes[got] = (w1 - w0) * 8;
      if (w1 > w0) {
        k.bulk_load(v.ring + got * kUnitWords, src + w0, rbytes[got],
                    M + M_MBAR + got);
      }
    }
    for (int64_t s = 0; s < got; ++s) {
      if (rbytes[s] == 0) continue;
      const uint64_t bit = uint64_t(1) << s;
      k.bulk_wait(M + M_MBAR + s, (M[M_PARITY] & bit) ? 1 : 0);
      M[M_PARITY] ^= bit;
      k.bulk_store(reinterpret_cast<int64_t*>(rdst[s]),
                   v.ring + s * kUnitWords, rbytes[s]);
    }
    k.bulk_commit();
    k.bulk_wait_read();
    if (got < v.ring_slots) break;
  }
  k.bulk_wait_all();
  k.proxy_fence();
}

// (d): a warp's share: units claimed one at a time, the other windows'
// first, then the bulk windows' that the producer has not taken
template <class Block>
LSVM_FN void copy_units(Block& k, const View& v, uint64_t* S, int64_t nb,
                        int64_t nbu, int64_t nv, int64_t nvu) {
  const int64_t lane = k.tid() % k.ws();
  const int64_t g = k.warp_size();
  for (;;) {
    int64_t u = -1;
    if (lane == 0) {
      u = static_cast<int64_t>(k.atomic_add(S + M_UVEC, 1));
      if (u >= nvu) {
        const int64_t ub = static_cast<int64_t>(k.atomic_add(S + M_UBULK, 1));
        u = ub < nbu ? nvu + ub : -1;
      }
    }
    u = k.warp_bcast(u);
    if (u < 0) break;
    const bool bulk = u >= nvu;
    const int64_t uu = bulk ? u - nvu : u;
    const int64_t* cp = find_unit(v, bulk, bulk ? nb : nv, uu);
    const int64_t w0 = (uu - cp[C_UNIT0]) * kUnitWords;
    copy_range(cp, w0, imin(w0 + kUnitWords, cp[C_LEN]), lane, g);
  }
}

// (e): the serial lanes, stepped in lane order by one warp
template <class Block>
LSVM_FN void replay(Block& k, const Wave& w, const View& v) {
  const int64_t B = v.B;
  const int64_t lane = k.tid() % k.ws();
  const int64_t g = k.warp_size();
  int64_t* sd = reinterpret_cast<int64_t*>(v.misc + M_SDESC);
  for (int64_t base = 0; base < B; base += g) {
    const int64_t mine = base + lane;
    uint64_t mask = k.warp_ballot(mine < B &&
                                  v.ctl[L_FLAG * B + mine] == kSerial);
    while (mask) {
      int64_t i = 0;
      while (!((mask >> i) & 1)) ++i;
      mask &= mask - 1;
      const int64_t b = base + i;
      if (lane == 0) {
        Dec d;
        decode(w, v, b, d);
        execute(w, v, b, d, sd);
      }
      k.warp_sync();
      const int64_t n = sd[C_LEN];
      if (n > 0) {
        // the whole source window first, then the destination: memmove
        const int64_t* srow = word_addr(sd[C_SROW]);
        int64_t* drow = word_addr(sd[C_DROW]);
        const int64_t soff = sd[C_SOFF], smask = sd[C_SMASK];
        const int64_t doff = sd[C_DOFF], dmask = sd[C_DMASK];
        for (int64_t j = lane; j < n; j += g) {
          v.stage[j] = srow[(soff + j) & smask];
        }
        k.warp_sync();
        for (int64_t j = lane; j < n; j += g) {
          drow[(doff + j) & dmask] = v.stage[j];
        }
      }
      k.warp_sync();
    }
  }
}

// --- the conflict sweeps ---------------------------------------------------
// Both mark a free lane serial (L_FLAG) from the footprints of (a).

// Does window pair (lane b, lane j) make lane b serial?
LSVM_FN bool pair_hits(const View& v, int64_t b, int64_t j) {
  const int64_t rlo = v.flo[2 * b], rhi = v.fhi[2 * b];
  const int64_t wlo = v.flo[2 * b + 1], whi = v.fhi[2 * b + 1];
  const int64_t orl = v.flo[2 * j], orh = v.fhi[2 * j];
  const int64_t owl = v.flo[2 * j + 1], owh = v.fhi[2 * j + 1];
  return (j != b) & (meet(wlo, whi, owl, owh) | meet(wlo, whi, orl, orh) |
                     meet(rlo, rhi, owl, owh));
}

// Pairwise, by warp 0 (every lane's owner is there): each lane's row of
// the B x B pairs split over the warp's P = threads / B threads of that
// lane (thread t takes lane t % B, every P-th partner from t / B), then
// OR-ed into the lane's owner, thread b.  No early exit, so the threads
// never diverge in the loop.  Every thread of warp 0 calls it.
template <class Block>
LSVM_FN void sweep_pairwise(Block& k, const View& v) {
  const int64_t tid = k.tid(), B = v.B, g = k.warp_size();
  k.warp_sync();
  if (B > g) {
    // (the host's narrow blocks: a thread owns several lanes)
    for (int64_t b = tid; b < B; b += k.nt()) {
      bool hit = false;
      for (int64_t j = 0; j < B; ++j) hit |= pair_hits(v, b, j);
      if (hit && v.ctl[L_FLAG * B + b] == kFree) {
        v.ctl[L_FLAG * B + b] = kSerial;
      }
    }
    return;
  }
  // (32-bit arithmetic: the card divides 64-bit integers in software)
  const int B32 = static_cast<int>(B), t32 = static_cast<int>(tid);
  const int P = static_cast<int>(g) / B32, b = t32 % B32, h = t32 / B32;
  bool hit = false;
  if (h < P) {
    for (int j = h; j < B32; j += P) hit |= pair_hits(v, b, j);
  }
  bool any = false;
  for (int q = 0; q < P; ++q) any |= k.warp_shfl(hit, b + q * B32) != 0;
  if (tid < B && any && v.ctl[L_FLAG * B + tid] == kFree) {
    v.ctl[L_FLAG * B + tid] = kSerial;
  }
}

// (start, number) of two windows: is the first later in the sort?
LSVM_FN bool later(int64_t ka, int64_t ia, int64_t kb, int64_t ib) {
  return ka > kb || (ka == kb && ia > ib);
}

// Compare-exchange of positions lo < hi of a bitonic run: the lower
// keeps the earlier (start, number) when the run ascends.
LSVM_FN void cswap(int64_t& xa, int64_t& ia, int64_t& xb, int64_t& ib,
                   bool asc) {
  const bool swap = later(xa, ia, xb, ib) == asc;
  const int64_t x0 = xa, i0 = ia;
  xa = swap ? xb : xa;
  ia = swap ? ib : ia;
  xb = swap ? x0 : xb;
  ib = swap ? i0 : ib;
}

// The bitonic sort in registers: thread t holds positions E t .. E t +
// E - 1 (E = 2 or 4; whole warps of threads hold positions, N >= 32 E):
// a stage whose pairs lie in one thread (j < E) is done in place, one
// whose partner lies in the same warp (j < 32 E) by shuffles, the others
// through shared memory.
template <int E, class Block>
LSVM_FN void sort_in_registers(Block& k, const View& v) {
  const int tid = static_cast<int>(k.tid());
  const int N = static_cast<int>(v.N), n2 = static_cast<int>(2 * v.B);
  const bool in = tid < N / E;
  const int lane = tid % 32;
  int64_t x[E], id[E];
  LSVM_UNROLL
  for (int e = 0; e < E; ++e) {
    const int i = E * tid + e;
    x[e] = in && i < n2 ? v.flo[i] : kBig;
    id[e] = i;
  }
  for (int m = 2; m <= N; m <<= 1) {
    for (int j = m >> 1; j > 0; j >>= 1) {
      if (j < E) {
        const int i0 = E * tid;
        if (j == 1) {
          cswap(x[0], id[0], x[1], id[1], (i0 & m) == 0);
          if (E == 4) {
            cswap(x[E - 2], id[E - 2], x[E - 1], id[E - 1],
                  ((i0 + 2) & m) == 0);
          }
        } else {
          // (E == 4, j == 2)
          cswap(x[0], id[0], x[E - 2], id[E - 2], (i0 & m) == 0);
          cswap(x[1], id[1], x[E - 1], id[E - 1], ((i0 + 1) & m) == 0);
        }
        continue;
      }
      const bool shfl = j < 32 * E;
      if (!shfl) {
        if (in) {
          LSVM_UNROLL
          for (int e = 0; e < E; ++e) {
            v.skey[E * tid + e] = x[e];
            v.sid[E * tid + e] = id[e];
          }
        }
        k.sync();
      }
      if (in) {
        LSVM_UNROLL
        for (int e = 0; e < E; ++e) {
          const int i = E * tid + e;
          int64_t ox, oid;
          if (shfl) {
            const int from = lane ^ (j / E);
            ox = k.warp_shfl(x[e], from);
            oid = k.warp_shfl(id[e], from);
          } else {
            ox = v.skey[i ^ j];
            oid = v.sid[i ^ j];
          }
          // the lower position keeps the earlier of the two when the
          // run ascends, the later when it descends
          const bool lower = (i & j) == 0, asc = (i & m) == 0;
          const bool take = (lower == asc) == later(x[e], id[e], ox, oid);
          x[e] = take ? ox : x[e];
          id[e] = take ? oid : id[e];
        }
      }
      if (!shfl) k.sync();
    }
  }
  if (in) {
    LSVM_UNROLL
    for (int e = 0; e < E; ++e) {
      v.skey[E * tid + e] = x[e];
      v.sid[E * tid + e] = id[e];
    }
  }
  k.sync();
}

// The bitonic sort of the 2B windows by (start, number) into skey/sid
// (padded to N with empty windows): in registers with 32-thread warps
// when 2 or 4 positions a thread cover N (sort_in_registers), otherwise
// every stage through memory.
template <class Block>
LSVM_FN void sort_windows(Block& k, const View& v) {
  const int tid = static_cast<int>(k.tid()), nt = static_cast<int>(k.nt());
  const int N = static_cast<int>(v.N), n2 = static_cast<int>(2 * v.B);
  if (k.ws() == 32 && N >= 64 && N <= 2 * nt) {
    sort_in_registers<2>(k, v);
    return;
  }
  if (k.ws() == 32 && N >= 128 && N <= 4 * nt) {
    sort_in_registers<4>(k, v);
    return;
  }
  for (int i = tid; i < N; i += nt) {
    v.skey[i] = i < n2 ? v.flo[i] : kBig;
    v.sid[i] = i;
  }
  k.sync();
  // (N and j are powers of two: pair q's first position is q with a zero
  // bit inserted at j)
  for (int m = 2; m <= N; m <<= 1) {
    for (int j = m >> 1; j > 0; j >>= 1) {
      for (int q = tid; q < N / 2; q += nt) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1)), l = i + j;
        const int64_t ki = v.skey[i], kl = v.skey[l];
        const int64_t ii = v.sid[i], il = v.sid[l];
        const bool swap = later(ki, ii, kl, il) == ((i & m) == 0);
        v.skey[i] = swap ? kl : ki;
        v.skey[l] = swap ? ki : kl;
        v.sid[i] = swap ? il : ii;
        v.sid[l] = swap ? ii : il;
      }
      k.sync();
    }
  }
}

// Over the block's threads (a thread past `parts` holds the identities):
// ea / ew the largest `a` / `aw` of the threads before this one, em the
// smallest `m` of the threads after it.  With 32-thread warps, by warp
// shuffles and the warps' totals in shared memory (two barriers);
// otherwise by doubling steps in shared memory.
template <class Block>
LSVM_FN void block_scan(Block& k, const View& v, int64_t a, int64_t aw,
                        int64_t m, int64_t parts, int64_t& ea, int64_t& ew,
                        int64_t& em) {
  const int64_t tid = k.tid(), nt = k.nt();
  int64_t* xa = v.scan;
  int64_t* xw = v.scan + nt;
  int64_t* mw = v.scan + 2 * nt;
  if (k.ws() == 32 && nt % 32 == 0) {
    const int lane = static_cast<int>(tid % 32);
    const int64_t warp = tid / 32, nw = nt / 32;
    int64_t ia = a, iw = aw, im = m;
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t ya = k.warp_shfl(ia, lane >= d ? lane - d : lane);
      const int64_t yw = k.warp_shfl(iw, lane >= d ? lane - d : lane);
      const int64_t ym = k.warp_shfl(im, lane + d < 32 ? lane + d : lane);
      ia = imax(ia, ya);
      iw = imax(iw, yw);
      im = imin(im, ym);
    }
    if (lane == 31) {
      xa[warp] = ia;
      xw[warp] = iw;
    }
    if (lane == 0) mw[warp] = im;
    const int64_t pa = k.warp_shfl(ia, lane > 0 ? lane - 1 : 0);
    const int64_t pw = k.warp_shfl(iw, lane > 0 ? lane - 1 : 0);
    const int64_t pm = k.warp_shfl(im, lane < 31 ? lane + 1 : 31);
    k.sync();
    ea = lane > 0 ? pa : -kBig;
    ew = lane > 0 ? pw : -kBig;
    em = lane < 31 ? pm : kBig;
    for (int64_t u = 0; u < warp; ++u) {
      ea = imax(ea, xa[u]);
      ew = imax(ew, xw[u]);
    }
    for (int64_t u = warp + 1; u < nw; ++u) em = imin(em, mw[u]);
    k.sync();
    return;
  }
  if (tid < parts) {
    xa[tid] = a;
    xw[tid] = aw;
    mw[tid] = m;
  }
  k.sync();
  for (int64_t d = 1; d < parts; d <<= 1) {
    int64_t na = 0, nw = 0, nm = 0;
    if (tid < parts) {
      na = xa[tid];
      nw = xw[tid];
      nm = mw[tid];
      if (tid >= d) {
        na = imax(na, xa[tid - d]);
        nw = imax(nw, xw[tid - d]);
      }
      if (tid + d < parts) nm = imin(nm, mw[tid + d]);
    }
    k.sync();
    if (tid < parts) {
      xa[tid] = na;
      xw[tid] = nw;
      mw[tid] = nm;
    }
    k.sync();
  }
  ea = tid > 0 && tid < parts ? xa[tid - 1] : -kBig;
  ew = tid > 0 && tid < parts ? xw[tid - 1] : -kBig;
  em = tid + 1 < parts ? mw[tid + 1] : kBig;
  k.sync();
}

// Sorted, by the whole block: marks window i hit (flo[i] = 1, flo[i] = 0
// otherwise) when another window meets it in the way that makes its lane
// serial; the caller then marks lane b serial when window 2b or 2b+1 is
// hit.  Every thread of the block must call it.
template <class Block>
LSVM_FN void sweep_sorted(Block& k, const View& v) {
  const int64_t tid = k.tid(), nt = k.nt(), N = v.N, n2 = 2 * v.B;
  sort_windows(k, v);
  // each of the first `parts` threads scans a chunk of C positions: the
  // largest end of any window and of a write window, and the smallest
  // start of a write window
  const int64_t C = (N + nt - 1) / nt;
  const int64_t parts = (N + C - 1) / C;
  const int64_t p0 = tid * C, p1 = imin(p0 + C, N);
  int64_t a = -kBig, aw = -kBig, m = kBig;
  if (tid < parts) {
    for (int64_t p = p0; p < p1; ++p) {
      const int64_t id = v.sid[p];
      if (id >= n2) continue;
      const int64_t hi = v.fhi[id];
      a = imax(a, hi);
      if (id & 1) {
        aw = imax(aw, hi);
        m = imin(m, v.skey[p]);
      }
    }
  }
  // the chunks' exclusive prefix maxima (ea, ew) and suffix minimum (em)
  int64_t ea, ew, em;
  block_scan(k, v, a, aw, m, parts, ea, ew, em);
  if (tid < parts) {
    // backward: the smallest write start after each position
    int64_t m = em;
    for (int64_t p = p1 - 1; p >= p0; --p) {
      const int64_t id = v.sid[p];
      const int64_t lo = v.skey[p];
      if (id < n2) {
        const int64_t hi = v.fhi[id];
        const int64_t next = p + 1 < N ? v.skey[p + 1] : kBig;
        v.flo[id] = (id & 1) ? next < hi : m < hi;
        if (id & 1) m = imin(m, lo);
      }
    }
    // forward: the largest end before each position
    int64_t a = ea;
    int64_t aw = ew;
    for (int64_t p = p0; p < p1; ++p) {
      const int64_t id = v.sid[p];
      if (id >= n2) continue;
      const int64_t lo = v.skey[p], hi = v.fhi[id];
      if ((id & 1) ? a > lo : aw > lo) v.flo[id] = 1;
      a = imax(a, hi);
      if (id & 1) aw = imax(aw, hi);
    }
  }
  k.sync();
}

// --- the wave ----------------------------------------------------------------
// The phase clocks (LSVM_PHASE_CLOCKS builds only): thread 0's cycles in
// (a) live and footprints, (b) the sweep, (c) the free lanes up to the
// block's barrier, (e) its replay of the serial lanes, (d) the copies it
// waited for after that; then the macro-steps, the serial lane steps and
// the sum of the five (the macro-steps' cycles).
enum : int64_t { K_A = 0, K_B, K_C, K_D, K_E, K_STEPS, K_SERIAL, K_TOTAL,
                 kClockWords };

// A cluster's helper block: each macro-step, between the cluster barrier
// after block 0's (c) and the one that ends the step, it copies queued
// units with block 0's warps.  The leader's words, queue and descriptors
// are read where block 0 keeps them (its shared memory, or the global
// scratch).
template <class Block>
LSVM_FN void help_wave(const Wave& w, const Plan& plan, Block& k) {
  const View v = view_of(w, plan, k.leader_smem(), k.nt());
  const uint64_t* done = v.misc + M_DONE;
  for (int64_t step = 0;; ++step) {
    k.cluster_sync();
    if (*done) break;
    uint64_t* S = v.misc + (step & 1) * kStepWords;
    const uint64_t qb = S[M_QBULK], qv = S[M_QVEC];
    const int64_t nbu = static_cast<int64_t>(qb & 0xffffffffu);
    const int64_t nvu = static_cast<int64_t>(qv & 0xffffffffu);
    if (nbu + nvu > 0) {
      copy_units(k, v, S, static_cast<int64_t>(qb >> 32), nbu,
                 static_cast<int64_t>(qv >> 32), nvu);
    }
    k.cluster_sync();
  }
  // block 0 keeps its shared memory until every helper has read it
  k.cluster_sync();
}

// `Keep`: the thread's first lane keeps its operands decoded in (a) for
// (c) in registers (the 512-thread build decodes them again instead).
template <bool Keep, class Block>
LSVM_FN void run_wave(const Wave& w, const Plan& plan, Block& k,
                      int64_t* clocks) {
  if (k.cluster_rank() != 0) {
    help_wave(w, plan, k);
    return;
  }
  const bool cluster = k.cluster_size() > 1;
  const int64_t tid = k.tid(), nt = k.nt(), B = w.B;
  const int64_t ws = k.ws(), warp = tid / ws, lane = tid % ws;
  const int64_t nwarps = (nt + ws - 1) / ws;
  int64_t* smem = k.smem();
  const View v = view_of(w, plan, smem, nt);
  uint64_t* M = v.misc;
  const bool small = small_wave(B, nt, ws);

  // the tables into shared memory, the lanes' start: params in r0.., pc at
  // the operator's entry
  if (plan.code >= 0) {
    for (int64_t i = tid; i < w.n_instr * kInstrWidth; i += nt) {
      smem[plan.code + i] = w.code[i];
    }
  }
  if (plan.tabs >= 0) {
    for (int64_t i = tid; i < w.n_regions; i += nt) {
      smem[plan.tabs + i] = w.rbase[i];
      smem[plan.tabs + w.n_regions + i] = w.rmask[i];
    }
    for (int64_t i = tid; i < w.n_dev; i += nt) {
      smem[plan.tabs + 2 * w.n_regions + i] = w.failed[i];
      smem[plan.tabs + 2 * w.n_regions + w.n_dev + i] =
          addr_word(w.rows[i]);
    }
  }
  if (tid == 0) {
    for (int64_t i = 0; i < kMiscWords; ++i) M[i] = 0;
    for (int64_t s = 0; s < v.ring_slots; ++s) k.bulk_init(M + M_MBAR + s);
  }
  for (int64_t b = tid; b < B; b += nt) {
    int64_t* C = v.ctl + b;
    const int64_t sel = clampi(w.op_sel[b], 0, w.n_ops - 1);
    C[L_PC * B] = w.slot_start[sel];
    C[L_PC0 * B] = w.slot_start[sel];
    C[L_END * B] = w.slot_end[sel];
    C[L_FUEL * B] = w.slot_fuel[sel];
    C[L_LSP * B] = 0;
    C[L_INFLIGHT * B] = 0;
    C[L_HALTED * B] = 0;
    C[L_STEPS * B] = 0;
    C[L_HOME * B] = w.homes[b];
    C[L_FLAG * B] = kIdle;
    C[L_RET * B] = 0;
    C[L_STATUS * B] = kStatusFellOff;
    for (int64_t j = 0; j < kStackWords; ++j) v.stack[j * B + b] = 0;
    for (int64_t r = 0; r < kRegs; ++r) {
      v.regs[r * B + b] = r < w.n_params ? w.params[b * w.n_params + r] : 0;
    }
    int64_t* F = w.fault + b * 4;
    F[0] = -1;
    F[1] = F[2] = F[3] = 0;
  }
  k.sync();
#ifdef LSVM_PHASE_CLOCKS
  int64_t ck[kClockWords] = {0, 0, 0, 0, 0, 0, 0, 0};
  int64_t t_mark = k.clock();
  auto lap = [&](int64_t slot) {
    const int64_t now = k.clock();
    ck[slot] += now - t_mark;
    t_mark = now;
  };
#define LSVM_LAP(slot) lap(slot)
#else
#define LSVM_LAP(slot) ((void)0)
#endif

  // the thread's first lane keeps its decoded step from (a) to (c)
  Dec d0;
  for (int64_t step = 0;; ++step) {
    // this step's shared words; thread 0 clears the next step's, which
    // every thread finished reading before the last barrier
    uint64_t* S = M + (step & 1) * kStepWords;
    if (tid == 0) {
      uint64_t* S1 = M + ((step + 1) & 1) * kStepWords;
      for (int64_t i = 0; i < kStepWords; ++i) S1[i] = 0;
    }
    // (a) which lanes are live, and their footprints
    uint64_t mine = 0;
    if (!small || warp == 0) {
      for (int64_t b = tid; b < B; b += nt) {
        int64_t* C = v.ctl + b;
        const bool live = !C[L_HALTED * B] && C[L_PC * B] < C[L_END * B] &&
                          C[L_STEPS * B] < C[L_FUEL * B];
        // a halted lane decodes too (every read is clamped), so the
        // warp does not diverge; its windows are then empty
        Dec d;
        decode(w, v, b, d);
        int64_t iv[4];
        intervals(w, d, iv);
        mine |= live && iv[2] < iv[3] ? kWrites : 0;
        iv[0] = live ? iv[0] : kBig;
        iv[1] = live ? iv[1] : -kBig;
        iv[2] = live ? iv[2] : kBig;
        iv[3] = live ? iv[3] : -kBig;
        if (Keep && b == tid) d0 = d;
        v.flo[2 * b] = iv[0];
        v.fhi[2 * b] = iv[1];
        v.flo[2 * b + 1] = iv[2];
        v.fhi[2 * b + 1] = iv[3];
        C[L_FLAG * B] = !live ? kIdle
                        : meet(iv[2], iv[3], iv[0], iv[1]) ? kSerial : kFree;
        mine |= live ? kLive : 0;
      }
    }
    LSVM_LAP(K_A);

    // (b) the conflict sweep
    if (w.sweep) {
      if (small) {
        if (warp == 0) sweep_pairwise(k, v);
      } else {
        // no lane writes: nothing can conflict
        if (k.warp_or(mine & kWrites) && lane == 0) {
          k.fetch_or(S + M_FLAGS, kWrites);
        }
        k.sync();
        if (S[M_FLAGS] & kWrites) {
          sweep_sorted(k, v);
          for (int64_t b = tid; b < B; b += nt) {
            if (v.ctl[L_FLAG * B + b] == kFree &&
                (v.flo[2 * b] | v.flo[2 * b + 1])) {
              v.ctl[L_FLAG * B + b] = kSerial;
            }
          }
        }
      }
    }
    LSVM_LAP(K_B);

    // (c) the free lanes, each by the thread that owns it (every thread
    // of a warp runs as many rounds, so the warp queues its windows
    // together)
    if (!small || warp == 0) {
      for (int64_t base = 0; base < B; base += nt) {
        const int64_t b = base + tid;
        int64_t cp[kDescWords];
        cp[C_LEN] = 0;
        const int64_t flag = b < B ? v.ctl[L_FLAG * B + b] : kIdle;
        mine |= flag == kSerial ? kAnySerial : 0;
        if (flag == kFree) {
          Dec d;
          if (Keep && b == tid) d = d0;
          else decode(w, v, b, d);
          execute(w, v, b, d, cp);
          if (cp[C_LEN] > 0 && cp[C_LEN] <= kInlineWords) {
            copy_inline(cp);
          }
        }
        enqueue(k, v, S, cp);
      }
      const uint64_t m = k.warp_or(mine);
      if (m && lane == 0) k.fetch_or(S + M_FLAGS, m);
    }
    k.sync();
    LSVM_LAP(K_C);
    const uint64_t f = S[M_FLAGS];
    if (cluster) {
      // the queue is whole: the helpers may copy
      if (tid == 0) M[M_DONE] = (f & kLive) ? 0 : 1;
      k.cluster_sync();
    }
    if (!(f & kLive)) break;

    // (d) the queued windows' copies, by every warp and the bulk copy
    // producer, while (e) warp 0 first replays the serial lanes
    const uint64_t qb = S[M_QBULK], qv = S[M_QVEC];
    const int64_t nb = static_cast<int64_t>(qb >> 32);
    const int64_t nbu = static_cast<int64_t>(qb & 0xffffffffu);
    const int64_t nvq = static_cast<int64_t>(qv >> 32);
    const int64_t nvu = static_cast<int64_t>(qv & 0xffffffffu);
    if (nbu > 0) {
      // the words every thread wrote so far, before the bulk copy engine
      // reads any (a step without bulk windows pays no fence)
      k.proxy_fence();
      k.sync();
    }
    if ((f & kAnySerial) && warp == 0) {
      replay(k, w, v);
#ifdef LSVM_PHASE_CLOCKS
      if (tid == 0) {
        for (int64_t b = 0; b < B; ++b) {
          ck[K_SERIAL] += v.ctl[L_FLAG * B + b] == kSerial;
        }
      }
#endif
    }
    LSVM_LAP(K_E);
    if (nbu > 0 && warp == nwarps - 1) {
      if (lane == 0) produce(k, v, S, nb, nbu);
      k.warp_sync();
    }
    if (nbu + nvu > 0) copy_units(k, v, S, nb, nbu, nvq, nvu);
    if (cluster) k.cluster_sync();
    else k.sync();
    LSVM_LAP(K_D);
#ifdef LSVM_PHASE_CLOCKS
    ck[K_STEPS] += 1;
#endif
  }

  if (cluster) k.cluster_sync();

  // the end of the wave: a lane that did not halt ran out of fuel or off
  // its program's end; fault pcs count from the lane's operator entry
  for (int64_t b = tid; b < B; b += nt) {
    const int64_t* C = v.ctl + b;
    const int64_t steps = C[L_STEPS * B];
    w.ret[b] = C[L_RET * B];
    w.status[b] = C[L_HALTED * B] ? C[L_STATUS * B]
                  : (steps >= C[L_FUEL * B] ? kStatusFuel : kStatusFellOff);
    w.steps[b] = steps;
    for (int64_t r = 0; r < kRegs; ++r) {
      w.regs[b * kRegs + r] = v.regs[r * B + b];
    }
    int64_t* F = w.fault + b * 4;
    if (F[0] >= 0) F[0] = F[0] - C[L_PC0 * B];
  }
#ifdef LSVM_PHASE_CLOCKS
  if (tid == 0 && clocks != nullptr) {
    int64_t total = 0;
    for (int64_t i = K_A; i <= K_E; ++i) total += ck[i];
    ck[K_TOTAL] = total;
    for (int64_t i = 0; i < kClockWords; ++i) clocks[i] = ck[i];
  }
#else
  (void)clocks;
#endif
#undef LSVM_LAP
}

}  // namespace lockstep_vm
