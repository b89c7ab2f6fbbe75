// The lockstep Tiara engine's whole-wave algorithm, written once for any
// "block" of cooperating threads.
//
// `run_wave<Block>` executes one wave of B requests against the shared
// pool from the first macro-step to the last, exactly as the port's host
// loop (`core/vm.py`, `_Engine.run_host_loop`) does:
//
//   * every macro-step, each live request executes its current
//     instruction, and request i observes every memory effect of the
//     requests j < i of the same macro-step (lane-order sequential
//     execution, the `pyvm` oracle's semantics);
//   * a step's lanes whose footprints touch no other lane's ("free"
//     lanes) commute with everything, so they run at once; the others
//     ("serial" lanes) then run one after another in lane order.  The
//     footprints are the host loop's `lane_intervals`, compared pairwise:
//     a lane is serial when its write window meets another lane's read
//     or write window, when its read window meets another lane's write
//     window, or when a MEMCPY's own source and destination meet (a
//     memmove).  With the sweep off (`static_noconflict`, or one lane)
//     only the last test is made;
//   * a free lane's MEMCPY is queued and copied by the whole block after
//     the free lanes have stepped (16-byte vectors where a window
//     neither wraps its region nor is misaligned against its source,
//     word by word otherwise: `tiara_gather`'s window copy); a serial
//     lane's MEMCPY reads its source window into the block's staging
//     buffer before it writes, so an overlapping copy keeps memmove
//     semantics.
//
// Integer arithmetic is done in uint64_t, so it wraps as the hardware
// does (signed overflow is undefined in C++); comparisons are signed.
//
// `Block` supplies tid(), nt(), sync(), sync_or(int), claim(int*) (an
// atomic fetch-and-add of 1), stage() (shared words for the copy staging
// and the interval tiles, at least max(max_window, 4 * nt()) of them),
// ncopy() (a shared int) and desc() (kDescWords shared words).
// `csrc/lockstep_vm.cu` instantiates it with a CUDA thread block; the
// header also compiles as plain C++ (no __CUDACC__), where host threads
// meeting at a barrier run the same code
// (`tests/lockstep_vm_host.cpp`).

#pragma once

#include <stdint.h>

// LSVM_FN marks the code the CUDA kernel runs: device functions under
// nvcc, plain functions in the C++ build.
#ifdef __CUDACC__
#define LSVM_FN __device__ __forceinline__
#define LSVM_FN_NOINLINE __device__
#else
#define LSVM_FN inline
#define LSVM_FN_NOINLINE inline
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
// build).
enum Hdr : int64_t {
  H_CODE = 0, H_N_INSTR, H_RBASE, H_RMASK, H_N_REGIONS, H_SLOT_START,
  H_SLOT_END, H_SLOT_FUEL, H_N_OPS, H_INPUTS, H_N_PARAMS, H_B, H_N_DEV,
  H_POOL_WORDS, H_MAX_WINDOW, H_PROTECT, H_SWEEP, H_MEM, H_RET, H_STATUS,
  H_STEPS, H_REGS, H_FAULT, H_SCRATCH, H_COUNT
};

// per-lane scratch words
enum : int64_t {
  L_PC = 0, L_END, L_FUEL, L_PC0, L_LSP, L_INFLIGHT, L_HALTED, L_FLAG,
  L_RLO, L_RHI, L_WLO, L_WHI, L_STACK, kLaneWords = L_STACK + 3 * kDepth
};
// a queued window copy: source row start, masked source offset, source
// mask, destination row start, masked destination offset, destination
// mask, words
enum : int64_t {
  C_SROW = 0, C_SOFF, C_SMASK, C_DROW, C_DOFF, C_DMASK, C_LEN, kDescWords
};
// lane flags within a macro-step
enum : int64_t { kIdle = 0, kFree = 1, kSerial = 2 };

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
  int64_t* mem;            // n_dev * pool_words words, then the sink word
  int64_t* ret;            // (B,)
  int64_t* status;         // (B,)
  int64_t* steps;          // (B,)
  int64_t* regs;           // (B, 16)
  int64_t* fault;          // (B, 4)
  int64_t* lane;           // (B, kLaneWords)
  int64_t* copies;         // (B, kDescWords)
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
  w.mem = reinterpret_cast<int64_t*>(h[H_MEM]);
  w.ret = reinterpret_cast<int64_t*>(h[H_RET]);
  w.status = reinterpret_cast<int64_t*>(h[H_STATUS]);
  w.steps = reinterpret_cast<int64_t*>(h[H_STEPS]);
  w.regs = reinterpret_cast<int64_t*>(h[H_REGS]);
  w.fault = reinterpret_cast<int64_t*>(h[H_FAULT]);
  w.lane = reinterpret_cast<int64_t*>(h[H_SCRATCH]);
  w.copies = w.lane + w.B * kLaneWords;
  return w;
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
LSVM_FN int64_t clampi(int64_t a, int64_t lo,
                                                   int64_t hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}
// Python's (and torch.remainder's) modulo: the sign of the divisor
LSVM_FN int64_t pymod(int64_t a, int64_t n) {
  const int64_t r = a % n;
  return r < 0 ? r + n : r;
}

// the 16-entry ALU table of vm.py's `_alu_table`, indexed by the clamped
// opcode (14 and 15 pass `a` through)
LSVM_FN int64_t alu(int64_t op, int64_t a,
                                                int64_t b) {
  const unsigned sh = static_cast<unsigned>(b & 63);
  const uint64_t ua = static_cast<uint64_t>(a);
  switch (clampi(op, 0, 15)) {
    case 0: return wadd(a, b);
    case 1: return wsub(a, b);
    case 2: return wmul(a, b);
    case 3: return a & b;
    case 4: return a | b;
    case 5: return a ^ b;
    case 6: return static_cast<int64_t>(ua << sh);
    case 7: return static_cast<int64_t>(ua >> sh);
    case 8: return a == b;
    case 9: return a != b;
    case 10: return a < b;
    case 11: return a >= b;
    case 12: return imin(a, b);
    case 13: return imax(a, b);
    default: return a;
  }
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

LSVM_FN int64_t dev_of(const Wave& w,
                                                   int64_t reg, int64_t fld,
                                                   bool via, int64_t home) {
  const int64_t d = via ? reg : fld;
  return d == kDevLocal ? home : pymod(d, w.n_dev);
}

LSVM_FN bool dev_oob(const Wave& w, int64_t reg,
                                                 bool via) {
  return via && reg != kDevLocal && (reg < 0 || reg >= w.n_dev);
}

LSVM_FN bool failed_dev(const Wave& w,
                                                    int64_t d) {
  return w.failed[clampi(d, 0, w.n_dev - 1)] != 0;
}

LSVM_FN_NOINLINE void decode(const Wave& w, int64_t b, Dec& d) {
  const int64_t* L = w.lane + b * kLaneWords;
  const int64_t* R = w.regs + b * kRegs;
  d.pc = L[L_PC];
  const int64_t* row = w.code + clampi(d.pc, 0, w.n_instr - 1) * kInstrWidth;
  d.op = row[F_OP];
  d.dstf = row[F_DST];
  const int64_t af = row[F_A], bf = row[F_B], cf = row[F_C];
  d.df = row[F_D];
  const int64_t ef = row[F_E];
  d.flags = row[F_FLAGS];
  d.imm = row[F_IMM];
  d.imm2 = row[F_IMM2];
  d.rA = R[af & 15];
  d.rB = R[bf & 15];
  d.rC = R[cf & 15];
  d.rD = R[d.df & 15];
  const int64_t rE = R[ef & 15];
  d.rDST = R[d.dstf & 15];
  const int64_t rIMM2 = R[d.imm2 & 15];
  d.rERR = R[kErrReg];
  const int64_t home = w.homes[b];
  const int64_t flags = d.flags;

  // word ops (LOAD/STORE/CAS/CAA)
  const int64_t w_rid = clampi(af, 0, w.n_regions - 1);
  const bool w_via = (flags & FLAG_DEV_REG) != 0;
  d.w_dev = dev_of(w, rE, ef, w_via, home);
  d.w_off = wadd(d.rB, d.imm);
  const int64_t w_mask = w.rmask[w_rid];
  d.w_addr = wadd(w.rbase[w_rid], d.w_off & w_mask);
  // memcpy operands
  const int64_t m_drid = clampi(af, 0, w.n_regions - 1);
  const int64_t m_srid = clampi(d.df, 0, w.n_regions - 1);
  const bool via_d = (flags & FLAG_DSTDEV_REG) != 0;
  const bool via_s = (flags & FLAG_SRCDEV_REG) != 0;
  d.m_ddev = dev_of(w, d.rDST, d.dstf, via_d, home);
  d.m_sdev = dev_of(w, d.rC, cf, via_s, home);
  d.m_dbase = w.rbase[m_drid];
  d.m_sbase = w.rbase[m_srid];
  d.m_dmask = w.rmask[m_drid];
  d.m_smask = w.rmask[m_srid];
  const int64_t cap = d.imm;
  int64_t ln = (flags & FLAG_LEN_REG) ? imin(imax(rIMM2, 0), cap) : cap;
  ln = imin(imin(ln, wadd(d.m_dmask, 1)), wadd(d.m_smask, 1));
  d.m_fail = failed_dev(w, d.m_ddev) || failed_dev(w, d.m_sdev);
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
              failed_dev(w, d.w_dev);
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
LSVM_FN_NOINLINE void intervals(const Wave& w, const Dec& d,
                                          int64_t* iv) {
  const int64_t P = w.pool_words;
  const bool is_load = d.op == OP_LOAD;
  const bool is_store = d.op == OP_STORE;
  const bool is_atom = d.op == OP_CAS || d.op == OP_CAA;
  const bool is_mcpy = d.op == OP_MEMCPY;
  const int64_t wf = wadd(wmul(d.w_dev, P), d.w_addr);
  int64_t r_lo = kBig, r_hi = -kBig, w_lo = kBig, w_hi = -kBig;
  if (is_load) {
    r_lo = wf;
    r_hi = wadd(wf, 1);
  } else if (is_store || is_atom) {
    w_lo = wf;
    w_hi = wadd(wf, 1);
  } else if (is_mcpy) {
    const int64_t s_size = wadd(d.m_smask, 1);
    const int64_t s_start = d.m_soff & d.m_smask;
    const bool s_wrap = wadd(s_start, d.ln) > s_size;
    r_lo = wadd(wadd(wmul(d.m_sdev, P), d.m_sbase), s_wrap ? 0 : s_start);
    r_hi = wadd(r_lo, s_wrap ? s_size : d.ln);
    const int64_t d_size = wadd(d.m_dmask, 1);
    const int64_t d_start = d.m_doff & d.m_dmask;
    const bool d_wrap = wadd(d_start, d.ln) > d_size;
    w_lo = wadd(wadd(wmul(d.m_ddev, P), d.m_dbase), d_wrap ? 0 : d_start);
    w_hi = wadd(w_lo, d_wrap ? d_size : d.ln);
  }
  // a zero-length window is empty, not a point
  if (r_hi <= r_lo) { r_lo = kBig; r_hi = -kBig; }
  if (w_hi <= w_lo) { w_lo = kBig; w_hi = -kBig; }
  iv[0] = r_lo;
  iv[1] = r_hi;
  iv[2] = w_lo;
  iv[3] = w_hi;
}

LSVM_FN bool meet(int64_t alo, int64_t ahi,
                                              int64_t blo, int64_t bhi) {
  return alo < bhi && blo < ahi;
}

// --- one lane's step, all but the MEMCPY's window copy --------------------
// The word ops read and write the pool here; a MEMCPY that copies leaves
// its window in `cp` (C_LEN > 0) for the block to copy.
LSVM_FN_NOINLINE void execute(const Wave& w, int64_t b,
                                        const Dec& d, int64_t* cp) {
  int64_t* L = w.lane + b * kLaneWords;
  int64_t* R = w.regs + b * kRegs;
  const int64_t P = w.pool_words;
  const int64_t op = d.op;
  const bool is_movi = op == OP_MOVI, is_alu = op == OP_ALU;
  const bool is_load = op == OP_LOAD, is_store = op == OP_STORE;
  const bool is_mcpy = op == OP_MEMCPY;
  const bool is_cas = op == OP_CAS, is_atom = is_cas || op == OP_CAA;
  const bool is_jump = op == OP_JUMP, is_loop = op == OP_LOOP;
  const bool is_wait = op == OP_WAIT, is_ret = op == OP_RET;
  const int64_t flags = d.flags;
  cp[C_LEN] = 0;

  const bool flt = w.protect &&
                   ((d.w_flt && (is_load || is_store || is_atom)) ||
                    (d.m_flt && is_mcpy));

  // LOAD / CAS / CAA read the word (vm.py's `_DenseOps.readv` clamps)
  int64_t w_old = 0;
  if (is_load || is_atom) {
    w_old = w.mem[clampi(d.w_dev, 0, w.n_dev - 1) * P +
                  clampi(d.w_addr, 0, P - 1)];
  }
  // the register write channel
  if ((is_movi || is_alu || is_load || is_atom || is_mcpy) && !flt) {
    int64_t v;
    if (is_movi) {
      v = d.imm;
    } else if (is_alu) {
      v = alu(d.df, d.rA, (flags & FLAG_IMMB) ? d.imm : d.rB);
    } else if (is_load || is_atom) {
      v = w_old;
    } else {
      v = d.m_fail ? (d.rERR | 1) : d.rERR;
    }
    R[is_mcpy ? kErrReg : (d.dstf & 15)] = v;
  }
  // STORE / CAS / CAA write the word
  if ((is_store || is_atom) && !flt) {
    const int64_t hit = w_old == d.rC;
    const int64_t v = is_store ? d.rDST
                               : (hit ? (is_cas ? d.rD : wadd(w_old, d.rD))
                                      : w_old);
    const int64_t at = wadd(wmul(d.w_dev, P), d.w_addr);
    if (at >= 0 && at < w.n_dev * P) w.mem[at] = v;
  }
  // MEMCPY: queue the window (words past max_window are never copied)
  if (is_mcpy && !flt) {
    const int64_t n = imin(d.ln, w.max_window);
    const int64_t drow = wadd(wmul(d.m_ddev, P), d.m_dbase);
    // (a destination row outside the pool, from a home past the last
    // device, is never written)
    if (n > 0 && drow >= 0 && drow + d.m_dmask < w.n_dev * P) {
      cp[C_SROW] = clampi(d.m_sdev, 0, w.n_dev - 1) * P + d.m_sbase;
      cp[C_SOFF] = d.m_soff & d.m_smask;
      cp[C_SMASK] = d.m_smask;
      cp[C_DROW] = drow;
      cp[C_DOFF] = d.m_doff & d.m_dmask;
      cp[C_DMASK] = d.m_dmask;
      cp[C_LEN] = n;
    }
  }
  // the in-flight counter
  int64_t inflight = L[L_INFLIGHT];
  if (is_mcpy && !flt && (flags & FLAG_ASYNC)) {
    inflight = imin(inflight + 1, kMaxInflight);
  }
  if (is_wait) {
    const int64_t thr = (flags & FLAG_THR_REG) ? d.rA : d.imm;
    inflight = imin(inflight, imax(thr, 0));
  }
  L[L_INFLIGHT] = inflight;
  w.steps[b] = w.steps[b] + 1;

  // RET / protection fault
  if (is_ret) {
    L[L_HALTED] = 1;
    w.ret[b] = d.rA;
    w.status[b] = d.imm;
    return;
  }
  if (flt) {
    L[L_HALTED] = 1;
    w.status[b] = kStatusProtFault;
    int64_t* F = w.fault + b * 4;
    F[0] = d.pc;
    F[1] = op;
    F[2] = is_mcpy ? d.m_faddr : d.w_off;
    F[3] = is_mcpy ? d.m_fdev : d.w_fdev;
    return;
  }

  // control flow and the depth-8 loop stack
  const int64_t pc = d.pc;
  int64_t* S = L + L_STACK;
  int64_t lsp = L[L_LSP];
  bool take = false;
  if (is_jump) {
    const int64_t lhs = d.rA;
    const int64_t rhs = (flags & FLAG_IMMB) ? d.imm : d.rB;
    const int64_t cond = d.df;
    take = cond == ALU_ALWAYS ? true
           : cond == ALU_EQ   ? lhs == rhs
           : cond == ALU_NE   ? lhs != rhs
           : cond == ALU_LT   ? lhs < rhs
                              : lhs >= rhs;
  }
  bool skip = false;
  if (is_loop) {
    const int64_t m = (flags & FLAG_MREG) ? imin(imax(d.rB, 0), d.imm)
                                          : d.imm;
    skip = m <= 0;
    if (!skip) {
      const int64_t sp = clampi(lsp, 0, kDepth - 1);
      S[3 * sp + 0] = wadd(pc, 1);
      S[3 * sp + 1] = wadd(pc, d.imm2);
      S[3 * sp + 2] = m;
      lsp = lsp + 1;
    }
  }
  int64_t pc_new = wadd(pc, 1);
  if ((is_jump && take) || (is_loop && skip)) {
    pc_new = wadd(wadd(pc, 1), d.imm2);
  }
  if (is_jump && take) {
    // a taken jump pops every frame whose body it escaped
    for (int k = 0; k < kDepth; ++k) {
      if (lsp > 0 && S[3 * clampi(lsp - 1, 0, kDepth - 1) + 1] < pc_new) {
        lsp = lsp - 1;
      }
    }
  } else {
    // a normal advance iterates or pops the frames whose body just ended
    for (int k = 0; k < kDepth; ++k) {
      if (lsp <= 0) break;
      int64_t* top = S + 3 * clampi(lsp - 1, 0, kDepth - 1);
      if (pc_new != wadd(top[1], 1)) break;
      const int64_t rem = top[2] - 1;
      if (rem > 0) {
        top[2] = rem;
        pc_new = top[0];
        break;
      }
      lsp = lsp - 1;
    }
  }
  L[L_PC] = pc_new;
  L[L_LSP] = lsp;
}

// --- the block's window copies ------------------------------------------
#ifdef __CUDACC__
typedef ulonglong2 vec16_t;
#else
struct alignas(16) vec16_t {
  unsigned long long x, y;
};
#endif

// Copy one queued window with the `g` threads of a group, this thread
// being `t` of them: the source and destination do not overlap.
LSVM_FN_NOINLINE void copy_window(int64_t* mem, const int64_t* cp,
                                            int64_t t, int64_t g) {
  const int64_t n = cp[C_LEN];
  const int64_t soff = cp[C_SOFF], smask = cp[C_SMASK];
  const int64_t doff = cp[C_DOFF], dmask = cp[C_DMASK];
  if (soff + (n - 1) <= smask && doff + (n - 1) <= dmask) {
    const int64_t* src = mem + cp[C_SROW] + soff;
    int64_t* dst = mem + cp[C_DROW] + doff;
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
      int64_t v = t;
      for (; v + 3 * g < nv; v += 4 * g) {
        const vec16_t a0 = s2[v], a1 = s2[v + g], a2 = s2[v + 2 * g],
                      a3 = s2[v + 3 * g];
        d2[v] = a0;
        d2[v + g] = a1;
        d2[v + 2 * g] = a2;
        d2[v + 3 * g] = a3;
      }
      for (; v < nv; v += g) d2[v] = s2[v];
      if (((n - head) & 1) && t == 0) dst[n - 1] = src[n - 1];
    } else {
      for (int64_t i = t; i < n; i += g) dst[i] = src[i];
    }
  } else {
    // a window that wraps its region, word by word
    const int64_t srow = cp[C_SROW], drow = cp[C_DROW];
    for (int64_t i = t; i < n; i += g) {
      mem[drow + ((doff + i) & dmask)] = mem[srow + ((soff + i) & smask)];
    }
  }
}

// --- the wave ---------------------------------------------------------------
template <class Block>
LSVM_FN_NOINLINE void run_wave(const Wave& w, Block& k) {
  const int64_t tid = k.tid(), nt = k.nt(), B = w.B;
  int64_t* stage = k.stage();

  // the lanes' start: params in r0.., pc at the operator's entry
  for (int64_t b = tid; b < B; b += nt) {
    int64_t* L = w.lane + b * kLaneWords;
    const int64_t sel = clampi(w.op_sel[b], 0, w.n_ops - 1);
    L[L_PC] = w.slot_start[sel];
    L[L_PC0] = w.slot_start[sel];
    L[L_END] = w.slot_end[sel];
    L[L_FUEL] = w.slot_fuel[sel];
    L[L_LSP] = 0;
    L[L_INFLIGHT] = 0;
    L[L_HALTED] = 0;
    for (int64_t j = 0; j < 3 * kDepth; ++j) L[L_STACK + j] = 0;
    int64_t* R = w.regs + b * kRegs;
    for (int64_t r = 0; r < kRegs; ++r) {
      R[r] = r < w.n_params ? w.params[b * w.n_params + r] : 0;
    }
    w.ret[b] = 0;
    w.status[b] = kStatusFellOff;
    w.steps[b] = 0;
    int64_t* F = w.fault + b * 4;
    F[0] = -1;
    F[1] = F[2] = F[3] = 0;
  }
  k.sync();

  for (;;) {
    // (a) which lanes are live, and their footprints
    if (tid == 0) *k.ncopy() = 0;
    int any = 0, serial = 0;
    for (int64_t b = tid; b < B; b += nt) {
      int64_t* L = w.lane + b * kLaneWords;
      const bool live = !L[L_HALTED] && L[L_PC] < L[L_END] &&
                        w.steps[b] < L[L_FUEL];
      int64_t flag = kIdle;
      L[L_RLO] = L[L_WLO] = kBig;
      L[L_RHI] = L[L_WHI] = -kBig;
      if (live) {
        Dec d;
        decode(w, b, d);
        intervals(w, d, L + L_RLO);
        flag = meet(L[L_WLO], L[L_WHI], L[L_RLO], L[L_RHI]) ? kSerial
                                                              : kFree;
        any = 1;
      }
      L[L_FLAG] = flag;
      serial |= flag == kSerial;
    }
    if (!k.sync_or(any)) break;

    // (b) the conflict sweep, pairwise over tiles of nt lanes
    if (w.sweep) {
      for (int64_t t0 = 0; t0 < B; t0 += nt) {
        const int64_t tn = imin(nt, B - t0);
        if (tid < tn) {
          const int64_t* L = w.lane + (t0 + tid) * kLaneWords;
          for (int j = 0; j < 4; ++j) stage[4 * tid + j] = L[L_RLO + j];
        }
        k.sync();
        for (int64_t b = tid; b < B; b += nt) {
          int64_t* L = w.lane + b * kLaneWords;
          if (L[L_FLAG] != kFree) continue;
          const int64_t rlo = L[L_RLO], rhi = L[L_RHI];
          const int64_t wlo = L[L_WLO], whi = L[L_WHI];
          bool hit = false;
          for (int64_t j = 0; j < tn && !hit; ++j) {
            if (t0 + j == b) continue;
            const int64_t* o = stage + 4 * j;
            hit = meet(wlo, whi, o[2], o[3]) || meet(wlo, whi, o[0], o[1]) ||
                  meet(rlo, rhi, o[2], o[3]);
          }
          if (hit) {
            L[L_FLAG] = kSerial;
            serial = 1;
          }
        }
        k.sync();
      }
    }
    serial = k.sync_or(serial);

    // (c) the free lanes, each by the thread that owns it
    for (int64_t b = tid; b < B; b += nt) {
      if (w.lane[b * kLaneWords + L_FLAG] != kFree) continue;
      Dec d;
      decode(w, b, d);
      int64_t cp[kDescWords];
      execute(w, b, d, cp);
      if (cp[C_LEN] > 0) {
        int64_t* q = w.copies + k.claim(k.ncopy()) * kDescWords;
        for (int j = 0; j < kDescWords; ++j) q[j] = cp[j];
      }
    }
    k.sync();

    // (d) their window copies, by the whole block: groups of whole warps
    // (of the whole block when there are fewer copies than warps)
    const int64_t nq = *k.ncopy();
    if (nq > 0) {
      const int64_t warps = nt >= 32 ? nt / 32 : 1;
      const int64_t groups = imin(nq, warps);
      const int64_t g = nt >= 32 ? (warps / groups) * 32 : nt;
      const int64_t grp = tid / g;
      if (grp < groups) {
        for (int64_t i = grp; i < nq; i += groups) {
          copy_window(w.mem, w.copies + i * kDescWords, tid % g, g);
        }
      }
    }
    k.sync();

    // (e) the serial lanes, one after another in lane order
    if (serial) {
      int64_t* desc = k.desc();
      for (int64_t b = 0; b < B; ++b) {
        if (w.lane[b * kLaneWords + L_FLAG] != kSerial) continue;
        if (tid == 0) {
          Dec d;
          decode(w, b, d);
          execute(w, b, d, desc);
        }
        k.sync();
        int64_t cp[kDescWords];
        for (int j = 0; j < kDescWords; ++j) cp[j] = desc[j];
        k.sync();
        const int64_t n = cp[C_LEN];
        if (n > 0) {
          // the whole source window first, then the destination: memmove
          for (int64_t i = tid; i < n; i += nt) {
            stage[i] = w.mem[cp[C_SROW] + ((cp[C_SOFF] + i) & cp[C_SMASK])];
          }
          k.sync();
          for (int64_t i = tid; i < n; i += nt) {
            w.mem[cp[C_DROW] + ((cp[C_DOFF] + i) & cp[C_DMASK])] = stage[i];
          }
          k.sync();
        }
      }
    }
    k.sync();
  }

  // the end of the wave: a lane that did not halt ran out of fuel or off
  // its program's end; fault pcs count from the lane's operator entry
  for (int64_t b = tid; b < B; b += nt) {
    const int64_t* L = w.lane + b * kLaneWords;
    if (!L[L_HALTED]) {
      w.status[b] = w.steps[b] >= L[L_FUEL] ? kStatusFuel : kStatusFellOff;
    }
    int64_t* F = w.fault + b * 4;
    if (F[0] >= 0) F[0] = F[0] - L[L_PC0];
  }
}

}  // namespace lockstep_vm
