"""The ``lockstep_vm`` kernel: one launch per lockstep wave on the card.

On the CPU: the routes ``impl`` picks, the kernel's operand packing
against the engine's statics, the engines against the JAX package on the
seeded cases of ``test_torch_vm.py`` (its helpers, imported inside the
tests so this file imports no JAX when the card half runs), and the
kernel's own wave algorithm (``csrc/lockstep_vm.cuh``) compiled as host
C++ (``tests/lockstep_vm_host.cpp``, host threads for the block's) and
held to the host loop on a seeded corpus at small sizes.  The sharded
engine's kernel route runs the same host build on one row buffer per
shard, held to the sharded host loop and to the JAX package's dense
mixed engine over the arrival-order wave (``test_torch_sharded.py``'s
deployment, imported inside the tests).

On the card (``gpu`` marker, skipped here):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lockstep_vm.py

the kernel bit for bit against the host loop over the corpus of
``core/lockstep_corpus.py`` at small sizes, one launch per wave with no
``tiara_gather`` launch, and a sharded wave on a mesh of one card as one
launch equal to the sharded host loop.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import lockstep_corpus as corpus
from repro_torch.core import vm
from repro_torch.kernels.lockstep_vm import kernel as lk

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "src", "repro_torch", "kernels",
                    "lockstep_vm", "csrc")
FIELDS = ("ret", "status", "steps", "regs", "fault")


def small_corpus():
    """The corpus at small sizes: the stock operators at 1 and 7 lanes
    (256-byte KV blocks), the mixed stock wave, the fault rows, the loops
    and fuel, and 12 random waves."""
    return corpus.corpus(sizes=(1, 7), n_random=12, block_bytes=256,
                         resolver=False)


def assert_same_wave(got: vm.VMResult, want: vm.VMResult, tag: str):
    assert torch.equal(got.mem.cpu(), want.mem.cpu()), f"{tag}: mem"
    for f in FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f).cpu()), \
            f"{tag}: {f}"


# ---------------------------------------------------------------------------
# CPU: routes and packing
# ---------------------------------------------------------------------------

def test_auto_on_a_cpu_pool_runs_the_host_loop(monkeypatch):
    w = corpus.stock_waves(7, block_bytes=256)[0]
    eng = w.engine()
    mem = torch.from_numpy(w.mem.copy())

    def refuse(*a, **k):
        raise AssertionError("the kernel route ran on a CPU pool")
    monkeypatch.setattr(eng, "run_kernel", refuse)
    kernels.reset_launch_counts()
    got = eng(mem, *w.args())
    assert_same_wave(got, eng.run_host_loop(mem, *w.args()), w.name)
    assert kernels.launch_counts()["lockstep_vm"] == 0
    assert (got.status == 0).all()


def test_cuda_on_a_cpu_pool_raises():
    w = corpus.stock_waves(1, block_bytes=256)[0]
    mem = torch.from_numpy(w.mem.copy())
    with pytest.raises(ValueError, match="CUDA"):
        w.engine(impl="cuda")(mem, *w.args())
    with pytest.raises(ValueError, match="CUDA"):
        vm.invoke_batched(w.ops[0], w.regions, mem, w.params.tolist(),
                          impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        w.engine(impl="triton")


def test_header_order_matches_the_kernel_source():
    """kernel.HEADER and the source's Hdr enum name the same operands in
    the same order, and the scratch sizes agree."""
    src = open(os.path.join(CSRC, "lockstep_vm.cuh")).read()
    body = re.search(r"enum Hdr : int64_t \{(.*?)\};", src, re.S).group(1)
    names = [n.strip()[2:].lower() for n in body.split(",") if n.strip()]
    names = [n.split("=")[0].strip() for n in names]
    assert names[-1] == "count"
    assert tuple(names[:-1]) == tuple(n.lower() for n in lk.HEADER)
    ctl = re.search(r"L_PC = 0, (.*?), kCtlWords", src, re.S)
    assert len(ctl.group(1).split(",")) + 1 == lk.CTL_WORDS
    lanes = re.search(r"kLaneWords = kCtlWords \+ kRegs \+ kStackWords", src)
    assert lanes and re.search(r"kStackWords = 3 \* kDepth", src)
    assert lk.LANE_WORDS == lk.CTL_WORDS + lk.NUM_REGS + 3 * 8
    desc = re.search(r"C_SROW = 0, (.*?),\s*kDescWords", src, re.S)
    assert len(desc.group(1).split(",")) + 1 == lk.DESC_WORDS
    clocks = re.search(r"K_A = 0, (.*?),\s*kClockWords", src, re.S)
    assert len(clocks.group(1).split(",")) + 1 == len(lk.CLOCK_WORDS)
    assert f"kMaxThreads = {lk.MAX_THREADS};" in src
    # the pool is reached only through the row table: no flat pool pointer
    # and no dev * P + addr index anywhere in the code
    assert "rows" in lk.HEADER and "mem" not in lk.HEADER
    code = re.sub(r"//[^\n]*", "", src)
    assert re.search(r"int64_t\* const\* rows;", code)
    assert not re.search(r"\bmem\b", code)
    assert not re.search(r"\[[^\]]*\* P \+", code)


def test_packing_round_trips_the_program_statics():
    """Every pointer of the header names a tensor holding what
    ``_program_statics`` and the region table say; the inputs tensor holds
    the wave's params, programs (clamped by the kernel), homes and failed
    devices back to back."""
    w = corpus.mixed_stock_wave(9)
    eng = w.engine()
    mem = torch.from_numpy(w.mem.copy())
    ops = eng.kernel_operands(mem, *w.args())
    out, scratch = lk.alloc(ops["B"], mem.device)
    hdr = dict(zip(lk.HEADER, lk.pack(out=out, scratch=scratch, **ops)))
    code_np, start_np, end_np, fuel_np, max_window = vm._program_statics(
        [o.code for o in w.ops], [o.step_bound for o in w.ops])
    base_np, mask_np, _ = w.regions.as_arrays()
    held = dict(code=code_np, rbase=base_np, rmask=mask_np,
                slot_start=start_np, slot_end=end_np, slot_fuel=fuel_np)
    for name, want in held.items():
        t = ops[name]
        assert hdr[name] == t.data_ptr()
        assert np.array_equal(t.numpy().reshape(want.shape), want), name
    assert (hdr["n_instr"], hdr["n_regions"], hdr["n_ops"]) == (
        code_np.shape[0], base_np.shape[0], len(w.ops))
    assert (hdr["B"], hdr["n_dev"], hdr["pool_words"], hdr["max_window"]) \
        == (9, 2, w.mem.shape[1], max_window)
    assert (hdr["protect"], hdr["sweep"]) == (1, 1)
    k = hdr["n_params"]
    inputs = ops["inputs"].numpy()
    assert hdr["inputs"] == ops["inputs"].data_ptr()
    assert np.array_equal(inputs[:9 * k].reshape(9, k), w.params[:, :k])
    assert np.array_equal(inputs[9 * k:9 * k + 9], w.op_sel)
    assert np.array_equal(inputs[9 * k + 9:9 * k + 18], w.homes)
    n_dev, P = w.mem.shape
    assert np.array_equal(inputs[9 * k + 18:9 * k + 18 + n_dev],
                          w.failed.astype(np.int64))
    # the row table: the engine's private flat copy, row d at d * P, its
    # sink word past the last row; the header points at the table
    rows = ops["rows"]
    flat = rows[0].data_ptr()
    assert [r.data_ptr() for r in rows] == [flat + 8 * d * P
                                            for d in range(n_dev)]
    assert flat != mem.data_ptr()
    assert rows[0].untyped_storage().nbytes() == 8 * (w.mem.size + 1)
    assert inputs[9 * k + 18 + n_dev:].tolist() == [r.data_ptr()
                                                    for r in rows]
    assert hdr["rows"] == ops["inputs"].data_ptr() + 8 * (9 * k + 18 + n_dev)
    assert torch.equal(torch.stack(rows), mem)
    for f in FIELDS:
        assert hdr[f] == getattr(out, f).data_ptr()
    assert hdr["scratch"] == scratch.data_ptr()
    assert scratch.numel() == lk.scratch_words(9) == \
        9 * (lk.LANE_WORDS + 4 + lk.DESC_WORDS) + 2 * 32 + 3 * 512
    # a static proof turns the sweep off; so does a wave of one
    nc = corpus.mixed_stock_wave(9)
    nc.static_noconflict = True
    assert nc.engine().kernel_operands(mem, *nc.args())["sweep"] is False


# ---------------------------------------------------------------------------
# CPU: the engines against the JAX package, through test_torch_vm's helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_engines_match_jax_on_the_seeded_cases(impl):
    """The stock workloads, batched and one request, and the conflict-free
    merged wave of five programs, with and without the static proof,
    against the JAX package's pyvm, the route asked for by name and left
    to the pool."""
    import test_torch_vm as tv
    for name, make in sorted(tv.WORKLOADS.items()):
        jprog, jrt, mem, params = make()
        jv, pv, prt = tv.carry(jprog, jrt)
        want_mem, want = tv.pyvm_wave([jv], jrt, mem, [0] * len(params),
                                      params)
        got = vm.invoke_batched(pv, prt, mem, params, device="cpu",
                                impl=impl)
        tv.assert_same(got, want_mem, want)
        mem1, want1 = tv.pyvm_wave([jv], jrt, mem, [0], params[:1])
        one = vm.invoke(pv, prt, torch.from_numpy(mem.copy()), params[0],
                        impl=impl)
        assert np.array_equal(one.mem.numpy(), mem1)
        assert (one.ret, one.status, one.steps) == (
            want1["ret"][0], want1["status"][0], want1["steps"][0])
        assert np.array_equal(one.regs, want1["regs"][0])
    progs, jrt, mem, sel, params = tv._merged_wave()
    keep = [b for b, s in enumerate(sel) if s != 2]     # no lock lanes
    sel = [sel[b] for b in keep]
    params = [params[b] for b in keep]
    carried = [tv.carry(p, jrt) for p in progs]
    want_mem, want = tv.pyvm_wave([c[0] for c in carried], jrt, mem, sel,
                                  params)
    for nc in (False, True):
        got = vm.invoke_batched_mixed([c[1] for c in carried],
                                      carried[0][2], mem, sel, params,
                                      device="cpu", static_noconflict=nc,
                                      impl=impl)
        tv.assert_same(got, want_mem, want)


# ---------------------------------------------------------------------------
# CPU: the kernel's wave algorithm, compiled as host C++
# ---------------------------------------------------------------------------

#: the card's shared memory a block may take, in words (227 KB)
CARD_SMEM_WORDS = 232448 // 8
#: host blocks: (threads, warp width); 64 threads in two warps of 32 run
#: the bulk copy producer beside the copying warps, as the card does
BLOCKS = {1: 1, 5: 4, 64: 32}


def _build_host(tmp_path_factory, *defines):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    so = str(tmp_path_factory.mktemp("lockstep_vm") / "lockstep_vm_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", *defines, "-I", CSRC, "-o", so,
                    os.path.join(HERE, "lockstep_vm_host.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.lockstep_vm_host_run.argtypes = [ptr, i64, i64, i64, i64, i64, ptr,
                                         i64]
    lib.lockstep_vm_host_run.restype = ctypes.c_int
    lib.lockstep_vm_host_plan.argtypes = [ptr, i64, i64, i64, ptr]
    lib.lockstep_vm_host_sweep.argtypes = [ptr, i64, i64, i64, i64, ptr]
    return lib


class HostKernel:
    """The kernel source built for the host, run on a wave's own packed
    operands."""

    def __init__(self, lib):
        self.lib = lib

    def header(self, eng, mem, args):
        ops = eng.kernel_operands(mem, *args)
        out, scratch = lk.alloc(ops["B"], mem.device)
        return ops, out, scratch, lk.pack(out=out, scratch=scratch, **ops)

    def plan(self, hdr, threads, smem_words=CARD_SMEM_WORDS):
        out = np.zeros(5 + 7, np.int64)
        self.lib.lockstep_vm_host_plan(hdr.ctypes.data, threads,
                                       BLOCKS.get(threads, 32), smem_words,
                                       out.ctypes.data)
        return dict(words=out[0], ring=out[1], stage=out[2], code=out[3],
                    tabs=out[4], parts=dict(zip(
                        ("ctl", "regs", "stack", "foot", "sort", "scan",
                         "desc"), out[5:])))

    def __call__(self, eng, mem, args, threads, *, smem_words=CARD_SMEM_WORDS,
                 keep=True, clocks=None, cluster=0):
        ops, out, _, hdr = self.header(eng, mem, args)
        rc = self.lib.lockstep_vm_host_run(
            hdr.ctypes.data, hdr.size, threads, BLOCKS.get(threads, 32),
            smem_words, int(keep),
            None if clocks is None else clocks.ctypes.data, cluster)
        assert rc == 0
        return vm.VMResult(mem=torch.stack(ops["rows"]), **out._asdict())

    def launcher(self, launched, threads=64):
        """A stand-in for ``lockstep_vm_kernel``: the host build run on the
        operands as the card's wrapper packs them (CPU tensors), each
        launch's operands appended to ``launched``."""
        def launch(**operands):
            out, scratch = lk.alloc(operands["B"], operands["inputs"].device)
            hdr = lk.pack(out=out, scratch=scratch, **operands)
            rc = self.lib.lockstep_vm_host_run(
                hdr.ctypes.data, hdr.size, threads, BLOCKS[threads],
                CARD_SMEM_WORDS, 0, None, 0)
            assert rc == 0
            launched.append(operands)
            return out
        return launch

    def sweep(self, iv, threads, ws, sorted_):
        iv = np.ascontiguousarray(iv, dtype=np.int64)
        out = np.zeros(iv.shape[0], np.int64)
        self.lib.lockstep_vm_host_sweep(iv.ctypes.data, iv.shape[0],
                                        threads, ws, int(sorted_),
                                        out.ctypes.data)
        return out.astype(bool)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    return HostKernel(_build_host(tmp_path_factory))


@pytest.mark.parametrize("threads", sorted(BLOCKS))
def test_kernel_source_on_host_threads_matches_the_host_loop(host_kernel,
                                                             threads):
    """The kernel's wave algorithm, run by ``threads`` host threads that
    meet where the kernel's block and warps synchronize, equals the host
    loop on every wave of the small corpus (the 1-thread block keeps its
    decoded operands as the 256-thread build does, the others decode again
    as the 512-thread build does)."""
    for w in small_corpus():
        eng = w.engine()
        mem = torch.from_numpy(w.mem.copy())
        assert_same_wave(host_kernel(eng, mem, w.args(), threads,
                                     keep=threads == 1),
                         eng.run_host_loop(mem, *w.args()), w.name)


@pytest.mark.parametrize("threads", [5, 64])
def test_kernel_source_keeps_lane_state_in_global_memory_past_the_budget(
        host_kernel, threads):
    """A wave whose lane state overflows the block's shared memory (a
    budget that holds the staging window and little else) keeps its state
    in the global scratch and still equals the host loop; at the card's
    227 KB the same waves keep everything on chip."""
    waves = [corpus.stock_waves(64, block_bytes=256)[i] for i in (2, 3, 7)]
    waves += corpus.random_waves(5, 2, (64,))
    for w in waves:
        eng = w.engine()
        mem = torch.from_numpy(w.mem.copy())
        _, _, _, hdr = host_kernel.header(eng, mem, w.args())
        budget = 48 + eng.max_window + 2
        tight = host_kernel.plan(hdr, threads, budget)
        assert tight["stage"] >= 0
        assert all(tight["parts"][p] < 0 for p in ("ctl", "regs", "stack",
                                                    "foot", "desc")), tight
        roomy = host_kernel.plan(hdr, threads)
        assert all(roomy["parts"][p] >= 0 for p in ("ctl", "regs", "stack",
                                                     "foot"))
        assert_same_wave(host_kernel(eng, mem, w.args(), threads,
                                     smem_words=budget),
                         eng.run_host_loop(mem, *w.args()), w.name)


def test_kernel_source_plans_the_card_shapes(host_kernel):
    """At the card's 227 KB: a resolver wave (one warp: its windows are
    one word) keeps its tables and every part of its lane state on chip; a
    wave of 1024 lanes (512 threads) keeps its control words, footprints
    and sorted sweep on chip and its registers and loop stacks in the
    global scratch."""
    w = corpus.resolver_wave(n_slots=16, pages=8, n_pages=64)
    _, _, _, hdr = host_kernel.header(w.engine(), torch.from_numpy(w.mem),
                                      w.args())
    assert lk.threads_for(16, 1) == 32
    p = host_kernel.plan(hdr, 32)
    assert p["code"] >= 0 and p["tabs"] >= 0 and p["ring"] == 0
    assert all(p["parts"][q] >= 0 for q in ("ctl", "regs", "stack", "foot",
                                             "desc"))
    w = corpus.stock_waves(1024, block_bytes=256, serialized=False)[0]
    _, _, _, hdr = host_kernel.header(w.engine(), torch.from_numpy(w.mem),
                                      w.args())
    assert lk.threads_for(1024, 1) == lk.MAX_THREADS == 512
    p = host_kernel.plan(hdr, 512)
    assert p["words"] <= CARD_SMEM_WORDS
    assert all(p["parts"][q] >= 0 for q in ("ctl", "foot", "sort", "scan"))
    assert p["parts"]["regs"] < 0 and p["parts"]["stack"] < 0


def test_kernel_source_runs_the_resolver_wave(host_kernel):
    """The serving resolver's wave (8 tenants' remote-reply fetches) at a
    small table: every lane streams its block ids to the reply region."""
    w = corpus.resolver_wave(pages=8, n_pages=64)
    eng = w.engine()
    mem = torch.from_numpy(w.mem.copy())
    got = host_kernel(eng, mem, w.args(), 3)
    assert_same_wave(got, eng.run_host_loop(mem, *w.args()), w.name)
    assert got.ret.tolist() == [8] * 8 and (got.status == 0).all()


def test_kernel_source_serializes_a_contended_wave(host_kernel):
    """The contended lock: the lowest lane wins the latch, every other
    lane sees it taken (serialized steps), as pyvm says."""
    w = corpus.stock_waves(7, block_bytes=256)[2]
    assert w.name.startswith("dist_lock")
    got = host_kernel(w.engine(), torch.from_numpy(w.mem.copy()), w.args(),
                      4)
    assert got.status.tolist() == [0] + [1] * 6


def test_kernel_source_copies_long_windows_through_the_bulk_ring(
        host_kernel):
    """8 KiB KV blocks (1024-word windows, several 4 KiB copy units each)
    at 64 lanes: the producer's bulk ring and the copying warps share the
    units, and every reply slot equals the host loop's."""
    for w in corpus.stock_waves(64, serialized=False)[2:4]:
        eng = w.engine()
        mem = torch.from_numpy(w.mem.copy())
        _, _, _, hdr = host_kernel.header(eng, mem, w.args())
        assert host_kernel.plan(hdr, 64)["ring"] >= 2
        assert_same_wave(host_kernel(eng, mem, w.args(), 64),
                         eng.run_host_loop(mem, *w.args()), w.name)


@pytest.mark.parametrize("cluster", [2, 8])
def test_kernel_source_on_a_cluster_of_host_blocks(host_kernel, cluster):
    """Helper blocks copy block 0's queued windows between cluster
    barriers, through its shared memory: the stock waves whose windows
    are queued (32-word KV blocks, 32-word expert slabs) and a random wave
    equal the host loop; the launch picks a cluster of 8 for 256 lanes
    with queued windows and one block otherwise."""
    waves = corpus.stock_waves(64, block_bytes=256, serialized=False)[2:]
    waves += corpus.random_waves(9, 1, (64,))
    for w in waves:
        eng = w.engine()
        mem = torch.from_numpy(w.mem.copy())
        assert_same_wave(host_kernel(eng, mem, w.args(), 64, keep=False,
                                     cluster=cluster),
                         eng.run_host_loop(mem, *w.args()), w.name)
    src = open(os.path.join(CSRC, "lockstep_vm.cuh")).read()
    assert "kClusterMinLanes = 256;" in src and "kClusterMax = 8;" in src


def test_phase_clocks_build_counts_steps_and_serial_lanes(tmp_path_factory):
    """The phase-clocks build of the same source: its macro-step count is
    the wave's longest lane, its serial lane steps are at least the
    contended lock's (every lane but the winner retries), and its result
    equals the host loop's."""
    clk = HostKernel(_build_host(tmp_path_factory, "-DLSVM_PHASE_CLOCKS"))
    w = corpus.stock_waves(7, block_bytes=256)[2]
    eng = w.engine()
    mem = torch.from_numpy(w.mem.copy())
    words = np.full(len(lk.CLOCK_WORDS), -1, np.int64)
    got = clk(eng, mem, w.args(), 5, clocks=words)
    assert_same_wave(got, eng.run_host_loop(mem, *w.args()), w.name)
    c = dict(zip(lk.CLOCK_WORDS, words.tolist()))
    assert c["steps"] == int(got.steps.max())
    assert c["serial"] >= w.B - 1
    assert c["total"] == 0          # the host's clock reads 0


def _pairwise(iv):
    """Per lane: another lane's window meets it as the pairwise sweep
    asks (vm.py's ``_lane_conflicts``), and its own windows meet."""
    t = torch.from_numpy(np.asarray(iv, dtype=np.int64))
    r_lo, r_hi, w_lo, w_hi = t.unbind(1)
    e_r, e_w = r_hi <= r_lo, w_hi <= w_lo
    big = vm._BIG
    r_lo = torch.where(e_r, big, r_lo)
    r_hi = torch.where(e_r, -big, r_hi)
    w_lo = torch.where(e_w, big, w_lo)
    w_hi = torch.where(e_w, -big, w_hi)
    pair = vm._lane_conflicts(r_lo, r_hi, w_lo, w_hi).numpy()
    own = ((w_lo < r_hi) & (r_lo < w_hi)).numpy()
    return pair, own


def _random_footprints(rng, B, span):
    iv = np.zeros((B, 4), np.int64)
    for b in range(B):
        for k in (0, 2):
            if rng.random() < 0.25:
                continue                      # an empty window
            lo = int(rng.integers(0, span))
            iv[b, k:k + 2] = (lo, lo + int(rng.integers(1, 6)))
    return iv


@pytest.mark.parametrize("seed", range(6))
def test_sorted_sweep_contains_the_pairwise_set(host_kernel, seed):
    """On seeded random footprints (dense and sparse, ties among starts,
    empty windows), the block's sorted sweep marks every lane the pairwise
    sweep marks, and no other lane but those whose own windows meet; so
    does the pairwise form itself."""
    rng = np.random.default_rng(seed)
    for B in (1, 2, 7, 33, 100, 257):
        for span in (4, 16, 4 * B + 1):
            iv = _random_footprints(rng, B, span)
            pair, own = _pairwise(iv)
            for threads, ws in ((1, 1), (5, 4), (64, 32)):
                got = host_kernel.sweep(iv, threads, ws, True)
                assert (got >= pair).all() and (got <= (pair | own)).all()
            assert (host_kernel.sweep(iv, 1, 1, False) == (pair | own)).all()


def test_sorted_sweep_contains_the_pairwise_set_on_the_corpus(
        host_kernel, monkeypatch):
    """The same on the corpus's own footprints: every macro-step's
    windows, as the host loop hands them to its conflict sweep, over the
    small corpus's waves of more than one lane."""
    seen = []
    orig = vm._sweep_conflict

    def record(r_lo, r_hi, w_lo, w_hi):
        seen.append(torch.stack([r_lo, r_hi, w_lo, w_hi], 1).numpy().copy())
        return orig(r_lo, r_hi, w_lo, w_hi)
    monkeypatch.setattr(vm, "_sweep_conflict", record)
    for w in small_corpus() + [corpus.mixed_stock_wave(64)]:
        if w.B > 1:
            w.engine().run_host_loop(torch.from_numpy(w.mem.copy()),
                                     *w.args())
    assert len(seen) > 100
    for iv in seen:
        pair, own = _pairwise(iv)
        got = host_kernel.sweep(iv, 5, 4, True)
        assert (got >= pair).all() and (got <= (pair | own)).all()


# ---------------------------------------------------------------------------
# CPU: the sharded engine's kernel route, one row buffer a shard
# ---------------------------------------------------------------------------

SHARDED_WAVES = ("acceptance", "contended", "memcpy", "failed")


@pytest.fixture(scope="module")
def sharded_pair():
    """test_torch_sharded's deployment on both packages: 4 tenants of
    latch/data/reply (1024 reply words) over 4 homes, every acceptance
    operator registered (plus rmw and the yardstick's nop)."""
    import test_torch_sharded as ts
    return ts, ts._connect(n_tenants=4, reply_words=1024)


def _sharded_wave(ts, pair, name, seed=3):
    """A wave of posts over ``ts.N_DEV`` homes: ``acceptance`` the
    reference's acceptance mix (tests/test_sharded.py) cut to 32 posts,
    ``contended`` CAS, STORE and store-then-load on shared latches from
    every home, ``memcpy`` MEMCPYs from every device into every home,
    ``failed`` the acceptance mix with the last device failed.  Returns
    (op ids, params, homes, failed devices)."""
    rng = np.random.default_rng(seed)
    n = ts.N_DEV
    posts = []
    for i in range(32 if name in ("acceptance", "failed") else 16):
        s = pair.sessions[i % 4]
        home = int(rng.integers(0, n))
        if name == "contended":
            posts.append((s, ("rcas", "store_latch", "rmw")[i % 3],
                          ([1000 + i, 0], [2000 + i], [3000 + i, 1])[i % 3],
                          home))
        elif name == "memcpy":
            posts.append((s, "rcpy", [int(rng.integers(0, 60)),
                                      512 + 4 * i, (3 * i + 1) % n],
                          i % n))
        else:
            kind = i % 8
            if kind < 3:
                posts.append((s, "sum2", [int(rng.integers(0, 60)), i], home))
            elif kind < 5:
                posts.append((s, "rcpy", [int(rng.integers(0, 60)),
                                          512 + 4 * i,
                                          int(rng.integers(0, n))], home))
            elif kind == 5:
                posts.append((s, "cas_latch", [10_000 + i], home))
            elif kind == 6:
                posts.append((s, "store_latch", [20_000 + i], home))
            else:
                posts.append((s, "rcas", [30_000 + i,
                                          int(rng.integers(0, n))], home))
    failed = {n - 1} if name == "failed" else None
    return ([s.op_id(op) for s, op, _, _ in posts],
            [p for _, _, p, _ in posts], [h for _, _, _, h in posts], failed)


def _spy_sharded_routes(monkeypatch):
    """Keep each sharded engine route's device-major result."""
    seen = {}
    for name in ("run_kernel", "run_host_loop"):
        orig = getattr(vm._ShardedEngine, name)

        def spy(self, *a, _orig=orig, _name=name):
            seen[_name] = _orig(self, *a)
            return seen[_name]
        monkeypatch.setattr(vm._ShardedEngine, name, spy)
    return seen


@pytest.mark.parametrize("name", SHARDED_WAVES)
def test_kernel_source_runs_the_sharded_wave_on_row_buffers(
        host_kernel, sharded_pair, monkeypatch, name):
    """The sharded engine's kernel route with the host build as its
    launch: one launch over one private row buffer per shard, no
    collective; bit for bit the sharded host loop's result, device-major
    (pool rows, ret, status, steps, registers and fault rows, padding
    lanes included), and the JAX package's dense mixed engine's over the
    arrival-order wave on the same pool (the reference's mixed engines
    count a fault's pc in the merged store, the port from the operator's
    entry)."""
    from repro.core import vm as jvm
    from repro_torch.core import compile as tc
    ts, pair = sharded_pair
    ep = pair.ep
    ids, params, homes, failed = _sharded_wave(ts, pair, name)
    pool = ep.host_mem().copy()
    vops, rt = ep.registry.store_ops(), ep.regions
    plan = tc.plan_mixed_batch(ids, homes=homes, n_devices=ts.N_DEV)
    mesh = ts._mesh()
    seen = _spy_sharded_routes(monkeypatch)
    want = vm.invoke_sharded_mixed(vops, rt, pool, plan, params,
                                   failed=failed, mesh=mesh, impl="torch")
    assert sum(mesh.collective_counts().values()) > 0
    launched = []
    monkeypatch.setattr(vm, "sharded_route", lambda impl, mesh: "cuda")
    monkeypatch.setattr(vm, "lockstep_vm_kernel",
                        host_kernel.launcher(launched))
    mesh.reset_stats()
    got = vm.invoke_sharded_mixed(vops, rt, pool, plan, params,
                                  failed=failed, mesh=mesh)
    assert len(launched) == 1 and mesh.collective_counts() == {}
    ops = launched[0]
    assert ops["B"] == len(ids) and ops["n_dev"] == ts.N_DEV
    assert len({r.untyped_storage().data_ptr() for r in ops["rows"]}) \
        == ts.N_DEV
    for f in vm.VMResult._fields:
        assert torch.equal(getattr(seen["run_kernel"], f).full(),
                           getattr(seen["run_host_loop"], f).full()), f
    assert not np.array_equal(got.mem.full().numpy(), pool)
    assert np.array_equal(got.mem.full().numpy(), want.mem.full().numpy())
    for f in ("ret", "status", "steps", "regs", "fault"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    # the JAX dense mixed engine over the arrival-order wave, padded with
    # memoryless lanes as test_torch_sharded's yardstick pads it
    pad = -len(ids) % ts.YARD_PAD
    jp = [list(p) + [0] * (ts.YARD_PARAMS - len(p)) for p in params]
    j = jvm.invoke_batched_mixed(
        pair.jep.registry.store_ops(), pair.jep.regions, pool,
        ids + [pair.sessions[0].op_id("nop")] * pad,
        jp + [[0] * ts.YARD_PARAMS] * pad, homes=homes + [0] * pad,
        failed=failed)
    B = len(ids)
    assert np.array_equal(np.asarray(j.mem), got.mem.full().numpy())
    for f in ("ret", "status", "steps", "regs"):
        assert np.array_equal(np.asarray(getattr(j, f))[:B],
                              getattr(got, f)), f
    fault = np.array(j.fault)[:B]
    entry = pair.jep.registry.dispatch_table()[ids]
    fault[:, 0] = np.where(fault[:, 0] >= 0, fault[:, 0] - entry, -1)
    assert np.array_equal(fault, got.fault)
    if name == "failed":
        assert (got.fault[:, 0] >= 0).any()
        assert (got.fault[got.fault[:, 0] >= 0, 3] == ts.N_DEV - 1).all()


def test_kernel_source_rows_of_one_flat_buffer(host_kernel, sharded_pair,
                                               monkeypatch):
    """The dense route, its rows laid out in one flat buffer at d * P,
    runs the acceptance wave in arrival order on the host build equal to
    its host loop and to the sharded kernel route over one buffer a
    shard (the same lanes, rows and results, only the rows' addresses
    differ)."""
    from repro_torch.core import compile as tc
    ts, pair = sharded_pair
    ep = pair.ep
    ids, params, homes, _ = _sharded_wave(ts, pair, "acceptance")
    pool = torch.from_numpy(ep.host_mem().copy())
    vops = ep.registry.store_ops()
    p, h = vm._marshal_batch(params, homes)
    eng = vm.build_mixed_batched_vm(vops, ep.regions, ts.N_DEV, len(ids))
    args = (p, h, np.zeros(ts.N_DEV, bool), np.asarray(ids))
    flat = host_kernel(eng, pool, args, 64, keep=False)
    ops, _, _, _ = host_kernel.header(eng, pool, args)
    P = pool.shape[1]
    assert [r.data_ptr() for r in ops["rows"]] == [
        ops["rows"][0].data_ptr() + 8 * d * P for d in range(ts.N_DEV)]
    assert_same_wave(flat, eng.run_host_loop(pool, *args), "flat rows")
    launched = []
    monkeypatch.setattr(vm, "sharded_route", lambda impl, mesh: "cuda")
    monkeypatch.setattr(vm, "lockstep_vm_kernel",
                        host_kernel.launcher(launched))
    got = vm.invoke_sharded_mixed(
        vops, ep.regions, pool.numpy(),
        tc.plan_mixed_batch(ids, homes=homes, n_devices=ts.N_DEV), params,
        mesh=ts._mesh())
    assert torch.equal(got.mem.full(), flat.mem)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(flat, f).numpy()), f


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("group", ["stock", "faults", "loops", "random",
                                   "wide"])
def test_cuda_kernel_matches_the_host_loop(cuda_device, group):
    """Bit for bit on the card: mem, ret, status, steps, regs and fault,
    the kernel against the host loop, over a part of the corpus; "wide"
    takes the stock operators at 256 and 1024 lanes (the sorted sweep, the
    512-thread build, lane state past the shared budget, the bulk copy
    ring on 8 KiB blocks) and the mixed wave at 1024."""
    waves = {"stock": lambda: [x for B in (1, 7, 64)
                               for x in corpus.stock_waves(B)]
             + [corpus.mixed_stock_wave(64)],
             "faults": corpus.fault_waves, "loops": corpus.loop_waves,
             "random": lambda: corpus.random_waves(1, 32, (1, 7, 64)),
             "wide": lambda: [x for B in (256, 1024)
                              for x in corpus.stock_waves(B,
                                                          serialized=False)]
             + [corpus.mixed_stock_wave(1024, locks=False)]}
    for w in waves[group]():
        eng = w.engine()
        mem = torch.from_numpy(w.mem.copy()).to(cuda_device)
        got = eng.run_kernel(mem, *w.args())
        want = eng.run_host_loop(mem, *w.args())
        torch.cuda.synchronize()
        assert_same_wave(got, want, w.name)


@pytest.mark.gpu
def test_cuda_wave_is_one_launch(cuda_device):
    """A wave on a card pool makes exactly one lockstep_vm launch and no
    tiara_gather launch; "torch" on a card pool raises."""
    w = corpus.stock_waves(64)[3]
    assert w.name.startswith("paged_kv_fetch")
    mem = torch.from_numpy(w.mem.copy()).to(cuda_device)
    eng = w.engine()
    kernels.reset_launch_counts()
    got = eng(mem, *w.args())
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["lockstep_vm"] == 1 and counts["tiara_gather"] == 0
    assert_same_wave(got, eng.run_host_loop(mem, *w.args()), w.name)
    with pytest.raises(ValueError, match="impl='torch'"):
        w.engine(impl="torch")(mem, *w.args())


@pytest.mark.gpu
def test_cuda_sharded_wave_is_one_launch(cuda_device):
    """The mixed stock wave (contended lock lanes, remote replies) over a
    mesh of 2 shards of the card: "auto" runs it as one lockstep_vm
    launch, no tiara_gather launch and no collective, equal to the
    sharded host loop ("torch") bit for bit; "cuda" on a mesh of CPU
    shards raises."""
    from repro_torch.core import compile as tc
    from repro_torch.distributed.mesh import make_device_mesh
    w = corpus.mixed_stock_wave(64)
    plan = tc.plan_mixed_batch(w.op_sel, homes=w.homes, n_devices=w.n_dev)
    mesh = make_device_mesh(w.n_dev, devices=[cuda_device] * w.n_dev)
    pool = torch.from_numpy(w.mem.copy()).to(cuda_device)
    run = dict(mesh=mesh, failed={1})
    want = vm.invoke_sharded_mixed(w.ops, w.regions, pool, plan,
                                   w.params.tolist(), impl="torch", **run)
    kernels.reset_launch_counts()
    mesh.reset_stats()
    got = vm.invoke_sharded_mixed(w.ops, w.regions, pool, plan,
                                  w.params.tolist(), **run)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["lockstep_vm"] == 1 and counts["tiara_gather"] == 0
    assert mesh.collective_counts() == {}
    assert torch.equal(got.mem.full(), want.mem.full())
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    cpu = make_device_mesh(w.n_dev, devices=["cpu"] * w.n_dev)
    with pytest.raises(ValueError, match="CUDA"):
        vm.invoke_sharded_mixed(w.ops, w.regions, w.mem, plan,
                                w.params.tolist(), mesh=cpu, impl="cuda")


@pytest.mark.gpu
def test_cuda_phase_clocks_and_pointer_chase(cuda_device):
    """The phase-clocks build equals the main build on a wave and counts
    its macro-steps; the pointer chase follows its chain to the end."""
    w = corpus.resolver_wave(pages=32, n_pages=256)
    eng = w.engine()
    mem = torch.from_numpy(w.mem.copy()).to(cuda_device)
    ops = eng.kernel_operands(mem, *w.args())
    out, clocks = lk.lockstep_vm_clocks(**ops)
    want = eng.run_host_loop(mem, *w.args())
    torch.cuda.synchronize()
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(want, f)), f
    c = dict(zip(lk.CLOCK_WORDS, clocks.tolist()))
    assert c["steps"] == int(want.steps.max()) and c["total"] > 0
    assert c["total"] == sum(c[k] for k in "abcde")
    n = 1 << 12
    perm = torch.randperm(n, device=cuda_device)
    buf = torch.zeros(n, dtype=torch.int64, device=cuda_device)
    buf[perm] = torch.roll(perm, -1)
    got = lk.pointer_chase(buf, int(perm[0]), 3 * n + 5)
    assert int(got[1]) == int(perm[5]) and int(got[0]) > 0
