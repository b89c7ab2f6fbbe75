"""The ``lockstep_vm`` kernel: one launch per lockstep wave on the card.

On the CPU: the routes ``impl`` picks, the kernel's operand packing
against the engine's statics, the engines against the JAX package on the
seeded cases of ``test_torch_vm.py`` (its helpers, imported inside the
tests so this file imports no JAX when the card half runs), and the
kernel's own wave algorithm (``csrc/lockstep_vm.cuh``) compiled as host
C++ (``tests/lockstep_vm_host.cpp``, host threads for the block's) and
held to the host loop on a seeded corpus at small sizes.

On the card (``gpu`` marker, skipped here):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lockstep_vm.py

the kernel bit for bit against the host loop over the corpus of
``core/lockstep_corpus.py`` at small sizes, and one launch per wave with
no ``tiara_gather`` launch.
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
    lanes = re.search(r"L_STACK, kLaneWords = L_STACK \+ 3 \* kDepth", src)
    assert lanes and lk.LANE_WORDS == 12 + 3 * 8
    desc = re.search(r"C_SROW = 0, (.*?), kDescWords", src, re.S)
    assert len(desc.group(1).split(",")) + 1 == lk.DESC_WORDS


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
    assert np.array_equal(inputs[9 * k + 18:], w.failed.astype(np.int64))
    assert hdr["mem"] == ops["mem"].data_ptr()
    assert ops["mem"].numel() == w.mem.size + 1
    assert torch.equal(ops["mem"][:-1].view(w.mem.shape), mem)
    for f in FIELDS:
        assert hdr[f] == getattr(out, f).data_ptr()
    assert hdr["scratch"] == scratch.data_ptr()
    assert scratch.numel() == 9 * (lk.LANE_WORDS + lk.DESC_WORDS)
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

@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    so = str(tmp_path_factory.mktemp("lockstep_vm") / "lockstep_vm_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", "-I", CSRC, "-o", so,
                    os.path.join(HERE, "lockstep_vm_host.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    lib.lockstep_vm_host_run.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_int64]
    lib.lockstep_vm_host_run.restype = ctypes.c_int

    def run(eng, mem, args, threads):
        ops = eng.kernel_operands(mem, *args)
        out, scratch = lk.alloc(ops["B"], mem.device)
        hdr = lk.pack(out=out, scratch=scratch, **ops)
        assert lib.lockstep_vm_host_run(hdr.ctypes.data, hdr.size,
                                        threads) == 0
        return vm.VMResult(mem=ops["mem"][:-1].view(mem.shape),
                           **out._asdict())
    return run


@pytest.mark.parametrize("threads", [1, 5])
def test_kernel_source_on_host_threads_matches_the_host_loop(host_kernel,
                                                             threads):
    """The kernel's wave algorithm, run by ``threads`` host threads that
    meet where the kernel's block synchronizes, equals the host loop on
    every wave of the small corpus."""
    for w in small_corpus():
        eng = w.engine()
        mem = torch.from_numpy(w.mem.copy())
        assert_same_wave(host_kernel(eng, mem, w.args(), threads),
                         eng.run_host_loop(mem, *w.args()), w.name)


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


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("group", ["stock", "faults", "loops", "random"])
def test_cuda_kernel_matches_the_host_loop(cuda_device, group):
    """Bit for bit on the card: mem, ret, status, steps, regs and fault,
    the kernel against the host loop, over a part of the corpus."""
    waves = {"stock": lambda: [x for B in (1, 7, 64)
                               for x in corpus.stock_waves(B)]
             + [corpus.mixed_stock_wave(64)],
             "faults": corpus.fault_waves, "loops": corpus.loop_waves,
             "random": lambda: corpus.random_waves(1, 32, (1, 7, 64))}
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
