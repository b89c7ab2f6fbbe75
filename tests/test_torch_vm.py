"""The port's batched and mixed VM engines against the JAX package.

Operators are built and pools populated by the JAX package from numpy
seeds, then carried into the port with ``repro_torch.convert`` (encoded
instruction words and region arrays), so both packages run the
identical program on the identical pool.  Every result field is held
bit for bit: mem, ret, status, steps, regs and fault rows — against the
JAX package's ``pyvm`` oracle for conflict-free waves and against its
mixed lockstep engine for a contended one.  All on the CPU.
"""

import numpy as np
import pytest
import torch

from repro.core import isa as jisa
from repro.core import memory as jmemory
from repro.core import operators as jops
from repro.core import pyvm as jpyvm
from repro.core import vm as jvm
from repro.core.memory import Grant as JGrant
from repro.core.program import OperatorBuilder as JBuilder
from repro.core.verifier import verify as jverify
from repro_torch import convert
from repro_torch.core import vm
from repro_torch.core.memory import Grant
from repro_torch.core.verifier import verify

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# carrying operators across
# ---------------------------------------------------------------------------

def carry(jprog, jrt):
    """(JAX verified op, port verified op, port region table)."""
    jv = jverify(jprog, grant=JGrant.all_of(jrt), regions=jrt)
    prt = convert.regions_from(jrt)
    pprog = convert.program_from_code(
        jprog.code, jprog.name, jprog.n_params, jrt,
        regions_read=jprog.regions_read,
        regions_written=jprog.regions_written)
    pv = verify(pprog, grant=Grant.all_of(prt), regions=prt)
    return jv, pv, prt


def fault_row(f):
    return np.asarray([-1, 0, 0, 0] if f is None
                      else [f.pc, f.opcode, f.addr, f.device], np.int64)


def pyvm_wave(jvs, jrt, mem, op_sel, params, homes=None, failed=None):
    """Sequential JAX-package pyvm oracle over a wave (arrival order)."""
    mem = mem.copy()
    out = dict(ret=[], status=[], steps=[], regs=[], fault=[])
    for b, (s, p) in enumerate(zip(op_sel, params)):
        r = jpyvm.run(jvs[s], jrt, mem, list(p),
                      home=0 if homes is None else int(homes[b]),
                      failed=failed)
        out["ret"].append(r.ret)
        out["status"].append(r.status)
        out["steps"].append(r.steps)
        out["regs"].append(np.asarray(r.regs, np.int64))
        out["fault"].append(fault_row(r.fault))
    return mem, {k: np.asarray(v, np.int64) for k, v in out.items()}


def assert_same(res, mem, want):
    assert np.array_equal(res.mem.cpu().numpy(), np.asarray(mem))
    for k in ("ret", "status", "steps", "regs", "fault"):
        assert np.array_equal(np.asarray(getattr(res, k)),
                              np.asarray(want[k])), k


# ---------------------------------------------------------------------------
# stock workloads at small sizes
# ---------------------------------------------------------------------------

B = 4


def _graph_walk():
    w = jops.GraphWalk(n_nodes=32, max_depth=6, reply_words=B * 8)
    rt = w.regions()
    mem = jmemory.make_pool(1, rt)
    order = w.populate(mem, rt, seed=11)
    params = [[int(order[3 * i]) * 8, 2 + i, 8 * i] for i in range(B)]
    return w.build(rt, reply_param=True), rt, mem, params


def _ptw():
    p = jops.PageTableWalk(fanout=8, n_pages=8, reply_pages=B)
    rt = p.regions()
    mem = jmemory.make_pool(1, rt)
    vas = sorted(p.populate(mem, rt, seed=12))
    params = [[vas[i % len(vas)], 512 * i] for i in range(B)]
    return p.build(rt, reply_param=True), rt, mem, params


def _kv():
    k = jops.PagedKVFetch(n_blocks_pool=16, block_bytes=256,
                          max_req_blocks=4, reply_slots=B)
    rt = k.regions()
    mem = jmemory.make_pool(1, rt)
    k.populate(mem, rt, seed=13)
    k.make_request(mem, rt, [5, 0, 9, 3])
    slot = 4 * k.block_words
    params = [[1 + i % 4, i * slot] for i in range(B)]
    return k.build(rt, reply_param=True), rt, mem, params


def _moe():
    m = jops.MoEExpertGather(n_experts=16, max_k=4, slab_words=32,
                             reply_slots=B)
    rt = m.regions()
    mem = jmemory.make_pool(1, rt)
    m.populate(mem, rt, seed=14)
    jmemory.write_region(mem, rt, 0, "expert_ids", [7, 2, 11, 4])
    params = [[4 - i % 4, i * 4 * 32] for i in range(B)]
    return m.build(rt, reply_param=True), rt, mem, params


WORKLOADS = {"graph_walk": _graph_walk, "ptw3": _ptw,
             "paged_kv_fetch": _kv, "moe_expert_gather": _moe}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_batched_matches_pyvm(name):
    jprog, jrt, mem, params = WORKLOADS[name]()
    jv, pv, prt = carry(jprog, jrt)
    assert pv.step_bound == jv.step_bound
    assert np.array_equal(pv.code, jv.code)
    want_mem, want = pyvm_wave([jv], jrt, mem, [0] * B, params)
    res = vm.invoke_batched(pv, prt, mem, params, device="cpu")
    assert_same(res, want_mem, want)
    assert (want["status"] == jisa.STATUS_OK).all()


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_single_request_matches_pyvm(name):
    jprog, jrt, mem, params = WORKLOADS[name]()
    jv, pv, prt = carry(jprog, jrt)
    want_mem, want = pyvm_wave([jv], jrt, mem, [0], params[:1])
    r = vm.invoke(pv, prt, torch.from_numpy(mem.copy()), params[0])
    assert np.array_equal(r.mem.numpy(), want_mem)
    assert (r.ret, r.status, r.steps) == (want["ret"][0],
                                          want["status"][0],
                                          want["steps"][0])
    assert np.array_equal(r.regs, want["regs"][0]) and r.fault is None


@pytest.mark.parametrize("name", sorted(jops.ALL_WORKLOADS))
def test_own_copies_match_reference(name):
    """The port's own copies of the jax-free modules: the same stock
    workload builds the same code words, populates the same pool for the
    same seed, and verifies to the same bound and certificate."""
    from repro_torch.core import operators as pops
    jw, pw = jops.ALL_WORKLOADS[name](), pops.ALL_WORKLOADS[name]()
    jrt, prt = jw.regions(), pw.regions()
    jm, pm = jmemory.make_pool(1, jrt), np.zeros((1, prt.pool_words),
                                                 np.int64)
    if hasattr(jw, "populate"):
        jout, pout = jw.populate(jm, jrt, seed=4), pw.populate(pm, prt,
                                                                seed=4)
        assert np.array_equal(jm, pm)
        assert repr(jout) == repr(pout)
    jv = jverify(jw.build(jrt), grant=JGrant.all_of(jrt), regions=jrt)
    pv = verify(pw.build(prt), grant=Grant.all_of(prt), regions=prt)
    assert np.array_equal(jv.code, pv.code)
    assert jv.step_bound == pv.step_bound
    assert jv.certificate.describe() == pv.certificate.describe()


def _merged_wave():
    """Five stock operators in one pool, a mixed wave of 9 requests with
    three DistLock lanes contending on one latch."""
    gw = jops.GraphWalk(n_nodes=32, max_depth=4, reply_words=2 * 8)
    ptw = jops.PageTableWalk(fanout=8, n_pages=8, reply_pages=2)
    lk = jops.DistLock(max_retries=2)
    kv = jops.PagedKVFetch(n_blocks_pool=16, block_bytes=256,
                           max_req_blocks=4, reply_slots=2)
    moe = jops.MoEExpertGather(n_experts=16, max_k=4, slab_words=32,
                               reply_slots=2)
    rt, views = jmemory.merge_tables([
        ("gw", gw.regions()), ("ptw", ptw.regions()),
        ("lk", lk.regions()), ("kv", kv.regions()), ("moe", moe.regions())])
    mem = jmemory.make_pool(2, rt)
    order = gw.populate(mem, views["gw"], seed=21)
    vas = sorted(ptw.populate(mem, views["ptw"], seed=22))
    kv.populate(mem, views["kv"], seed=23)
    kv.make_request(mem, views["kv"], [3, 8, 1, 15])
    moe.populate(mem, views["moe"], seed=24)
    jmemory.write_region(mem, views["moe"], 0, "expert_ids", [9, 0, 5, 2])
    progs = [gw.build(views["gw"], reply_param=True),
             ptw.build(views["ptw"], reply_param=True),
             lk.build(views["lk"]),
             kv.build(views["kv"], reply_param=True),
             moe.build(views["moe"], reply_param=True)]
    lock = [0, 1, 77, 1, 2, 1, 3]      # latch 0, state 1, replicas on dev 1
    sel = [2, 0, 3, 2, 1, 4, 2, 0, 3]
    params = [lock, [int(order[1]) * 8, 3, 0], [4, 0],
              [0, 1, 78, 1, 2, 1, 3], [vas[0], 0], [3, 0],
              [0, 1, 79, 1, 2, 1, 3], [int(order[9]) * 8, 4, 8],
              [2, 4 * kv.block_words]]
    return progs, rt, mem, sel, params


def test_mixed_engine_matches_jax_contended():
    """The mixed lockstep engine, contended CAS included (the lowest
    arrival index wins), bit for bit against the JAX mixed engine."""
    progs, jrt, mem, sel, params = _merged_wave()
    carried = [carry(p, jrt) for p in progs]
    jvs = [c[0] for c in carried]
    pvs = [c[1] for c in carried]
    prt = carried[0][2]
    want = jvm.invoke_batched_mixed(jvs, jrt, mem.copy(), sel, params)
    got = vm.invoke_batched_mixed(pvs, prt, mem, sel, params, device="cpu")
    assert_same(got, want.mem, {k: getattr(want, k) for k in
                                ("ret", "status", "steps", "regs", "fault")})
    locks = [b for b, s in enumerate(sel) if s == 2]
    assert got.status[locks[0]] == jisa.STATUS_OK     # first arrival wins
    assert (got.status[locks[1:]] == jisa.STATUS_FAIL).all()


def test_mixed_engine_conflict_free_matches_pyvm():
    """Without the contended lanes the mixed wave equals the sequential
    oracle, with and without the trusted static-noconflict build."""
    progs, jrt, mem, sel, params = _merged_wave()
    keep = [b for b, s in enumerate(sel) if s != 2]
    sel = [sel[b] for b in keep]
    params = [params[b] for b in keep]
    carried = [carry(p, jrt) for p in progs]
    jvs = [c[0] for c in carried]
    prt = carried[0][2]
    want_mem, want = pyvm_wave(jvs, jrt, mem, sel, params)
    for nc in (False, True):
        got = vm.invoke_batched_mixed([c[1] for c in carried], prt, mem,
                                      sel, params, device="cpu",
                                      static_noconflict=nc)
        assert_same(got, want_mem, want)


def _shr_prog(rt):
    b = JBuilder("shr", n_params=2, regions=rt)
    x, s = b.param(0), b.param(1)
    y, z = b.reg(), b.reg()
    b.shr(y, x, s)                   # register shift amount (masked 0..63)
    b.shr(z, x, 1)                   # immediate shift
    b.store(y, "out", b.const(0))
    b.store(z, "out", b.const(1))
    b.ret(y)
    return b.build()


@pytest.mark.parametrize("value,shift", [(-8, 1), (-8, 0), (-1, 63),
                                         (-(1 << 63), 64), (-5, -1),
                                         (12345, 3)])
def test_shr_is_logical(value, shift):
    """SHR on a negative word is a logical shift (torch's >> is
    arithmetic): the port must match pyvm, shift amounts masked."""
    jrt = jmemory.packed_table([("out", 64)])
    jv, pv, prt = carry(_shr_prog(jrt), jrt)
    mem = jmemory.make_pool(1, jrt)
    want_mem, want = pyvm_wave([jv], jrt, mem, [0], [[value, shift]])
    got = vm.invoke_batched(pv, prt, mem, [[value, shift]], device="cpu")
    assert_same(got, want_mem, want)
    assert want["ret"][0] == np.int64(
        np.uint64(value % (1 << 64)) >> np.uint64(shift & 63))


def test_out_of_region_fault_lane():
    """One wild lane faults (STATUS_PROT_FAULT + its FaultInfo row, all
    its writes suppressed); the other lanes run to their real results."""
    jprog, jrt, mem, params = _graph_walk()
    params[2] = [1 << 20, 3, 16]          # offset outside the graph region
    jv, pv, prt = carry(jprog, jrt)
    want_mem, want = pyvm_wave([jv], jrt, mem, [0] * B, params)
    got = vm.invoke_batched(pv, prt, mem, params, device="cpu")
    assert_same(got, want_mem, want)
    assert want["status"][2] == jisa.STATUS_PROT_FAULT
    assert got.fault_at(2).addr == want["fault"][2][2]
    assert got.fault_at(0) is None


def test_failed_device_faults_match_pyvm():
    """A word op homed on a failed device faults exactly as pyvm says."""
    jprog, jrt, m1, params = _graph_walk()
    mem = np.concatenate([m1, m1])        # two device rows
    homes = [0, 1, 0, 1]
    jv, pv, prt = carry(jprog, jrt)
    want_mem, want = pyvm_wave([jv], jrt, mem, [0] * B, params,
                               homes=homes, failed={1})
    got = vm.invoke_batched(pv, prt, mem, params, homes=homes, failed={1},
                            device="cpu")
    assert_same(got, want_mem, want)
    assert list(want["status"]) == [0, jisa.STATUS_PROT_FAULT] * 2


def test_engine_never_mutates_its_input_pool():
    jprog, jrt, mem, params = _kv()
    _, pv, prt = carry(jprog, jrt)
    pool = torch.from_numpy(mem.copy())
    before = pool.clone()
    res = vm.invoke_batched(pv, prt, pool, params)
    assert torch.equal(pool, before)
    assert not torch.equal(res.mem, before)
    assert res.mem.device == pool.device


def test_deferred_result_on_cpu():
    jprog, jrt, mem, params = _ptw()
    _, pv, prt = carry(jprog, jrt)
    res = vm.invoke_batched(pv, prt, mem, params, block=False, device="cpu")
    assert vm.result_ready(res)
    assert isinstance(res.ret, torch.Tensor)
    done = vm.materialize_result(res)
    assert isinstance(done.ret, np.ndarray) and done.mem is res.mem


def test_no_silent_cpu_fallback(monkeypatch):
    """With no card and no device named, an entry point raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jprog, jrt, mem, params = _ptw()
    _, pv, prt = carry(jprog, jrt)
    with pytest.raises(RuntimeError, match="CUDA"):
        vm.invoke_batched(pv, prt, mem, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.pool_from_numpy(mem)
    assert convert.pool_from_numpy(mem, "cpu").device == CPU
