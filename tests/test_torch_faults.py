"""The reference's fault scenarios (``tests/test_faults.py``) replayed on
the port, on the CPU, plus a differential of every fault-table row and
every certificate enforcement point against the JAX package.

The port's engines and endpoints get ``device="cpu"``; a result's pool
is a tensor, read through ``.cpu().numpy()`` (``_np``).  The failed
device under ``placement="auto"`` lives in
``tests/test_torch_sharded_endpoint.py``; the doorbell retry's requeue
in ``tests/test_torch_endpoint.py``.

RNIC-grade fault semantics, end to end.

Layer by layer:

1. **Engines** — a wild pointer / failed device takes a runtime
   protection fault (``STATUS_PROT_FAULT``): the lane halts with the
   faulting instruction's architectural effect suppressed, and every
   engine (pyvm oracle, dense batched, trace-compiled, double-buffered)
   reports bit-identical status/steps/regs/mem *and* the same decoded
   :class:`~repro.core.isa.FaultInfo`.
2. **Degraded mode** — a MEMCPY touching a *failed* device is NOT a
   fault: it sets the error register, drops the copy, and the operator
   keeps running (paper §3.2); an async one still occupies an in-flight
   slot so WAIT semantics are unchanged.
3. **Endpoint** — a faulting post's CQE carries the FaultInfo, the
   owning session enters the RNIC QP error state (subsequent posts
   retire ``STATUS_FLUSHED`` until ``reset()``), other sessions are
   untouched; transient doorbell losses are absorbed by bounded retry;
   a poisoned deferred materialization loses no CQEs.
4. **Harness** — :mod:`repro.core.faults` plans compose and validate;
   the simulator models mid-flight transfer aborts.

The hypothesis chaos property at the bottom runs at the reference's
``max_examples``.
"""

import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.core import compile as tc
from repro_torch.core import faults, isa, memory, pyvm, vm
from repro_torch.core import operators as ops
from repro_torch.core.endpoint import EndpointError, TiaraEndpoint
from repro_torch.core.memory import Grant
from repro_torch.core.serving_loop import VirtualClock
from repro_torch.core.program import OperatorBuilder
from repro_torch.core.verifier import verify


# ---------------------------------------------------------------------------
# helpers: sequential pyvm oracle with fault rows
# ---------------------------------------------------------------------------

def _np(mem):
    """A pool as numpy: the port's engines return tensors."""
    return mem.cpu().numpy() if isinstance(mem, torch.Tensor) else mem


def run_oracle(vop, rt, mem, params, homes=None, failed=None):
    """Replay the batch one request at a time on pyvm (shared memory).
    Valid as a batch oracle only for disjoint-write waves."""
    seq = mem.copy()
    rs = []
    for i, p in enumerate(params):
        home = homes[i] if homes is not None else 0
        rs.append(pyvm.run(vop, rt, seq, p, home=home,
                           failed=failed or set()))
    return seq, rs


def fault_rows(infos):
    rows = [[f.pc, f.opcode, f.addr, f.device] if f is not None
            else list(vm.NO_FAULT) for f in infos]
    return np.asarray(rows, dtype=np.int64)


def assert_fault_parity(res, seq_mem, rs):
    assert np.array_equal(res.ret, [r.ret for r in rs])
    assert np.array_equal(res.status, [r.status for r in rs])
    assert np.array_equal(res.steps, [r.steps for r in rs])
    assert np.array_equal(np.asarray(res.regs),
                          [np.asarray(r.regs) for r in rs])
    assert np.array_equal(_np(res.mem), seq_mem)
    assert np.array_equal(np.asarray(res.fault),
                          fault_rows([r.fault for r in rs]))
    for i, r in enumerate(rs):
        assert res.fault_at(i) == r.fault     # decoded FaultInfo equality


def all_engines(vop, rt, mem, params, homes=None, failed=None, **kw):
    """(name, BatchedInvokeResult) for every single-op batch engine."""
    kw.setdefault("device", "cpu")
    yield "batched", vm.invoke_batched(vop, rt, mem.copy(), params,
                                       homes=homes or 0, failed=failed, **kw)
    yield "compiled", tc.invoke_compiled(vop, rt, mem.copy(), params,
                                         homes=homes or 0, failed=failed,
                                         **kw)
    yield "compiled_dbuf", tc.invoke_compiled(
        vop, rt, mem.copy(), params, homes=homes or 0, failed=failed,
        double_buffer=True, **kw)


# ---------------------------------------------------------------------------
# 1. Engine parity under faults
# ---------------------------------------------------------------------------

def test_fault_parity_graph_walk_engines():
    """Torn next-pointers: some lanes chase a wild pointer and fault,
    the rest complete — every engine matches the oracle bit-for-bit,
    including the decoded per-lane FaultInfo and full containment of
    the faulted lanes' writes."""
    B = 6
    w = ops.GraphWalk(n_nodes=32, max_depth=8, reply_words=B * ops.NODE_WORDS)
    rt = w.regions()
    vop = verify(w.build(rt, reply_param=True), grant=Grant.all_of(rt),
                 regions=rt)
    mem = memory.make_pool(1, rt)
    order = w.populate(mem, rt)
    # tear two nodes' next pointers: one wildly negative, one far oob
    g = rt["graph"]
    mem[0, g.base + int(order[0]) * 8 + 1] = -77
    mem[0, g.base + int(order[3]) * 8 + 1] = 10**7
    # lanes 0/3 step onto the torn pointers; 1/2/4/5 stay on clean arcs
    params = [[int(order[i]) * 8, 2, i * ops.NODE_WORDS] for i in range(B)]
    seq, rs = run_oracle(vop, rt, mem, params)
    stats = [r.status for r in rs]
    assert isa.STATUS_PROT_FAULT in stats and isa.STATUS_OK in stats
    before = mem.copy()
    for name, res in all_engines(vop, rt, mem, params):
        assert_fault_parity(res, seq, rs)
        # containment: a faulted lane's reply slot is untouched
        for i, r in enumerate(rs):
            if r.status == isa.STATUS_PROT_FAULT:
                reply = rt["reply"]
                lo = reply.base + i * ops.NODE_WORDS
                assert np.array_equal(_np(res.mem)[0, lo:lo + ops.NODE_WORDS],
                                      before[0, lo:lo + ops.NODE_WORDS]), name


def test_fault_parity_gather_chain_partial_commit():
    """A stale block-table entry faults the fused gather-chain superop
    mid-loop: iterations before the bad block commit (registers, steps,
    reply words), the faulting MEMCPY and everything after are
    suppressed — identically on the oracle, the dense engine, and both
    compiled traces."""
    kv = ops.PagedKVFetch(n_blocks_pool=16, block_bytes=512,
                          max_req_blocks=4, reply_slots=4)
    rt = kv.regions()
    W = kv.block_words
    vop = verify(kv.build(rt, reply_param=True), grant=Grant.all_of(rt),
                 regions=rt)
    mem = memory.make_pool(1, rt)
    kv.populate(mem, rt)
    kv.make_request(mem, rt, [0, 1, 2, 3])
    # block id 2 now translates to a wild physical offset
    bt = rt["blocktable"]
    mem[0, bt.base + 2] = 10**9
    # lane i fetches the first n_i blocks into its own reply slot:
    # n <= 2 never touches block 2, n >= 3 faults on its third iteration
    params = [[n, i * kv.max_req_blocks * W] for i, n in
              enumerate([1, 3, 2, 4])]
    seq, rs = run_oracle(vop, rt, mem, params)
    assert [r.status for r in rs] == [isa.STATUS_OK, isa.STATUS_PROT_FAULT,
                                      isa.STATUS_OK, isa.STATUS_PROT_FAULT]
    for r in (rs[1], rs[3]):
        assert r.fault.opcode == int(isa.Op.MEMCPY)
        assert r.fault.addr == 10**9          # the wild source offset
    # partial commit: two clean iterations preceded the fault
    assert rs[1].steps > rs[0].steps
    for name, res in all_engines(vop, rt, mem, params):
        assert_fault_parity(res, seq, rs)


def test_failed_device_word_op_faults():
    """A word op homed on a failed device takes a protection fault whose
    FaultInfo names the dead device; lanes on healthy homes are
    unaffected.  Parity across every engine."""
    rt = memory.packed_table([("data", 64), ("reply", 64)])
    b = OperatorBuilder("sum2", n_params=2, regions=rt)
    x, y = b.reg(), b.reg()
    b.load(x, "data", b.param(0))
    b.load(y, "data", b.param(0), disp=1)
    b.add(x, x, y)
    b.store(x, "reply", b.param(1))
    b.ret(x)
    vop = verify(b.build(), grant=Grant.all_of(rt), regions=rt)
    mem = memory.make_pool(2, rt)
    mem[:, rt["data"].base:rt["data"].end] = \
        np.arange(10, 74).reshape(1, -1) * np.asarray([[1], [2]])
    params = [[2 * i, i] for i in range(4)]
    homes = [0, 1, 0, 1]
    seq, rs = run_oracle(vop, rt, mem, params, homes=homes, failed={1})
    assert [r.status for r in rs] == [isa.STATUS_OK, isa.STATUS_PROT_FAULT,
                                      isa.STATUS_OK, isa.STATUS_PROT_FAULT]
    for r in (rs[1], rs[3]):
        assert r.fault.device == 1
        assert r.fault.opcode == int(isa.Op.LOAD)
        assert r.fault.pc == 0                # first word op of the body
    for name, res in all_engines(vop, rt, mem, params, homes=homes,
                                 failed={1}):
        assert_fault_parity(res, seq, rs)


def test_protect_false_legacy_wrap():
    """protect=False restores the legacy wrap-on-oob semantics: the wild
    chase completes with STATUS_OK, no fault is recorded, and the
    compiled trace still matches the oracle."""
    w = ops.GraphWalk(n_nodes=16, max_depth=8)
    rt = w.regions()
    vop = verify(w.build(rt), grant=Grant.all_of(rt), regions=rt)
    mem = memory.make_pool(1, rt)
    order = w.populate(mem, rt)
    mem[0, rt["graph"].base + int(order[0]) * 8 + 1] = -77
    params = [int(order[0]) * 8, 4]
    r_py = pyvm.run(vop, rt, mem.copy(), params, protect=False)
    assert r_py.status == isa.STATUS_OK and r_py.fault is None
    r_jx = vm.invoke(vop, rt, mem.copy(), params, protect=False,
                     device="cpu")
    assert (r_jx.ret, r_jx.status, r_jx.steps) == \
        (r_py.ret, r_py.status, r_py.steps)
    assert r_jx.fault is None
    rc = tc.invoke_compiled(vop, rt, mem.copy(), [params], protect=False,
                            device="cpu")
    assert rc.status[0] == isa.STATUS_OK and rc.fault_at(0) is None
    assert np.array_equal(_np(rc.mem), r_py.mem)


# ---------------------------------------------------------------------------
# 2. Failed-device MEMCPY = degraded mode (ERR_REG), not a fault
# ---------------------------------------------------------------------------

def _rcpy(rt, *, is_async, src_side=True, n_words=4):
    """MEMCPY with the remote device id in a register param; the other
    side is home-local."""
    b = OperatorBuilder("rcpy", n_params=1, regions=rt)
    zero = b.const(0)
    if src_side:
        b.memcpy(dst_region="reply", dst_off=zero,
                 src_region="data", src_off=zero, n_words=n_words,
                 src_dev=b.param(0), is_async=is_async)
    else:
        b.memcpy(dst_region="reply", dst_off=zero, dst_dev=b.param(0),
                 src_region="data", src_off=zero, n_words=n_words,
                 is_async=is_async)
    if is_async:
        b.wait(0)
    b.ret(b.const(7))
    return verify(b.build(), grant=Grant.all_of(rt), regions=rt)


def _rcpy_pool(rt):
    mem = memory.make_pool(2, rt)
    d = rt["data"]
    mem[0, d.base:d.end] = np.arange(100, 100 + d.size)
    mem[1, d.base:d.end] = np.arange(500, 500 + d.size)
    return mem


@pytest.mark.parametrize("src_side", [True, False],
                         ids=["src_failed", "dst_failed"])
@pytest.mark.parametrize("is_async", [False, True],
                         ids=["sync", "async"])
def test_failed_device_memcpy_sets_err_reg(src_side, is_async):
    """The paper's §3.2 degraded mode: a MEMCPY whose remote side is a
    *failed* device sets ERR_REG bit 0 and drops the copy — the lane
    does NOT fault, the operator runs to completion, and (async) the
    doomed transfer still occupies an in-flight slot so the WAIT that
    follows keeps its semantics."""
    rt = memory.packed_table([("data", 16), ("reply", 16)])
    vop = _rcpy(rt, is_async=is_async, src_side=src_side)
    mem = _rcpy_pool(rt)
    before = mem.copy()
    r = pyvm.run(vop, rt, mem, [1], home=0, failed={1},
                 record_trace=True)
    assert r.status == isa.STATUS_OK and r.fault is None
    assert r.ret == 7
    assert np.asarray(r.regs)[isa.ERR_REG] & 1
    # the copy was dropped: neither pool changed anywhere
    assert np.array_equal(mem, before)
    if is_async:
        evs = [e.op for e in r.trace]
        assert isa.Op.MEMCPY in evs and isa.Op.WAIT in evs
    # engine parity, including the suppressed copy and the ERR register
    r_jx = vm.invoke(vop, rt, before.copy(), [1], home=0, failed={1},
                     device="cpu")
    assert (r_jx.ret, r_jx.status, r_jx.steps) == (r.ret, r.status, r.steps)
    assert np.array_equal(r_jx.regs, np.asarray(r.regs))
    assert np.array_equal(_np(r_jx.mem), before)
    assert r_jx.fault is None


def test_failed_memcpy_inflight_slots_then_wait():
    """Several doomed async copies in a row: each still takes an
    in-flight slot (bounded by MAX_INFLIGHT) and WAIT(0) joins them all
    without stalling forever; a healthy copy issued afterwards still
    lands."""
    rt = memory.packed_table([("data", 16), ("reply", 16)])
    b = OperatorBuilder("burst", n_params=1, regions=rt)
    zero = b.const(0)
    for _ in range(3):
        b.memcpy(dst_region="reply", dst_off=zero,
                 src_region="data", src_off=zero, n_words=4,
                 src_dev=b.param(0), is_async=True)
    b.wait(0)
    b.memcpy(dst_region="reply", dst_off=zero,
             src_region="data", src_off=zero, n_words=4)   # local, healthy
    b.ret(zero)
    vop = verify(b.build(), grant=Grant.all_of(rt), regions=rt)
    mem = _rcpy_pool(rt)
    r = pyvm.run(vop, rt, mem, [1], home=0, failed={1})
    assert r.status == isa.STATUS_OK
    assert np.asarray(r.regs)[isa.ERR_REG] & 1
    rep = rt["reply"]
    assert np.array_equal(mem[0, rep.base:rep.base + 4],
                          np.arange(100, 104))   # the local copy landed
    r_jx = vm.invoke(vop, rt, _rcpy_pool(rt), [1], home=0, failed={1},
                     device="cpu")
    assert np.array_equal(_np(r_jx.mem), mem)
    assert np.array_equal(r_jx.regs, np.asarray(r.regs))


# ---------------------------------------------------------------------------
# 3. Endpoint: CQE faults, QP error state, flush, reset
# ---------------------------------------------------------------------------

def _graph_endpoint(n_tenants=2, n_devices=1, **kwargs):
    w = ops.GraphWalk(n_nodes=32, max_depth=8,
                      reply_words=4 * ops.NODE_WORDS)
    named = [(f"t{i}", w.regions()) for i in range(n_tenants)]
    ep, sessions = TiaraEndpoint.for_tenants(named, n_devices=n_devices,
                                             device="cpu", **kwargs)
    orders = {}
    for i in range(n_tenants):
        s = sessions[f"t{i}"]
        s.register(w.build(s.view, reply_param=True))
        orders[f"t{i}"] = w.populate(s.pool, s.view, seed=i)
    return ep, [sessions[f"t{i}"] for i in range(n_tenants)], orders, w


def test_endpoint_fault_cqe_session_error_and_reset():
    ep, (s0, s1), orders, w = _graph_endpoint()
    o0, o1 = orders["t0"], orders["t1"]
    # tear t0's ring only — injected as a declarative pre-wave plan
    ep.inject(faults.corrupt_words(
        [(0, s0.view["graph"].base + int(o0[0]) * 8 + 1, -77)]))
    bad = s0.post("graph_walk", [int(o0[0]) * 8, 2, 0])
    good = s1.post("graph_walk", [int(o1[0]) * 8, 2, 0])
    ep.doorbell()
    # the CQE carries the decoded fault
    assert bad.faulted and bad.fault is not None
    assert bad.fault.addr == -76          # load of torn_ptr + 1
    assert bad.event.fault == bad.fault and bad.event.faulted
    # ... and errors exactly the owning session
    assert s0.in_error and s0.error == bad.fault
    assert not s1.in_error and good.ok
    assert good.ret == w.reference(o1, int(o1[0]), 2)
    # QP in error: new posts are flushed without executing
    c2 = s0.post("graph_walk", [int(o0[5]) * 8, 1, 8])
    assert c2.done and c2.flushed and c2.status == isa.STATUS_FLUSHED
    assert c2.event.wave == -1
    # result(check=True) surfaces the fault, result(check=False) doesn't
    with pytest.raises(EndpointError, match="pc"):
        bad.result()
    assert c2.result(check=False) == 0
    # reset + repair -> posts flow again
    s0.reset()
    assert not s0.in_error and s0.error is None
    w.populate(s0.pool, s0.view, seed=0)       # heal the torn pointer
    c3 = s0.post("graph_walk", [int(o0[0]) * 8, 2, 0])
    ep.doorbell()
    assert c3.ok and c3.ret == w.reference(o0, int(o0[0]), 2)


def test_endpoint_same_wave_concurrent_flush_after():
    """Posts launched in the same wave as the faulting one are
    concurrent and retire with their real results; posts that arrive
    after the launch are flushed at retirement."""
    ep, (s0, _), orders, w = _graph_endpoint()
    o0 = orders["t0"]
    ep.inject(faults.corrupt_words(
        [(0, s0.view["graph"].base + int(o0[0]) * 8 + 1, -5_000)]))
    bad = s0.post("graph_walk", [int(o0[0]) * 8, 2, 0])
    peer = s0.post("graph_walk", [int(o0[9]) * 8, 3, 8])  # clean arc
    h = ep.doorbell(wait=False)
    late = s0.post("graph_walk", [int(o0[9]) * 8, 1, 16])
    ep.wait_all()
    assert bad.faulted
    assert peer.ok and peer.ret == w.reference(o0, int(o0[9]), 3)
    assert late.flushed                  # in the SQ at retirement time
    # FIFO: the CQ drains in post order, flushed entries included
    polled = s0.poll_cq()
    assert [c.seq for c in polled] == [bad.seq, peer.seq, late.seq]


def test_endpoint_transient_doorbell_retry_and_exhaustion():
    """Bounded retry-with-backoff absorbs transient launch losses; the
    backoff goes through the injectable sleep hook (no real sleeping)
    with seeded deterministic jitter.  (The requeue after exhaustion and
    the untouched pool are ``tests/test_torch_endpoint.py``'s
    ``test_transient_doorbell_retry_leaves_pool_untouched``; this case
    keeps the backoff schedule and its exhaustion count.)"""
    def build(seed):
        vc = VirtualClock()
        slept = []

        def sleep(s):
            slept.append(s)
            vc.sleep(s)

        ep, ss, orders, w = _graph_endpoint(
            retry_limit=3, retry_backoff_s=0.001, retry_jitter=0.5,
            retry_jitter_seed=seed, clock=vc, sleep=sleep)
        return ep, ss[0], orders, w, slept

    ep, s0, orders, w, slept = build(seed=7)
    o0 = orders["t0"]
    c = s0.post("graph_walk", [int(o0[0]) * 8, 2, 0])
    # two lost doorbells: absorbed by the bounded retry, and the two
    # backoffs (jittered exponential) went through the hook
    ep.inject(faults.drop_doorbells(2))
    assert ep.doorbell() == 1
    assert c.ok and c.ret == w.reference(o0, int(o0[0]), 2)
    assert len(slept) == 2
    assert 0.001 <= slept[0] <= 0.0015      # base * (1 + jitter in [0,.5])
    assert 0.002 <= slept[1] <= 0.003
    # retry_limit+1 losses: the doorbell raises after retry_limit
    # backoffs, each through the hook
    s0.post("graph_walk", [int(o0[3]) * 8, 1, 8])
    ep.inject(faults.drop_doorbells(4))
    with pytest.raises(faults.TransientError):
        ep.doorbell()
    assert len(slept) == 2 + 3

    # same seed -> the identical jittered backoff sequence (chaos runs
    # are reproducible); a different seed -> a different sequence
    def backoffs(seed):
        ep2, s0b, orders2, _, slept2 = build(seed=seed)
        o = orders2["t0"]
        s0b.post("graph_walk", [int(o[0]) * 8, 2, 0])
        ep2.inject(faults.drop_doorbells(2))
        ep2.doorbell()
        return slept2

    assert backoffs(7) == slept[:2]
    assert backoffs(8) != backoffs(7)


def test_endpoint_poison_materialize_no_lost_cqes():
    ep, (s0, _), orders, w = _graph_endpoint()
    o0 = orders["t0"]
    c = s0.post("graph_walk", [int(o0[2]) * 8, 3, 0])
    h = ep.doorbell(wait=False)
    ep.inject(faults.poison_materialize(1))
    with pytest.raises(faults.InjectedEngineError):
        ep.wait_all()
    # the wave survived the failed retirement: still queued, no CQE lost
    assert not c.done and ep.in_flight_waves == 1
    # the poison is consumed; the next (blocking) wait retries the
    # materialization and delivers the CQE exactly once
    assert ep.wait_all() == 1
    assert c.done and c.ok and ep.in_flight_waves == 0
    assert s0.poll_cq() == [c]
    assert s0.poll_cq() == []


# ---------------------------------------------------------------------------
# 4. Harness: plan algebra, validation, simulator aborts
# ---------------------------------------------------------------------------

def test_faultplan_compose_and_validate():
    plan = (faults.fail_devices(1, 3) + faults.corrupt_words([(0, 5, -9)])
            + faults.drop_doorbells(2) + faults.poison_materialize()
            + faults.delay_waves(0.5, 0.25)
            + faults.stall_tenant("t0", 1.0))
    assert plan.fail_devices == frozenset({1, 3})
    assert plan.corrupt == ((0, 5, -9),)
    assert plan.transient_launch_failures == 2
    assert plan.poison_materialize == 1
    assert plan.delay_waves == (0.5, 0.25)
    assert plan.stall_tenants == (("t0", 1.0),)
    assert not plan.empty and faults.FaultPlan().empty
    with pytest.raises(ValueError):
        faults.FaultPlan(transient_launch_failures=-1)
    with pytest.raises(ValueError):
        faults.FaultPlan(poison_materialize=-2)
    with pytest.raises(ValueError):
        faults.delay_waves(-0.1)
    with pytest.raises(ValueError):
        faults.stall_tenant("t0", -1.0)


def test_endpoint_inject_validates_and_clears():
    ep, (s0, _), orders, _ = _graph_endpoint()
    with pytest.raises(EndpointError, match="outside"):
        ep.inject(faults.corrupt_words([(7, 0, 1)]))       # no device 7
    with pytest.raises(EndpointError, match="outside"):
        ep.inject(faults.corrupt_words(
            [(0, ep.regions.pool_words, 1)]))              # word oob
    with pytest.raises(EndpointError, match="unknown tenant"):
        ep.inject(faults.stall_tenant("nobody", 1.0))
    ep.inject(faults.fail_devices(0) + faults.drop_doorbells(1)
              + faults.poison_materialize(2)
              + faults.delay_waves(0.5) + faults.stall_tenant("t1", 9.0))
    assert ep.failed_devices == {0}
    assert ep.stalled("t1") and not ep.stalled("t0")
    ep.clear_faults()
    assert not ep.failed_devices
    assert ep._transient_left == 0 and ep._poison_left == 0
    assert not ep._pending_delays and not ep.stalled("t1")
    # a cleared endpoint dispatches cleanly
    o0 = orders["t0"]
    c = s0.post("graph_walk", [int(o0[0]) * 8, 1, 0])
    ep.doorbell()
    assert c.ok


def test_endpoint_delay_and_stall_injection():
    """delay_waves charges the sleep hook at launch; stall_tenant
    withholds a tenant's posts from drains until the stall expires
    (endpoint clock), without wedging other tenants."""
    vc = VirtualClock()
    ep, (s0, s1), orders, w = _graph_endpoint(clock=vc, sleep=vc.sleep)
    o0, o1 = orders["t0"], orders["t1"]
    ep.inject(faults.delay_waves(0.25) + faults.stall_tenant("t0", 1.0))
    c0 = s0.post("graph_walk", [int(o0[0]) * 8, 1, 0])
    c1 = s1.post("graph_walk", [int(o1[0]) * 8, 1, 0])
    t0 = vc()
    assert ep.doorbell() == 1                  # t0 withheld, t1 executes
    assert vc() - t0 == 0.25                   # the injected launch delay
    assert c1.ok and not c0.done and s0.outstanding == 1
    vc.advance(1.0)                            # the stall expires
    assert ep.doorbell() == 1
    assert c0.ok and c0.ret == w.reference(o0, int(o0[0]), 1)


def test_simulator_midflight_abort():
    """``fail_memcpy_at`` aborts the i-th transfer halfway: half the
    payload crosses, the abort is counted, and timing stays causal
    (an aborted transfer never takes longer than a full one)."""
    from repro_torch.core import simulator
    w = ops.GraphWalk(n_nodes=16, max_depth=8)
    rt = w.regions()
    vop = verify(w.build(rt), grant=Grant.all_of(rt), regions=rt)
    mem = memory.make_pool(1, rt)
    order = w.populate(mem, rt)
    r = pyvm.run(vop, rt, mem, [int(order[0]) * 8, 4], record_trace=True)
    base = simulator.simulate_task(vop, r.trace)
    hurt = simulator.simulate_task(vop, r.trace, fail_memcpy_at=[0])
    assert base.failed_transfers == 0
    assert hurt.failed_transfers == 1
    assert hurt.dma_bulk_bytes == base.dma_bulk_bytes // 2
    assert hurt.nic_resident_us <= base.nic_resident_us
    # an index past the trace's transfer count is a no-op
    none = simulator.simulate_task(vop, r.trace, fail_memcpy_at=[99])
    assert none.failed_transfers == 0
    assert none.dma_bulk_bytes == base.dma_bulk_bytes


# ---------------------------------------------------------------------------
# 5. Completion.result() is a consuming read (regression)
# ---------------------------------------------------------------------------

def test_result_consuming_read_and_poll_interplay():
    ep, (s0, _), orders, w = _graph_endpoint()
    o0 = orders["t0"]
    want = w.reference(o0, int(o0[0]), 2)
    # result() consumes the CQE: a later poll never sees it again
    c = s0.post("graph_walk", [int(o0[0]) * 8, 2, 0])
    assert c.result() == want
    assert s0.poll_cq() == []
    # result() is idempotent on an already-consumed handle
    assert c.result() == want
    # poll-then-result: the identity scan tolerates an absent handle
    c2 = s0.post("graph_walk", [int(o0[0]) * 8, 2, 0])
    ep.doorbell()
    assert s0.poll_cq() == [c2]
    assert c2.result() == want
    assert s0.poll_cq() == []


# ---------------------------------------------------------------------------
# 6. Hypothesis chaos property (slow): random tears + failed devices
# ---------------------------------------------------------------------------

def test_chaos_parity_property():
    """Random pointer tears x random failed-device sets x random walk
    params: the dense and compiled engines stay bit-identical to the
    sequential oracle — statuses, steps, registers, fault rows, memory
    — on a disjoint-write wave over a two-device pool."""
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    B = 4
    w = ops.GraphWalk(n_nodes=16, max_depth=8,
                      reply_words=B * ops.NODE_WORDS)
    rt = w.regions()
    vop = verify(w.build(rt, reply_param=True), grant=Grant.all_of(rt),
                 regions=rt)

    @settings(max_examples=12, deadline=None)
    @given(tears=st.lists(
               st.tuples(st.integers(0, 15), st.integers(-2**40, 2**40)),
               min_size=0, max_size=3),
           failed=st.sets(st.integers(0, 1), max_size=2),
           seed=st.integers(0, 2**31 - 1))
    def prop(tears, failed, seed):
        rng = np.random.default_rng(seed)
        mem = memory.make_pool(2, rt)
        orders = [w.populate(mem, rt, device=d, seed=seed + d)
                  for d in range(2)]
        g = rt["graph"]
        for node, val in tears:
            mem[rng.integers(0, 2), g.base + node * 8 + 1] = val
        homes = [int(h) for h in rng.integers(0, 2, size=B)]
        params = [[int(orders[homes[i]][rng.integers(0, 16)]) * 8,
                   int(rng.integers(0, 8)), i * ops.NODE_WORDS]
                  for i in range(B)]
        seq, rs = run_oracle(vop, rt, mem, params, homes=homes,
                             failed=failed)
        for name, res in all_engines(vop, rt, mem, params, homes=homes,
                                     failed=failed):
            assert_fault_parity(res, seq, rs)

    prop()


def test_injected_corruption_writes_only_its_words(monkeypatch):
    """A pending corruption lands in the device-resident pool word by
    word: the doorbell never downloads the pool for it (a 4 GiB pool on
    a card would cross the bus twice per injection)."""
    ep, (s0, _), orders, w = _graph_endpoint()
    o0 = orders["t0"]
    ep.doorbell()                               # the pool is resident
    word = s0.view["graph"].base + int(o0[0]) * 8 + 1

    def download():
        raise AssertionError("the doorbell downloaded the pool")

    monkeypatch.setattr(ep, "_host_view", download)
    ep.inject(faults.corrupt_words([(0, word, -77)]))
    bad = s0.post("graph_walk", [int(o0[0]) * 8, 2, 0])
    ep.doorbell()
    monkeypatch.undo()
    assert bad.faulted and bad.fault.addr == -76
    assert int(ep.mem[0, word]) == -77


# ---------------------------------------------------------------------------
# 7. A fault's pc whichever engine runs the wave (a repaired port fault)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode, placement", [
    ("mixed", "single"), ("segmented", "single"), ("serial", "single"),
    ("auto", "single"), ("auto", "sharded")])
def test_mixed_wave_fault_pc_counts_from_the_operator(mode, placement):
    """The mixed engines run a merged instruction store; a fault's pc in
    the CQE is still counted from the faulting operator's own entry, as
    pyvm and the single-op engines count it, so one post gets one
    FaultInfo whichever engine or placement the wave takes.  (The
    reference's mixed engine reported the merged store's pc.)"""
    from repro_torch.distributed.mesh import make_device_mesh
    P = _package("repro_torch")
    mesh = make_device_mesh(2, devices=["cpu"] * 2)
    run = _Run(P, *_row_endpoint(P, mesh=mesh))
    ep = run.ep
    assert ep.registry.dispatch_table()[run.ss["t1"].op_id("devload")] > 0
    posts = [("t0", "sum2", [1, 0]), ("t0", "devload", [5, 1, 7]),
             ("t1", "sum2", [64, 2]), ("t1", "devload", [2, 3, 9])]
    mem = _host(ep.mem)
    cs = [run.post(t, op, p) for t, op, p in posts]
    ep.doorbell(mode=mode, placement=placement)
    vops = ep.registry.store_ops()
    for c in cs:
        r = pyvm.run(vops[c.op_id], ep.regions, mem, list(c.params),
                     home=c.home)
        assert (c.status, c.fault, c.event.fault) == \
            (r.status, r.fault, r.fault)
    assert [c.fault.pc for c in cs[1::2]] == [0, 0]   # devload's first op
    assert cs[2].fault.pc == 0 and cs[2].faulted
    assert run.ss["t1"].error == cs[2].fault


# ---------------------------------------------------------------------------
# 8. The fault table, row by row, against the JAX package
#
# One scenario per row of the fault table (the mesh row is the sharded
# endpoint's, ``tests/test_torch_sharded_endpoint.py``) and per
# certificate enforcement point.  Each scenario takes a package
# (``repro`` or ``repro_torch``), builds the same endpoint from the same
# numpy-seeded pool, injects the row's FaultPlan, posts and rings; every
# post that executed is held to that package's pyvm on the pre-wave pool.
# The two packages' records — CQE streams, final pools, what was raised,
# slept and counted — must be equal.
# ---------------------------------------------------------------------------

_CORE = ("costmodel", "endpoint", "faults", "isa", "memory", "program",
         "pyvm", "registry", "serving_loop", "verifier", "wcet")


def _package(name):
    return types.SimpleNamespace(name=name, **{
        m: importlib.import_module(f"{name}.core.{m}") for m in _CORE})


def _host(mem):
    """A pool as numpy from either package (torch tensor or jax array)."""
    if isinstance(mem, torch.Tensor):
        return mem.cpu().numpy().copy()
    return np.array(mem)


def _row_ops(P, rt):
    """sum2 (two home loads, one store), devload (a load from the device
    named by a register), chase (a load at the address a load returned),
    rcpy / arcpy (a 4-word MEMCPY from the device named by a register,
    sync / async + WAIT)."""
    B = P.program.OperatorBuilder
    b = B("sum2", n_params=2, regions=rt)
    x, y = b.reg(), b.reg()
    b.load(x, "data", b.param(0))
    b.load(y, "data", b.param(0), disp=1)
    b.add(x, x, y)
    b.store(x, "reply", b.param(1))
    b.ret(x)
    out = [b.build()]
    b = B("devload", n_params=3, regions=rt)
    x = b.reg()
    b.load(x, "data", b.param(0), dev=b.param(2))
    b.store(x, "reply", b.param(1))
    b.ret(x)
    out.append(b.build())
    b = B("chase", n_params=2, regions=rt)
    x = b.reg()
    b.load(x, "data", b.param(0))
    b.load(x, "data", x)
    b.store(x, "reply", b.param(1))
    b.ret(x)
    out.append(b.build())
    for name, is_async in (("rcpy", False), ("arcpy", True)):
        b = B(name, n_params=2, regions=rt)
        zero = b.const(0)
        b.memcpy(dst_region="reply", dst_off=b.param(1), src_region="data",
                 src_off=zero, n_words=4, src_dev=b.param(0),
                 is_async=is_async)
        if is_async:
            b.wait(0)
        b.ret(b.const(7))
        out.append(b.build())
    return out


def _device_kw(P, kw):
    if P.name == "repro_torch":
        kw = dict(kw, device="cpu")     # the port defaults to the card
    return kw


def _row_endpoint(P, *, n_devices=2, **kw):
    named = [(f"t{i}", P.memory.packed_table([("data", 64),
                                              ("reply", 64)]))
             for i in range(2)]
    ep, ss = P.endpoint.TiaraEndpoint.for_tenants(
        named, n_devices=n_devices, **_device_kw(P, kw))
    rng = np.random.default_rng(22)
    for t in ("t0", "t1"):
        for prog in _row_ops(P, ss[t].view):
            ss[t].register(prog)
        for d in range(n_devices):
            ss[t].write_region("data", rng.integers(-2**40, 2**40, 64),
                               device=d)
    return ep, ss


def _fault(P, ep, c):
    """A CQE's FaultInfo as a tuple.  Every wave here runs the mixed
    engine, whose reference version reports the pc in the merged
    instruction store (a fault of the reference, recorded in ROADMAP's
    Queue 3); the port counts it from the operator's entry, as pyvm and
    every single-op engine do.  The reference's pc is brought to that
    count here, and only here."""
    f = c.fault
    if f is None:
        return None
    pc = f.pc
    if P.name == "repro":
        pc -= int(ep.registry.dispatch_table()[c.op_id])
    return (pc, f.opcode, f.addr, f.device)


def _cqe(P, ep, c):
    wave = None if c.event is None else c.event.wave
    return (c.seq, c.session.tenant, c.op_name, tuple(c.params), c.home,
            c.ret, c.status, c.steps, tuple(int(r) for r in c.regs),
            _fault(P, ep, c), wave)


# Every wave is padded to WAVE lanes and every post to three params, so
# that the JAX engine compiles once per static-noconflict variant.
WAVE = 8


def _filler(k):
    """The k-th healthy filler post: two home-local rcpy of the same
    words into the same place first (a write conflict, so no wave has a
    static no-conflict proof and every wave takes the same engine
    variant; the two copies write equal values), then sum2s, all into
    reply words 40..63 that no scenario post touches."""
    if k < 2:
        return "rcpy", [0, 40]
    return "sum2", [k % 60, 44 + k % 20]


def _params(params):
    return list(params) + [0] * (3 - len(params))


class _Run:
    """One package's scenario: its posts in order, and a doorbell that
    pads the wave with healthy t1 fillers and holds every post the wave
    executed to pyvm."""

    def __init__(self, P, ep, ss):
        self.P, self.ep, self.ss = P, ep, ss
        self.cs, self.extra = [], {}

    def post(self, tenant, op, params=(), **kw):
        c = self.ss[tenant].post(op, _params(params), **kw)
        self.cs.append(c)
        return c

    def ring(self, **kw):
        ep, P = self.ep, self.P
        k = 0
        while 0 < ep.outstanding < WAVE:
            self.post("t1", *_filler(k))
            k += 1
        mem = _host(ep.mem)
        for d, w, v in ep._pending_corrupt:      # applied at launch
            mem[d, w] = v
        retired = {c.seq for c in self.cs if c.done}
        n = ep.doorbell(mode="mixed", **kw)
        ep.wait_all()
        vops = ep.registry.store_ops()
        ran = sorted((c for c in self.cs if c.done and c.seq not in retired
                      and c.event is not None and c.event.wave >= 0),
                     key=lambda c: c.seq)
        for c in ran:
            r = P.pyvm.run(vops[c.op_id], ep.regions, mem, list(c.params),
                           home=c.home, failed=set(ep.failed_devices))
            assert (c.ret, c.status, c.steps) == (r.ret, r.status, r.steps)
            assert [int(v) for v in c.regs] == [int(v) for v in r.regs]
            want = None if r.fault is None else (
                r.fault.pc, r.fault.opcode, r.fault.addr, r.fault.device)
            assert _fault(P, ep, c) == want
        assert np.array_equal(_host(ep.mem), mem)
        return n

    def record(self):
        return dict(cqes=[_cqe(self.P, self.ep, c) for c in self.cs],
                    polled={t: [c.seq for c in s.poll_cq()]
                            for t, s in self.ss.items()},
                    pool=_host(self.ep.mem), extra=self.extra)


def _row_wild_device_register(P):
    run = _Run(P, *_row_endpoint(P))
    run.post("t0", "devload", [3, 0, 1])
    run.post("t0", "devload", [5, 1, 7])         # device 7 of 2
    run.post("t1", "devload", [2, 2, 0])
    run.post("t1", "devload", [4, 3, -1])        # negative device
    run.ring()
    run.extra["in_error"] = [run.ss[t].in_error for t in ("t0", "t1")]
    return run


def _row_out_of_region(P):
    run = _Run(P, *_row_endpoint(P))
    ep, s0 = run.ep, run.ss["t0"]
    data = s0.view["data"]
    # word ops: an offset past the region, and a torn pointer
    run.post("t0", "sum2", [1, 0])
    run.post("t0", "sum2", [64, 1])              # reads data[64]
    run.post("t1", "sum2", [2, 2])
    run.post("t1", "sum2", [3, 70])              # stores reply[70]
    ep.inject(P.faults.corrupt_words([(0, data.base + 9, 10**6)]))
    run.post("t0", "chase", [9, 5])              # reads data[10**6]
    # MEMCPY window: the 4-word copy lands past reply's end
    run.post("t1", "rcpy", [0, 62])
    run.ring()
    # each session's error is its first faulting post's FaultInfo
    for t in ("t0", "t1"):
        first = next(c for c in run.cs
                     if c.session.tenant == t and c.faulted)
        assert run.ss[t].error == first.fault
    return run


def _row_failed_device_word_op(P):
    run = _Run(P, *_row_endpoint(P))
    run.ep.inject(P.faults.fail_devices(1))
    run.post("t0", "sum2", [0, 0], home=0)
    run.post("t0", "sum2", [2, 1], home=1)       # homed on the dead one
    run.post("t1", "devload", [4, 2, 1])         # reads the dead one
    run.post("t1", "devload", [4, 3, 0])
    run.ring()
    return run


def _row_failed_device_memcpy(P):
    run = _Run(P, *_row_endpoint(P))
    run.ep.inject(P.faults.fail_devices(1))
    for op in ("rcpy", "arcpy"):
        run.post("t0", op, [1, 0])               # from the dead device
        run.post("t1", op, [0, 8])               # healthy: lands
    run.ring()
    run.extra["err_reg"] = [int(c.regs[run.P.isa.ERR_REG])
                            for c in run.cs]
    run.extra["in_error"] = [run.ss[t].in_error for t in ("t0", "t1")]
    return run


def _row_flush_until_reset(P):
    run = _Run(P, *_row_endpoint(P))
    run.post("t0", "sum2", [100, 0])             # faults: t0 in error
    run.post("t1", "sum2", [1, 0])
    run.ring()
    flushed = [run.post("t0", "sum2", [i, i]) for i in range(3)]
    run.post("t1", "sum2", [2, 1])
    run.extra["flushed_at_post"] = [(c.done, c.status) for c in flushed]
    run.ring()
    run.ss["t0"].reset()
    run.post("t0", "sum2", [5, 4])
    run.ring()
    return run


def _row_transient_doorbell(P):
    vc = P.serving_loop.VirtualClock()
    slept = []

    def sleep(s):
        slept.append(s)
        vc.sleep(s)

    run = _Run(P, *_row_endpoint(P, retry_limit=3, retry_backoff_s=0.001,
                                 retry_jitter=0.5, retry_jitter_seed=5,
                                 clock=vc, sleep=sleep))
    run.post("t0", "sum2", [0, 0])
    run.ep.inject(P.faults.drop_doorbells(2))
    run.ring()
    run.post("t1", "sum2", [1, 1])
    pool = _host(run.ep.mem)
    run.ep.inject(P.faults.drop_doorbells(4))
    with pytest.raises(P.faults.TransientError):
        run.ep.doorbell()
    run.extra["untouched"] = np.array_equal(_host(run.ep.mem), pool)
    run.extra["requeued"] = run.ep.outstanding
    run.ring()
    run.extra["slept"] = slept
    return run


def _row_loop(P, config, qos=None, **ep_kw):
    vc = P.serving_loop.VirtualClock()
    ep, ss = _row_endpoint(P, clock=vc, sleep=vc.sleep, **ep_kw)
    loop = P.serving_loop.ServingLoop(
        ep, P.serving_loop.ServingConfig(mode="mixed", **config),
        qos={t: P.serving_loop.TenantQoS(**q)
             for t, q in (qos or {}).items()})
    run = _Run(P, ep, ss)
    run.loop, run.vc, run.mem0 = loop, vc, _host(ep.mem)
    return run


def _submit(run, tenant, params, op="sum2", **kw):
    c = run.loop.submit(tenant, op, _params(params), **kw)
    run.cs.append(c)
    return c


def _finish(run):
    """Drain the loop, then hold everything that ran to pyvm, wave by
    wave from the pre-run pool (the posts of a wave write disjoint
    words), and keep the loop's counters."""
    run.loop.drain()
    run.ep.wait_all()
    vops, mem = run.ep.registry.store_ops(), run.mem0.copy()
    ran = [c for c in run.cs if c.event is not None and c.event.wave >= 0]
    for c in sorted(ran, key=lambda c: (c.event.wave, c.seq)):
        r = run.P.pyvm.run(vops[c.op_id], run.ep.regions, mem,
                           list(c.params), home=c.home)
        assert (c.ret, c.status, c.steps) == (r.ret, r.status, r.steps)
    assert np.array_equal(_host(run.ep.mem), mem)
    st = run.loop.stats
    run.extra["stats"] = {k: getattr(st, k) for k in (
        "submitted", "admitted", "launched", "executed", "ok", "faulted",
        "flushed", "timed_out", "rejected", "shed")}
    assert st.submitted == (st.executed + st.flushed + st.timed_out
                            + st.rejected + st.shed)
    return run


def _row_admission_reject(P):
    run = _row_loop(P, dict(max_pending=4, ring_size=64, ring_age_s=1e9,
                            min_efficiency=2.0),
                    qos={"t0": dict(rate=10.0, burst=2)}, max_sq_depth=1)
    a = [_submit(run, "t0", [i, i]) for i in range(3)]   # bucket empties
    b = [_submit(run, "t1", *_filler(i)[::-1]) for i in range(5)]
    # the bounded SQ: a direct post behind one already queued
    d = [run.post("t0", "sum2", [9, 30 + i]) for i in range(2)]
    run.extra["eagain"] = [c.rejected for c in a + b + d]
    run.vc.advance(0.1)                                  # one token back
    _submit(run, "t0", [7, 7])
    return _finish(run)


def _row_load_shed(P):
    run = _row_loop(P, dict(ring_size=64, ring_age_s=1e9,
                            min_efficiency=2.0, shed_watermark=WAVE),
                    qos={"t0": dict(weight=2.0), "t1": dict(weight=1.0)})
    for i in range(6):
        _submit(run, "t0", [i, i])
        _submit(run, "t1", *_filler(i)[::-1])
    run.extra["shed"] = run.loop.pump().shed
    return _finish(run)


def _row_deadline_expired(P):
    run = _row_loop(P, dict(ring_size=64, ring_age_s=1e9,
                            min_efficiency=2.0))
    _submit(run, "t0", [0, 0], deadline_s=0.0)           # at admission
    _submit(run, "t0", [1, 1], deadline_s=0.01)          # at the pump
    for i in range(WAVE):
        _submit(run, "t1", *_filler(i)[::-1])
    run.vc.advance(0.02)
    run.extra["pump_timed_out"] = run.loop.pump().timed_out
    run.post("t1", "sum2", [2, 2], deadline_s=0.01)      # at the drain
    run.vc.advance(0.02)
    run.extra["drained"] = run.ep.doorbell()
    return _finish(run)


def _row_deadline_infeasible(P):
    """sum2's certified WCET against deadlines below it: each post
    retires TIMEOUT at admission, never queued, never launched."""
    run = _row_loop(P, dict(ring_size=2, ring_age_s=0.0))
    wcet_s = run.ep.registry[run.ss["t0"].op_id("sum2")] \
        .certificate.wcet_latency_us * 1e-6
    for frac in (0.25, 0.5, 0.99):
        _submit(run, "t0", [1, 1], deadline_s=frac * wcet_s)
    run.extra["launched_at_admission"] = run.loop.stats.launched
    run.extra["wcet_s"] = wcet_s
    return _finish(run)


def _cert_admission(P):
    """The enforcement point switched off: the same infeasible posts
    launch and run to a real completion."""
    run = _row_loop(P, dict(ring_size=WAVE, ring_age_s=0.0,
                            admission_wcet=False))
    wcet_s = run.ep.registry[run.ss["t0"].op_id("sum2")] \
        .certificate.wcet_latency_us * 1e-6
    for i in range(WAVE):
        _submit(run, "t0", *_filler(i)[::-1], deadline_s=0.25 * wcet_s)
    return _finish(run)


def _hog(P, rt):
    b = P.program.OperatorBuilder("hog", n_params=1, regions=rt)
    z = b.const(0)
    r = b.reg()
    with b.loop(4096):
        for _ in range(4):
            b.load(r, "src", z)
    b.ret(r)
    return b.build()


def _cert_registration(P):
    rt = P.memory.packed_table([("src", 1024), ("dst", 1024)])
    refused = []
    for budget in ({}, dict(budget=P.wcet.Budget(max_memcpy_bytes=128))):
        reg = P.registry.OperatorRegistry(rt, **budget)
        reg.add_tenant(P.memory.Grant.all_of(rt, "t"))
        b = P.program.OperatorBuilder("mover", n_params=0, regions=rt)
        z = b.const(0)
        b.memcpy(dst_region="dst", dst_off=z, src_region="src", src_off=z,
                 n_words=64, src_dev=0)
        b.ret()
        for prog in (_hog(P, rt), b.build()):
            try:
                reg.register("t", prog)
                refused.append(None)
            except P.registry.RegistrationError as e:
                refused.append(str(e))
    run = _Run(P, None, {})
    run.extra["refused"] = refused
    assert "pc" in refused[0] and "cycles" in refused[0]
    assert "LOAD" in refused[0] and refused[1] is None
    assert "memcpy" in refused[3].lower()
    return run


def _cert_wave_us(P):
    m = P.costmodel.DispatchCostModel()
    got = []
    for batch, steps in ((1, 40), (8, 4096), (64, 900)):
        free = m.wave_us(batch=batch, step_bound=steps, key=1)
        for frac in (0.25, 1.0, 10.0):
            clamped = m.wave_us(batch=batch, step_bound=steps, key=1,
                                cert_ceiling_us=free * frac)
            assert clamped == min(free, free * frac)
            got.append((free, clamped))
    run = _Run(P, None, {})
    run.extra["wave_us"] = got
    return run


FAULT_TABLE_ROWS = {
    "wild_device_register": _row_wild_device_register,
    "out_of_region": _row_out_of_region,
    "failed_device_word_op": _row_failed_device_word_op,
    "failed_device_memcpy": _row_failed_device_memcpy,
    "flush_until_reset": _row_flush_until_reset,
    "transient_doorbell": _row_transient_doorbell,
    "admission_reject": _row_admission_reject,
    "load_shed": _row_load_shed,
    "deadline_expired": _row_deadline_expired,
    "deadline_infeasible": _row_deadline_infeasible,
    "cert_registration": _cert_registration,
    "cert_admission": _cert_admission,
    "cert_wave_us": _cert_wave_us,
}


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("row", list(FAULT_TABLE_ROWS))
def test_fault_table_row_matches_jax(row):
    scenario = FAULT_TABLE_ROWS[row]
    want = scenario(_package("repro"))
    got = scenario(_package("repro_torch"))
    if want.ep is not None:
        w, g = want.record(), got.record()
        assert g["cqes"] == w["cqes"]
        assert g["polled"] == w["polled"]
        assert np.array_equal(g["pool"], w["pool"])
    assert _same(got.extra, want.extra), (got.extra, want.extra)
