"""The port's endpoint and serving loop against the JAX package's, plus
the slice-wide import guard.

Both endpoints get the same tenants, operators, pool contents and posts;
CQE order, statuses, return values, steps, registers, FaultInfo, QP
flushes and the exactly-one-CQE identity must agree.  The port runs on
the CPU (``device="cpu"``); the JAX engines run as in the JAX package's
own tests.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro.core import memory as jmemory
from repro.core import pyvm as jpyvm
from repro.core import serving_loop as jsl
from repro.core import simulator as jsim
from repro.core.endpoint import TiaraEndpoint as JEndpoint
from repro.core.frontend import compile_source as jcompile_source
from repro.core.memory import Grant as JGrant
from repro.core.program import OperatorBuilder as JBuilder
from repro.core.verifier import verify as jverify
from repro_torch.core import (costmodel, faults, isa, memory, pyvm,
                              simulator)
from repro_torch.core import serving_loop as psl
from repro_torch.core.endpoint import EndpointError, TiaraEndpoint
from repro_torch.core.frontend import compile_source
from repro_torch.core.program import OperatorBuilder
from repro_torch.distributed.mesh import Sharded

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _layout(mem_mod):
    return mem_mod.packed_table([("data", 64), ("reply", 512)])


def _sum_op(builder_cls, rt):
    """Two loads, one store: cheap, and it faults on a wild offset."""
    b = builder_cls("sum2", n_params=2, regions=rt)
    x, y = b.reg(), b.reg()
    b.load(x, "data", b.param(0))
    b.load(y, "data", b.param(0), disp=1)
    b.add(x, x, y)
    b.store(x, "reply", b.param(1))
    b.ret(x)
    return b.build()


def _pair(n_tenants=2, **kw):
    """The same deployment on both packages: (jax ep, jax sessions,
    port ep, port sessions)."""
    out = []
    for ep_cls, mem_mod, builder, extra in (
            (JEndpoint, jmemory, JBuilder, {}),
            (TiaraEndpoint, memory, OperatorBuilder, {"device": "cpu"})):
        ep, ss = ep_cls.for_tenants(
            [(f"t{i}", _layout(mem_mod)) for i in range(n_tenants)],
            **extra, **kw)
        sessions = [ss[f"t{i}"] for i in range(n_tenants)]
        for i, s in enumerate(sessions):
            s.register(_sum_op(builder, s.view))
            s.write_region("data", np.arange(10 + i, 74 + i,
                                             dtype=np.int64))
        out += [ep, sessions]
    return out


def _cqe(c):
    f = None if c.fault is None else (c.fault.pc, c.fault.opcode,
                                      c.fault.addr, c.fault.device)
    wave = None if c.event is None else c.event.wave
    return (c.seq, c.op_name, c.ret, c.status, c.steps,
            tuple(int(r) for r in c.regs), f, wave)


def _polled(sessions):
    return [[_cqe(c) for c in s.poll_cq()] for s in sessions]


def _post_both(jss, pss, posts):
    for t, params in posts:
        jss[t].post("sum2", params)
        pss[t].post("sum2", params)


def test_endpoint_waves_match_jax():
    jep, jss, pep, pss = _pair()
    _post_both(jss, pss, [(0, [3, 0]), (1, [5, 1]), (0, [7, 2]),
                          (1, [60, 3]), (0, [11, 4]), (1, [0, 5])])
    assert jep.doorbell() == pep.doorbell() == 6
    assert _polled(pss) == _polled(jss)
    for jr, pr in zip(jss, pss):
        assert np.array_equal(pr.read_region("reply"),
                              jr.read_region("reply"))


def test_fault_flush_and_reset_match_jax():
    jep, jss, pep, pss = _pair()
    # t0's second post reads outside its 64-word data region
    _post_both(jss, pss, [(0, [1, 0]), (0, [500, 1]), (1, [2, 2]),
                          (0, [4, 3])])
    jep.doorbell()
    pep.doorbell()
    assert pss[0].in_error and not pss[1].in_error
    assert (pss[0].error.pc, pss[0].error.addr) == \
        (jss[0].error.pc, jss[0].error.addr)
    # while in error, t0's posts flush without executing
    _post_both(jss, pss, [(0, [2, 6]), (1, [3, 7])])
    jep.doorbell()
    pep.doorbell()
    got, want = _polled(pss), _polled(jss)
    assert got == want
    statuses = [c[3] for c in got[0]]
    assert statuses == [0, isa.STATUS_PROT_FAULT, 0, isa.STATUS_FLUSHED]
    for s in jss + pss:
        s.reset()
    _post_both(jss, pss, [(0, [2, 8])])
    jep.doorbell()
    pep.doorbell()
    assert _polled(pss) == _polled(jss)


def test_split_phase_matches_jax():
    jep, jss, pep, pss = _pair()
    handles = []
    for ep, ss in ((jep, jss), (pep, pss)):
        ss[0].post("sum2", [1, 0])
        ss[1].post("sum2", [2, 1])
        h1 = ep.doorbell(wait=False)
        ss[0].post("sum2", [3, 2])
        ss[1].post("sum2", [4, 3])
        h2 = ep.doorbell(wait=False)
        first = [c.seq for c in ep.wait_any()]
        assert ep.wait_all() == 2
        handles.append((first, h1.done, h2.done))
    assert handles[0] == handles[1]
    assert _polled(pss) == _polled(jss)


def _serve(sl, ep, ss, vc, trace, config):
    loop = sl.ServingLoop(ep, config)
    cs = []
    for t, tenant, params in trace:
        vc.advance_to(t)
        cs.append(loop.submit(f"t{tenant}", "sum2", params))
        loop.pump()
    stats = loop.drain()
    ep.wait_all()
    return [(c.seq, c.status, c.ret) for c in cs], stats


def test_serving_loop_matches_jax():
    """The same arrival trace on a virtual clock: identical per-post
    outcomes and counters, and the exactly-one-CQE identity."""
    rng = np.random.default_rng(7)
    trace = [(i * 1e-4, int(rng.integers(0, 2)),
              [int(rng.integers(0, 60)), i]) for i in range(16)]
    config = dict(ring_size=4, max_inflight_waves=2, max_pending=4)
    results = []
    for sl in (jsl, psl):
        vc = sl.VirtualClock()
        kw = dict(clock=vc, sleep=vc.sleep)
        jep, jss, pep, pss = _pair(**kw)
        ep, ss = (jep, jss) if sl is jsl else (pep, pss)
        results.append(_serve(sl, ep, ss, vc, trace,
                              sl.ServingConfig(**config)))
    (jcs, jst), (pcs, pst) = results
    assert pcs == jcs
    for k in ("submitted", "admitted", "launched", "executed", "ok",
              "faulted", "flushed", "timed_out", "rejected", "shed"):
        assert getattr(pst, k) == getattr(jst, k), k
    assert pst.submitted == pst.executed + pst.flushed + pst.timed_out + \
        pst.rejected + pst.shed == len(trace)


def test_transient_doorbell_retry_leaves_pool_untouched():
    _, _, pep, pss = _pair()
    pep.inject(faults.drop_doorbells(2))
    pss[0].post("sum2", [3, 0])
    assert pep.doorbell() == 1
    assert pss[0].poll_cq()[0].ret == 13 + 14
    pool = pep.mem.clone()
    pep.inject(faults.drop_doorbells(pep.retry_limit + 1))
    c = pss[1].post("sum2", [5, 9])
    with pytest.raises(faults.TransientError):
        pep.doorbell()
    assert torch.equal(pep.mem, pool) and pep.outstanding == 1
    pep.doorbell()
    assert c.ok and c.ret == 16 + 17


def test_pool_stays_resident_between_waves():
    _, _, pep, pss = _pair()
    pss[0].post("sum2", [0, 0])
    pep.doorbell()
    assert pep._host is None                  # nothing downloaded
    assert list(pss[0].read_region("reply", count=1)) == [10 + 11]
    assert pep._host is None                  # region reads are partial
    pss[1].write_region("data", [100, 200], offset=2)
    pss[1].post("sum2", [2, 4])
    pep.doorbell()
    assert pss[1].poll_cq()[0].ret == 300
    host = pep.host_mem()                     # host becomes authoritative
    view = pss[0].view
    host[0, view["data"].base] = 1000
    pss[0].post("sum2", [0, 1])
    pep.doorbell()                            # ... and is uploaded once
    assert pss[0].poll_cq()[-1].ret == 1000 + 11
    r = pss[0].trace("sum2", [0, 2])          # pyvm on the host copy
    assert r.ret == 1011 and pep.host_mem()[0, view["reply"].base + 2] == 1011


def test_placement():
    """Both placements run: "auto" picks single on a one-row pool,
    "sharded" runs the mesh engine (one CPU shard here; four shards in
    ``tests/test_torch_sharded.py``) and leaves the pool per shard."""
    _, _, pep, pss = _pair()
    pss[0].post("sum2", [1, 0])
    pep.doorbell(placement="auto")
    assert pep.last_placement.mode == "single"
    assert "sharded" not in pep.last_placement.costs
    cs = [pss[0].post("sum2", [1, 2]), pss[1].post("sum2", [5, 3])]
    pep.doorbell(placement="sharded")
    assert pep.last_placement is None
    # tenant i's data[k] is 10 + i + k
    assert [c.ret for c in cs] == [11 + 12, 16 + 17]
    assert all(c.ok for c in cs)
    assert isinstance(pep._dev_mem, Sharded) and pep.mesh.size == 1
    assert list(pss[1].read_region("reply", offset=3, count=1)) == [33]
    with pytest.raises(EndpointError):
        pep.doorbell(mode="batched", placement="auto")


def test_endpoint_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TiaraEndpoint(64)
    assert TiaraEndpoint(64, device="cpu").device.type == "cpu"


def test_quickstart_flow_matches_jax_frontend():
    """quickstart steps 1-5 and 7-8: write an operator in the frontend,
    verify and register it, post, ring, poll — same code words as the
    reference frontend, same answer as pyvm — then time it with the
    port's cycle simulator over ``Session.trace``: the reference
    simulator's ``TaskSim`` on the reference pyvm's trace, exactly, and
    below the dependent RDMA chain (quickstart step 5)."""
    src = '''
def walk(start, depth):
    cur = start
    for _ in bounded(depth, 8):
        cur = load("graph", cur + 1)
    memcpy("reply", 0, "graph", cur, 8)
    return load("graph", cur)
'''
    from repro.core import operators as jops
    w = jops.GraphWalk(n_nodes=16, max_depth=8)
    ep, ss = TiaraEndpoint.for_tenants([("q", memory.packed_table(
        [("graph", 16 * 8), ("reply", 64)]))], device="cpu")
    sess = ss["q"]
    prog = compile_source(src, regions=sess.view)
    jprog = jcompile_source(src, regions=jmemory.merge_tables(
        [("q", w.regions())])[1]["q"])
    assert np.array_equal(prog.code, jprog.code)
    op_id = sess.register(prog)
    order = w.populate(sess.pool, sess.view, seed=3)
    ref = pyvm.run(ep.registry[op_id].verified, ep.regions,
                   ep.host_mem().copy(), [int(order[0]) * 8, 5])
    c = sess.post("walk", [int(order[0]) * 8, 5])
    assert c.result() == ref.ret == w.reference(order, int(order[0]), 5)
    assert sess.poll_cq() == []

    params = [int(order[0]) * 8, 5]
    ts = simulator.simulate_task(ep.registry[op_id].verified,
                                 sess.trace("walk", params).trace)
    jrt, jviews = jmemory.merge_tables([("q", w.regions())])
    jvop = jverify(jprog, grant=JGrant.all_of(jviews["q"], "q"),
                   regions=jrt)
    jres = jpyvm.run(jvop, jrt, ep.host_mem().copy(), params,
                     record_trace=True)
    assert dataclasses.asdict(ts) == \
        dataclasses.asdict(jsim.simulate_task(jvop, jres.trace))
    assert 0 < ts.latency_us < costmodel.rdma_chain_latency_us(5)


# ---------------------------------------------------------------------------
# the import guard
# ---------------------------------------------------------------------------

def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / p for p in (
            "chip_smoke.py", "examples/quickstart_torch.py",
            "examples/serve_paged_torch.py",
            "examples/train_tiny_lm_torch.py",
            "examples/disaggregated_kv_torch.py",
            "tools/check_budgets_torch.py",
            "experiments/mk_tables_torch.py")]
    assert len(files) > 15
    scanned = {f.relative_to(ROOT).as_posix() for f in files}
    for mod in ("configs/__init__", "models/transformer", "models/attention",
                "kernels/flash_attention/ops",
                "kernels/paged_attention/kernel",
                "kernels/selective_scan/ops", "kernels/wkv6/ops",
                "serving/engine",
                "serving/resolver", "launch/serve"):
        assert f"src/repro_torch/{mod}.py" in scanned, mod
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
