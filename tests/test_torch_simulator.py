"""The port's cycle simulator against the JAX package's.

``repro_torch.core.simulator`` is an own copy of
``repro.core.simulator`` (jax-free; imports rewritten, logic unchanged).
Each stock operator is built, populated from a numpy seed, verified and
run on the ``pyvm`` oracle by each package's own modules; the two traces
must be the same events, and every simulator output must be equal —
exactly, since both packages run the same float arithmetic in the same
order: ``TaskSim`` field for field (plain, pipelined, serialized and with
an injected mid-flight abort), ``overlap_speedup``,
``saturated_throughput_mops``, ``bottleneck`` and
``effective_gather_gbs``.
"""

import dataclasses
import types

import numpy as np
import pytest

from repro.core import memory as jmemory
from repro.core import operators as jops
from repro.core import pyvm as jpyvm
from repro.core import simulator as jsim
from repro.core.memory import Grant as JGrant
from repro.core.verifier import verify as jverify
from repro_torch.core import memory, operators, pyvm, simulator
from repro_torch.core.memory import Grant
from repro_torch.core.verifier import verify

JAX = types.SimpleNamespace(ops=jops, memory=jmemory, pyvm=jpyvm, sim=jsim,
                            Grant=JGrant, verify=jverify)
PORT = types.SimpleNamespace(ops=operators, memory=memory, pyvm=pyvm,
                             sim=simulator, Grant=Grant, verify=verify)


def _graph_walk(p):
    w = p.ops.GraphWalk(n_nodes=64, max_depth=16)
    rt = w.regions()
    mem = p.memory.make_pool(1, rt)
    order = w.populate(mem, rt, seed=41)
    return w.build(rt), rt, mem, [int(order[0]) * 8, 10], {}


def _ptw(p):
    w = p.ops.PageTableWalk(fanout=8, n_pages=8)
    rt = w.regions()
    mem = p.memory.make_pool(1, rt)
    vas = sorted(w.populate(mem, rt, seed=42))
    return w.build(rt), rt, mem, [vas[3]], {}


def _lock(p):
    w = p.ops.DistLock()
    rt = w.regions()
    mem = p.memory.make_pool(3, rt)
    p.memory.write_region(mem, rt, 0, "lock", [0, 0])
    return w.build(rt), rt, mem, [0, 1, 9, 1, 1, 2, 1], {}


def _kv_remote(p):
    w = p.ops.PagedKVFetch(n_blocks_pool=32, block_bytes=32768,
                           max_req_blocks=16)
    rt = w.regions()
    mem = p.memory.make_pool(2, rt)
    w.populate(mem, rt, seed=43)
    w.make_request(mem, rt, [(5 * i) % 32 for i in range(16)])
    return (w.build(rt, remote_reply=True), rt, mem, [16, 1],
            dict(pipelined=True, serial_chain=False))


def _moe(p):
    w = p.ops.MoEExpertGather(n_experts=64, max_k=32, slab_words=256)
    rt = w.regions()
    mem = p.memory.make_pool(1, rt)
    w.populate(mem, rt, seed=44)
    p.memory.write_region(mem, rt, 0, "expert_ids",
                          np.arange(10, dtype=np.int64))
    return w.build(rt), rt, mem, [10], {}


def _nsa(p):
    w = p.ops.NSASelect(n_scores=16, block_words=64)
    rt = w.regions()
    mem = p.memory.make_pool(1, rt)
    w.populate(mem, rt, seed=45)
    return w.build(rt), rt, mem, [16, 40], {}


OPS = {"graph_walk": _graph_walk, "ptw3": _ptw, "dist_lock": _lock,
       "paged_kv_fetch_remote": _kv_remote, "moe_expert_gather": _moe,
       "nsa_select": _nsa}


def _simulate(p, name):
    """Everything the simulator gives for one traced invocation."""
    prog, rt, mem, params, kw = OPS[name](p)
    vop = p.verify(prog, grant=p.Grant.all_of(rt), regions=rt)
    res = p.pyvm.run(vop, rt, mem, params, record_trace=True)
    assert res.status in (0, 1)
    sim = p.sim
    ts = sim.simulate_task(vop, res.trace, **kw)
    out = dict(
        trace=[dataclasses.astuple(e) for e in res.trace],
        task=dataclasses.asdict(ts),
        serialized=dataclasses.asdict(sim.simulate_task(
            vop, res.trace, serialize_async=True, **kw)),
        fpga=dataclasses.asdict(sim.simulate_task(vop, res.trace)),
        aborted=dataclasses.asdict(sim.simulate_task(
            vop, res.trace, fail_memcpy_at=(0,), reply_payload_bytes=64,
            **kw)),
        overlap=sim.overlap_speedup(vop, res.trace, **kw),
        mops=sim.saturated_throughput_mops(ts),
        bottleneck=sim.bottleneck(ts),
        gbs=sim.effective_gather_gbs(ts, 1 << 20))
    return out


@pytest.mark.parametrize("name", sorted(OPS))
def test_simulator_matches_reference(name):
    want, got = _simulate(JAX, name), _simulate(PORT, name)
    assert len(got["trace"]) > 0
    assert got == want


def test_simulator_sees_the_overlap_and_the_walk():
    """The port's numbers say what the reference's say: a 10-chunk async
    gather hides latency (ratio > 1.3), and the depth-10 walk beats ten
    dependent RDMA round trips."""
    from repro_torch.core import costmodel as cm
    moe = _simulate(PORT, "moe_expert_gather")
    assert moe["overlap"] > 1.3 and moe["task"]["async_issued"] == 10
    walk = _simulate(PORT, "graph_walk")
    assert walk["task"]["latency_us"] < cm.rdma_chain_latency_us(10)
