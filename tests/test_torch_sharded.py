"""The port's sharded pool: ``doorbell(placement="sharded")`` on a mesh of
4 CPU shards, replaying the scenarios of ``tests/test_sharded.py``.

Every wave is held to the port's ``pyvm`` (posts replayed one at a time)
*and* to the JAX package's dense mixed engine
(``repro.core.vm.invoke_batched_mixed``) on the same ``(n_dev, P)`` pool —
the engine the reference proves its sharded engine equal to, since this
process sees one JAX device — bit for bit: pool, ret, status, steps,
registers.  JAX's own ``invoke_sharded_mixed`` runs at n = 1.  The
fault, multi-device-home and rehoming scenarios are in
``tests/test_torch_sharded_endpoint.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import compile as jcompile
from repro.core import memory as jmemory
from repro.core import vm as jvm
from repro.core.costmodel import DispatchCostModel as JCostModel
from repro.core.endpoint import TiaraEndpoint as JEndpoint
from repro.core.program import OperatorBuilder as JBuilder
from repro_torch.core import compile as tc
from repro_torch.core import memory, pyvm, vm
from repro_torch.core.costmodel import DispatchCostModel
from repro_torch.core.endpoint import EndpointError, TiaraEndpoint
from repro_torch.core.program import OperatorBuilder
from repro_torch.distributed.mesh import Sharded, make_device_mesh

N_DEV = 4


def _mesh(n=N_DEV):
    return make_device_mesh(n, devices=["cpu"] * n)


def _layout(mem_mod, reply_words=64):
    return mem_mod.packed_table([("latch", 8), ("data", 64),
                                 ("reply", reply_words)])


def _sum_op(B, rt):
    """reply[p1] = data[p0] + data[p0+1] (home-local)."""
    b = B("sum2", n_params=2, regions=rt)
    x, y = b.reg(), b.reg()
    b.load(x, "data", b.param(0))
    b.load(y, "data", b.param(0), disp=1)
    b.add(x, x, y)
    b.store(x, "reply", b.param(1))
    b.ret(x)
    return b.build()


def _cas_op(B, rt):
    """CAS latch[0] of the post's home: 0 -> p0 (single-touch)."""
    b = B("cas_latch", n_params=1, regions=rt)
    zero = b.const(0)
    old = b.reg()
    b.cas(old, "latch", zero, cmp=zero, swap=b.param(0))
    b.ret(old)
    return b.build()


def _store_op(B, rt):
    """Blind store latch[1] = p0 on the post's home (single-touch)."""
    b = B("store_latch", n_params=1, regions=rt)
    one = b.const(1)
    b.store(b.param(0), "latch", one)
    b.ret(b.param(0))
    return b.build()


def _rcpy_op(B, rt):
    """Cross-home MEMCPY: reply[p1..p1+4) <- device p2's data[p0..p0+4)."""
    b = B("rcpy", n_params=3, regions=rt)
    b.memcpy(dst_region="reply", dst_off=b.param(1),
             src_region="data", src_off=b.param(0), n_words=4,
             src_dev=b.param(2))
    b.ret(b.param(1))
    return b.build()


def _rcas_op(B, rt):
    """Cross-home CAS on device p1's latch[2]: 0 -> p0."""
    b = B("rcas", n_params=2, regions=rt)
    zero = b.const(0)
    old = b.reg()
    b.cas(old, "latch", zero, cmp=zero, swap=b.param(0), disp=2,
          dev=b.param(1))
    b.ret(old)
    return b.build()


def _rmw_op(B, rt):
    """Store p0 to device p1's latch[3], then read it back."""
    b = B("rmw", n_params=2, regions=rt)
    out = b.reg()
    b.store(b.param(0), "latch", b.const(3), dev=b.param(1))
    b.load(out, "latch", b.const(3), dev=b.param(1))
    b.ret(out)
    return b.build()


def _nop_op(B, rt):
    """Touches no memory: the yardstick's padding lanes run it."""
    b = B("nop", n_params=0, regions=rt)
    b.ret(b.const(0))
    return b.build()


_BUILDERS = (_sum_op, _cas_op, _store_op, _rcpy_op, _rcas_op, _rmw_op,
             _nop_op)
# the JAX yardstick's waves are padded with nop lanes to a multiple of
# YARD_PAD and their params to YARD_PARAMS columns, so waves of different
# sizes share one compiled engine
YARD_PAD = 32
YARD_PARAMS = 3


@dataclasses.dataclass
class Pair:
    """The same deployment on both packages: the port's endpoint over a
    CPU mesh, and the JAX endpoint whose registry supplies the yardstick
    engine's operators."""
    ep: TiaraEndpoint
    sessions: list
    jep: JEndpoint


def _connect(n_tenants=3, n_devices=N_DEV, reply_words=64, mesh=True,
             **kwargs):
    named = [(f"t{i}", _layout(memory, reply_words))
             for i in range(n_tenants)]
    ep, ss = TiaraEndpoint.for_tenants(
        named, n_devices=n_devices, device="cpu",
        mesh=_mesh(n_devices) if mesh else None, **kwargs)
    jep, jss = JEndpoint.for_tenants(
        [(f"t{i}", _layout(jmemory, reply_words))
         for i in range(n_tenants)], n_devices=n_devices)
    for i in range(n_tenants):
        for s, B in ((ss[f"t{i}"], OperatorBuilder),
                     (jss[f"t{i}"], JBuilder)):
            for build in _BUILDERS:
                s.register(build(B, s.view))
            for d in range(n_devices):
                s.write_region("data",
                               np.arange(10, 74, dtype=np.int64) * (d + 1),
                               device=d)
    return Pair(ep, [ss[f"t{i}"] for i in range(n_tenants)], jep)


def _yardsticks(pair, completions):
    """The pyvm replay and the JAX dense mixed engine on the pool as it
    stands before the wave: (pool, {seq: (ret, status, steps, regs)})
    from each."""
    ep = pair.ep
    pre = ep.host_mem().copy()
    vops = ep.registry.store_ops()
    seq = pre.copy()
    expect = {}
    cs = sorted(completions, key=lambda c: c.seq)
    for c in cs:
        r = pyvm.run(vops[c.op_id], ep.regions, seq, list(c.params),
                     home=c.home)
        expect[c.seq] = (r.ret, r.status, r.steps)
    jops = pair.jep.registry.store_ops()
    assert [o.code.tobytes() for o in jops] == \
        [o.code.tobytes() for o in vops]
    # padding lanes arrive last and touch no memory, and zero params
    # are the registers' initial zeros: the real lanes' results are
    # those of the unpadded wave
    pad = -len(cs) % YARD_PAD
    nop = pair.sessions[0].op_id("nop")
    params = [list(c.params) + [0] * (YARD_PARAMS - len(c.params))
              for c in cs] + [[0] * YARD_PARAMS] * pad
    j = jvm.invoke_batched_mixed(jops, pair.jep.regions, pre,
                                 [c.op_id for c in cs] + [nop] * pad,
                                 params,
                                 homes=[c.home for c in cs] + [0] * pad)
    jexp = {c.seq: (int(j.ret[i]), int(j.status[i]), int(j.steps[i]),
                    np.asarray(j.regs[i]))
            for i, c in enumerate(cs)}
    return seq, expect, np.asarray(j.mem), jexp


def oracle_then_doorbell(pair, completions, sequential=True,
                         **doorbell_kwargs):
    """Ring the doorbell and hold the wave to the JAX dense mixed engine
    bit for bit, and (``sequential``) to the pyvm replay."""
    seq, expect, jmem, jexp = _yardsticks(pair, completions)
    pair.ep.doorbell(**doorbell_kwargs)
    got = pair.ep._host_view()
    assert np.array_equal(got, jmem)
    if sequential:
        assert np.array_equal(got, seq)
    for c in completions:
        assert c.done
        assert (c.ret, c.status, c.steps) == jexp[c.seq][:3], c
        assert np.array_equal(c.regs, jexp[c.seq][3])
        if sequential:
            assert (c.ret, c.status, c.steps) == expect[c.seq], c
    return seq


def test_sharded_doorbell_matches_oracle():
    pair = _connect()
    cs = []
    for i in range(13):
        s = pair.sessions[i % 3]
        home = i % N_DEV
        kind = i % 4
        if kind == 0:
            cs.append(s.post("sum2", [2 * (i % 5), i % 16], home=home))
        elif kind == 1:
            cs.append(s.post("cas_latch", [100 + i], home=home))
        elif kind == 2:
            cs.append(s.post("store_latch", [200 + i], home=home))
        else:
            cs.append(s.post("rcpy",
                             [i % 32, 16 + 4 * (i % 12), (i * 3) % N_DEV],
                             home=home))
    oracle_then_doorbell(pair, cs, placement="sharded")
    # the pool stays per shard after the wave, one row per mesh device
    assert isinstance(pair.ep._dev_mem, Sharded)
    assert pair.ep.last_decision is None and pair.ep.last_placement is None


def test_sharded_contended_cas_store_wave():
    """Contended STORE/CAS across posts AND across homes: arrival-order
    deterministic round-robin semantics survive sharding."""
    pair = _connect()
    cs = []
    for i in range(12):
        s = pair.sessions[i % 3]
        home = i % N_DEV
        if i % 2 == 0:
            cs.append(s.post("rcas", [1000 + i, 0], home=home))
        else:
            cs.append(s.post("store_latch", [2000 + i], home=home))
    oracle_then_doorbell(pair, cs, placement="sharded")
    for s in pair.sessions:
        winner = next(c for c in cs
                      if c.session is s and c.op_name == "rcas")
        assert winner.ret == 0
        assert s.read_region("latch", device=0, offset=2, count=1)[0] \
            == winner.params[0]


def test_sharded_cross_home_memcpy_reads_remote_data():
    pair = _connect()
    s0 = pair.sessions[0]
    src_dev = N_DEV - 1
    c = s0.post("rcpy", [8, 0, src_dev], home=0)
    pair.ep.doorbell(placement="sharded")
    want = np.arange(18, 22, dtype=np.int64) * (src_dev + 1)
    assert np.array_equal(s0.read_region("reply", device=0, count=4), want)
    assert c.done and c.ok


def test_sharded_matches_mixed_engine_on_multitouch_contention():
    """Store-then-readback on one shared word: the engines' round-robin
    macro-step semantics, not the sequential oracle.  The sharded engine
    reproduces the port's and the JAX package's dense mixed engines bit
    for bit, arrival order restored across the home bucketing."""
    pair = _connect()
    ep = pair.ep
    pre = ep.host_mem().copy()
    B = 9
    cs = [pair.sessions[0].post("rmw", [100 + i, 0], home=i % N_DEV)
          for i in range(B)]
    dense = vm.invoke_batched_mixed(
        ep.registry.store_ops(), ep.regions, pre, [c.op_id for c in cs],
        [list(c.params) for c in cs], homes=[c.home for c in cs],
        device="cpu")
    oracle_then_doorbell(pair, cs, sequential=False, placement="sharded")
    assert np.array_equal(ep._host_view(), dense.mem.numpy())
    for i, c in enumerate(cs):
        assert (c.ret, c.status, c.steps) == (int(dense.ret[i]),
                                              int(dense.status[i]),
                                              int(dense.steps[i]))
        assert np.array_equal(c.regs, dense.regs[i])
    # and it IS the engine semantics: every request reads the macro-step
    # winner (the last-arriving store), not its own value
    assert [c.ret for c in cs] == [100 + B - 1] * B


def test_jax_sharded_engine_at_one_device_matches_port():
    """JAX's own ``invoke_sharded_mixed`` runs at n = 1 in this process:
    the port's sharded engine over a 1-shard mesh gives the same bits."""
    pair = _connect(n_tenants=2, n_devices=1)
    vops = pair.ep.registry.store_ops()
    jops = pair.jep.registry.store_ops()
    pool = pair.ep.host_mem().copy()
    ids = [0, 1, 3, 6, 5, 2, 0, 8]
    params = [[2, 0], [7], [8, 20, 0], [11], [3, 4, 0], [9], [5, 1], [4, 0]]
    homes = [0] * len(ids)
    plan = tc.plan_mixed_batch(ids, homes=homes, n_devices=1)
    jplan = jcompile.plan_mixed_batch(ids, homes=homes, n_devices=1)
    got = vm.invoke_sharded_mixed(vops, pair.ep.regions, pool, plan, params,
                                  mesh=_mesh(1))
    want = jvm.invoke_sharded_mixed(jops, pair.jep.regions, pool, jplan,
                                    params)
    assert np.array_equal(np.asarray(want.mem), got.mem.full().numpy())
    for f in ("ret", "status", "steps", "regs"):
        assert np.array_equal(np.asarray(getattr(want, f)),
                              getattr(got, f)), f
    # the reference's mixed engines report a fault's pc in the merged
    # store; the port counts it from the operator's entry, as pyvm does
    fault = np.array(want.fault)
    entry = pair.jep.registry.dispatch_table()[ids]
    fault[:, 0] = np.where(fault[:, 0] >= 0, fault[:, 0] - entry, -1)
    assert fault[:, 0].max() >= 0                  # a lane did fault
    assert np.array_equal(fault, got.fault)


def test_sharded_per_session_fifo_and_repeat_doorbells():
    pair = _connect()
    posted = {s.tenant: [] for s in pair.sessions}
    rng = np.random.default_rng(1)
    for _ in range(3):
        for i in range(6):
            s = pair.sessions[int(rng.integers(0, 3))]
            c = s.post("sum2", [int(rng.integers(0, 30)), i],
                       home=int(rng.integers(0, N_DEV)))
            posted[s.tenant].append(c)
        oracle_then_doorbell(pair, [c for cs in posted.values() for c in cs
                                    if not c.done], placement="sharded")
    for s in pair.sessions:
        assert s.poll_cq() == posted[s.tenant]


def test_choose_placement_matches_reference_on_a_feasible_mesh():
    """``EngineCost.sharded_us`` and ``choose_placement`` price the
    reference's cases as the JAX package's cost model does, mode and
    costs."""
    cases = [dict(batch=4, n_devices=8, step_bound=10),
             dict(batch=2048, n_devices=8, step_bound=64),
             dict(batch=2048, n_devices=8, step_bound=64,
                  contention_rate=0.5),
             dict(batch=2048, n_devices=8, step_bound=64,
                  batch_per_device=2048),
             dict(batch=2048, n_devices=1, step_bound=64),
             dict(batch=2048, n_devices=8, step_bound=64,
                  sharded_feasible=False),
             dict(batch=1024, n_devices=4, step_bound=8, sharded_cached=True,
                  mixed_cached=True, static_noconflict=True)]
    for kw in cases:
        got = DispatchCostModel().choose_placement(**kw)
        want = JCostModel().choose_placement(**kw)
        assert got.mode == want.mode, kw
        assert got.costs == pytest.approx(want.costs, rel=1e-12), kw
    wide = DispatchCostModel().choose_placement(batch=2048, n_devices=8,
                                                step_bound=64)
    assert wide.mode == "sharded"


def test_placement_auto_degrades_when_mesh_infeasible():
    """A pool with more homes than the process has devices (and no mesh
    given) runs ``placement="auto"`` on one device, and "sharded" raises
    rather than shrink the mesh."""
    pair = _connect(mesh=False)          # one CPU: no mesh of 4 builds
    s0 = pair.sessions[0]
    cs = [s0.post("sum2", [i, i], home=i % N_DEV) for i in range(6)]
    oracle_then_doorbell(pair, cs, placement="auto")
    assert pair.ep.last_placement.mode == "single"
    assert "sharded" not in pair.ep.last_placement.costs
    assert pair.ep.mesh is None
    c = s0.post("sum2", [1, 1])
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        pair.ep.doorbell(placement="sharded")
    assert not c.done and pair.ep.outstanding == 1


def test_sharded_doorbell_clears_engine_decision_audit():
    pair = _connect()
    s0 = pair.sessions[0]
    s0.post("sum2", [0, 0])
    s0.post("cas_latch", [1])
    pair.ep.doorbell(mode="auto")
    assert pair.ep.last_decision is not None
    s0.post("sum2", [1, 1])
    pair.ep.doorbell(placement="sharded")
    assert pair.ep.last_decision is None


def test_explicit_placement_clears_placement_audit():
    pair = _connect()
    ep, s0 = pair.ep, pair.sessions[0]
    s0.post("sum2", [0, 0])
    ep.doorbell(placement="auto")
    assert ep.last_placement is not None
    s0.post("sum2", [1, 1])
    ep.doorbell(placement="sharded")
    assert ep.last_placement is None
    s0.post("sum2", [2, 2])
    ep.doorbell(placement="auto")
    assert ep.last_placement is not None
    s0.post("sum2", [3, 3])
    ep.doorbell(placement="single")
    assert ep.last_placement is None


def test_doorbell_placement_validation_and_requeue():
    pair = _connect()
    ep, s0 = pair.ep, pair.sessions[0]
    with pytest.raises(ValueError):
        ep.doorbell(placement="everywhere")
    c = s0.post("sum2", [0, 0])
    with pytest.raises(EndpointError):
        ep.doorbell(mode="segmented", placement="sharded")
    assert ep.outstanding == 1 and not c.done
    ep.doorbell(placement="sharded")
    assert c.done and c.ok


def test_invoke_sharded_requires_placed_plan():
    pair = _connect()
    vops = pair.ep.registry.store_ops()
    pool = pair.ep.host_mem()
    with pytest.raises(ValueError):
        vm.invoke_sharded_mixed(vops, pair.ep.regions, pool,
                                tc.plan_mixed_batch([0]), [[0, 0]],
                                mesh=_mesh())
    placed = tc.plan_mixed_batch([0], homes=[0], n_devices=N_DEV + 1)
    with pytest.raises((ValueError, RuntimeError)):
        vm.invoke_sharded_mixed(vops, pair.ep.regions, pool, placed,
                                [[0, 0]], mesh=_mesh())
    with pytest.raises(ValueError):
        vm.invoke_sharded_mixed(vops, pair.ep.regions, pool,
                                tc.plan_mixed_batch([0], homes=[0],
                                                    n_devices=N_DEV),
                                [[0, 0]], mesh=_mesh(2))


_PROP_OPS = ("sum2", "cas_latch", "store_latch", "rcpy", "rcas")


@pytest.mark.parametrize("seed", range(3))
def test_random_sharded_waves_seeded(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 13))
    pair = _connect()
    cs = []
    for i in range(n):
        si, oi, arg, home = (int(x) for x in rng.integers(0, 1000, size=4))
        s = pair.sessions[si % 3]
        name = _PROP_OPS[oi % len(_PROP_OPS)]
        home = home % N_DEV
        if name == "sum2":
            params = [arg % 32, i % 16]
        elif name == "rcpy":
            params = [arg % 32, 16 + (i % 12) * 4, (arg // 7) % N_DEV]
        elif name == "rcas":
            params = [arg % (2**31), (arg // 3) % N_DEV]
        else:
            params = [arg % (2**31)]
        cs.append(s.post(name, params, home=home))
    oracle_then_doorbell(pair, cs, placement="sharded")
    for s in pair.sessions:
        got = s.poll_cq()
        assert [c.seq for c in got] == sorted(c.seq for c in got)


def test_sharded_4tenant_b1024_bit_identical():
    """The reference's acceptance wave on 4 homes: 4 tenants, 1024 mixed
    posts with cross-home MEMCPYs and contended STORE/CAS, sharded
    placement — bit-identical to the pyvm replay and to the JAX dense
    mixed engine.  The same wave with ``placement="auto"`` afterwards
    agrees too."""
    pair = _connect(n_tenants=4, reply_words=1024)
    rng = np.random.default_rng(7)
    n_sum, n_cpy = [0] * 4, [0] * 4

    def post_wave():
        cs = []
        for i in range(1024):
            t = i % 4
            s = pair.sessions[t]
            home = int(rng.integers(0, N_DEV))
            kind = i % 8
            if kind < 3:
                cs.append(s.post("sum2", [int(rng.integers(0, 60)),
                                          n_sum[t] % 512], home=home))
                n_sum[t] += 1
            elif kind < 5:
                cs.append(s.post("rcpy",
                                 [int(rng.integers(0, 60)),
                                  512 + 4 * (n_cpy[t] % 128),
                                  int(rng.integers(0, N_DEV))], home=home))
                n_cpy[t] += 1
            elif kind == 5:
                cs.append(s.post("cas_latch", [10_000 + i], home=home))
            elif kind == 6:
                cs.append(s.post("store_latch", [20_000 + i], home=home))
            else:
                cs.append(s.post("rcas", [30_000 + i,
                                          int(rng.integers(0, N_DEV))],
                                 home=home))
        return cs

    mesh = pair.ep.mesh
    mesh.reset_stats()
    oracle_then_doorbell(pair, post_wave(), placement="sharded")
    counts = mesh.collective_counts()
    assert counts["all-gather"] > 0 and counts["all-reduce"] > 0
    # the wave moved data across shards: the cross-home MEMCPYs
    assert mesh.collective_bytes()["all-reduce"] > 0


def test_sharded_engine_routes_by_impl_and_mesh(monkeypatch):
    """``impl`` on the sharded engine: "auto" on a mesh of CPU shards runs
    the host loop (its collectives counted, the kernel route never
    taken), as "torch" does; "cuda" raises there, and on a mesh whose
    shards span two cards (one launch would need peer access), where
    "auto" keeps the host loop; a mesh whose shards all name one card
    takes the kernel under "auto" and "cuda"."""
    pair = _connect()
    ep = pair.ep
    vops, rt = ep.registry.store_ops(), ep.regions
    pool = ep.host_mem().copy()
    ids, homes = [0, 3, 4], [0, 2, 1]
    params = [[2, 0], [8, 20, 3], [77, 1]]
    plan = tc.plan_mixed_batch(ids, homes=homes, n_devices=N_DEV)

    def refuse(*a):
        raise AssertionError("the kernel route ran on a CPU mesh")
    monkeypatch.setattr(vm._ShardedEngine, "run_kernel", refuse)
    mesh = _mesh()
    got = vm.invoke_sharded_mixed(vops, rt, pool, plan, params, mesh=mesh)
    assert sum(mesh.collective_counts().values()) > 0
    want = vm.invoke_sharded_mixed(vops, rt, pool, plan, params, mesh=mesh,
                                   impl="torch")
    assert torch.equal(got.mem.full(), want.mem.full())
    for f in ("ret", "status", "steps", "regs", "fault"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    with pytest.raises(ValueError, match="CUDA"):
        vm.invoke_sharded_mixed(vops, rt, pool, plan, params, mesh=mesh,
                                impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        vm.build_sharded_mixed_vm(vops, rt, N_DEV, 2, impl="triton")
    two = make_device_mesh(2, devices=["cuda:0", "cuda:1"])
    eng = vm.build_sharded_mixed_vm(vops, rt, 2, 2, impl="cuda")
    with pytest.raises(ValueError, match="one CUDA card"):
        eng(two, None, None, None, None, None, None)
    assert vm.sharded_route("auto", two) == "torch"
    assert vm.sharded_route("torch", two) == "torch"
    one = make_device_mesh(N_DEV, devices=["cuda:0"] * N_DEV)
    assert vm.sharded_route("auto", one) == "cuda"
    assert vm.sharded_route("cuda", one) == "cuda"
    assert vm.sharded_route("auto", mesh) == "torch"


def test_sharded_engine_key_holds_impl():
    """The sharded engine cache keys on ``impl`` as the dense engines'
    do: an "auto" engine and a "torch" engine are two entries, and
    ``sharded_engine_cached`` asks for the route it is given."""
    pair = _connect(n_tenants=1)
    vops, rt = pair.ep.registry.store_ops(), pair.ep.regions
    mesh = _mesh()
    keys = {impl: vm._sharded_engine_key(vops, rt, N_DEV, 5, "pool",
                                         mesh=mesh, impl=impl)
            for impl in ("auto", "cuda", "torch")}
    assert len(set(keys.values())) == 3
    assert vm._sharded_engine_key(vops, rt, N_DEV, 5, "pool",
                                  mesh=mesh) == keys["auto"]
    eng = vm._cached_sharded_engine(vops, rt, N_DEV, 5, mesh=mesh,
                                    impl="torch")
    assert eng.impl == "torch"
    assert vm.sharded_engine_cached(vops, rt, N_DEV, 5, mesh=mesh,
                                    impl="torch")
    assert not vm.sharded_engine_cached(vops, rt, N_DEV, 5, mesh=mesh,
                                        impl="cuda")
    assert vm._cached_sharded_engine(vops, rt, N_DEV, 5, mesh=mesh,
                                     impl="torch") is eng
