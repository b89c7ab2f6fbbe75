"""The port's sharded pool at the endpoint and in serving, on meshes of
CPU shards: the failed-device fault and ``placement="auto"`` degrade of
``tests/test_faults.py``, the multi-device homes of
``tests/test_endpoint.py``, and rehoming with ``n_homes > 1`` of
``tests/test_e2e_paged.py`` (tiny sizes, tokens equal to the host
resolver's).  Results are held to the port's ``pyvm`` and to each
operator's own reference answer; the engines' parity with the JAX
package is ``tests/test_torch_sharded.py``'s.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import faults, pyvm
from repro_torch.core import operators as ops
from repro_torch.core.endpoint import TiaraEndpoint
from repro_torch.distributed.mesh import Sharded, make_device_mesh
from repro_torch.models import transformer as ttf
from repro_torch.serving import ServingEngine

N_DEV = 4


def _mesh(n=N_DEV):
    return make_device_mesh(n, devices=["cpu"] * n)


# ---------------------------------------------------------------------------


def _graph_endpoint(n_devices, mesh=None):
    w = ops.GraphWalk(n_nodes=32, max_depth=8,
                      reply_words=4 * ops.NODE_WORDS)
    named = [(f"t{i}", w.regions()) for i in range(2)]
    ep, sessions = TiaraEndpoint.for_tenants(named, n_devices=n_devices,
                                             device="cpu", mesh=mesh)
    orders = {}
    for i in range(2):
        s = sessions[f"t{i}"]
        s.register(w.build(s.view, reply_param=True))
        orders[f"t{i}"] = w.populate(s.pool, s.view, seed=i)
    return ep, [sessions[f"t{i}"] for i in range(2)], orders, w


def test_failed_device_faults_and_auto_placement_degrades():
    """A post homed on a failed device faults with the device named in
    the CQE, and ``placement="auto"`` refuses the mesh while any device
    is failed; ``revive()`` and ``reset()`` recover, and the mesh is
    feasible again."""
    ep, (s0, s1), orders, w = _graph_endpoint(N_DEV, mesh=_mesh())
    o0, o1 = orders["t0"], orders["t1"]
    dead = N_DEV - 1
    w.populate(s1.pool, s1.view, device=dead, seed=1)
    ep.inject(faults.fail_devices(dead))
    cs = [s0.post("graph_walk", [int(o0[0]) * 8, 2, 0], home=0),
          s1.post("graph_walk", [int(o1[0]) * 8, 2, 0], home=dead)]
    ep.doorbell(placement="auto")
    assert ep.last_placement is not None
    assert ep.last_placement.mode == "single"
    assert "sharded" not in ep.last_placement.costs
    assert cs[0].ok
    assert cs[1].faulted and cs[1].fault.device == dead
    assert s1.in_error and not s0.in_error
    ep.revive(dead)
    s1.reset()
    c = s1.post("graph_walk", [int(o1[0]) * 8, 2, 0], home=dead)
    ep.doorbell(placement="sharded")
    assert c.ok and c.ret == w.reference(o1, int(o1[0]), 2)
    s0.post("graph_walk", [int(o0[0]) * 8, 2, 0])
    ep.doorbell(placement="auto")
    assert "sharded" in ep.last_placement.costs


def test_multi_device_homes_on_the_mesh():
    w = ops.GraphWalk(n_nodes=64, max_depth=8)
    ep, sessions = TiaraEndpoint.for_tenants([("gw", w.regions())],
                                             n_devices=3, device="cpu",
                                             mesh=_mesh(3))
    s = sessions["gw"]
    s.register(w.build(s.view))
    orders = [w.populate(s.pool, s.view, device=d, seed=d)
              for d in range(3)]
    pre = ep.host_mem().copy()
    cs = [s.post("graph_walk", [int(orders[d][0]) * 8, 5], home=d)
          for d in range(3)]
    vops = ep.registry.store_ops()
    for c in cs:
        r = pyvm.run(vops[c.op_id], ep.regions, pre, list(c.params),
                     home=c.home)
        assert (r.ret, r.status) == (w.reference(orders[c.home],
                                                 int(orders[c.home][0]), 5),
                                     0)
    ep.doorbell(placement="sharded")
    assert np.array_equal(ep._host_view(), pre)
    for d, c in enumerate(cs):
        assert c.ret == w.reference(orders[d], int(orders[d][0]), 5)
    # host reads and writes reach the right shard
    s.write_region("graph", [7, 8], device=2)
    assert list(s.read_region("graph", device=2, count=2)) == [7, 8]
    assert isinstance(ep._dev_mem, Sharded)
    assert torch.equal(ep.mem[2, s.view["graph"].base:
                              s.view["graph"].base + 2],
                       torch.tensor([7, 8]))


@pytest.fixture(scope="module")
def tiny():
    cfg = reduce_config(get_config("tiny-lm"))
    return cfg, ttf.init_params(cfg, seed=0, device="cpu")


def test_tiara_parity_sharded_homes_with_rehome(tiny):
    """``ServingEngine(resolver="tiara", n_homes=4, placement="sharded")``
    on a 4-shard mesh: the host resolver's tokens, with the audit's
    cross-device traffic rehoming regions mid-run."""
    cfg, params = tiny
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, 4 + i)))
               for i in range(5)]

    def engine(**kw):
        return ServingEngine(cfg, params, temperature=0.0, eos_id=-1,
                             max_slots=3, max_seq=64, device="cpu", **kw)

    host = engine()
    for p in prompts:
        host.submit(p, max_new=4)
    want = host.run_to_completion()
    mesh = _mesh()
    eng = engine(resolver="tiara", n_homes=N_DEV, placement="sharded",
                 rehome_every=2, mesh=mesh)
    for p in prompts:
        eng.submit(p, max_new=4)
    mesh.reset_stats()
    assert eng.run_to_completion() == want
    aud = eng.resolver_audit()
    assert aud["rehomes"] >= 1 and aud["rehomed_words"] > 0
    assert aud["cross_device_words"] > 0
    # the decode steps' waves ran on the mesh
    assert mesh.collective_counts().get("all-reduce", 0) > 0
