"""The endpoint's lockstep waves run on its resident pool, in place.

The endpoint keeps its pool laid out with the engines' sink word
(``vm.resident_pool``) and donates it to a lockstep wave of one launch
(``vm.donate``): the ``lockstep_vm`` kernel on the card, the host loop on
the CPU, writes the pool in place, so the pool's storage is the same
tensor before and after the wave.  Direct engine calls keep their private
copy; the compiled, segmented and sharded routes keep their own buffers;
a doorbell that fails before its launch leaves the pool as it was.

On the CPU every wave is held to pyvm replayed on a host copy of the pool
taken before the wave.  On the card (``gpu`` marker, skipped here):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_lockstep_vm_endpoint.py

one lockstep wave on a resident pool of 1 GiB allocates no second pool.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import faults, pyvm, vm
from repro_torch.core import lockstep_corpus as corpus
from repro_torch.core import operators as ops
from repro_torch.core.endpoint import TiaraEndpoint


def _endpoint(device="cpu", n_nodes=64, kv_blocks=16, block_bytes=256):
    gw = ops.GraphWalk(n_nodes=n_nodes, max_depth=6, reply_words=8 * 16)
    kv = ops.PagedKVFetch(n_blocks_pool=kv_blocks, block_bytes=block_bytes,
                          max_req_blocks=4, reply_slots=16)
    ep, ss = TiaraEndpoint.for_tenants(
        [("gw", gw.regions()), ("kv", kv.regions())], device=device)
    g, k = ss["gw"], ss["kv"]
    order = gw.populate(g.pool, g.view, seed=1)
    kv.populate(k.pool, k.view, seed=2)
    g.register(gw.build(g.view, reply_param=True))
    k.register(kv.build(k.view, reply_param=True))
    k.write_region("req", [3, 8, 1, 15])
    return ep, g, k, order, kv.block_words


def _post(g, k, order, block_words, mode):
    walks = 1 if mode == "interp" else 4
    cs = [g.post("graph_walk", [int(order[i]) * 8, 3, 8 * i])
          for i in range(walks)]
    if mode not in ("interp", "batched"):
        cs += [k.post("paged_kv_fetch", [4, 4 * block_words * i])
               for i in range(4)]
    return cs


def _hold_to_pyvm(ep, cs, pre):
    vops = ep.registry.store_ops()
    mem = pre.copy()
    for c in cs:
        r = pyvm.run(vops[c.op_id], ep.regions, mem, list(c.params),
                     home=c.home)
        assert (c.ret, c.status, c.steps) == (r.ret, r.status, r.steps)
    assert np.array_equal(ep._host_view(), mem)


def _storage(t):
    return t.untyped_storage().data_ptr()


@pytest.mark.parametrize("mode", ["mixed", "batched", "interp"])
def test_lockstep_waves_run_on_the_resident_pool(mode):
    """Three waves in a row on one mode: the pool's storage stays the
    same tensor across every wave, and the pool equals pyvm's replay."""
    ep, g, k, order, bw = _endpoint()
    pool = ep.mem
    assert vm._sink_view(pool) is not None
    ptr = _storage(pool)
    for _ in range(3):
        pre = ep._host_view().copy()
        cs = _post(g, k, order, bw, mode)
        ep.doorbell(mode=mode)
        assert all(c.ok for c in cs)
        assert _storage(ep.mem) == ptr
        _hold_to_pyvm(ep, cs, pre)


def test_transient_failure_leaves_the_resident_pool_bit_identical():
    """A doorbell that runs out of retries on injected transient launch
    failures (raised before any launch) leaves the resident pool bit for
    bit and in the same storage; the next doorbell runs the wave in
    place."""
    ep, g, k, order, bw = _endpoint()
    ep.doorbell()                          # nothing posted: uploads nothing
    pre_cs = _post(g, k, order, bw, "mixed")
    ep.doorbell(mode="mixed")
    assert all(c.ok for c in pre_cs)
    before, ptr = ep.mem.clone(), _storage(ep.mem)
    ep.inject(faults.drop_doorbells(ep.retry_limit + 1))
    cs = _post(g, k, order, bw, "mixed")
    with pytest.raises(faults.TransientError):
        ep.doorbell(mode="mixed")
    assert torch.equal(ep.mem, before) and _storage(ep.mem) == ptr
    pre = ep._host_view().copy()
    ep.doorbell(mode="mixed")
    assert _storage(ep.mem) == ptr
    _hold_to_pyvm(ep, cs, pre)


def test_other_routes_keep_their_buffers_and_lockstep_adopts_them():
    """A segmented wave (compiled segments, several launches) rebinds the
    pool to its own buffer; the next lockstep wave then runs in place on
    that buffer."""
    ep, g, k, order, bw = _endpoint()
    ptr = _storage(ep.mem)
    pre = ep._host_view().copy()
    cs = _post(g, k, order, bw, "segmented")
    ep.doorbell(mode="segmented")
    _hold_to_pyvm(ep, cs, pre)
    seg = _storage(ep.mem)
    assert seg != ptr
    pre = ep._host_view().copy()
    cs = _post(g, k, order, bw, "mixed")
    ep.doorbell(mode="mixed")
    assert _storage(ep.mem) == seg
    _hold_to_pyvm(ep, cs, pre)


def test_direct_engine_calls_keep_their_private_copy():
    """Outside a donation, and inside one on another tensor or on a pool
    without the sink word, an engine run leaves its input untouched; a
    donation serves one run only."""
    w = corpus.stock_waves(7, block_bytes=256, serialized=False)[2]
    eng = w.engine()
    plain = torch.from_numpy(w.mem.copy())
    want = eng.run_host_loop(plain, *w.args())
    assert torch.equal(plain, torch.from_numpy(w.mem))
    resident = vm.resident_pool(w.mem, "cpu")
    with vm.donate(plain):
        eng.run_host_loop(resident, *w.args())
        eng.run_host_loop(plain, *w.args())          # no sink word
    assert torch.equal(resident, torch.from_numpy(w.mem))
    assert torch.equal(plain, torch.from_numpy(w.mem))
    with vm.donate(resident):
        assert vm.donated(resident)
        got = eng.run_host_loop(resident, *w.args())
        assert not vm.donated(resident)              # taken
        again = eng.run_host_loop(resident, *w.args())
    assert _storage(got.mem) == _storage(resident)
    assert _storage(again.mem) != _storage(resident)
    assert torch.equal(resident, want.mem) and torch.equal(got.mem, want.mem)
    with vm.donate(resident), vm.donate(None):
        assert not vm.donated(resident)


@pytest.mark.gpu
def test_cuda_endpoint_wave_allocates_no_second_pool():
    """On the card: a mixed lockstep wave on a resident pool of about
    1 GiB makes one lockstep_vm launch, keeps the pool's data_ptr, grows
    the peak allocation by far less than the pool, and leaves the pool
    equal to pyvm's replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ep, g, k, order, bw = _endpoint("cuda", n_nodes=1 << 20,
                                    kv_blocks=131072, block_bytes=8192)
    pool = ep.mem
    torch.cuda.synchronize()
    ptr, pool_bytes = pool.data_ptr(), pool.numel() * 8
    assert pool_bytes > (1 << 30)
    pre = ep._host_view().copy()
    cs = _post(g, k, order, bw, "mixed")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    ep.doorbell(mode="mixed")
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - base
    assert kernels.launch_counts()["lockstep_vm"] == 1
    assert ep.mem.data_ptr() == ptr
    assert grew < pool_bytes // 16, grew
    _hold_to_pyvm(ep, cs, pre)
