"""The reference's queue-pair endpoint scenarios (``tests/test_endpoint.py``)
replayed on the port: sessions, posted work, doorbell batching,
completion queues — against the port's per-request ``pyvm`` oracle.

The port runs on the CPU (``device="cpu"`` passed to every endpoint).
Its pool is a tensor, so ``ep.mem`` is read through ``.cpu().numpy()``
(``_pool``); nothing else differs from the reference's cases.

The invariants under test:

1. A doorbell drains all sessions' posts as ONE wave in global arrival
   order, so results (including contended STORE/CAS posts) are
   bit-identical to replaying the posts one at a time on ``pyvm``.
2. Completions retire into each session's CQ in per-session FIFO order,
   for any interleaving of posts across sessions and doorbells.
3. The legacy ``registry.invoke*`` shims are gone (their one-release
   window closed with PR 5) — the endpoint is the only surface.

The split-phase completion surface (``doorbell(wait=False)`` /
``wait_any`` / ``wait_all``) has its own suite in
``test_async_completion.py``.
"""

import numpy as np
import pytest

from repro_torch.core import memory, pyvm
from repro_torch.core import operators as ops
from repro_torch.core.endpoint import Completion, EndpointError, TiaraEndpoint
from repro_torch.core.program import OperatorBuilder
from repro_torch.core.registry import RegistrationError
from repro_torch.core.verifier import VerificationError


# ---------------------------------------------------------------------------
# Tenant workload: a tiny region layout with a compute op and two
# contended atomics on a shared latch — every failure mode in one layout.
# ---------------------------------------------------------------------------

def _layout():
    return memory.packed_table([("latch", 8), ("data", 64), ("reply", 64)])


def _sum_op(rt):
    """reply[p1] = data[p0] + data[p0+1]; returns the sum."""
    b = OperatorBuilder("sum2", n_params=2, regions=rt)
    x, y = b.reg(), b.reg()
    b.load(x, "data", b.param(0))
    b.load(y, "data", b.param(0), disp=1)
    b.add(x, x, y)
    b.store(x, "reply", b.param(1))
    b.ret(x)
    return b.build()


def _cas_op(rt):
    """CAS latch[0]: 0 -> p0; returns the old value (contended)."""
    b = OperatorBuilder("cas_latch", n_params=1, regions=rt)
    zero = b.const(0)
    old = b.reg()
    b.cas(old, "latch", zero, cmp=zero, swap=b.param(0))
    b.ret(old)
    return b.build()


def _store_op(rt):
    """Blind store: latch[1] = p0.

    Single-touch on the contended word, like the CAS op: the engines'
    round-robin lockstep semantics coincide with the sequential
    per-request oracle exactly when each request touches contended state
    once (a store-then-read-back op would observe same-macro-step
    neighbours — the documented engine interleaving, asserted in
    test_batched_vm.test_mixed_contended_store_cas_deterministic)."""
    b = OperatorBuilder("store_latch", n_params=1, regions=rt)
    one = b.const(1)
    b.store(b.param(0), "latch", one)
    b.ret(b.param(0))
    return b.build()


def _pool(ep):
    """The endpoint's pool as numpy (the port keeps it as a tensor)."""
    return ep.mem.cpu().numpy().copy()


def _connect(n_tenants=3, **kwargs):
    kwargs.setdefault("device", "cpu")
    named = [(f"t{i}", _layout()) for i in range(n_tenants)]
    ep, sessions = TiaraEndpoint.for_tenants(named, **kwargs)
    for s in sessions.values():
        for build in (_sum_op, _cas_op, _store_op):
            s.register(build(s.view))
        s.write_region("data", np.arange(10, 74, dtype=np.int64))
    return ep, [sessions[f"t{i}"] for i in range(n_tenants)]


def _oracle_replay(ep, completions):
    """Replay posts one at a time on pyvm in global arrival order."""
    vops = ep.registry.store_ops()
    seq = _pool(ep)
    expect = {}
    for c in sorted(completions, key=lambda c: c.seq):
        r = pyvm.run(vops[c.op_id], ep.regions, seq, list(c.params),
                     home=c.home)
        expect[c.seq] = (r.ret, r.status, r.steps)
    return seq, expect


def oracle_then_doorbell(ep, completions, **doorbell_kwargs):
    seq, expect = _oracle_replay(ep, completions)
    ep.doorbell(**doorbell_kwargs)
    assert np.array_equal(_pool(ep), seq)
    for c in completions:
        assert c.done
        assert (c.ret, c.status, c.steps) == expect[c.seq], c
    return seq


# ---------------------------------------------------------------------------
# Basics
# ---------------------------------------------------------------------------

def test_post_is_lazy_and_doorbell_retires():
    ep, (s0, s1, s2) = _connect()
    c = s0.post("sum2", [4, 0])
    assert not c.done and s0.outstanding == 1 and ep.outstanding == 1
    assert s0.poll_cq() == []
    n = ep.doorbell()
    assert n == 1 and c.done and ep.outstanding == 0
    assert c.ret == (10 + 4) + (10 + 5)
    assert c.ok
    assert s0.poll_cq() == [c] and s0.poll_cq() == []


def test_result_rings_doorbell_on_demand():
    ep, (s0, *_) = _connect()
    c = s0.post("sum2", [0, 0])
    assert c.result() == 21
    assert c.done
    # result() is a consuming read: the CQE is gone from the queue
    assert s0.poll_cq() == []
    c2 = s0.post("sum2", [2, 1])
    with pytest.raises(EndpointError):
        c2.result(flush=False)
    assert c2.result() == 25


def test_result_raises_on_failed_status():
    """result() is CQE-error-like: non-OK status raises unless the
    caller opts out (expected failures, e.g. a busy lock)."""
    ep, (s0, *_) = _connect()
    # cas_latch twice in one wave: the second post loses (status OK but
    # ret != 0) — so build an op that *fails*: sum2 can't fail, use the
    # verifier-backed status path via a raw failing program instead
    from repro_torch.core import isa
    b = OperatorBuilder("failer", n_params=0, regions=s0.view)
    b.ret(b.const(7), status=isa.STATUS_FAIL)
    s0.register(b.build())
    c = s0.post("failer")
    with pytest.raises(EndpointError):
        c.result()
    assert c.result(check=False) == 7
    assert c.status == isa.STATUS_FAIL and not c.ok


def test_failed_watermark_doorbell_cancels_triggering_post(monkeypatch):
    """If the watermark auto-ring blows up, post() must not leave the
    triggering request queued (the caller holds no handle and would
    re-post -> double execution); earlier posts stay queued."""
    ep, sessions = _connect(flush_watermark=3)
    c1 = sessions[0].post("sum2", [0, 0])
    c2 = sessions[1].post("sum2", [1, 1])

    def boom(*a, **k):
        raise RuntimeError("transient engine failure")

    monkeypatch.setattr(ep.registry, "_invoke_mixed", boom)
    with pytest.raises(RuntimeError):
        sessions[2].post("sum2", [2, 2])     # crosses the watermark
    monkeypatch.undo()
    assert ep.outstanding == 2               # trigger post cancelled
    assert ep.doorbell() == 2
    assert c1.done and c2.done and c1.ret == 21


def test_multi_session_wave_matches_pyvm_oracle():
    ep, sessions = _connect()
    cs = []
    for i in range(12):
        s = sessions[i % 3]
        cs.append(s.post("sum2", [2 * (i % 5), i]))
    oracle_then_doorbell(ep, cs)


def test_contended_cas_and_store_in_one_wave():
    """Contended atomics across posts keep the deterministic
    lowest-arrival-index-wins semantics — the wave IS arrival order."""
    ep, sessions = _connect()
    cs = []
    for i in range(9):
        s = sessions[i % 3]   # all three tenants race on their own latch
        if i % 2 == 0:
            cs.append(s.post("cas_latch", [100 + i]))
        else:
            cs.append(s.post("store_latch", [200 + i]))
    oracle_then_doorbell(ep, cs)
    # each tenant's latch holds its first-arriving CAS token
    for t, s in enumerate(sessions):
        winner = next(c for c in cs if c.session is s
                      and c.op_name == "cas_latch")
        assert s.read_region("latch", count=1)[0] == winner.params[0]
        assert winner.ret == 0   # saw the initial latch


def test_per_session_fifo_across_multiple_doorbells():
    ep, sessions = _connect()
    posted = {s.tenant: [] for s in sessions}
    rng = np.random.default_rng(0)
    for round_ in range(3):
        for i in range(8):
            s = sessions[int(rng.integers(0, 3))]
            c = s.post("sum2", [int(rng.integers(0, 30)), i])
            posted[s.tenant].append(c)
        ep.doorbell()
    for s in sessions:
        got = s.poll_cq()
        assert got == posted[s.tenant]
        assert [c.seq for c in got] == sorted(c.seq for c in got)


def test_poll_cq_limit():
    ep, (s0, *_) = _connect()
    cs = [s0.post("sum2", [i, i]) for i in range(5)]
    ep.doorbell()
    assert s0.poll_cq(2) == cs[:2]
    assert s0.poll_cq(None) == cs[2:]


def test_flush_watermark_auto_doorbell():
    """Crossing the watermark rings split-phase: the wave launches
    (posts leave the SQs) but retirement is deferred to a poll/wait —
    post() never blocks on device completion."""
    ep, sessions = _connect(flush_watermark=4)
    cs = [sessions[i % 3].post("sum2", [i, i]) for i in range(4)]
    assert ep.outstanding == 0               # SQs drained by the ring
    assert ep.in_flight == 4                 # ... but nothing retired yet
    assert all(c.in_flight and not c.done for c in cs)
    assert ep.wait_all() == 4
    assert all(c.done and c.ok for c in cs)


def test_flush_watermark_pipelines_posts():
    """Posts keep flowing while a watermark-triggered wave is still in
    flight: the next posts queue behind it (and launch a second
    overlapping wave at the next watermark) instead of blocking on the
    first wave's completion."""
    ep, sessions = _connect(flush_watermark=3)
    first = [sessions[i].post("sum2", [i, i]) for i in range(3)]
    assert ep.in_flight_waves == 1 and all(c.in_flight for c in first)
    # posting into the shadow of the in-flight wave neither blocks nor
    # retires it
    second = [sessions[i].post("sum2", [i + 1, i]) for i in range(3)]
    assert ep.in_flight_waves == 2
    assert all(c.in_flight for c in first + second)
    assert ep.wait_all() == 6
    for c in first + second:
        assert c.ok and c.ret == 2 * c.params[0] + 21   # data[i] = 10 + i
    # waves retired in launch order, per-session FIFO intact
    for i, s in enumerate(sessions):
        got = s.poll_cq()
        assert got == [first[i], second[i]]


def test_empty_doorbell_is_noop():
    ep, _ = _connect()
    before = _pool(ep)
    assert ep.doorbell() == 0
    assert np.array_equal(_pool(ep), before)


def test_doorbell_preserves_arrival_order_not_post_session_order():
    """Interleaved posts from two sessions hit a shared... they can't
    share regions — but arrival order is still what the oracle replays,
    and steps/ret must match per-request regardless of which session's
    post came first."""
    ep, (s0, s1, _) = _connect()
    cs = [s1.post("cas_latch", [7]), s0.post("cas_latch", [8]),
          s1.post("cas_latch", [9])]
    oracle_then_doorbell(ep, cs)
    assert cs[0].ret == 0 and cs[2].ret == 7     # s1: first CAS wins
    assert cs[1].ret == 0                        # s0's latch was free


# ---------------------------------------------------------------------------
# Doorbell modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["auto", "mixed", "segmented", "serial"])
def test_wave_modes_match_oracle(mode):
    ep, sessions = _connect()
    cs = [sessions[i % 3].post(("sum2", "store_latch")[i % 2], [i % 7]
                               if i % 2 else [i % 7, i])
          for i in range(8)]
    oracle_then_doorbell(ep, cs, mode=mode)


def test_single_op_modes_and_interp():
    ep, (s0, *_) = _connect()
    cs = [s0.post("sum2", [i, i]) for i in range(4)]
    oracle_then_doorbell(ep, cs, mode="batched")
    cs = [s0.post("sum2", [i + 1, i]) for i in range(4)]
    oracle_then_doorbell(ep, cs, mode="compiled")
    c = s0.post("sum2", [3, 3])
    oracle_then_doorbell(ep, [c], mode="interp")


def test_single_op_mode_rejects_mixed_wave_and_requeues():
    ep, (s0, s1, _) = _connect()
    c0 = s0.post("sum2", [0, 0])
    c1 = s1.post("cas_latch", [5])
    with pytest.raises(EndpointError):
        ep.doorbell(mode="batched")
    # a failed doorbell must not drop the send queues: the posts are
    # still outstanding and a valid ring retires them
    assert ep.outstanding == 2 and not c0.done
    assert ep.doorbell() == 2
    assert c0.done and c1.done and c0.ret == 21


def test_interp_mode_rejects_multi_request_wave():
    ep, (s0, *_) = _connect()
    s0.post("sum2", [0, 0])
    s0.post("sum2", [1, 1])
    with pytest.raises(EndpointError):
        ep.doorbell(mode="interp")


def test_unknown_mode_rejected():
    ep, (s0, *_) = _connect()
    s0.post("sum2", [0, 0])
    with pytest.raises(ValueError):
        ep.doorbell(mode="warp")


# ---------------------------------------------------------------------------
# Connect-time wiring, isolation, capacity
# ---------------------------------------------------------------------------

def test_connect_wires_view_and_grant():
    ep, (s0, *_) = _connect()
    assert s0.view.rid("latch") != ep.sessions["t1"].view.rid("latch")
    assert sorted(s0.view.names()) == ["t0/data", "t0/latch", "t0/reply"]
    # grant covers exactly the tenant's regions
    assert s0.grant.readable == {s0.view.rid(n)
                                 for n in ("latch", "data", "reply")}


def test_tenant_cannot_touch_foreign_regions():
    """An operator naming another tenant's region dies at register time
    (static verification against the session's grant)."""
    ep, (s0, s1, _) = _connect()
    b = OperatorBuilder("thief", n_params=1, regions=ep.regions)
    v = b.reg()
    b.load(v, "t1/data", b.param(0))     # t0 program reads t1's region
    b.ret(v)
    with pytest.raises(VerificationError):
        s0.register(b.build())


def test_connect_validation():
    ep, _ = _connect()
    with pytest.raises(EndpointError):
        ep.connect("t0", _layout())          # duplicate tenant
    with pytest.raises(EndpointError):
        ep.connect("a/b", _layout())         # separator in name
    small = TiaraEndpoint(16, device="cpu")
    with pytest.raises(EndpointError):
        small.connect("big", _layout())      # pool exhausted


def test_connect_is_all_or_nothing():
    """A rejected layout must leave the shared table untouched — no
    leaked regions (RegionTable has no unregister), and the tenant can
    be admitted later with a layout that fits."""
    # fits latch(8)+data(64) but not reply
    small = TiaraEndpoint(128, device="cpu")
    n_before = len(small.regions)
    with pytest.raises(EndpointError):
        small.connect("t", _layout())
    assert len(small.regions) == n_before    # nothing leaked
    s = small.connect("t", memory.packed_table([("latch", 8),
                                                ("data", 64)]))
    assert sorted(s.view.names()) == ["t/data", "t/latch"]


def test_duplicate_program_name_rejected():
    ep, (s0, *_) = _connect()
    with pytest.raises(RegistrationError):
        s0.register(_sum_op(s0.view))


def test_post_by_op_id_and_unknown_name():
    ep, (s0, *_) = _connect()
    c = s0.post(s0.op_id("sum2"), [0, 0])
    assert c.op_name == "sum2"
    with pytest.raises(KeyError):
        s0.post("nope", [])


def test_post_rejects_foreign_op_id():
    """A queue pair may only post operators registered through it —
    another tenant's op_id is refused at post time (and in trace)."""
    ep, (s0, s1, _) = _connect()
    foreign = s1.op_id("store_latch")
    with pytest.raises(EndpointError):
        s0.post(foreign, [666])
    with pytest.raises(EndpointError):
        s0.trace(foreign, [666])
    assert ep.outstanding == 0


def test_multi_device_homes():
    w = ops.GraphWalk(n_nodes=64, max_depth=8)
    ep, sessions = TiaraEndpoint.for_tenants([("gw", w.regions())],
                                             n_devices=3, device="cpu")
    s = sessions["gw"]
    s.register(w.build(s.view))
    orders = [w.populate(s.pool, s.view, device=d, seed=d)
              for d in range(3)]
    cs = [s.post("graph_walk", [int(orders[d][0]) * 8, 5], home=d)
          for d in range(3)]
    oracle_then_doorbell(ep, cs)
    for d, c in enumerate(cs):
        assert c.ret == w.reference(orders[d], int(orders[d][0]), 5)


# ---------------------------------------------------------------------------
# Deprecated shims: removed after their one-release window (PR 5)
# ---------------------------------------------------------------------------

def test_registry_invoke_shims_removed():
    """The PR-3 deprecation window is closed: the un-prefixed registry
    entry points no longer exist, so stale callers fail loudly instead
    of silently bypassing the endpoint surface."""
    ep, (s0, *_) = _connect()
    reg = ep.registry
    for name in ("invoke", "invoke_batched", "invoke_mixed"):
        assert not hasattr(reg, name)
    # the internal engines are still there for the endpoint to drive
    # the port's engines run where the pool lies: hand them the pool
    # tensor (a numpy pool would be uploaded to the card)
    r = reg._invoke(s0.op_id("sum2"), ep.mem, [0, 0])
    assert r.ret == 21


# ---------------------------------------------------------------------------
# Property: any interleaving across >= 3 sessions — per-session FIFO,
# bit-identical to the per-request pyvm oracle (contended atomics
# included).  Deterministic seeded sweep first; hypothesis (if
# installed) explores adversarial interleavings.
# ---------------------------------------------------------------------------

_OPS = ("sum2", "cas_latch", "store_latch")


def _run_interleaving(choices, doorbells):
    """choices: per-post (session_idx in [0,3), op_idx in [0,3), arg);
    doorbells: set of post indices after which to ring mid-sequence."""
    ep, sessions = _connect()
    live, posted = [], {s.tenant: [] for s in sessions}
    all_cs = []
    for i, (si, oi, arg) in enumerate(choices):
        s = sessions[si]
        name = _OPS[oi]
        params = [arg % 32, i % 64] if name == "sum2" else [arg]
        c = s.post(name, params)
        live.append(c)
        posted[s.tenant].append(c)
        all_cs.append(c)
        if i in doorbells:
            seq, expect = _oracle_replay(ep, live)
            ep.doorbell()
            assert np.array_equal(_pool(ep), seq)
            for cc in live:
                assert (cc.ret, cc.status, cc.steps) == expect[cc.seq]
            live = []
    if live:
        seq, expect = _oracle_replay(ep, live)
        ep.doorbell()
        assert np.array_equal(_pool(ep), seq)
        for cc in live:
            assert (cc.ret, cc.status, cc.steps) == expect[cc.seq]
    for s in sessions:
        assert s.poll_cq() == posted[s.tenant]   # per-session FIFO


@pytest.mark.parametrize("seed", range(4))
def test_random_interleavings_seeded(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 20))
    choices = [(int(rng.integers(0, 3)), int(rng.integers(0, 3)),
                int(rng.integers(0, 1000))) for _ in range(n)]
    doorbells = set(int(i) for i in
                    rng.choice(n, size=int(rng.integers(0, 3)),
                               replace=False))
    _run_interleaving(choices, doorbells)


def test_interleaving_property_hypothesis():
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    post = st.tuples(st.integers(0, 2), st.integers(0, 2),
                     st.integers(0, 2**63 - 1))

    # engine compiles are cached across examples (same layouts, same
    # programs), so cost scales with the number of distinct wave sizes
    @settings(max_examples=20, deadline=None)
    @given(choices=st.lists(post, min_size=1, max_size=12),
           data=st.data())
    def prop(choices, data):
        n = len(choices)
        doorbells = set(data.draw(st.lists(st.integers(0, n - 1),
                                           max_size=3)))
        _run_interleaving(choices, doorbells)

    prop()


def test_completion_repr_hides_session():
    ep, (s0, *_) = _connect()
    c = s0.post("sum2", [0, 0])
    assert "Session" not in repr(c)
    assert isinstance(c, Completion)
    ep.doorbell()
