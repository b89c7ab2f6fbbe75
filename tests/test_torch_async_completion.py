"""The reference's split-phase scenarios (``tests/test_async_completion.py``)
replayed on the port, on the CPU (``device="cpu"`` passed to every
endpoint).  Split-phase completion surface: ``doorbell(wait=False)`` launches a
wave and returns an in-flight :class:`WaveHandle`; completions retire on
``poll_cq`` / ``wait_any`` / ``wait_all`` / ``Completion.wait`` — always
in wave order, so per-session FIFO survives any number of waves in
flight, and every retirement is bit-identical to replaying the posts one
at a time on the ``pyvm`` oracle.

The property test drives random interleavings of
post / doorbell(wait=False) / poll_cq / wait_any across 3 sessions
(seeded sweep always; hypothesis when installed), including contended
STORE/CAS posts pipelined behind an in-flight async-MEMCPY wave.
"""

import numpy as np
import pytest

from repro_torch.core import memory, pyvm
from repro_torch.core.endpoint import (CompletionEvent, TiaraEndpoint,
                                 WaveHandle)
from repro_torch.core.program import OperatorBuilder

# ---------------------------------------------------------------------------
# Tenant workload: compute + contended atomics + an async-MEMCPY gather
# (the paper's split-phase pair) in one layout.
# ---------------------------------------------------------------------------


def _layout():
    return memory.packed_table([("latch", 8), ("data", 64), ("reply", 64),
                                ("table", 16), ("pool", 256),
                                ("gout", 256)])


def _sum_op(rt):
    b = OperatorBuilder("sum2", n_params=2, regions=rt)
    x, y = b.reg(), b.reg()
    b.load(x, "data", b.param(0))
    b.load(y, "data", b.param(0), disp=1)
    b.add(x, x, y)
    b.store(x, "reply", b.param(1))
    b.ret(x)
    return b.build()


def _cas_op(rt):
    b = OperatorBuilder("cas_latch", n_params=1, regions=rt)
    zero = b.const(0)
    old = b.reg()
    b.cas(old, "latch", zero, cmp=zero, swap=b.param(0))
    b.ret(old)
    return b.build()


def _store_op(rt):
    b = OperatorBuilder("store_latch", n_params=1, regions=rt)
    one = b.const(1)
    b.store(b.param(0), "latch", one)
    b.ret(b.param(0))
    return b.build()


def _gather_op(rt):
    """Async-MEMCPY gather chain (ids -> table -> pool rows -> gout):
    params r0 = n rows, r1 = gout slot offset.  The copies issue async
    and a WAIT(0) joins them — the trace the deferred-completion cycle
    model overlaps, and in-wave the op that keeps the engine busy while
    later waves post behind it."""
    b = OperatorBuilder("agather", n_params=2, regions=rt)
    n = b.param(0)
    i = b.const(0)
    idv, paddr = b.reg(), b.reg()
    dst = b.mov(b.reg(), b.param(1))
    with b.loop((n, 8)):
        b.load(idv, "data", i)
        b.load(paddr, "table", idv)
        b.memcpy(dst_region="gout", dst_off=dst,
                 src_region="pool", src_off=paddr,
                 n_words=8, is_async=True)
        b.add(dst, dst, 8)
        b.add(i, i, 1)
    b.wait(0)
    b.ret(n)
    return b.build()


_OPS = ("sum2", "cas_latch", "store_latch", "agather")


def _connect(n_tenants=3, **kwargs):
    kwargs.setdefault("device", "cpu")
    named = [(f"t{i}", _layout()) for i in range(n_tenants)]
    ep, sessions = TiaraEndpoint.for_tenants(named, **kwargs)
    for s in sessions.values():
        for build in (_sum_op, _cas_op, _store_op, _gather_op):
            s.register(build(s.view))
        s.write_region("data", np.arange(10, 74, dtype=np.int64) % 16)
        s.write_region("table", (np.arange(16, dtype=np.int64) * 16) % 256)
        s.write_region("pool", np.arange(1000, 1256, dtype=np.int64))
    return ep, [sessions[f"t{i}"] for i in range(n_tenants)]


def _post(session, i, oi, arg):
    name = _OPS[oi % len(_OPS)]
    if name == "sum2":
        params = [arg % 32, i % 64]
    elif name == "agather":
        params = [1 + arg % 4, (i % 4) * 64]   # disjoint 64-word slots
    else:
        params = [arg]
    return session.post(name, params)


class _Oracle:
    """Replays posts one at a time on pyvm in global arrival order,
    incrementally — the sequential reference the split-phase retirement
    must match bit-for-bit."""

    def __init__(self, ep):
        self.ep = ep
        self.vops = ep.registry.store_ops()
        self.mem = np.array(ep._host_view())
        self.expect = {}
        self.next_seq = 0

    def absorb(self, completions):
        """Advance the reference over the given (seq-sorted) posts."""
        for c in sorted(completions, key=lambda c: c.seq):
            assert c.seq >= self.next_seq
            r = pyvm.run(self.vops[c.op_id], self.ep.regions, self.mem,
                         list(c.params), home=c.home)
            self.expect[c.seq] = (r.ret, r.status, r.steps)
            self.next_seq = c.seq + 1

    def check(self, completions):
        for c in completions:
            assert c.done and c.event is not None
            got = (c.ret, c.status, c.steps)
            assert got == self.expect[c.seq], (c.op_name, c.seq)
            assert (c.event.ret, c.event.status, c.event.steps) == got

    def check_mem(self):
        assert np.array_equal(np.asarray(self.ep._host_view()), self.mem)


# ---------------------------------------------------------------------------
# Basics
# ---------------------------------------------------------------------------


def test_doorbell_nowait_returns_before_retirement():
    """The acceptance bit: doorbell(wait=False) hands back an in-flight
    handle before any async MEMCPY (or anything else) retires a CQE."""
    ep, (s0, *_) = _connect()
    c = s0.post("agather", [4, 0])
    h = ep.doorbell(wait=False)
    assert isinstance(h, WaveHandle) and not h.done
    assert not c.done and c.in_flight and c.wave_handle is h
    assert ep.in_flight == 1 and ep.in_flight_waves == 1
    assert s0.outstanding == 0          # drained from the send queue
    got = h.wait()
    assert got == [c] and c.done and c.ret == 4
    assert ep.in_flight == 0 and h.done and h.ready


def test_wait_all_retires_every_wave_in_order():
    ep, sessions = _connect()
    oracle = _Oracle(ep)
    waves = []
    for w in range(3):
        cs = [_post(sessions[i % 3], i, i, w * 10 + i) for i in range(6)]
        oracle.absorb(cs)
        waves.append((cs, ep.doorbell(wait=False)))
    assert ep.in_flight_waves == 3
    n = ep.wait_all()
    assert n == 18 and ep.in_flight_waves == 0
    for cs, h in waves:
        oracle.check(cs)
        assert h.done
    oracle.check_mem()
    # wave ids in the events are strictly increasing across waves
    ids = [cs[0].event.wave for cs, _ in waves]
    assert ids == sorted(ids) and len(set(ids)) == 3


def test_wait_any_retires_oldest_wave_only():
    ep, (s0, s1, _) = _connect()
    oracle = _Oracle(ep)
    c1 = s0.post("sum2", [2, 0])
    oracle.absorb([c1])
    h1 = ep.doorbell(wait=False)
    c2 = s1.post("sum2", [4, 1])
    oracle.absorb([c2])
    ep.doorbell(wait=False)
    got = ep.wait_any()
    assert got == [c1] and h1.done
    assert not c2.done and ep.in_flight_waves == 1
    assert ep.wait_any() == [c2]
    assert ep.wait_any() == []
    oracle.check([c1, c2])
    oracle.check_mem()


def test_completion_wait_retires_through_earlier_waves():
    """Retiring a later wave first would break per-session FIFO; waiting
    on wave 2 must deliver wave 1's CQEs first."""
    ep, (s0, *_) = _connect()
    c1 = s0.post("sum2", [0, 0])
    ep.doorbell(wait=False)
    c2 = s0.post("sum2", [2, 1])
    ep.doorbell(wait=False)
    assert c2.wait() is c2
    assert c1.done                       # FIFO: wave 1 retired first
    assert s0.poll_cq() == [c1, c2]


def test_result_on_in_flight_post_needs_no_flush():
    ep, (s0, *_) = _connect()
    c = s0.post("sum2", [0, 0])
    ep.doorbell(wait=False)
    # no doorbell ring needed: the post is launched, flush=False is fine
    assert c.result(flush=False) == (10 % 16) + (11 % 16)


def test_poll_cq_retires_ready_waves_nonblocking():
    ep, (s0, *_) = _connect()
    c = s0.post("sum2", [0, 0])
    ep.doorbell(wait=False)
    # the launch is tiny: spin until it lands, then poll_cq must
    # deliver without any explicit wait call
    deadline = 200
    got = []
    while not got and deadline:
        got = s0.poll_cq()
        deadline -= 1
    if not got:                      # ready() never flipped: force once
        ep.wait_all()
        got = s0.poll_cq()
    assert got == [c] and c.done


def test_pipelined_waves_chain_the_pool_dependency():
    """Wave 2 posts against wave 1's in-flight output: a sum2 reading
    the reply slot a wave-1 sum2 wrote must observe it."""
    ep, (s0, *_) = _connect()
    # wave 1: reply[0] = data[4] + data[5]
    c1 = s0.post("sum2", [4, 0])
    ep.doorbell(wait=False)
    # wave 2 (posted while wave 1 is in flight): sum over data[8:10]
    c2 = s0.post("sum2", [8, 1])
    ep.doorbell(wait=False)
    assert ep.wait_all() == 2
    assert c1.ret == (14 % 16) + (15 % 16)
    assert c2.ret == (18 % 16) + (19 % 16)
    r = s0.read_region("reply", count=2)
    assert r.tolist() == [c1.ret, c2.ret]


def test_empty_nowait_doorbell_returns_done_handle():
    ep, _ = _connect()
    h = ep.doorbell(wait=False)
    assert isinstance(h, WaveHandle) and h.done and len(h) == 0
    assert h.wait() == []


def test_blocking_doorbell_retires_pending_waves_too():
    """A wait=True doorbell behind in-flight waves retires them first
    (wave order), so its own completions join a consistent CQ tail."""
    ep, (s0, *_) = _connect()
    c1 = s0.post("sum2", [0, 0])
    ep.doorbell(wait=False)
    c2 = s0.post("sum2", [2, 1])
    n = ep.doorbell()                # blocking
    assert n == 1 and c1.done and c2.done
    assert s0.poll_cq() == [c1, c2]


def test_completion_event_carries_retire_timestamp():
    ep, (s0, *_) = _connect()
    c = s0.post("sum2", [0, 0])
    h = ep.doorbell(wait=False)
    assert c.event is None
    h.wait()
    assert isinstance(c.event, CompletionEvent)
    assert c.event.ok and c.event.retired_at > 0
    assert c.event.wave == h.wave_id and c.event.seq == c.seq


def test_host_reads_block_on_in_flight_waves():
    """Control-path reads must observe every launched wave — reading a
    region while a wave is in flight blocks until it lands (but does
    not retire its CQEs)."""
    ep, (s0, *_) = _connect()
    c = s0.post("sum2", [4, 3])
    ep.doorbell(wait=False)
    r = s0.read_region("reply", offset=3, count=1)
    assert r[0] == (14 % 16) + (15 % 16)
    assert not c.done                     # reads don't retire CQEs
    assert ep.wait_all() == 1


def test_contended_atomics_behind_in_flight_async_memcpy_wave():
    """The acceptance interleaving: a wave of async-MEMCPY gathers goes
    in flight, then a wave of contended STORE/CAS posts on the same
    latch pipelines behind it — retirement is bit-identical to the
    sequential oracle and the first-arriving CAS wins."""
    ep, sessions = _connect()
    oracle = _Oracle(ep)
    g = [sessions[i].post("agather", [3 + i, 0]) for i in range(3)]
    oracle.absorb(g)
    ep.doorbell(wait=False)
    cs = []
    for i in range(9):
        s = sessions[i % 3]
        cs.append(s.post("cas_latch", [100 + i]) if i % 2 == 0
                  else s.post("store_latch", [200 + i]))
    oracle.absorb(cs)
    ep.doorbell(wait=False)
    assert ep.in_flight_waves == 2
    assert ep.wait_all() == 12
    oracle.check(g + cs)
    oracle.check_mem()
    for t, s in enumerate(sessions):
        winner = next(c for c in cs if c.session is s
                      and c.op_name == "cas_latch")
        assert s.read_region("latch", count=1)[0] == winner.params[0]
        assert winner.ret == 0


# ---------------------------------------------------------------------------
# Property: any interleaving of post / doorbell(wait=False) / poll_cq /
# wait_any across 3 sessions retires bit-identically to the pyvm oracle
# and preserves per-session FIFO.
# ---------------------------------------------------------------------------


def _run_async_interleaving(posts, rings, polls, waits):
    """posts: per-post (session_idx, op_idx, arg); rings/polls/waits:
    post indices after which to ring doorbell(wait=False) / poll_cq /
    wait_any.  Ends with wait_all + full CQ drain."""
    ep, sessions = _connect()
    oracle = _Oracle(ep)
    polled = {s.tenant: [] for s in sessions}
    posted = {s.tenant: [] for s in sessions}
    pending = []
    all_cs = []

    def drain_cqs():
        for s in sessions:
            polled[s.tenant].extend(s.poll_cq())

    for i, (si, oi, arg) in enumerate(posts):
        s = sessions[si % 3]
        c = _post(s, i, oi, arg)
        pending.append(c)
        posted[s.tenant].append(c)
        all_cs.append(c)
        if i in rings and pending:
            oracle.absorb(pending)
            ep.doorbell(wait=False)
            pending = []
        if i in polls:
            drain_cqs()
        if i in waits:
            for c2 in ep.wait_any():
                assert c2.done
    if pending:
        oracle.absorb(pending)
        ep.doorbell(wait=False)
    ep.wait_all()
    drain_cqs()
    oracle.check(all_cs)
    oracle.check_mem()
    for s in sessions:
        assert polled[s.tenant] == posted[s.tenant]   # per-session FIFO


@pytest.mark.parametrize("seed", range(6))
def test_async_interleavings_seeded(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 18))
    posts = [(int(rng.integers(0, 3)), int(rng.integers(0, 4)),
              int(rng.integers(0, 1000))) for _ in range(n)]

    def some(k):
        return set(int(x) for x in
                   rng.choice(n, size=int(rng.integers(0, k)),
                              replace=False))

    _run_async_interleaving(posts, some(4), some(3), some(3))


def test_async_interleaving_property_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    post = st.tuples(st.integers(0, 2), st.integers(0, 3),
                     st.integers(0, 2**63 - 1))

    @settings(max_examples=15, deadline=None)
    @given(posts=st.lists(post, min_size=1, max_size=10), data=st.data())
    def prop(posts, data):
        n = len(posts)
        idx = st.lists(st.integers(0, n - 1), max_size=3)
        _run_async_interleaving(posts, set(data.draw(idx)),
                                set(data.draw(idx)),
                                set(data.draw(idx)))

    prop()
