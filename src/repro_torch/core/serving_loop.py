"""Overload-safe continuous serving loop over a :class:`TiaraEndpoint`.

The endpoint is a wave-at-a-time executor: callers ring ``doorbell()``
by hand and any number of waves pile up in flight.  A serving fabric
cannot fail open like that — under overload every resource must stay
bounded and every degradation must be deterministic.  This module is
that discipline, in the shape the serving literature converged on
(RedN's chained asynchronously-retired work requests for throughput,
EDM's bounded fabric queueing for tail latency — see PAPERS.md):

  * **Bounded in-flight waves.**  Wave formation never launches past
    ``max_inflight_waves``; at the bound it blocks in
    :meth:`TiaraEndpoint.wait_any` for the oldest wave (the
    watermark carry-over), so split-phase pipelining is capped, not
    unbounded.
  * **Continuous batcher.**  :meth:`ServingLoop.pump` forms waves like
    a serving engine's continuous batcher: ring when the batch hits
    ``ring_size``, when the oldest admitted post ages past
    ``ring_age_s``, or when the cost model's
    :meth:`~repro_torch.core.costmodel.DispatchCostModel.launch_efficiency`
    says the launch already amortizes well enough
    (``min_efficiency``) — the estimate adapts online through the
    endpoint's per-slot EWMA wall-clock feed.
  * **Admission control & backpressure.**  Each tenant has a token
    bucket (``TenantQoS.rate``/``burst``) and a bounded admitted queue
    (``max_pending``); :meth:`ServingLoop.submit` either blocks with a
    timeout (pumping the loop while it waits) or rejects immediately
    with a ``STATUS_EAGAIN`` CQE.  Rejected work never executes but
    always retires exactly one completion.
  * **Weighted fair queueing.**  Admitted posts carry virtual finish
    tags (``F = max(V, F_tenant) + 1/weight``); wave formation selects
    the globally smallest tags, which is automatically a per-tenant
    FIFO prefix — per-session FIFO survives fair scheduling.
  * **Deadlines.**  A per-post ``deadline_s`` is enforced at admission,
    at every pump, and again when the doorbell drains the queues; an
    expired post retires ``STATUS_TIMEOUT`` and never executes.
  * **Load shedding.**  Expired work is always dropped first (the
    deadline sweep precedes shedding); past ``shed_watermark`` total
    backlog the loop drops the lowest-weight tenants' newest work with
    ``STATUS_EAGAIN`` until the backlog fits — sustained overload
    degrades the cheapest work deterministically instead of growing
    queues without bound.

Determinism: every decision reads the endpoint's injectable clock, so
a :class:`VirtualClock` makes an entire overload run — arrivals,
deadlines, sheds, fairness — exactly reproducible from a seed while
the waves still execute for real (`tests/test_serving_loop.py` holds
bit-parity with the pyvm oracle under chaos).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core import isa
from repro_torch.core.endpoint import Completion, Session, TiaraEndpoint


class VirtualClock:
    """A deterministic clock + sleep pair for the endpoint's
    ``clock``/``sleep`` hooks: ``sleep`` *advances* the clock instead of
    blocking, so overload scenarios (backoff, injected delays, aging
    deadlines) run in microseconds of wall time and are exactly
    reproducible."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.now += max(float(seconds), 0.0)

    def advance(self, seconds: float) -> float:
        self.now += max(float(seconds), 0.0)
        return self.now

    def advance_to(self, t: float) -> float:
        self.now = max(self.now, float(t))
        return self.now


@dataclasses.dataclass(frozen=True)
class TenantQoS:
    """Per-tenant service contract.

    ``rate`` is the token-bucket refill in posts/second (None =
    unlimited), ``burst`` the bucket depth, ``weight`` the WFQ share —
    a weight-2 tenant gets twice the wave slots of a weight-1 tenant
    when both have backlog."""

    rate: Optional[float] = None
    burst: int = 32
    weight: float = 1.0

    def __post_init__(self):
        if self.rate is not None and self.rate <= 0:
            raise ValueError("rate must be positive (or None)")
        if self.burst < 1:
            raise ValueError("burst must be >= 1")
        if self.weight <= 0:
            raise ValueError("weight must be positive")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Serving-loop policy knobs (see module docstring)."""

    max_inflight_waves: int = 2     # split-phase pipelining bound
    max_pending: int = 64           # per-tenant admitted-queue bound
    ring_size: int = 32             # formation: ring at this batch
    ring_age_s: float = 0.005       # formation: ring at this head age
    min_efficiency: float = 0.5     # formation: ring at this cost-model
                                    # launch efficiency
    shed_watermark: Optional[int] = None   # total backlog triggering
                                           # load shedding (None = off)
    block_timeout_s: float = 0.0    # submit(block=True) budget
    block_poll_s: float = 0.0005    # sleep step while blocked
    default_deadline_s: Optional[float] = None
    admission_wcet: bool = True     # fail-fast posts whose operator's
                                    # certified WCET already exceeds the
                                    # remaining deadline (statically
                                    # infeasible: never queued, never
                                    # launched, still exactly one CQE)
    mode: str = "auto"              # doorbell engine mode
    placement: str = "single"       # doorbell placement
    opportunistic_poll: bool = True  # retire landed waves every pump
                                     # (False = only the in-flight
                                     # bound retires — deterministic
                                     # retirement points under a
                                     # virtual clock)

    def __post_init__(self):
        if self.max_inflight_waves < 1:
            raise ValueError("max_inflight_waves must be >= 1")
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if self.ring_size < 1:
            raise ValueError("ring_size must be >= 1")


@dataclasses.dataclass
class ServingStats:
    """Counters + latency reservoir; one CQE retires per submitted post
    across these buckets (``submitted == sum of terminal outcomes``
    once the loop drains)."""

    submitted: int = 0
    admitted: int = 0
    launched: int = 0
    executed: int = 0        # retired with a real engine result
    ok: int = 0
    faulted: int = 0
    flushed: int = 0
    timed_out: int = 0
    rejected: int = 0        # STATUS_EAGAIN at admission
    shed: int = 0            # STATUS_EAGAIN from load shedding
    per_tenant: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    latencies: List[Tuple[str, float]] = dataclasses.field(
        default_factory=list, repr=False)

    def bump(self, tenant: str, field: str, n: int = 1) -> None:
        setattr(self, field, getattr(self, field) + n)
        t = self.per_tenant.setdefault(tenant, {})
        t[field] = t.get(field, 0) + n

    def latency_percentile(self, q: float) -> float:
        """Submit-to-retire latency percentile over executed posts
        (seconds; 0.0 with no samples)."""
        if not self.latencies:
            return 0.0
        xs = sorted(lat for _, lat in self.latencies)
        i = min(int(q * len(xs)), len(xs) - 1)
        return xs[i]

    @property
    def p50_s(self) -> float:
        return self.latency_percentile(0.50)

    @property
    def p99_s(self) -> float:
        return self.latency_percentile(0.99)


@dataclasses.dataclass(frozen=True)
class PumpReport:
    """What one :meth:`ServingLoop.pump` turn did."""

    launched: int = 0        # posts launched in a new wave (0 = no ring)
    wave_id: int = -1
    predicted_us: float = 0.0   # cost-model estimate for the new wave
    retired: int = 0
    timed_out: int = 0
    shed: int = 0
    flushed: int = 0


class ServingLoop:
    """The continuous serving loop: admit -> queue fairly -> form waves
    -> launch split-phase -> retire, with every stage bounded.

    Typical use::

        loop = ServingLoop(ep, ServingConfig(max_inflight_waves=2),
                           qos={"a": TenantQoS(weight=2.0)})
        c = loop.submit("a", "walk", [start, 12], deadline_s=0.1)
        loop.pump()          # call from the serving thread's main turn
        ...
        loop.drain()         # flush everything at shutdown
    """

    def __init__(self, endpoint: TiaraEndpoint,
                 config: Optional[ServingConfig] = None,
                 qos: Optional[Dict[str, TenantQoS]] = None):
        self.ep = endpoint
        self.config = config or ServingConfig()
        self._qos: Dict[str, TenantQoS] = dict(qos or {})
        self._pending: Dict[str, Deque[Completion]] = {}
        self._tokens: Dict[str, float] = {}
        self._token_t: Dict[str, float] = {}
        self._tags: Dict[int, float] = {}       # seq -> WFQ finish tag
        self._submit_t: Dict[int, float] = {}   # seq -> admission time
        self._vtime = 0.0                       # WFQ virtual time
        self._vfinish: Dict[str, float] = {}    # tenant -> last tag
        self._launched: List[Completion] = []   # awaiting harvest
        self.stats = ServingStats()

    # -- QoS --------------------------------------------------------------

    def qos(self, tenant: str) -> TenantQoS:
        return self._qos.get(tenant, TenantQoS())

    def set_qos(self, tenant: str, qos: TenantQoS) -> None:
        self._qos[tenant] = qos

    # -- admission --------------------------------------------------------

    def _refill(self, tenant: str, now: float) -> None:
        q = self.qos(tenant)
        if q.rate is None:
            return
        last = self._token_t.get(tenant)
        if last is None:
            self._tokens[tenant] = float(q.burst)
        else:
            self._tokens[tenant] = min(
                float(q.burst),
                self._tokens.get(tenant, 0.0) + (now - last) * q.rate)
        self._token_t[tenant] = now

    def _admissible(self, tenant: str, now: float) -> bool:
        self._refill(tenant, now)
        q = self.qos(tenant)
        if q.rate is not None and self._tokens.get(tenant, 0.0) < 1.0:
            return False
        queue = self._pending.get(tenant)
        return queue is None or len(queue) < self.config.max_pending

    def submit(self, tenant: str, op: Union[str, int],
               params: Sequence[int] = (), *, home: int = 0,
               deadline_s: Optional[float] = None,
               contention: float = 0.0,
               block: bool = False) -> Completion:
        """Admit one invocation for ``tenant`` (exactly one CQE retires
        whatever happens).  Admission order: an errored session flushes
        (``STATUS_FLUSHED``); an already-expired deadline times out
        (``STATUS_TIMEOUT``); an empty token bucket or a full admitted
        queue rejects with ``STATUS_EAGAIN`` — or, with ``block=True``,
        pumps the loop for up to ``block_timeout_s`` first (the
        backpressure path: the caller is slowed to the rate the fabric
        sustains).  ``contention`` is the caller's conflict hint for
        this post's operator; the loop EWMAs it per slot
        (:meth:`~repro_torch.core.costmodel.DispatchCostModel
        .observe_conflicts`) and prices future waves with the learned
        rate."""
        ep = self.ep
        sess: Session = ep.session(tenant)
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        c = sess._make(op, params, home=home, deadline_s=deadline_s)
        self.stats.bump(tenant, "submitted")
        ep.cost_model.observe_conflicts(c.op_id, contention)
        if sess.in_error:
            ep._retire_immediate(c, isa.STATUS_FLUSHED)
            self.stats.bump(tenant, "flushed")
            return c
        now = ep._clock()
        if c.deadline is not None and c.deadline <= now:
            ep._retire_immediate(c, isa.STATUS_TIMEOUT)
            self.stats.bump(tenant, "timed_out")
            return c
        if self._wcet_infeasible(c, now):
            # statically infeasible deadline: the certificate already
            # proves the worst case overruns it — fail fast instead of
            # queueing work that could only expire after launch
            ep._retire_immediate(c, isa.STATUS_TIMEOUT)
            self.stats.bump(tenant, "timed_out")
            return c
        if not self._admissible(tenant, now):
            gave_up = True
            if block and self.config.block_timeout_s > 0.0:
                give_up_at = now + self.config.block_timeout_s
                while True:
                    self.pump()
                    ep._sleep(self.config.block_poll_s)
                    now = ep._clock()
                    if self._admissible(tenant, now):
                        gave_up = False
                        break
                    if now >= give_up_at:
                        break
                # the post may have expired (or its remaining window
                # shrunk below the certified WCET) while it waited
                if not gave_up and ((c.deadline is not None
                                     and c.deadline <= now)
                                    or self._wcet_infeasible(c, now)):
                    ep._retire_immediate(c, isa.STATUS_TIMEOUT)
                    self.stats.bump(tenant, "timed_out")
                    return c
            if gave_up:
                ep._retire_immediate(c, isa.STATUS_EAGAIN)
                self.stats.bump(tenant, "rejected")
                return c
        q = self.qos(tenant)
        if q.rate is not None:
            self._tokens[tenant] -= 1.0
        # WFQ finish tag: monotone within a tenant, so selecting the
        # globally smallest tags always takes per-tenant FIFO prefixes
        tag = max(self._vtime, self._vfinish.get(tenant, 0.0)) \
            + 1.0 / q.weight
        self._vfinish[tenant] = tag
        self._tags[c.seq] = tag
        self._submit_t[c.seq] = now
        self._pending.setdefault(tenant, deque()).append(c)
        self.stats.bump(tenant, "admitted")
        return c

    def _wcet_infeasible(self, c: Completion, now: float) -> bool:
        """True when the post's deadline is *statically* infeasible:
        the operator's certified worst-case latency
        (:class:`~repro_torch.core.wcet.LineRateCertificate`) already
        overruns the time remaining, so queueing or launching could
        only burn fabric work before the same ``STATUS_TIMEOUT``
        retires.  Admission retires it immediately instead."""
        if not self.config.admission_wcet or c.deadline is None:
            return False
        cert = self.ep.registry[c.op_id].certificate
        if cert is None:
            return False
        return now + cert.wcet_latency_us * 1e-6 > c.deadline

    # -- backlog maintenance ----------------------------------------------

    def _drop(self, tenant: str, c: Completion, status: int,
              field: str) -> None:
        tag_c = self._tags.pop(c.seq, None)
        self._submit_t.pop(c.seq, None)
        # WFQ never charges for unserved work: give the dropped post's
        # virtual slot back by shifting the tenant's later queued tags
        # (and its finish tag) down one service quantum.  Without the
        # refund, a tenant losing work to deadlines or sheds keeps
        # paying for service it never received — its head tag drifts
        # above everyone else's and it starves in a feedback loop
        # (expire -> fall behind -> expire).  The uniform shift keeps
        # per-tenant tags monotone, so wave formation still selects
        # FIFO prefixes.
        if tag_c is not None:
            quantum = 1.0 / self.qos(tenant).weight
            for d in self._pending.get(tenant, ()):
                if d.seq in self._tags and self._tags[d.seq] > tag_c:
                    self._tags[d.seq] -= quantum
            self._vfinish[tenant] = \
                self._vfinish.get(tenant, 0.0) - quantum
        self.ep._retire_immediate(c, status)
        self.stats.bump(tenant, field)

    def _flush_errored(self) -> int:
        n = 0
        for tenant, queue in self._pending.items():
            if queue and self.ep.session(tenant).in_error:
                while queue:
                    self._drop(tenant, queue.popleft(),
                               isa.STATUS_FLUSHED, "flushed")
                    n += 1
        return n

    def _expire(self, now: float) -> int:
        n = 0
        for tenant, queue in self._pending.items():
            live = deque()
            for c in queue:
                if c.deadline is not None and c.deadline <= now:
                    self._drop(tenant, c, isa.STATUS_TIMEOUT, "timed_out")
                    n += 1
                else:
                    live.append(c)
            self._pending[tenant] = live
        return n

    def _shed(self) -> int:
        """Past the watermark, drop the lowest-weight tenants' newest
        admitted work (LIFO within a tenant, so the survivors keep their
        FIFO prefix) until the backlog fits.  Ties on weight shed from
        the longest backlog first, so equal-weight tenants share the
        pain instead of the first-connected tenant absorbing every
        drop.  Runs after the deadline sweep, so expired work is always
        shed first."""
        wm = self.config.shed_watermark
        if wm is None:
            return 0
        backlog = sum(len(q) for q in self._pending.values())
        n = 0
        while backlog > wm:
            victim = min(
                (t for t, q in self._pending.items() if q),
                key=lambda t: (self.qos(t).weight,
                               -len(self._pending[t]), t))
            self._drop(victim, self._pending[victim].pop(),
                       isa.STATUS_EAGAIN, "shed")
            backlog -= 1
            n += 1
        return n

    def _harvest(self) -> int:
        """Collect stats for launched posts that have retired."""
        still: List[Completion] = []
        n = 0
        for c in self._launched:
            if not c.done:
                still.append(c)
                continue
            n += 1
            tenant = c.session.tenant
            t0 = self._submit_t.pop(c.seq, None)
            if c.status == isa.STATUS_TIMEOUT:
                # expired at the doorbell drain (never executed)
                self.stats.bump(tenant, "timed_out")
            elif c.status == isa.STATUS_FLUSHED:
                self.stats.bump(tenant, "flushed")
            else:
                self.stats.bump(tenant, "executed")
                if c.ok:
                    self.stats.bump(tenant, "ok")
                elif c.faulted:
                    self.stats.bump(tenant, "faulted")
                if t0 is not None and c.event is not None:
                    self.stats.latencies.append(
                        (tenant, c.event.retired_at - t0))
        self._launched = still
        return n

    def harvest(self) -> int:
        """Public harvest: collect stats/latencies for launched posts
        that have retired since the last pump.  For callers that drive
        retirement themselves (``ep.wait_all()`` between their own
        pumps) instead of going through :meth:`drain`."""
        return self._harvest()

    # -- wave formation ---------------------------------------------------

    def _selectable(self) -> List[Tuple[float, Completion]]:
        """(tag, post) for every pending post of a non-stalled tenant,
        smallest (= most entitled) tags first."""
        out: List[Tuple[float, Completion]] = []
        for tenant, queue in self._pending.items():
            if queue and self.ep.stalled(tenant):
                continue        # injected stall: age toward the deadline
            for c in queue:
                out.append((self._tags[c.seq], c))
        out.sort(key=lambda tc: (tc[0], tc[1].seq))
        return out

    def _should_ring(self, picked: List[Completion], now: float) -> bool:
        cfg = self.config
        if len(picked) >= cfg.ring_size:
            return True
        oldest = min(self._submit_t.get(c.seq, now) for c in picked)
        if now - oldest >= cfg.ring_age_s:
            return True
        key, steps, contention = self._wave_profile(picked)
        eff = self.ep.cost_model.launch_efficiency(
            batch=len(picked), step_bound=steps, key=key,
            contention_rate=contention)
        return eff >= cfg.min_efficiency

    def _wave_profile(self, picked: Sequence[Completion]
                      ) -> Tuple[Optional[int], int, float]:
        """(cost-model key, step bound, learned contention) for a
        candidate wave: the slot id for single-op waves (per-slot EWMA
        scales apply), the wave-global bucket otherwise; contention is
        the max of the selected slots' learned conflict rates — any
        contended slot pins the wave to the conflict-exact engine.

        A static no-conflict proof over the candidate's concrete params
        (``registry.prove_wave_noconflict``) overrides the learned rate
        with 0.0: the EWMA is a guess about past waves, the proof is a
        fact about this one — so a provably-disjoint wave forms and
        prices as conflict-free even on a slot with a contended
        history."""
        reg = self.ep.registry
        ids = sorted({c.op_id for c in picked})
        steps = max(reg[i].verified.step_bound for i in ids)
        contention = max(self.ep.cost_model.conflict_hint(i) for i in ids)
        if contention > 0.0 and reg.prove_wave_noconflict(
                [c.op_id for c in picked],
                [list(c.params) for c in picked],
                [c.home for c in picked]):
            contention = 0.0
        key = ids[0] if len(ids) == 1 else None
        return key, steps, contention

    def pump(self, force: bool = False) -> PumpReport:
        """One serving turn: retire what landed, flush/expire/shed the
        backlog, and launch one wave if the formation policy rings
        (``force=True`` rings on any non-empty backlog — the drain
        path).  Never launches past ``max_inflight_waves``: at the
        bound it first blocks for the oldest in-flight wave."""
        ep = self.ep
        cfg = self.config
        if cfg.opportunistic_poll:
            ep._retire_ready()
        flushed = self._flush_errored()
        now = ep._clock()
        timed_out = self._expire(now)
        shed = self._shed()
        retired = self._harvest()
        launched = 0
        wave_id = -1
        predicted_us = 0.0
        picked_all = self._selectable()
        if picked_all:
            tag_of = {c.seq: tag for tag, c in picked_all}
            picked = [c for _, c in picked_all[:cfg.ring_size]]
            ring = force or self._should_ring(picked, now)
            if ring and ep.in_flight_waves >= cfg.max_inflight_waves:
                ep.wait_any()           # the watermark-triggered bound
                retired += self._harvest()
                # the retired wave may have faulted a session whose
                # posts we just selected — flush them, never launch
                flushed += self._flush_errored()
                picked = [c for c in picked if not c.done]
            if ring and picked:
                key, steps, contention = self._wave_profile(picked)
                for c in picked:
                    queue = self._pending[c.session.tenant]
                    assert queue[0] is c, "WFQ must select FIFO prefixes"
                    queue.popleft()
                    self._tags.pop(c.seq, None)
                    ep._enqueue(c)
                self._vtime = max(self._vtime,
                                  max(tag_of[c.seq] for c in picked))
                # the wave's certified cost ceiling: no wave can cost
                # more than the sum of its members' certified worst
                # cases, so no EWMA prediction may price it above that
                certs = [ep.registry[c.op_id].certificate for c in picked]
                ceiling = (sum(x.wcet_latency_us for x in certs)
                           if all(x is not None for x in certs) else None)
                predicted_us = ep.cost_model.wave_us(
                    batch=len(picked), step_bound=steps, key=key,
                    mode="mixed", contention_rate=contention,
                    cert_ceiling_us=ceiling)
                if cfg.placement != "single" and ep.n_devices > 1:
                    # non-single placements: price the wave through the
                    # placement model (the learned home-skew EWMA sets
                    # batch_per_device when no plan is supplied), not
                    # the one-chip mixed engine
                    decision = ep.cost_model.choose_placement(
                        batch=len(picked), n_devices=ep.n_devices,
                        step_bound=steps, contention_rate=contention)
                    if cfg.placement == "sharded":
                        predicted_us = decision.costs.get(
                            "sharded", predicted_us)
                    else:                       # "auto": the pick's cost
                        predicted_us = decision.costs[decision.mode]
                    if ceiling is not None:
                        predicted_us = min(predicted_us, ceiling)
                handle = ep.doorbell(mode=cfg.mode,
                                     placement=cfg.placement,
                                     contention_rate=contention,
                                     wait=False)
                wave_id = handle.wave_id
                launched = len(picked)
                for c in picked:
                    self.stats.bump(c.session.tenant, "launched")
                self._launched.extend(picked)
        return PumpReport(launched=launched, wave_id=wave_id,
                          predicted_us=predicted_us, retired=retired,
                          timed_out=timed_out, shed=shed, flushed=flushed)

    # -- shutdown ---------------------------------------------------------

    @property
    def backlog(self) -> int:
        """Admitted posts not yet launched."""
        return sum(len(q) for q in self._pending.values())

    def drain(self, *, max_pumps: int = 10_000) -> ServingStats:
        """Launch everything admitted (stalled tenants wait for their
        stalls through the sleep hook), retire every in-flight wave,
        and harvest; returns the final stats."""
        pumps = 0
        while self.backlog > 0:
            report = self.pump(force=True)
            if report.launched == 0 and self.backlog > 0:
                # backlog but nothing selectable: stalled tenants —
                # sleep to the earliest stall expiry and retry
                now = self.ep._clock()
                stalls = [u for u in self.ep._stalls.values() if u > now]
                self.ep._sleep((min(stalls) - now) if stalls
                               else self.config.block_poll_s)
            pumps += 1
            if pumps > max_pumps:
                raise RuntimeError(
                    f"drain did not converge in {max_pumps} pumps "
                    f"(backlog {self.backlog})")
        self.ep.wait_all()
        self._harvest()
        return self.stats
