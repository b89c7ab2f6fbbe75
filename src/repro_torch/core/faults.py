"""Fault-injection harness — chaos plans for the endpoint and simulator.

Real RNIC stacks are validated by injecting faults at every layer —
cable pulls, CQE errors, doorbell losses — and checking that the
*semantics* (QP error states, flushed WQEs, containment) hold.  This
module is that harness for the software Tiara stack: a
:class:`FaultPlan` is a declarative, composable bundle of injections
that :meth:`~repro_torch.core.endpoint.TiaraEndpoint.inject` applies to the
live endpoint:

  * ``fail_devices``    mark pool devices failed.  Word ops targeting a
                        failed device take a runtime protection fault
                        (``STATUS_PROT_FAULT``); a Memcpy touching one
                        sets the error register and drops the copy — the
                        paper's §3.2 degraded mode.
  * ``corrupt``         overwrite pool words *before the next wave*
                        (device, word, value) — stale block-table
                        entries, torn pointers: the wild-address seeds
                        the runtime protection checks exist to catch.
  * ``transient_launch_failures``
                        the next N doorbell launches raise
                        :class:`TransientError` before dispatch — a
                        lost doorbell / launch-queue hiccup.  The
                        endpoint's bounded retry-with-backoff absorbs up
                        to its ``retry_limit``.
  * ``poison_materialize``
                        the next N deferred-wave materializations raise
                        :class:`InjectedEngineError` — a split-phase
                        launch that dies *after* issue.  Retirement must
                        leave the wave queued so a later wait retries it
                        (no lost CQEs, no double delivery).
  * ``delay_waves``     charge the next N doorbell launches the given
                        extra seconds (through the endpoint's injectable
                        ``sleep`` hook, so virtual clocks make it free) —
                        a slow NIC / congested launch queue.  Overload
                        tests use it to age queued work past deadlines.
  * ``stall_tenants``   withhold the named tenants' posts from doorbell
                        drains for the given duration (endpoint clock) —
                        a stalled QP / paused scheduler.  Their posts sit
                        in the SQ aging; the serving loop's deadlines and
                        load shedding must degrade them deterministically
                        instead of wedging the wave pipeline.

Plans compose with ``+`` so a chaos test can pile independent failures
into one injection.  The plan itself is immutable; the endpoint copies
its counters/lists at injection time.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Iterable, Tuple


class TransientError(Exception):
    """A launch-time failure that a retry may cure (lost doorbell)."""


class InjectedEngineError(Exception):
    """A deferred engine failure injected at materialization time."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One composable bundle of fault injections (see module docstring).

    ``corrupt`` entries are ``(device, word_index, value)`` triples
    applied to the raw pool (absolute word index, not region-relative)
    immediately before the next wave dispatches.
    """

    fail_devices: FrozenSet[int] = frozenset()
    corrupt: Tuple[Tuple[int, int, int], ...] = ()
    transient_launch_failures: int = 0
    poison_materialize: int = 0
    delay_waves: Tuple[float, ...] = ()
    stall_tenants: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "fail_devices",
                           frozenset(int(d) for d in self.fail_devices))
        object.__setattr__(
            self, "corrupt",
            tuple((int(d), int(w), int(v)) for d, w, v in self.corrupt))
        object.__setattr__(
            self, "delay_waves",
            tuple(float(d) for d in self.delay_waves))
        object.__setattr__(
            self, "stall_tenants",
            tuple((str(t), float(s)) for t, s in self.stall_tenants))
        if self.transient_launch_failures < 0 or self.poison_materialize < 0:
            raise ValueError("fault counters must be non-negative")
        if any(d < 0 for d in self.delay_waves) or \
                any(s < 0 for _, s in self.stall_tenants):
            raise ValueError("fault durations must be non-negative")

    def __add__(self, other: "FaultPlan") -> "FaultPlan":
        if not isinstance(other, FaultPlan):
            return NotImplemented
        return FaultPlan(
            fail_devices=self.fail_devices | other.fail_devices,
            corrupt=self.corrupt + other.corrupt,
            transient_launch_failures=(self.transient_launch_failures
                                       + other.transient_launch_failures),
            poison_materialize=(self.poison_materialize
                                + other.poison_materialize),
            delay_waves=self.delay_waves + other.delay_waves,
            stall_tenants=self.stall_tenants + other.stall_tenants)

    @property
    def empty(self) -> bool:
        return (not self.fail_devices and not self.corrupt
                and self.transient_launch_failures == 0
                and self.poison_materialize == 0
                and not self.delay_waves
                and not self.stall_tenants)


def fail_devices(*devices: int) -> FaultPlan:
    return FaultPlan(fail_devices=frozenset(devices))


def corrupt_words(entries: Iterable[Tuple[int, int, int]]) -> FaultPlan:
    return FaultPlan(corrupt=tuple(entries))


def drop_doorbells(n: int) -> FaultPlan:
    return FaultPlan(transient_launch_failures=n)


def poison_materialize(n: int = 1) -> FaultPlan:
    return FaultPlan(poison_materialize=n)


def delay_waves(*seconds: float) -> FaultPlan:
    """Charge the next ``len(seconds)`` doorbell launches the given extra
    delays, in order (a congested launch queue / slow NIC)."""
    return FaultPlan(delay_waves=tuple(seconds))


def stall_tenant(tenant: str, seconds: float) -> FaultPlan:
    """Withhold ``tenant``'s posts from doorbell drains for ``seconds``
    of endpoint-clock time starting at injection."""
    return FaultPlan(stall_tenants=((tenant, seconds),))
