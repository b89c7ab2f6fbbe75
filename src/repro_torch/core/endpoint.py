"""Queue-pair endpoint — the one way to invoke Tiara operators (port of
``repro.core.endpoint``).

The paper's execution model is an RNIC, not a function call: clients
*post* pre-registered operator invocations to per-tenant queue pairs and
poll completions, while the NIC decides how to batch whatever is sitting
in the queues.  This module is that surface in software:

  * :class:`TiaraEndpoint` models one NIC plus its attached memory blade.
    It owns the region table, the ``(n_devices, pool_words)`` pool, and
    the operator registry — callers never thread a raw numpy pool
    through invocations again.
  * :meth:`TiaraEndpoint.connect` admits a tenant: the tenant's region
    layout is re-registered under its namespace in the shared pool, a
    :class:`~repro_torch.core.memory.RegionView` and a full
    :class:`~repro_torch.core.memory.Grant` over exactly those regions are
    wired automatically, and the tenant gets back a :class:`Session` —
    its queue pair.
  * :meth:`Session.post` enqueues one operator invocation on the send
    queue and returns a :class:`Completion` handle immediately; nothing
    executes yet.
  * :meth:`TiaraEndpoint.doorbell` drains *all* sessions' outstanding
    posts into one wave in global arrival order and runs it through the
    mixed-batch planner + dispatch cost model (one engine run for the
    whole multi-tenant wave in the common case).  Results retire into
    per-session completion queues in per-session FIFO order; contended
    STORE/CAS posts keep the engines' deterministic
    lowest-arrival-index-wins semantics because the wave *is* the
    arrival order.
  * **Split-phase completion** (the paper's async MEMCPY + WAIT pair at
    the API level): ``doorbell(wait=False)`` *launches* the wave and
    returns an in-flight :class:`WaveHandle` immediately — the launch's
    kernels are queued on the device's stream with a CUDA event recorded
    behind them, the caller posts the next wave against the in-flight
    pool (stream order chains the data dependency), so post -> doorbell
    -> post -> poll pipelines.  On the CPU every launch is eager.
    Completions retire on :meth:`Session.poll_cq` (non-blocking, ready
    waves only), :meth:`TiaraEndpoint.wait_any` (block for the oldest
    wave), :meth:`TiaraEndpoint.wait_all`, :meth:`Completion.wait`, or
    :meth:`WaveHandle.wait`.  Waves retire strictly in launch order, so
    per-session FIFO survives any number of waves in flight; each
    retired CQE carries a frozen :class:`CompletionEvent` with status,
    return value, and retire timestamp.
  * :meth:`Session.poll_cq` / :meth:`Completion.result` are the receive
    side.  ``result()`` rings the doorbell on demand, so single-request
    control-path code stays one line.

An optional ``flush_watermark`` auto-rings the doorbell once that many
posts are outstanding across all sessions — the NIC analogue of a
doorbell-batching driver.  Watermark rings are split-phase
(``doorbell(wait=False)``): the triggering ``post()`` returns as soon as
the wave is *launched*, so posts keep pipelining through an auto-ring.

Overload semantics (the serving-loop substrate — see
``core/serving_loop.py``): a ``max_sq_depth`` bounds each session's send
queue — a post to a full SQ retires immediately with ``STATUS_EAGAIN``
(the RNIC "queue full" errno) and never executes; a per-post
``deadline_s`` is enforced at admission and again when the doorbell
drains the queues — an expired post retires ``STATUS_TIMEOUT`` instead
of joining the wave (the ``STATUS_FLUSHED`` retirement machinery from
the QP error path, generalized).  An optional ``admission`` hook
rejects posts before they are enqueued.  Time is injectable
(``clock``/``sleep`` constructor hooks), so retry backoff, deadlines,
and the fault harness's stall/delay injections run deterministically
under a virtual clock.

This surface is the only way to invoke operators.

**Devices and pool residency.**  The endpoint runs on the CUDA card
unless the caller names another ``device`` (the tests pass
``device="cpu"``); with no card and no device named, construction
raises.  The pool lives on the device across waves: each wave's engine
returns the new pool as a device tensor, and retirement copies only the
per-request fields (ret, status, steps, regs, fault) to the host.  The
resident pool is laid out with the engines' sink word
(``vm.resident_pool``), and a lockstep wave of one launch ("mixed",
"batched", "interp", or "auto" when it picks the lockstep engine for the
whole wave) is donated it (``vm.donate``): the ``lockstep_vm`` kernel, or
the host loop on the CPU, writes it in place, so the wave allocates and
copies no second pool and the pool's storage is the same tensor after
the wave.  The compiled, segmented and sharded routes keep their own
buffers and the pool is rebound to their output.  The
host copy is made lazily — :meth:`TiaraEndpoint._host_view` downloads it
when a host read needs it, :meth:`TiaraEndpoint.host_mem` additionally
marks it authoritative so host writes are uploaded once at the next
doorbell, and region reads and writes through a :class:`Session` touch
only the region's words on the device.  A read observes every launched
wave, as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import faults, isa, memory, pyvm, vm, wcet
from repro_torch.core import registry as _registry
from repro_torch.core.costmodel import DispatchCostModel
from repro_torch.core.memory import Grant, RegionTable, RegionView
from repro_torch.core.program import TiaraProgram
from repro_torch.core.registry import OperatorRegistry
from repro_torch.distributed.mesh import Sharded, make_device_mesh

# the wave/engine mode vocabularies are the registry's — one source of
# truth, the endpoint only adds the single-request "interp" spelling
_WAVE_MODES = _registry._MIXED_MODES
_SINGLE_OP_MODES = tuple(m for m in _registry._BATCHED_MODES
                         if m != "auto")
_SINGLE_REQ_MODES = ("interp",)
DOORBELL_MODES = _WAVE_MODES + _SINGLE_OP_MODES + _SINGLE_REQ_MODES


class EndpointError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class CompletionEvent:
    """One retired CQE, frozen at retirement time: what completed, with
    what result, in which wave, and when it retired (so callers can
    attribute latency to the wave that hid it)."""

    seq: int              # global arrival index of the post
    op_name: str
    ret: int
    status: int
    steps: int
    wave: int             # doorbell wave id the post retired with
    retired_at: float     # endpoint clock at retirement
    fault: Optional[isa.FaultInfo] = None   # set iff STATUS_PROT_FAULT

    @property
    def ok(self) -> bool:
        return self.status == isa.STATUS_OK

    @property
    def faulted(self) -> bool:
        return self.status == isa.STATUS_PROT_FAULT

    @property
    def flushed(self) -> bool:
        return self.status == isa.STATUS_FLUSHED

    @property
    def timed_out(self) -> bool:
        return self.status == isa.STATUS_TIMEOUT

    @property
    def rejected(self) -> bool:
        return self.status == isa.STATUS_EAGAIN


@dataclasses.dataclass(eq=False)
class Completion:
    """Handle for one posted invocation (one CQE once retired).
    Identity equality: two handles are the same completion only if they
    are the same object (value comparison over the regs array would be
    meaningless for a handle).

    ``seq`` is the global arrival index — the deterministic position of
    this post in the next wave.  Until :attr:`done`, the result fields
    hold zeros; :meth:`result` rings the owning endpoint's doorbell on
    demand so callers never have to flush by hand.  Once the post is
    *in flight* (its wave launched with ``doorbell(wait=False)``),
    :attr:`wave_handle` points at the wave and :meth:`wait` /
    :meth:`result` retire through it; at retirement :attr:`event` holds
    the frozen :class:`CompletionEvent`.
    """

    session: "Session" = dataclasses.field(repr=False)
    seq: int
    op_id: int
    op_name: str
    params: Tuple[int, ...]
    home: int
    deadline: Optional[float] = None    # absolute endpoint-clock deadline
    done: bool = False
    ret: int = 0
    status: int = 0
    steps: int = 0
    regs: Optional[np.ndarray] = dataclasses.field(default=None, repr=False)
    wave_handle: Optional["WaveHandle"] = dataclasses.field(
        default=None, repr=False)
    event: Optional[CompletionEvent] = None
    fault: Optional[isa.FaultInfo] = None   # set iff STATUS_PROT_FAULT

    @property
    def ok(self) -> bool:
        return self.done and self.status == isa.STATUS_OK

    @property
    def faulted(self) -> bool:
        return self.done and self.status == isa.STATUS_PROT_FAULT

    @property
    def flushed(self) -> bool:
        return self.done and self.status == isa.STATUS_FLUSHED

    @property
    def timed_out(self) -> bool:
        """Deadline expired before launch (``STATUS_TIMEOUT``, no run)."""
        return self.done and self.status == isa.STATUS_TIMEOUT

    @property
    def rejected(self) -> bool:
        """Refused at admission (``STATUS_EAGAIN``: SQ full, rate
        limited, or load shed — no run; safe to re-post later)."""
        return self.done and self.status == isa.STATUS_EAGAIN

    @property
    def in_flight(self) -> bool:
        """Launched but not yet retired."""
        return not self.done and self.wave_handle is not None

    def wait(self) -> "Completion":
        """Block until this post retires: an in-flight post retires its
        wave (and, FIFO, every earlier wave); a post still sitting in
        the send queue rings the doorbell first.  Returns ``self``."""
        if not self.done:
            if self.wave_handle is not None:
                self.session.endpoint._retire_through(self.wave_handle)
            else:
                self.session.endpoint.doorbell()
        return self

    def result(self, *, flush: bool = True, check: bool = True) -> int:
        """The operator's return value, ringing the doorbell if this
        post is still outstanding (``flush=False`` raises instead; an
        already *launched* post never needs a flush — it just retires
        its in-flight wave).

        With ``check=True`` (default) a non-OK status raises — like an
        RNIC CQE error — so failures can't masquerade as values; pass
        ``check=False`` (or read ``.ret``/``.status``/``.ok`` directly)
        for operators whose failure status is an expected outcome
        (e.g. a busy lock)."""
        if not self.done:
            if self.wave_handle is not None:
                self.session.endpoint._retire_through(self.wave_handle)
            elif not flush:
                raise EndpointError(
                    f"completion for {self.op_name!r} (seq {self.seq}) "
                    f"still outstanding; ring doorbell() first")
            else:
                self.session.endpoint.doorbell()
        # result() is a consuming read: drop this CQE from the session's
        # completion queue so a later poll_cq() doesn't deliver it twice.
        # Membership is identity (eq=False), so an already-polled handle
        # is simply absent — no exception to swallow, and engine errors
        # from the retire path above propagate untouched.
        cq = self.session._cq
        for i, c in enumerate(cq):
            if c is self:
                del cq[i]
                break
        if check and self.status != isa.STATUS_OK:
            detail = f" [{self.fault.describe()}]" if self.fault else ""
            raise EndpointError(
                f"op {self.op_name!r} (seq {self.seq}) completed with "
                f"status {self.status} (ret {self.ret}){detail}; use "
                f"result(check=False) or .ret/.status for expected "
                f"failures")
        return self.ret


class WaveHandle:
    """One launched-but-unretired doorbell wave (``doorbell(wait=False)``).

    The engine launch has been *issued* — the device computes in the
    background while the caller posts more work — but no CQE has
    been delivered: per-session FIFO requires waves to retire strictly
    in launch order, which :meth:`TiaraEndpoint._retire_through`
    enforces.  ``completions`` lists the wave's posts in global arrival
    order."""

    def __init__(self, endpoint: "TiaraEndpoint", wave_id: int,
                 completions: Sequence[Completion], res):
        self.endpoint = endpoint
        self.wave_id = wave_id
        self.completions = tuple(completions)
        self._res = res
        self.done = False
        # launch metadata for online cost-model calibration: _retire
        # feeds (measured wall clock, batch, steps) back into
        # DispatchCostModel.observe_dispatch.  obs_mode is None for
        # waves the model has no closed form for (sharded, interp).
        self.launched_at = 0.0
        self.obs_key: Optional[int] = None
        self.obs_mode: Optional[str] = None
        self.obs_steps = 0
        self.obs_chain = 0
        self.obs_contention = 0.0

    def __len__(self) -> int:
        return len(self.completions)

    def __repr__(self) -> str:
        state = "retired" if self.done else "in-flight"
        return (f"WaveHandle(wave={self.wave_id}, "
                f"n={len(self.completions)}, {state})")

    @property
    def ready(self) -> bool:
        """Non-blocking: has the launch landed on device?  (Retirement
        still only happens on a poll/wait call, and only in wave
        order.)"""
        return self.done or vm.result_ready(self._res)

    def wait(self) -> List[Completion]:
        """Block until this wave (and, FIFO, every earlier one) retires;
        returns the wave's completions in arrival order."""
        self.endpoint._retire_through(self)
        return list(self.completions)


class Session:
    """One tenant's queue pair: a send queue of posted invocations and a
    completion queue of retired ones, both FIFO in post order."""

    def __init__(self, endpoint: "TiaraEndpoint", tenant: str,
                 view: RegionView, grant: Grant):
        self.endpoint = endpoint
        self.tenant = tenant
        self.view = view
        self.grant = grant
        self._ops: Dict[str, int] = {}
        self._sq: List[Completion] = []      # posted, not yet drained
        self._cq: List[Completion] = []      # retired, not yet polled
        self._error: Optional[isa.FaultInfo] = None   # QP error state

    # -- error state (RNIC QP semantics) ---------------------------------

    @property
    def in_error(self) -> bool:
        """True once a post of this session took a runtime protection
        fault.  While in error, new posts (and posts still sitting in
        the send queue at retirement time) retire immediately with
        ``STATUS_FLUSHED`` and never execute — the RNIC QP error state.
        Posts that were already *launched* in a wave are concurrent with
        the faulting one and retire with their real results."""
        return self._error is not None

    @property
    def error(self) -> Optional[isa.FaultInfo]:
        """The fault that errored this session (None when healthy)."""
        return self._error

    def reset(self) -> "Session":
        """Clear the error state (the QP reset->init transition); posts
        flow again.  Flushed CQEs already delivered stay delivered."""
        self._error = None
        return self

    # -- control path ---------------------------------------------------

    def register(self, program: TiaraProgram) -> int:
        """Register an operator (compile output -> verify against this
        tenant's grant -> op_id); remembered by ``program.name`` so posts
        can use the name."""
        op_id = self.endpoint.registry.register(self.tenant, program)
        self._ops[program.name] = op_id
        return op_id

    def op_id(self, name: str) -> int:
        return self._ops[name]

    @property
    def pool(self) -> np.ndarray:
        """The endpoint's pool as a writable host array — for host-side
        (control path) population through this tenant's :attr:`view`.
        Fetching it makes the host copy authoritative: the next doorbell
        uploads it.

        Do NOT hold the returned array across a doorbell: every wave
        rebinds the endpoint's pool to the engine's output, so a stale
        reference reads/writes an orphaned copy.  Re-fetch ``.pool``
        (or use :meth:`write_region`/:meth:`read_region`) after each
        doorbell."""
        return self.endpoint.host_mem()

    def write_region(self, region: str, data: Sequence[int], *,
                     device: int = 0, offset: int = 0) -> None:
        r = self.view[region]
        data = np.asarray(data, dtype=np.int64)
        if offset + data.size > r.size:
            raise ValueError(f"write of {data.size} words at {offset} "
                             f"exceeds region {region!r} ({r.size} words)")
        self.endpoint._write_words(device, r.base + offset, data)

    def read_region(self, region: str, *, device: int = 0, offset: int = 0,
                    count: Optional[int] = None) -> np.ndarray:
        r = self.view[region]
        if count is None:
            count = r.size - offset
        if offset + count > r.size:
            raise ValueError("read exceeds region")
        return self.endpoint._read_words(device, r.base + offset, count)

    # -- data path ------------------------------------------------------

    def _resolve(self, op: Union[str, int]) -> Tuple[int, str]:
        """Name or op_id -> (op_id, name), rejecting other tenants' slots:
        a queue pair may only post operators registered through it."""
        if isinstance(op, str):
            return self._ops[op], op
        op_id = int(op)
        slot = self.endpoint.registry[op_id]
        if slot.tenant != self.tenant:
            raise EndpointError(
                f"op {op_id} belongs to tenant {slot.tenant!r}; session "
                f"{self.tenant!r} cannot post it")
        return op_id, slot.verified.program.name

    def _make(self, op: Union[str, int], params: Sequence[int] = (), *,
              home: int = 0,
              deadline_s: Optional[float] = None) -> Completion:
        """Build (and sequence) one invocation handle WITHOUT enqueueing
        it — the serving loop's admission path, which holds posts in its
        own per-tenant queues until wave formation.  ``deadline_s`` is
        relative; the handle carries the absolute endpoint-clock
        deadline."""
        op_id, name = self._resolve(op)
        deadline = None if deadline_s is None else \
            self.endpoint._clock() + float(deadline_s)
        return Completion(session=self, seq=self.endpoint._next_seq(),
                          op_id=op_id, op_name=name,
                          params=tuple(int(p) for p in params),
                          home=int(home), deadline=deadline)

    def post(self, op: Union[str, int], params: Sequence[int] = (), *,
             home: int = 0,
             deadline_s: Optional[float] = None) -> Completion:
        """Enqueue one invocation; returns its completion handle.  No
        execution happens until a doorbell (explicit, watermark, or
        ``Completion.result()``).

        Admission order (each reject retires exactly one CQE, never
        executes): a session in error flushes (``STATUS_FLUSHED``); an
        already-expired ``deadline_s`` times out (``STATUS_TIMEOUT``);
        the endpoint's ``admission`` hook may refuse with any status;
        a full bounded SQ rejects with ``STATUS_EAGAIN`` — the
        backpressure signal a caller handles by draining completions or
        re-posting later.  A live deadline travels with the post and is
        re-checked when the doorbell drains the queue."""
        ep = self.endpoint
        c = self._make(op, params, home=home, deadline_s=deadline_s)
        if self._error is not None:
            # QP in error: the post is flushed, never enqueued/executed
            ep._retire_immediate(c, isa.STATUS_FLUSHED)
            return c
        if c.deadline is not None and c.deadline <= ep._clock():
            ep._retire_immediate(c, isa.STATUS_TIMEOUT)
            return c
        if ep.admission is not None:
            status = ep.admission(c)
            if status is not None:
                ep._retire_immediate(c, int(status))
                return c
        if ep.max_sq_depth is not None and len(self._sq) >= ep.max_sq_depth:
            ep._retire_immediate(c, isa.STATUS_EAGAIN)
            return c
        self._sq.append(c)
        ep._posted(c)
        return c

    @property
    def outstanding(self) -> int:
        return len(self._sq)

    def poll_cq(self, n: Optional[int] = None) -> List[Completion]:
        """Pop up to ``n`` retired completions (all of them by default)
        in per-session FIFO order.

        Polling first retires any in-flight waves whose launches have
        landed (in wave order, never blocking): the split-phase receive
        path — post, ring ``doorbell(wait=False)``, keep working, poll
        until the CQEs appear."""
        self.endpoint._retire_ready()
        n = len(self._cq) if n is None else \
            max(0, min(int(n), len(self._cq)))
        out, self._cq = self._cq[:n], self._cq[n:]
        return out

    # -- oracle / simulator path ----------------------------------------

    def trace(self, op: Union[str, int], params: Sequence[int] = (), *,
              home: int = 0, record_trace: bool = True) -> pyvm.Result:
        """Run one invocation on the ``pyvm`` oracle against the
        endpoint's pool (in place), recording the event trace the cycle
        simulator replays.  This is the control-path debugging/timing
        entry point; the data path is :meth:`post` + doorbell."""
        op_id, _ = self._resolve(op)
        slot = self.endpoint.registry[op_id]
        return pyvm.run(slot.verified, self.endpoint.regions,
                        self.endpoint.host_mem(), list(params), home=home,
                        record_trace=record_trace)


class TiaraEndpoint:
    """One NIC + memory blade: region table, pool, registry, doorbell.

    ``pool_words`` is the capacity of the attached DRAM; tenants carve
    regions out of it at :meth:`connect` time (registration order, each
    region naturally aligned).  ``flush_watermark`` auto-rings the
    doorbell when that many posts are outstanding across all sessions.
    """

    def __init__(self, pool_words: int, *, n_devices: int = 1,
                 flush_watermark: Optional[int] = None,
                 max_steps: Optional[int] = None,
                 cost_model: Optional[DispatchCostModel] = None,
                 retry_limit: int = 3, retry_backoff_s: float = 0.001,
                 retry_jitter: float = 0.0,
                 retry_jitter_seed: Optional[int] = None,
                 max_sq_depth: Optional[int] = None,
                 admission: Optional[
                     Callable[[Completion], Optional[int]]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 budget: Optional[wcet.Budget] = wcet.DEFAULT_BUDGET,
                 sep: str = "/", device=None, mesh=None):
        self.device = vm.resolve_device(device)
        if mesh is not None and mesh.size != int(n_devices):
            raise EndpointError(
                f"a mesh of {mesh.size} shards for a pool of {n_devices} "
                f"device rows")
        # the mesh sharded placements run on: the caller's, else (built
        # on first use) one over the visible devices of the endpoint's
        # type — which cannot be built when fewer than n_devices are
        # visible ("auto" then stays single, "sharded" raises)
        self._mesh = mesh
        self._default_mesh = None
        self.regions = RegionTable(pool_words)
        self.registry = OperatorRegistry(self.regions, n_devices=n_devices,
                                         max_steps=max_steps,
                                         cost_model=cost_model,
                                         budget=budget)
        self.n_devices = int(n_devices)
        # the pool: a host array until the first doorbell uploads it,
        # then a device tensor across waves (see the module docstring).
        # _host is the host copy (None when stale); _host_auth says the
        # host copy is newer than the device one.
        self._dev_mem: Optional[torch.Tensor] = None
        self._host: Optional[np.ndarray] = memory.make_pool(n_devices,
                                                            self.regions)
        self._host_auth = True
        self.flush_watermark = flush_watermark
        self.retry_limit = int(retry_limit)       # transient-launch retries
        self.retry_backoff_s = float(retry_backoff_s)
        # retry backoff jitter: a seeded rng makes chaos runs
        # reproducible — the same seed sleeps the same sequence
        self.retry_jitter = float(retry_jitter)
        self._retry_rng = np.random.default_rng(retry_jitter_seed)
        # bounded per-session SQ + admission hook (overload semantics —
        # see the module docstring); None = unbounded / admit everything
        self.max_sq_depth = None if max_sq_depth is None \
            else int(max_sq_depth)
        self.admission = admission
        # injectable time: every timestamp, deadline check, backoff and
        # injected delay goes through these, so tests and benches swap
        # in a virtual clock and never real-sleep
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else time.sleep
        self._last_retire_t = self._clock()
        self.sep = sep
        self._sessions: Dict[str, Session] = {}
        self._seq = 0
        self._outstanding = 0
        self._inflight: List[WaveHandle] = []
        self._wave_seq = 0
        # fault-injection state (see core/faults.py); failed_devices is
        # also the live health set threaded into every engine dispatch
        self.failed_devices: set = set()
        self._pending_corrupt: List[Tuple[int, int, int]] = []
        self._transient_left = 0
        self._poison_left = 0
        self._pending_delays: List[float] = []
        self._stalls: Dict[str, float] = {}      # tenant -> stalled until
        # adaptive re-homing state (INDIGO-style, see note_access /
        # rehome): which device row holds each region's live copy, the
        # per-region per-device access audit, and the migration audit
        self._region_home: Dict[str, int] = {}
        self._region_access: Dict[str, np.ndarray] = {}
        self._dev_access = np.zeros(self.n_devices, dtype=np.int64)
        self.cross_device_words = 0      # words served home != accessor
        self.rehome_count = 0
        self.rehomed_words = 0

    @classmethod
    def for_tenants(cls, named: Sequence[Tuple[str, RegionTable]], *,
                    n_devices: int = 1, sep: str = "/", **kwargs
                    ) -> Tuple["TiaraEndpoint", Dict[str, Session]]:
        """Build an endpoint sized exactly for the given per-tenant
        region layouts and connect every tenant — the one-call setup for
        examples, benchmarks, and tests.  ``device=`` (with the other
        constructor options) passes through."""
        cursor = 0
        for _, table in named:
            cursor = memory.aligned_end(cursor, table)
        ep = cls(max(cursor, 1), n_devices=n_devices, sep=sep, **kwargs)
        sessions = {tenant: ep.connect(tenant, table)
                    for tenant, table in named}
        return ep, sessions

    # -- tenants --------------------------------------------------------

    def connect(self, tenant: str, regions: RegionTable) -> Session:
        """Admit a tenant: re-register its region layout under
        ``tenant/<name>`` in the shared pool, wire up its view + grant,
        and hand back its queue pair."""
        if self.sep in tenant:
            raise EndpointError(
                f"tenant name {tenant!r} must not contain {self.sep!r}")
        if tenant in self._sessions:
            raise EndpointError(f"tenant {tenant!r} already connected")
        # admission is all-or-nothing: check capacity BEFORE registering
        # anything (RegionTable has no unregister, so a mid-layout
        # failure would leak the tenant's earlier regions forever)
        need = memory.aligned_end(self.regions.high_water, regions)
        if need > self.regions.pool_words:
            raise EndpointError(
                f"cannot admit tenant {tenant!r}: layout needs "
                f"{need} words, pool has {self.regions.pool_words}")
        for r in regions:
            try:
                self.regions.register(f"{tenant}{self.sep}{r.name}",
                                      r.size, writable=r.writable)
            except ValueError as e:
                raise EndpointError(
                    f"cannot admit tenant {tenant!r}: {e}") from e
        view = RegionView(self.regions, f"{tenant}{self.sep}")
        grant = Grant.all_of(view, tenant)
        self.registry.add_tenant(grant)
        session = Session(self, tenant, view, grant)
        self._sessions[tenant] = session
        return session

    def session(self, tenant: str) -> Session:
        return self._sessions[tenant]

    @property
    def mem(self) -> torch.Tensor:
        """The pool as a device tensor, current with every launched wave
        and every host write (uploading the host copy if it is newer).
        After a sharded wave this gathers the shards onto the endpoint's
        device and keeps that copy resident instead."""
        pool = self._resident_pool()
        if isinstance(pool, Sharded):
            self._dev_mem = vm.as_pool(pool, self.device)
        return self._dev_mem

    def _resident_pool(self):
        """The pool as it lies: a device tensor, or after a sharded wave
        the per-shard rows (uploading the host copy if it is newer)."""
        if self._host_auth:
            # laid out with the engines' sink word, so a lockstep wave
            # can run on it in place (vm.donate)
            self._dev_mem = vm.resident_pool(self._host, self.device)
            self._host_auth = False
        return self._dev_mem

    @property
    def mesh(self):
        """The mesh sharded placements run on (None when no mesh of
        ``n_devices`` shards can be built)."""
        return self._placement_mesh(required=False)

    def _placement_mesh(self, required: bool):
        if self._mesh is not None:
            return self._mesh
        if self._default_mesh is None:
            try:
                self._default_mesh = make_device_mesh(
                    self.n_devices, device_type=self.device.type)
            except RuntimeError:
                if required:
                    raise
                return None
        return self._default_mesh

    def _set_device_pool(self, mem: torch.Tensor) -> None:
        """Rebind the pool to a launch's output; the host copy is stale."""
        self._dev_mem = mem
        self._host = None
        self._host_auth = False

    def _host_view(self) -> np.ndarray:
        """Host-side view of the pool.  While waves are in flight the
        device pool is still being computed; viewing it waits until the
        last launched wave lands — a read must observe every launched
        wave, in flight or not.  The download is cached until the next
        doorbell."""
        if self._host is None:
            t = self._dev_mem.cpu()
            self._host = t.numpy().copy() if t is self._dev_mem \
                else t.numpy()
        return self._host

    def _row(self, device: int) -> torch.Tensor:
        """Device row ``device`` of the resident pool (its shard, after a
        sharded wave)."""
        if isinstance(self._dev_mem, Sharded):
            return self._dev_mem.shards[device][0]
        return self._dev_mem[device]

    def host_mem(self) -> np.ndarray:
        """The pool, guaranteed host-writable for control-path access.

        The host copy becomes authoritative: the next doorbell uploads
        it once, so the data path never pays for host access it does
        not make."""
        mem = self._host_view()
        self._host_auth = True
        return mem

    def _read_words(self, device: int, start: int,
                    count: int) -> np.ndarray:
        """Words ``[start, start+count)`` of device row ``device`` —
        from the host copy when there is one, else only those words from
        the device pool."""
        if self._host is not None:
            return np.array(self._host[device, start:start + count])
        return self._row(device)[start:start + count].cpu().numpy()

    def _write_words(self, device: int, start: int,
                     data: np.ndarray) -> None:
        """Write ``data`` at word ``start`` of device row ``device``: into
        the host copy when it is authoritative, else straight into the
        device pool (stream-ordered after every launched wave)."""
        if self._host_auth:
            self._host[device, start:start + data.size] = data
            return
        row = self._row(device)
        row[start:start + data.size] = torch.as_tensor(data,
                                                       device=row.device)
        self._host = None

    @property
    def sessions(self) -> Dict[str, Session]:
        return dict(self._sessions)

    # -- fault injection (see core/faults.py) -----------------------------

    def inject(self, plan: "faults.FaultPlan") -> None:
        """Apply a :class:`~repro_torch.core.faults.FaultPlan`: device
        failures take effect on the next dispatch, corruptions before
        the next wave, transient/poison counters accumulate."""
        self.failed_devices |= set(plan.fail_devices)
        for d, w, _ in plan.corrupt:
            if not (0 <= d < self.n_devices
                    and 0 <= w < self.regions.pool_words):
                raise EndpointError(
                    f"corruption target (dev {d}, word {w}) outside the "
                    f"{self.n_devices}x{self.regions.pool_words} pool")
        self._pending_corrupt.extend(plan.corrupt)
        self._transient_left += plan.transient_launch_failures
        self._poison_left += plan.poison_materialize
        self._pending_delays.extend(plan.delay_waves)
        now = self._clock()
        for tenant, seconds in plan.stall_tenants:
            if tenant not in self._sessions:
                raise EndpointError(
                    f"cannot stall unknown tenant {tenant!r}")
            until = now + seconds
            self._stalls[tenant] = max(self._stalls.get(tenant, 0.0),
                                       until)

    def revive(self, *devices: int) -> None:
        """Bring failed devices back (all of them with no argument)."""
        if devices:
            self.failed_devices -= set(int(d) for d in devices)
        else:
            self.failed_devices.clear()

    def clear_faults(self) -> None:
        """Drop every pending injection, including device failures."""
        self.failed_devices.clear()
        self._pending_corrupt.clear()
        self._transient_left = 0
        self._poison_left = 0
        self._pending_delays.clear()
        self._stalls.clear()

    def stalled(self, tenant: str) -> bool:
        """Is the tenant's SQ currently withheld from doorbell drains
        (an injected ``stall_tenant`` still in effect)?"""
        return self._stalls.get(tenant, 0.0) > self._clock()

    # -- adaptive re-homing (INDIGO-style access audit + control-path
    #    migration) --------------------------------------------------------
    #
    # A region's *home* is the device row that holds its live copy —
    # posts against it execute there, and an accessor on another device
    # pays cross-device reply traffic.  The endpoint keeps a per-region
    # per-device access audit (``note_access``, fed by serving-side
    # resolvers per post), and ``rehome`` migrates a region's content
    # between device rows on the control path — between doorbells, never
    # under an in-flight wave.  The audit also feeds the cost model's
    # home-skew EWMA, so ``choose_placement`` prices the hot home's
    # sub-wave as the sharded critical path.

    def home_of(self, region: str) -> int:
        """The device row holding ``region``'s live copy (0 until the
        first ``rehome``)."""
        return self._region_home.get(region, 0)

    def note_access(self, region: str, device: int, words: int = 1) -> None:
        """Audit one access of ``words`` pool words against ``region``
        from ``device`` (the accessor's device — e.g. the client a reply
        streams to).  Accumulates the per-region and per-device counts,
        charges ``cross_device_words`` when the accessor is not the
        region's home, and feeds the cost model's home-skew EWMA."""
        try:
            self.regions[region]
        except KeyError:
            raise EndpointError(
                f"note_access: unknown region {region!r}") from None
        if not 0 <= int(device) < self.n_devices:
            raise EndpointError(
                f"note_access: device {device} outside mesh of "
                f"{self.n_devices}")
        counts = self._region_access.get(region)
        if counts is None:
            counts = self._region_access[region] = np.zeros(
                self.n_devices, dtype=np.int64)
        counts[int(device)] += int(words)
        self._dev_access[int(device)] += int(words)
        if int(device) != self.home_of(region):
            self.cross_device_words += int(words)
        self.cost_model.observe_home_access(self._dev_access)

    def access_counts(self, region: str) -> np.ndarray:
        """Per-device access-word counts for ``region`` since its last
        rehome (a copy; zeros before any access)."""
        counts = self._region_access.get(region)
        if counts is None:
            return np.zeros(self.n_devices, dtype=np.int64)
        return counts.copy()

    def rehome(self, region: str, device: int) -> int:
        """Control-path migration: copy ``region``'s content from its
        current home row to ``device``'s row and make that the home.
        Returns the words moved (0 when already home).  The access
        window resets, so the next rehome decision is made on fresh
        traffic.  Raises on unknown regions, out-of-mesh or failed
        target devices, and while waves are in flight (migration is a
        between-doorbells operation, like fault injection)."""
        try:
            r = self.regions[region]
        except KeyError:
            raise EndpointError(
                f"rehome: unknown region {region!r}") from None
        if not 0 <= int(device) < self.n_devices:
            raise EndpointError(
                f"rehome: device {device} outside mesh of "
                f"{self.n_devices}")
        if int(device) in self.failed_devices:
            raise EndpointError(
                f"rehome: target device {device} is failed")
        if self._inflight:
            raise EndpointError(
                "rehome: waves in flight — retire them first "
                "(wait_all) before migrating regions")
        src = self.home_of(region)
        self._region_access.pop(region, None)
        if src == int(device):
            return 0
        mem = self.host_mem()
        mem[int(device), r.base:r.base + r.size] = \
            mem[src, r.base:r.base + r.size]
        self._region_home[region] = int(device)
        self.rehome_count += 1
        self.rehomed_words += int(r.size)
        return int(r.size)

    def _retire_immediate(self, c: Completion, status: int) -> None:
        """Retire a post immediately with the given no-execution status
        (``event.wave == -1``): the flushed-WQE path of a session in
        error (``STATUS_FLUSHED``), an expired deadline
        (``STATUS_TIMEOUT``), or an admission reject / load shed
        (``STATUS_EAGAIN``).  Exactly one CQE is delivered either way —
        overload degrades a post's status, never loses its completion."""
        c.ret, c.status, c.steps = 0, int(status), 0
        c.regs = np.zeros(isa.NUM_REGS, dtype=np.int64)
        c.event = CompletionEvent(
            seq=c.seq, op_name=c.op_name, ret=0, status=c.status,
            steps=0, wave=-1, retired_at=self._clock())
        c.done = True
        c.session._cq.append(c)

    # -- doorbell (the data path) ----------------------------------------

    def _next_seq(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    def _posted(self, c: Completion) -> None:
        self._outstanding += 1
        if self.flush_watermark is not None and \
                self._outstanding >= self.flush_watermark:
            try:
                # split-phase auto-ring: the watermark *launches* the
                # wave but does not block the triggering post() on its
                # retirement — posts keep pipelining through the ring
                # and the CQEs arrive on the normal poll/wait paths
                self.doorbell(wait=False)
            except BaseException:
                # post() must be atomic: if the auto-ring fails, cancel
                # the triggering post (the doorbell failure path already
                # re-queued the wave, including it) so the caller, who
                # gets the exception instead of a handle, can re-post
                # without risking double execution
                c.session._sq.remove(c)
                self._outstanding -= 1
                raise

    def _enqueue(self, c: Completion) -> None:
        """Move an already-sequenced (``Session._make``) post into its
        session's SQ without triggering the watermark auto-ring — the
        serving loop's wave-formation path, which rings its own doorbell
        immediately after selecting the wave."""
        c.session._sq.append(c)
        self._outstanding += 1

    @property
    def outstanding(self) -> int:
        return self._outstanding

    @property
    def last_noconflict(self) -> Optional[bool]:
        """Did the last doorbell wave carry a static no-conflict proof
        (registration-time footprints with that wave's concrete params —
        ``registry.prove_wave_noconflict``)?  ``True`` means the engines
        ran with the runtime sweep compiled out; ``None`` before any
        wave."""
        return self.registry.last_noconflict

    def doorbell(self, *, mode: str = "auto",
                 contention_rate: float = 0.0,
                 placement: str = "single",
                 wait: bool = True) -> Union[int, "WaveHandle"]:
        """Drain every session's outstanding posts into one wave (global
        arrival order), launch it, and — with ``wait=True`` — retire the
        results into per-session CQs, returning the number of
        completions retired.

        **Split phase**: ``wait=False`` returns an in-flight
        :class:`WaveHandle` as soon as the launch is *issued* — before
        any (possibly slow, async-MEMCPY-heavy) work retires.  The pool
        binding becomes the launch's output tensor, so further posts and
        doorbells pipeline against the in-flight wave (stream order
        chains the data dependency); completions retire later via ``poll_cq`` /
        ``wait_any`` / ``wait_all`` / ``Completion.wait()``, always in
        wave order so per-session FIFO holds.  Modes that cannot defer
        (sharded placement, "interp") still compute eagerly but retire
        on the same split-phase path.

        ``mode`` picks the wave engine: the mixed-dispatch set
        ("auto"/"mixed"/"segmented"/"serial") for any wave, "batched"/
        "compiled"/"compiled_dbuf" for single-op waves, "interp" for a
        single-request wave — which makes the endpoint the one surface
        that can drive every engine (the benchmarks rely on this).

        ``placement`` decides *where* the wave executes — placement is a
        doorbell concern, invisible to :meth:`Session.post` callers:
        "single" (default) runs on one chip; "sharded" shards the pool
        over a device mesh and buckets the wave by each post's ``home``
        into per-device sub-waves (requires a wave mode, "auto" or
        "mixed"); "auto" lets the dispatch cost model pick (audited via
        ``registry.last_placement``).  Results are bit-identical across
        placements — contended STORE/CAS waves keep the deterministic
        arrival-order round-robin semantics on the mesh."""
        if mode not in DOORBELL_MODES:
            raise ValueError(
                f"unknown mode {mode!r}; expected one of "
                f"{list(DOORBELL_MODES)}")
        if placement not in _registry._PLACEMENTS:
            raise ValueError(
                f"unknown placement {placement!r}; expected one of "
                f"{list(_registry._PLACEMENTS)}")
        if placement != "single" and mode not in ("auto", "mixed"):
            raise EndpointError(
                f"placement {placement!r} needs a wave mode ('auto' or "
                f"'mixed'); got mode {mode!r}")
        if self._pending_corrupt:
            # injected pre-wave corruption (stale translations, torn
            # pointers) lands in the pool before any request sees it,
            # word by word where the pool lies (no download of the pool)
            for d, w, v in self._pending_corrupt:
                self._write_words(d, w, np.asarray([v], dtype=np.int64))
            self._pending_corrupt = []
        now = self._clock()
        wave: List[Completion] = []
        held = 0
        for name, s in self._sessions.items():
            if s._error is not None:
                # QP in error: anything still queued (enqueued before
                # the fault retired, e.g. by the serving loop) flushes
                # at the drain — it must never execute
                flushed, s._sq = s._sq, []
                for c in flushed:
                    self._retire_immediate(c, isa.STATUS_FLUSHED)
                continue
            if self._stalls.get(name, 0.0) > now:
                # injected tenant stall: its posts stay queued (and
                # aging — deadlines still apply at the next drain)
                held += len(s._sq)
                continue
            wave.extend(s._sq)
            s._sq = []
        self._outstanding = held
        # deadline enforcement at wave formation: an expired post never
        # executes — it retires STATUS_TIMEOUT right here, in seq order,
        # and the wave launches without it
        expired = [c for c in wave
                   if c.deadline is not None and c.deadline <= now]
        if expired:
            wave = [c for c in wave
                    if not (c.deadline is not None and c.deadline <= now)]
            for c in sorted(expired, key=lambda c: c.seq):
                self._retire_immediate(c, isa.STATUS_TIMEOUT)
        n_expired = len(expired)
        if not wave:
            if wait:
                return n_expired
            empty = WaveHandle(self, self._wave_seq, (),
                               None)  # nothing launched, nothing to wait
            empty.done = True
            self._wave_seq += 1
            return empty
        wave.sort(key=lambda c: c.seq)
        if self._pending_delays:
            # injected launch delay (slow NIC / congested launch queue):
            # charged through the sleep hook so virtual clocks advance
            self._sleep(self._pending_delays.pop(0))
        ids = [c.op_id for c in wave]
        params = [list(c.params) for c in wave]
        homes = [c.home for c in wave]
        reg = self.registry
        block = wait  # split-phase doorbells defer result retirement
        failed = set(self.failed_devices) or None
        attempt = 0
        while True:
            try:
                if self._transient_left > 0:
                    self._transient_left -= 1
                    raise faults.TransientError(
                        "injected transient launch failure")
                if mode in _WAVE_MODES:
                    # a wave that may run on the mesh takes the pool as
                    # it lies (sharded rows stay sharded)
                    mesh = None if placement == "single" else \
                        self._placement_mesh(required=placement ==
                                             "sharded")
                    pool = self._resident_pool()
                    # a lockstep wave of one launch writes the resident
                    # pool in place (vm.donate); the compiled, segmented
                    # and sharded routes keep their own buffers
                    with vm.donate(pool if isinstance(pool, torch.Tensor)
                                   else None):
                        res = reg._invoke_mixed(
                            ids, pool, params, homes=homes, mode=mode,
                            contention_rate=contention_rate, failed=failed,
                            placement=placement, block=block, mesh=mesh)
                    break
                mem = self.mem
                if mode in _SINGLE_OP_MODES:
                    if len(set(ids)) != 1:
                        raise EndpointError(
                            f"mode {mode!r} needs a single-op wave; got "
                            f"op_ids {sorted(set(ids))}")
                    with vm.donate(mem):
                        res = reg._invoke_batched(ids[0], mem, params,
                                                  homes=homes, mode=mode,
                                                  failed=failed, block=block)
                else:  # "interp"
                    if len(wave) != 1:
                        raise EndpointError(
                            f"mode 'interp' needs a single-request wave; "
                            f"got {len(wave)} posts")
                    with vm.donate(mem):
                        r = reg._invoke(ids[0], mem, params[0],
                                        home=homes[0], failed=failed,
                                        mode="interp")
                    frow = (np.asarray([r.fault.pc, r.fault.opcode,
                                        r.fault.addr, r.fault.device],
                                       dtype=np.int64)
                            if r.fault is not None else vm.NO_FAULT)
                    res = vm.BatchedInvokeResult(
                        mem=r.mem, ret=np.asarray([r.ret], dtype=np.int64),
                        status=np.asarray([r.status], dtype=np.int64),
                        steps=np.asarray([r.steps], dtype=np.int64),
                        regs=np.asarray(r.regs, dtype=np.int64)[None, :],
                        fault=np.asarray(frow, dtype=np.int64)[None, :])
                break
            except faults.TransientError:
                # bounded retry-with-backoff: a lost doorbell is cured by
                # ringing again, not by dropping the wave
                attempt += 1
                if attempt > self.retry_limit:
                    for c in wave:
                        c.session._sq.append(c)
                    self._outstanding += len(wave)
                    raise
                backoff = self.retry_backoff_s * (1 << (attempt - 1))
                if self.retry_jitter > 0.0:
                    # seeded, deterministic de-synchronization jitter
                    backoff *= 1.0 + self.retry_jitter * float(
                        self._retry_rng.random())
                self._sleep(backoff)
            except BaseException:
                # a failed doorbell must not drop the send queues: re-post
                # the wave untouched (it is seq-sorted, and nothing can
                # have posted concurrently), so the caller can ring again
                for c in wave:
                    c.session._sq.append(c)
                self._outstanding += len(wave)
                raise
        self._set_device_pool(res.mem)
        handle = WaveHandle(self, self._wave_seq, wave, res)
        self._wave_seq += 1
        # launch metadata for the online cost-model feed (_retire):
        # single-op waves calibrate their slot's scale, mixed waves the
        # wave-global bucket; modes without a closed analytical form
        # (sharded placement, interp) observe nothing
        handle.launched_at = self._clock()
        if placement == "single" and mode != "interp":
            uniq = sorted(set(ids))
            slots = [reg[i] for i in uniq]
            handle.obs_steps = max(s.verified.step_bound for s in slots)
            handle.obs_contention = contention_rate
            eff_mode = mode
            if mode == "auto":
                d = reg.last_decision
                eff_mode = d.mode if d is not None else None
            if len(uniq) == 1:
                handle.obs_key = uniq[0]
                handle.obs_chain = slots[0].chain_iters
                # a single-op wave through the wave planner runs the
                # mixed engine degenerately; observe it as "batched"
                handle.obs_mode = "batched" if eff_mode == "mixed" \
                    else eff_mode
            else:
                handle.obs_key = None
                handle.obs_mode = eff_mode
        for c in wave:
            c.wave_handle = handle
        self._inflight.append(handle)
        if wait:
            self._retire_through(handle)
            return len(wave) + n_expired
        return handle

    # -- completion retirement (the receive side) -------------------------

    def _retire(self, handle: WaveHandle) -> None:
        """Deliver one wave's CQEs: materialize the (possibly deferred)
        engine result, fill the completion handles, and append them to
        their sessions' CQs in global arrival order.  Only
        :meth:`_retire_through` / :meth:`_retire_ready` call this, and
        only in wave order."""
        if self._poison_left > 0:
            # injected deferred engine failure: raise BEFORE any CQE is
            # delivered; _retire_through leaves the wave queued, so the
            # next wait retries materialization (no lost completions)
            self._poison_left -= 1
            raise faults.InjectedEngineError(
                "injected materialization failure")
        res = vm.materialize_result(handle._res)
        # drop the result: a user-held Completion must not pin a whole
        # pool snapshot (the per-request fields are copied out below)
        handle._res = None
        now = self._clock()
        if handle.obs_mode is not None and handle.completions:
            # online calibration feed: this wave's measured wall clock
            # (from launch, or from the previous retirement when waves
            # pipelined and overlapped) updates the cost model's
            # per-slot EWMA scales, so mode="auto" and the serving
            # loop's formation policy adapt to the running host
            start = max(handle.launched_at, self._last_retire_t)
            measured_us = (now - start) * 1e6
            if measured_us > 0.0:
                self.cost_model.observe_dispatch(
                    handle.obs_key, handle.obs_mode,
                    batch=len(handle.completions),
                    step_bound=handle.obs_steps,
                    measured_us=measured_us,
                    contention_rate=handle.obs_contention,
                    chain_iters=handle.obs_chain)
        self._last_retire_t = now
        errored: List[Session] = []
        for i, c in enumerate(handle.completions):
            c.ret = int(res.ret[i])
            c.status = int(res.status[i])
            c.steps = int(res.steps[i])
            c.regs = np.asarray(res.regs[i])
            if c.status == isa.STATUS_PROT_FAULT:
                c.fault = res.fault_at(i)
                if c.session._error is None:
                    # RNIC QP semantics: first protection fault moves
                    # the owning session into the error state
                    c.session._error = c.fault
                    errored.append(c.session)
            c.event = CompletionEvent(
                seq=c.seq, op_name=c.op_name, ret=c.ret, status=c.status,
                steps=c.steps, wave=handle.wave_id, retired_at=now,
                fault=c.fault)
            c.done = True
            c.session._cq.append(c)
        handle.done = True
        # flush the errored sessions' not-yet-launched posts: they were
        # posted after the faulting wave launched and must not execute
        for s in errored:
            flushed, s._sq = s._sq, []
            self._outstanding -= len(flushed)
            for c in flushed:
                self._retire_immediate(c, isa.STATUS_FLUSHED)

    def _retire_through(self, handle: WaveHandle) -> None:
        """Retire every in-flight wave up to and including ``handle``
        (strict launch order — per-session FIFO depends on it).  A wave
        is only popped once its retirement succeeded, so a
        materialization error leaves it queued for a retry instead of
        silently losing it (and draining every later wave looking for
        it)."""
        if handle.done:
            return
        while self._inflight:
            h = self._inflight[0]
            self._retire(h)
            self._inflight.pop(0)
            if h is handle:
                break

    def _retire_ready(self) -> int:
        """Retire in-flight waves whose launches have landed, oldest
        first, stopping at the first one still computing (never
        blocks).  Returns the number of completions retired."""
        n = 0
        while self._inflight and self._inflight[0].ready:
            h = self._inflight[0]
            self._retire(h)
            self._inflight.pop(0)
            n += len(h)
        return n

    def wait_all(self) -> int:
        """Block until every in-flight wave retires; returns the number
        of completions retired."""
        n = self.in_flight
        if self._inflight:
            self._retire_through(self._inflight[-1])
        return n

    def wait_any(self) -> List[Completion]:
        """Block until at least one in-flight wave retires (the oldest —
        waves retire in launch order) and return its completions in
        arrival order; ``[]`` when nothing is in flight."""
        if not self._inflight:
            return []
        h = self._inflight[0]
        self._retire_through(h)
        return list(h.completions)

    @property
    def in_flight(self) -> int:
        """Posts launched but not yet retired."""
        return sum(len(h) for h in self._inflight)

    @property
    def in_flight_waves(self) -> int:
        return len(self._inflight)

    @property
    def cost_model(self) -> DispatchCostModel:
        """The registry's dispatch cost model — also the sink for the
        endpoint's online wall-clock observations and the serving
        loop's conflict-rate feed."""
        return self.registry.cost_model

    @property
    def last_decision(self):
        """The wave-level dispatch decision of the most recent doorbell
        that went through the cost model (audit hook)."""
        return self.registry.last_decision

    @property
    def last_placement(self):
        """The placement decision of the most recent
        ``doorbell(placement="auto")`` (audit hook)."""
        return self.registry.last_placement

    def dump(self) -> str:
        lines = [f"endpoint: {len(self._sessions)} sessions, "
                 f"{len(self.registry)} ops, pool "
                 f"{self.n_devices}x{self.regions.pool_words} words, "
                 f"{self._outstanding} outstanding"]
        lines.append(self.registry.dump())
        return "\n".join(lines)
