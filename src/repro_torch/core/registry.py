"""Operator registry — the NIC's control plane (port of
``repro.core.registry``).

Models one Tiara NIC: a region table over the host pool, per-tenant grants,
and the 256-entry ``op_id -> start_pc`` dispatch table (paper §3).
``register()`` is the eBPF-load moment: compile output goes through the
static verifier against the *tenant's* grant; only then does the operator
get a slot.  Registration is also the trace-compile moment: the slot
records whether the operator's CFG admits the interpreter-free fast path
(``core/compile``), so the data path can dispatch with no further checks.

The data path is *internal* engine plumbing behind the queue-pair
endpoint surface (``core/endpoint``): ``_invoke()`` is single-request
O(1) dispatch, ``_invoke_batched()`` the line-rate path (B requests, one
engine run), and ``_invoke_mixed()`` the *multi-tenant* line-rate path: a
wave whose requests carry per-request op_ids runs either through the
mixed lockstep engine (one launch over the merged instruction store, each
request entering at its slot's ``start_pc`` — the hardware dispatch
table in software) or stable-sorted into same-op segments through the
compiled traces, with per-request outputs scattered back to arrival
order.  All ``mode="auto"`` choices go through the analytical
:class:`~repro_torch.core.costmodel.DispatchCostModel` — engine choice is a
function of batch size, trace length, op-mix entropy, and the caller's
contention-rate hint, not a hardcoded preference.

There is no public invocation surface here.  All invocation goes through a
:class:`~repro_torch.core.endpoint.Session` and
:meth:`~repro_torch.core.endpoint.TiaraEndpoint.doorbell`, which owns the pool
and calls the internal engines here.

The instruction stores are per-MP BRAMs of 1024 entries; we model one
shared store and enforce the aggregate capacity.

Placement: ``placement="single"`` runs a wave on one device against the
whole pool; ``placement="sharded"`` runs it on the mesh-sharded engine
(``vm.invoke_sharded_mixed``), the pool split over a device mesh by row
(one ``lockstep_vm`` launch a wave when every shard lies on one card);
``placement="auto"`` lets the cost model pick between them.
"""

from __future__ import annotations

import dataclasses
from typing import (Dict, Iterator, List, Optional, Sequence, Set, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.core import access
from repro_torch.core import compile as tcompile
from repro_torch.core import isa, vm, wcet
from repro_torch.core.costmodel import (DispatchCostModel,
                                        DispatchDecision, SegmentStats)
from repro_torch.core.memory import Grant, RegionTable
from repro_torch.core.program import TiaraProgram
from repro_torch.core.verifier import VerifiedOperator, verify
from repro_torch.distributed.mesh import Sharded

_SINGLE_MODES = ("auto", "interp", "compiled")
_BATCHED_MODES = ("auto", "batched", "compiled", "compiled_dbuf")
_MIXED_MODES = ("auto", "mixed", "segmented", "serial")
_PLACEMENTS = ("single", "sharded", "auto")


class RegistrationError(Exception):
    pass


@dataclasses.dataclass
class Slot:
    """One dispatch-table entry with its three entry points:

    ``interp``   single-request interpreter (always there);
    ``batched``  batch-parallel interpreter, B requests per engine run;
    ``compiled`` trace-compiled straight-line fast path (when the CFG
                 admits one — ``compilable`` / ``compile_reason``).
    """

    op_id: int
    tenant: str
    verified: VerifiedOperator
    start_pc: int
    regions: RegionTable
    compile_reason: Optional[str] = None
    n_gather_chains: int = 0
    # Summed static caps of the *double-bufferable* gather chains only
    # (cap > compile.DBUF_CHUNK — the engine chunks per chain, so a
    # chain that fits one chunk must not count toward the overlap
    # discount or the dbuf candidate would price a win that the emitted
    # schedule cannot deliver).
    chain_iters: int = 0
    # Registration-time introspection (see ``tcompile.superop_report``):
    # every (superop kind, loop pc) the trace compiler will fuse, and —
    # when some loop matched nothing — the first structural reason the
    # gather-chain matcher bailed on it.
    superops: Tuple[Tuple[str, int], ...] = ()
    superop_near_miss: Optional[str] = None

    @property
    def compilable(self) -> bool:
        return self.compile_reason is None

    @property
    def footprint(self) -> Optional[access.OpFootprint]:
        """The operator's registration-time symbolic access footprint."""
        return self.verified.footprint

    @property
    def certificate(self) -> Optional[wcet.LineRateCertificate]:
        """The operator's registration-time line-rate certificate."""
        return self.verified.certificate

    def describe_analysis(self) -> str:
        """One-line summary of the static analysis artifacts: derived
        footprint, line-rate certificate, matched superoperators, and
        the nearest superop miss."""
        bits = ["footprint: "
                + access.describe_footprint(self.footprint, self.regions)]
        if self.certificate is not None:
            bits.append("certificate: " + self.certificate.describe())
        if self.superops:
            bits.append("superops: " + ", ".join(
                f"{kind}@pc{pc}" for kind, pc in self.superops))
        if self.superop_near_miss is not None:
            bits.append(f"superop near-miss: {self.superop_near_miss}")
        return "; ".join(bits)

    def interp(self, mem, params: Sequence[int] = (), *,
               home: int = 0,
               failed: Optional[Set[int]] = None,
               impl: str = "auto") -> vm.InvokeResult:
        """One request on the lockstep engine; ``impl`` "auto" runs the
        ``lockstep_vm`` kernel on a card pool and the host loop on a CPU
        pool ("cuda" / "torch" insist on one)."""
        return vm.invoke(self.verified, self.regions, mem, params,
                         home=home, failed=failed, impl=impl)

    def batched(self, mem, params: Sequence[Sequence[int]], *,
                homes: Union[int, Sequence[int]] = 0,
                failed: Optional[Set[int]] = None,
                block: bool = True,
                static_noconflict: bool = False,
                impl: str = "auto") -> vm.BatchedInvokeResult:
        """B requests on the lockstep engine (``impl`` as for
        :meth:`interp`)."""
        return vm.invoke_batched(self.verified, self.regions, mem, params,
                                 homes=homes, failed=failed, block=block,
                                 static_noconflict=static_noconflict,
                                 impl=impl)

    def compiled(self, mem, params: Sequence[Sequence[int]], *,
                 homes: Union[int, Sequence[int]] = 0,
                 failed: Optional[Set[int]] = None,
                 impl: str = "auto", double_buffer: bool = False,
                 block: bool = True,
                 static_noconflict: bool = False) -> vm.BatchedInvokeResult:
        if not self.compilable:
            raise ValueError(
                f"op {self.op_id} has no compiled entry point: "
                f"{self.compile_reason}")
        return tcompile.invoke_compiled(self.verified, self.regions, mem,
                                        params, homes=homes, failed=failed,
                                        impl=impl,
                                        double_buffer=double_buffer,
                                        noconflict=static_noconflict,
                                        block=block)


_PROOF_CACHE_MAX = 512


class OperatorRegistry:
    def __init__(self, regions: RegionTable, *, n_devices: int = 1,
                 max_steps: Optional[int] = None,
                 cost_model: Optional[DispatchCostModel] = None,
                 static_analysis: bool = True,
                 budget: Optional[wcet.Budget] = wcet.DEFAULT_BUDGET):
        self.regions = regions
        self.n_devices = int(n_devices)
        self.max_steps = max_steps
        self.cost_model = cost_model or DispatchCostModel()
        # Line-rate admission budget: registration rejects operators
        # whose certificate exceeds it (None disables enforcement —
        # certificates are still derived and reported).
        self.budget = budget
        # static_analysis=False disables the registration-time conflict
        # proofs at dispatch: every wave runs with the runtime sweep,
        # exactly the pre-analysis behaviour (escape hatch + A/B lever
        # for benchmarks).
        self.static_analysis = bool(static_analysis)
        self.last_decision: Optional[DispatchDecision] = None
        self.last_placement: Optional[DispatchDecision] = None
        # Audit hooks: did the last wave carry a static no-conflict
        # proof, and which segmented-wave op groups were coalesced into
        # one launch because their programs are bit-identical.
        self.last_noconflict: Optional[bool] = None
        self.last_fused_groups: Optional[List[List[int]]] = None
        self._grants: Dict[str, Grant] = {}
        self._slots: Dict[int, Slot] = {}
        self._by_name: Dict[str, int] = {}
        self._store_used = 0
        # Bounded memo of wave-proof verdicts: the serving loop re-forms
        # near-identical waves, and the proof is pure in
        # (op_ids, params, homes, n_devices).
        self._proof_cache: Dict[tuple, bool] = {}

    # -- tenants --------------------------------------------------------

    def add_tenant(self, grant: Grant) -> None:
        self._grants[grant.tenant] = grant

    def grant_of(self, tenant: str) -> Grant:
        if tenant not in self._grants:
            raise RegistrationError(f"unknown tenant {tenant!r}")
        return self._grants[tenant]

    # -- registration (control path) -------------------------------------

    def register(self, tenant: str, program: TiaraProgram) -> int:
        grant = self.grant_of(tenant)
        key = f"{tenant}/{program.name}"
        if key in self._by_name:
            raise RegistrationError(
                f"operator {key!r} already registered as op "
                f"{self._by_name[key]}")
        kwargs = {}
        if self.max_steps is not None:
            kwargs["max_steps"] = self.max_steps
        verified = verify(program, grant=grant, regions=self.regions,
                          **kwargs)
        # the eBPF-load budget check: an operator whose *certified*
        # worst case exceeds the NIC's line-rate budget never gets a
        # slot, and the error names the offending pc and resource
        if self.budget is not None and verified.certificate is not None:
            violations = self.budget.violations(verified.certificate)
            if violations:
                raise RegistrationError(
                    f"{program.name}: " + "; ".join(violations))
        if len(self._slots) >= isa.OP_TABLE_SIZE:
            raise RegistrationError("op_id table full (256 entries)")
        if self._store_used + program.n_instr > isa.INSTR_STORE_SIZE:
            raise RegistrationError(
                f"instruction store full: {self._store_used} + "
                f"{program.n_instr} > {isa.INSTR_STORE_SIZE}")
        op_id = len(self._slots)
        chains = tcompile.find_gather_chains(verified)
        report = tcompile.superop_report(verified)
        matched = tuple(report["matched"])  # type: ignore[arg-type]
        near_miss = report["near_miss"]
        reason = tcompile.why_not_compilable(verified)
        if reason is not None:
            # interp-only slots surface the full analysis in the reason
            # itself — the one string a "why is this slow" caller reads
            extra = ["footprint: "
                     + access.describe_footprint(verified.footprint,
                                                 self.regions)]
            if matched:
                extra.append("superops: " + ", ".join(
                    f"{kind}@pc{pc}" for kind, pc in matched))
            if near_miss is not None:
                extra.append(f"superop near-miss: {near_miss}")
            reason = "; ".join([reason] + extra)
        self._slots[op_id] = Slot(
            op_id=op_id, tenant=tenant, verified=verified,
            start_pc=self._store_used, regions=self.regions,
            compile_reason=reason,
            n_gather_chains=len(chains),
            chain_iters=sum(g.cap for g in chains
                            if g.cap > tcompile.DBUF_CHUNK),
            superops=matched,
            superop_near_miss=near_miss)
        self._store_used += program.n_instr
        self._by_name[f"{tenant}/{program.name}"] = op_id
        return op_id

    def lookup(self, tenant: str, name: str) -> int:
        return self._by_name[f"{tenant}/{name}"]

    def __getitem__(self, op_id: int) -> Slot:
        return self._slots[op_id]

    def __len__(self) -> int:
        return len(self._slots)

    @property
    def store_used(self) -> int:
        return self._store_used

    def dispatch_table(self) -> np.ndarray:
        """The 256-entry op_id -> start_pc hardware table (-1 = empty)."""
        t = np.full(isa.OP_TABLE_SIZE, -1, dtype=np.int64)
        for op_id, slot in self._slots.items():
            t[op_id] = slot.start_pc
        return t

    # -- static conflict proofs (wave formation) --------------------------

    def prove_wave_noconflict(self, op_ids: Sequence[int],
                              params: Sequence[Sequence[int]],
                              homes: Union[int, Sequence[int]] = 0, *,
                              n_devices: Optional[int] = None) -> bool:
        """Substitute the wave's concrete params into the registration-time
        footprints and try to prove the wave conflict-free.

        ``True`` is a proof: no macro-step of this wave can make the
        runtime sweep flag a conflict, so the lockstep engines may run
        with the sweep (and the sharded footprint all_gather) compiled
        out.  ``False`` is *not* a disproof — it just means "could not
        prove" (a ⊤ footprint, a disabled analysis, an unregistered
        footprint) and the engines keep the runtime sweep.  Verdicts are
        memoized; the serving loop re-forms near-identical waves.
        """
        if not self.static_analysis:
            return False
        ids = np.asarray(list(op_ids), dtype=np.int64)
        B = int(ids.size)
        if B != len(params):
            raise ValueError(f"{B} op_ids for {len(params)} param rows")
        if B == 0:
            return True
        # (B == 1 still runs the proof: a lone lane's MEMCPY sites must
        # be src/dst self-disjoint or the sweep would flag them)
        n_dev = self.n_devices if n_devices is None else int(n_devices)
        h = vm.homes_array(homes, B)
        key = (ids.tobytes(), h.tobytes(), n_dev,
               tuple(tuple(int(x) for x in row) for row in params))
        hit = self._proof_cache.get(key)
        if hit is not None:
            return hit
        fps = []
        for i in ids:
            fp = self._slots[int(i)].verified.footprint
            if fp is None:
                return False
            fps.append(fp)
        verdict = access.prove_wave_noconflict(fps, params, h, self.regions,
                                               n_devices=n_dev)
        if len(self._proof_cache) >= _PROOF_CACHE_MAX:
            self._proof_cache.pop(next(iter(self._proof_cache)))
        self._proof_cache[key] = verdict
        return verdict

    # -- invocation (data path) -------------------------------------------

    @staticmethod
    def _check_mode(mode: str, allowed: Sequence[str]) -> None:
        if mode not in allowed:
            raise ValueError(
                f"unknown mode {mode!r}; expected one of {list(allowed)}")

    def _invoke(self, op_id: int, mem,
                params: Sequence[int] = (), *, home: int = 0,
                failed: Optional[Set[int]] = None,
                mode: str = "interp") -> vm.InvokeResult:
        """Single-request dispatch.  ``mode``: "interp" (default — the
        classic MP datapath), "compiled" (trace-compiled fast path), or
        "auto" (cost-model pick between the two)."""
        self._check_mode(mode, _SINGLE_MODES)
        slot = self._slots[op_id]
        if mode == "auto":
            n_dev = int(mem.shape[0])
            decision = self.cost_model.choose_batched(
                batch=1, step_bound=slot.verified.step_bound,
                compilable=slot.compilable, key=op_id,
                batched_cached=vm.engine_cached(
                    slot.verified, self.regions, n_dev, 1),
                compiled_cached=tcompile.compiled_cached(
                    slot.verified, self.regions, n_dev, 1))
            self.last_decision = decision
            # at B=1 the batched lockstep engine *is* the scalar datapath
            mode = "compiled" if decision.mode == "compiled" else "interp"
        if mode == "interp":
            return slot.interp(mem, params, home=home, failed=failed)
        r = slot.compiled(mem, [list(params)], homes=home, failed=failed)
        return vm.InvokeResult(mem=r.mem, ret=int(r.ret[0]),
                               status=int(r.status[0]),
                               steps=int(r.steps[0]), regs=r.regs[0],
                               fault=r.fault_at(0))

    def _invoke_batched(self, op_id: int, mem,
                        params: Sequence[Sequence[int]], *,
                        homes: Union[int, Sequence[int]] = 0,
                        failed: Optional[Set[int]] = None,
                        mode: str = "auto",
                        contention_rate: float = 0.0,
                        block: bool = True,
                        static_noconflict: Optional[bool] = None
                        ) -> vm.BatchedInvokeResult:
        """Line-rate dispatch: B requests, one engine run.  ``mode``:
        "auto" (cost-model pick), "batched" (force the lockstep
        interpreter — always exact, even under contention), "compiled"
        (force the straight-line trace), or "compiled_dbuf" (force the
        double-buffered gather-chain schedule).  ``contention_rate``
        is the caller's estimate of the fraction of macro-steps whose
        footprints collide; any positive value steers "auto" to the
        interpreter, whose per-step conflict check serializes exactly.
        ``block=False`` defers result retirement (the endpoint's
        split-phase doorbell).

        ``static_noconflict``: None (default) derives the wave's static
        conflict proof from the registered footprints; an explicit bool
        is a caller-supplied verdict (a mixed wave's proof covers each
        of its segments).  A proven wave runs the engines with the
        runtime sweep compiled out and overrides ``contention_rate``."""
        self._check_mode(mode, _BATCHED_MODES)
        slot = self._slots[op_id]
        n_dev = int(mem.shape[0])
        B = len(params)
        nc = static_noconflict
        if nc is None:
            nc = B > 1 and self.prove_wave_noconflict(
                np.full(B, op_id, dtype=np.int64), params, homes,
                n_devices=n_dev)
        nc = bool(nc)
        self.last_noconflict = nc
        if mode == "auto":
            decision = self.cost_model.choose_batched(
                batch=B, step_bound=slot.verified.step_bound,
                compilable=slot.compilable, key=op_id,
                contention_rate=contention_rate,
                chain_iters=slot.chain_iters,
                static_noconflict=nc,
                batched_cached=vm.engine_cached(
                    slot.verified, self.regions, n_dev, B,
                    static_noconflict=nc),
                compiled_cached=tcompile.compiled_cached(
                    slot.verified, self.regions, n_dev, B, noconflict=nc),
                # only worth a cache-key hash when the dbuf candidate
                # can actually be priced (the op has gather chains)
                dbuf_cached=(slot.chain_iters > 0
                             and tcompile.compiled_cached(
                                 slot.verified, self.regions, n_dev, B,
                                 double_buffer=True, noconflict=nc)))
            self.last_decision = decision
            mode = decision.mode
        if mode == "batched":
            return slot.batched(mem, params, homes=homes, failed=failed,
                                block=block, static_noconflict=nc)
        return slot.compiled(mem, params, homes=homes, failed=failed,
                             double_buffer=(mode == "compiled_dbuf"),
                             block=block, static_noconflict=nc)

    # -- mixed-op invocation (the multi-tenant line-rate path) -------------

    def store_ops(self) -> List[VerifiedOperator]:
        """Every registered operator in op_id order — the programs of the
        shared instruction store.  Concatenated in this order their entry
        offsets reproduce :meth:`dispatch_table` exactly, which is what
        the mixed engine dispatches ``op_id`` against.  op_ids are
        assigned densely in registration order, so this is just the slots
        in insertion order (dicts preserve it)."""
        return [s.verified for s in self._slots.values()]

    def _segment_stats(self, plan: "tcompile.MixedPlan",
                       n_dev: int) -> List[SegmentStats]:
        out = []
        for seg in plan.segments:
            v = self._slots[seg.op_id].verified
            out.append(SegmentStats(
                size=seg.size, step_bound=v.step_bound,
                compilable=self._slots[seg.op_id].compilable,
                batched_cached=vm.engine_cached(v, self.regions, n_dev,
                                                seg.size),
                compiled_cached=tcompile.compiled_cached(
                    v, self.regions, n_dev, seg.size)))
        return out

    def _invoke_mixed(self, op_ids: Sequence[int], mem,
                      params: Sequence[Sequence[int]], *,
                      homes: Union[int, Sequence[int]] = 0,
                      failed: Optional[Set[int]] = None,
                      mode: str = "auto",
                      contention_rate: float = 0.0,
                      placement: str = "single",
                      block: bool = True,
                      mesh=None) -> vm.BatchedInvokeResult:
        """Dispatch a wave whose requests carry *per-request* op_ids.

        ``mode``:
          "mixed"      one lockstep launch over the merged instruction
                       store; request ``b`` enters at
                       ``dispatch_table()[op_ids[b]]``.  Exact round-robin
                       semantics, contended steps serialize per request
                       index — the reference mixed execution.
          "segmented"  stable-sort by op_id, run each same-op segment on
                       its best engine (compiled trace when the slot has
                       one), scatter outputs back to arrival order.
                       Matches "mixed" whenever cross-segment footprints
                       are disjoint (the normal serving case).
          "serial"     arrival-order baseline: one ``invoke_batched``
                       launch per *contiguous* same-op run — what a
                       dispatcher without mixed batching must do; a fully
                       interleaved wave degenerates to one launch per
                       request.
          "auto"       single-op waves delegate to
                       :meth:`_invoke_batched`; genuinely mixed waves go
                       to the cost model.

        ``placement``:
          "single"     the wave runs on one chip against the whole pool
                       (every mode above).
          "sharded"    the pool's leading axis is sharded over ``mesh``
                       (a 1-D :class:`~repro_torch.distributed.mesh.Mesh`
                       of ``n_devices`` shards; with none, one over the
                       first ``n_devices`` cards, which raises when fewer
                       are visible): the planner buckets the wave by
                       ``home`` into per-shard sub-waves and the mesh
                       executes them in lockstep, remote traffic on
                       collectives (``vm.invoke_sharded_mixed``) —
                       bit-identical to the "mixed" engine over the
                       arrival-order wave.  The pool comes back sharded.
          "auto"       :meth:`DispatchCostModel.choose_placement`
                       decides (recorded in :attr:`last_placement`).
          Both non-"single" placements require ``mode`` "auto" or
          "mixed", as in the reference.
        """
        self._check_mode(mode, _MIXED_MODES)
        if placement not in _PLACEMENTS:
            raise ValueError(
                f"unknown placement {placement!r}; expected one of "
                f"{list(_PLACEMENTS)}")
        if placement != "auto":
            # no placement decision this wave: clear the audit hook so
            # an earlier auto wave's pick cannot look current
            self.last_placement = None
        ids = np.asarray(list(op_ids), dtype=np.int64)
        if ids.ndim != 1 or ids.size != len(params):
            raise ValueError(
                f"op_ids shape {ids.shape} does not match "
                f"{len(params)} requests")
        for i in np.unique(ids):
            if int(i) not in self._slots:
                raise KeyError(f"op_id {int(i)} not registered")
        self.last_fused_groups = None
        # Static conflict proof over the whole wave, formed once at plan
        # time: a True lets every engine below (dense mixed, segmented
        # sub-launches, the sharded mesh) run with the runtime sweep —
        # and the mesh's footprint all_gather — compiled out.
        nc = ids.size > 1 and self.prove_wave_noconflict(
            ids, params, homes, n_devices=int(mem.shape[0]))
        if placement != "single":
            out = self._invoke_placed(ids, mem, params, homes=homes,
                                      failed=failed, mode=mode,
                                      contention_rate=contention_rate,
                                      placement=placement,
                                      static_noconflict=nc, mesh=mesh)
            if out is not None:
                # the wave ran on the mesh: no engine-mode decision was
                # made, so clear the audit hook rather than leave an
                # earlier wave's pick looking current
                self.last_decision = None
                self.last_noconflict = nc
                return out
        if isinstance(mem, Sharded):
            # the single-device engines take the whole pool on one device
            mem = vm.as_pool(mem)
        plan = tcompile.plan_mixed_batch(ids)
        decision = None
        if mode == "auto":
            if plan.n_segments == 1:
                return self._invoke_batched(
                    int(ids[0]), mem, params, homes=homes, failed=failed,
                    mode="auto", contention_rate=contention_rate,
                    block=block, static_noconflict=nc)
            n_dev = int(mem.shape[0])
            decision = self.cost_model.choose_mixed(
                segments=self._segment_stats(plan, n_dev),
                contention_rate=contention_rate,
                static_noconflict=nc,
                mixed_cached=vm.mixed_engine_cached(
                    self.store_ops(), self.regions, n_dev, plan.batch,
                    static_noconflict=nc))
            mode = decision.mode
        if mode == "mixed":
            out = vm.invoke_batched_mixed(
                self.store_ops(), self.regions, mem, ids, params,
                homes=homes, failed=failed, block=block,
                static_noconflict=nc)
        elif mode == "segmented":
            out = self._invoke_groups(
                self._coalesced_segments(plan),
                mem, params, homes=homes, failed=failed,
                contention_rate=contention_rate, block=block,
                static_noconflict=nc)
        else:
            out = self._invoke_groups(
                self._arrival_runs(ids), mem, params, homes=homes,
                failed=failed, contention_rate=contention_rate,
                block=block, static_noconflict=nc)
        if decision is not None:
            # nested per-group dispatches recorded their own decisions;
            # the wave-level pick is what callers audit
            self.last_decision = decision
        self.last_noconflict = nc
        return out

    def _invoke_placed(self, ids: np.ndarray, mem,
                       params: Sequence[Sequence[int]], *,
                       homes: Union[int, Sequence[int]],
                       failed: Optional[Set[int]],
                       mode: str, contention_rate: float,
                       placement: str,
                       static_noconflict: bool = False,
                       mesh=None) -> Optional[vm.BatchedInvokeResult]:
        """Resolve a non-"single" placement: run the wave on the sharded
        mesh engine, or return None when the cost model sends an "auto"
        wave back to single-device execution.  A statically-proven wave
        (``static_noconflict``) runs the mesh step without the footprint
        all_gather or the sweep, and is priced accordingly."""
        if mode not in ("auto", "mixed"):
            raise ValueError(
                f"placement={placement!r} executes the mixed lockstep "
                f"engine over the mesh; mode must be 'auto' or 'mixed', "
                f"not {mode!r}")
        n_dev = int(mem.shape[0])
        h = vm.homes_array(homes, len(params))
        plan = tcompile.plan_mixed_batch(ids, homes=h, n_devices=n_dev)
        if placement == "auto":
            bound = max(self._slots[int(i)].verified.step_bound
                        for i in np.unique(ids))
            # the dense (no-homes) plan's segment stats price the best
            # *single-chip* dispatch — mixed or segmented — so a wave
            # whose best local plan is segmented is not routed to the
            # mesh prematurely
            dense_plan = tcompile.plan_mixed_batch(ids)
            decision = self.cost_model.choose_placement(
                batch=int(ids.size), n_devices=n_dev, step_bound=bound,
                contention_rate=contention_rate,
                batch_per_device=plan.batch_per_device,
                # a pool can model more homes than the mesh has shards;
                # "auto" must degrade to "single" there, not pick a
                # placement whose mesh cannot run.  Likewise a mesh with
                # a failed member: the single-device engines model failed
                # devices exactly, the mesh would compute through the
                # dead shard
                sharded_feasible=(mesh is not None
                                  and mesh.size == n_dev and not failed),
                mixed_cached=vm.mixed_engine_cached(
                    self.store_ops(), self.regions, n_dev, int(ids.size),
                    static_noconflict=static_noconflict),
                sharded_cached=vm.sharded_engine_cached(
                    self.store_ops(), self.regions, n_dev,
                    plan.batch_per_device,
                    static_noconflict=static_noconflict, mesh=mesh),
                segments=self._segment_stats(dense_plan, n_dev),
                static_noconflict=static_noconflict)
            self.last_placement = decision
            if decision.mode != "sharded":
                return None
        return vm.invoke_sharded_mixed(self.store_ops(), self.regions,
                                       mem, plan, params, failed=failed,
                                       static_noconflict=static_noconflict,
                                       mesh=mesh)

    def _coalesced_segments(self, plan: "tcompile.MixedPlan"
                            ) -> Iterator[Tuple[int, np.ndarray]]:
        """Cross-op fusion for the segmented path: plan segments whose
        slots hold *bit-identical* programs (two tenants registering the
        same gather-chain kernel get distinct op_ids but the same code)
        coalesce into one engine launch on the first op_id — identical
        code means identical semantics, and the merged arrival indices
        scatter each request's outputs back exactly as before.  Fused
        groups (>1 op_id per launch) are recorded in
        :attr:`last_fused_groups` for auditing."""
        buckets: Dict[bytes, Tuple[int, List[np.ndarray], List[int]]] = {}
        for seg in plan.segments:
            code = vm._code_bytes(self._slots[seg.op_id].verified)
            if code not in buckets:
                buckets[code] = (seg.op_id, [], [])
            buckets[code][1].append(plan.segment_indices(seg))
            buckets[code][2].append(seg.op_id)
        self.last_fused_groups = [ops for _, _, ops in buckets.values()
                                  if len(ops) > 1]
        for rep_op, idx_lists, _ in buckets.values():
            yield rep_op, np.concatenate(idx_lists)

    @staticmethod
    def _arrival_runs(ids: np.ndarray):
        """Contiguous same-op runs in arrival order — the grouping a
        dispatcher without mixed batching is stuck with."""
        lo, B = 0, int(ids.size)
        while lo < B:
            hi = lo + 1
            while hi < B and ids[hi] == ids[lo]:
                hi += 1
            yield int(ids[lo]), np.arange(lo, hi)
            lo = hi

    def _invoke_groups(self, groups, mem,
                       params: Sequence[Sequence[int]], *,
                       homes: Union[int, Sequence[int]],
                       failed: Optional[Set[int]],
                       contention_rate: float = 0.0,
                       block: bool = True,
                       static_noconflict: Optional[bool] = None
                       ) -> vm.BatchedInvokeResult:
        """Launch each ``(op_id, arrival_indices)`` group on its own
        (best-engine auto dispatch), threading the pool through in group
        order and scattering per-request outputs back to arrival order.

        With ``block=False`` the per-group launches stay deferred: the
        pool threads through as device futures and the arrival-order
        scatter happens on device, so the whole multi-launch chain
        retires later in one materialization."""
        B = len(params)
        h = vm.homes_array(homes, B)
        mem_cur = vm.as_pool(mem)
        dev = mem_cur.device
        ret = torch.zeros(B, dtype=torch.int64, device=dev)
        status = torch.zeros(B, dtype=torch.int64, device=dev)
        steps = torch.zeros(B, dtype=torch.int64, device=dev)
        regs = torch.zeros((B, isa.NUM_REGS), dtype=torch.int64, device=dev)
        fault = torch.as_tensor(vm.NO_FAULT, device=dev).repeat(B, 1)
        for op_id, idx in groups:
            idx = np.asarray(idx)
            # a donated pool stays whole: a later group's failure must
            # not leave the earlier groups' writes in it
            with vm.donate(None):
                r = self._invoke_batched(
                    int(op_id), mem_cur, [list(params[i]) for i in idx],
                    homes=[int(h[i]) for i in idx], failed=failed,
                    mode="auto", contention_rate=contention_rate,
                    block=False, static_noconflict=static_noconflict)
            mem_cur = r.mem
            # the arrival-order scatter runs on the pool's device, so the
            # whole multi-launch chain retires later in one
            # materialization
            it = torch.as_tensor(idx, dtype=torch.int64, device=dev)
            ret[it], status[it] = r.ret, r.status
            steps[it], regs[it] = r.steps, r.regs
            fault[it] = r.fault
        return vm.finish_result(
            vm.BatchedInvokeResult(mem=mem_cur, ret=ret, status=status,
                                   steps=steps, regs=regs, fault=fault),
            block=block)

    def dump(self) -> str:
        lines = []
        for op_id, slot in sorted(self._slots.items()):
            p = slot.verified.program
            fast = "compiled" if slot.compilable else "interp-only"
            chains = f" gather-chains={slot.n_gather_chains}" \
                if slot.n_gather_chains else ""
            lines.append(
                f"op {op_id:3d}  tenant={slot.tenant:<12s} "
                f"{p.name:<20s} {p.n_instr:3d} instrs  "
                f"bound={slot.verified.step_bound:<8d} "
                f"regions r={p.regions_read} w={p.regions_written} "
                f"[{fast}{chains}]")
            # registration-time analysis artifacts: derived footprint,
            # matched superoperators, nearest superop near-miss
            lines.append("         " + slot.describe_analysis())
        return "\n".join(lines)
