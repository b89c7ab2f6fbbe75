"""Continuous-batching serving engine over the paged KV cache.

Decoder-only attention architectures (the vLLM/PagedAttention scenario the
paper targets).  Fixed B decode slots; prompts prefill into a free slot's
pages (padded to a power-of-two bucket), then every engine step decodes
all active slots in one batched call through the paged-attention path.

Block-table resolution is pluggable (``resolver=``):

* ``"host"`` (default) — today's local path, bit-for-bit: the engine
  indexes its own ``block_tables`` array.
* ``"tiara"`` — the disaggregated path: block tables, the KV page pool
  and (for MoE archs) the expert routing tables live as regions on a
  :class:`~repro_torch.core.endpoint.TiaraEndpoint`, and every decode step
  resolves them by posting ``PagedKVFetch`` / ``MoEExpertGather``
  operators from per-sequence sessions through the
  :class:`~repro_torch.core.serving_loop.ServingLoop` (see
  ``serving/resolver.py``) — admission, deadlines, fault semantics and
  adaptive region re-homing included.  Decode output is bit-identical
  to ``"host"`` on healthy fabric.

Recurrent/enc-dec archs are served via the transformer API directly (their
state is batch-indexed, not paged); the Tiara technique has no indirection
to collapse there.

The port runs eagerly on ``device`` (the CUDA card unless named; with no
card and no device named it raises): prefill goes through the CUDA
``flash_attention`` kernel, each decode step through ``paged_attention``
once per layer, and under ``resolver="tiara"`` every step's block-table
resolution runs an endpoint wave whose MEMCPYs read through
``tiara_gather``.
The KV pools are updated in place.  f32 matmuls on the card must stay
full f32, as on the reference's CPU: the engine refuses to run an f32
model on a card with ``torch.backends.cuda.matmul.allow_tf32`` set
(PyTorch's default is off); the flag does not touch a bf16 model's
products.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core import isa
from repro_torch.core.endpoint import Completion, EndpointError
from repro_torch.core.vm import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.param import tree_map
from repro_torch.serving.allocator import BlockAllocator
from repro_torch.serving.resolver import TiaraResolver, expert_layout
from repro_torch.serving.sampler import sample_tokens


@dataclasses.dataclass
class Sequence:
    sid: int
    prompt: List[int]
    max_new: int
    slot: Optional[int] = None
    pages: Optional[List[int]] = None
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


_STATUS_NAMES = {
    isa.STATUS_OK: "OK", isa.STATUS_FAIL: "FAIL",
    isa.STATUS_EAGAIN: "EAGAIN", isa.STATUS_TIMEOUT: "TIMEOUT",
    isa.STATUS_FLUSHED: "FLUSHED", isa.STATUS_PROT_FAULT: "PROT_FAULT",
}


@dataclasses.dataclass
class SequenceHandle:
    """One submitted sequence's completion handle — the engine-level
    mirror of :class:`~repro_torch.core.endpoint.Completion`: ``status``
    reuses the ISA's CQE statuses (``STATUS_OK`` / ``STATUS_EAGAIN`` on
    admission reject / ``STATUS_TIMEOUT`` on deadline expiry /
    ``STATUS_PROT_FAULT`` / ``STATUS_FLUSHED`` surfaced from the tiara
    resolver's fabric), ``poll()`` is the non-blocking check, and
    ``result()`` runs the engine until this sequence finishes."""

    sid: int
    tenant: str
    engine: "ServingEngine" = dataclasses.field(repr=False)
    deadline: Optional[float] = None      # absolute engine-clock deadline
    done: bool = False
    status: int = isa.STATUS_OK
    fault: Optional[isa.FaultInfo] = None

    @property
    def ok(self) -> bool:
        return self.done and self.status == isa.STATUS_OK

    @property
    def rejected(self) -> bool:
        return self.done and self.status == isa.STATUS_EAGAIN

    @property
    def timed_out(self) -> bool:
        return self.done and self.status == isa.STATUS_TIMEOUT

    @property
    def faulted(self) -> bool:
        return self.done and self.status == isa.STATUS_PROT_FAULT

    @property
    def flushed(self) -> bool:
        return self.done and self.status == isa.STATUS_FLUSHED

    def poll(self) -> bool:
        """Non-blocking: has this sequence reached a terminal state?"""
        return self.done

    @property
    def tokens(self) -> List[int]:
        """Tokens generated so far (the final output once done)."""
        return self.engine._tokens_of(self.sid)

    def result(self, *, max_steps: int = 10_000,
               check: bool = True) -> List[int]:
        """Run the engine until this sequence finishes and return its
        tokens.  With ``check`` (default), a non-OK terminal status
        raises :class:`~repro_torch.core.endpoint.EndpointError` — mirroring
        ``Completion.result()``."""
        self.engine.run_until(self.sid, max_steps=max_steps)
        if check and not self.ok:
            name = _STATUS_NAMES.get(self.status, str(self.status))
            raise EndpointError(
                f"sequence {self.sid} ({self.tenant}) ended "
                f"{name}" + (f": {self.fault}" if self.fault else ""))
        return self.tokens


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params: Any, *,
                 max_slots: int = 4,
                 max_seq: int = 512, n_pages: Optional[int] = None,
                 eos_id: int = 0, temperature: float = 0.0, seed: int = 0,
                 resolver: str = "host", n_homes: int = 1,
                 placement: str = "single",
                 max_pending: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 resolver_deadline_s: Optional[float] = None,
                 rehome: bool = True, rehome_every: int = 8,
                 device=None, mesh=None) -> None:
        assert not cfg.enc_dec and all(s.kind == "attn"
                                       for s in cfg.pattern), \
            "engine serves decoder-only attention archs"
        self.device = resolve_device(device)
        if self.device.type == "cuda" and \
                torch.backends.cuda.matmul.allow_tf32 and \
                torch.float32 in (tf.model_dtype(cfg.dtype),
                                  tf.model_dtype(cfg.param_dtype)):
            raise ValueError(
                "torch.backends.cuda.matmul.allow_tf32 is set: f32 matmuls "
                "would round to TF32; the engine keeps them full f32")
        self.cfg = cfg
        self.params = tree_map(lambda a: a.to(self.device), params)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.temperature = temperature
        self.pages_per_seq = (max_seq + cfg.page_size - 1) // cfg.page_size
        pool = n_pages or max_slots * self.pages_per_seq
        self.allocator = BlockAllocator(pool)

        # device state; one extra *scratch* page absorbs the KV writes of
        # inactive decode slots (they decode garbage in the batched step —
        # harmless, but they must never touch a live sequence's pages)
        self.scratch_page = pool
        self.caches = tf.init_caches(cfg, max_slots, self.pages_per_seq,
                                     n_pages=pool + 1, device=self.device)
        self.block_tables = np.full((max_slots, self.pages_per_seq),
                                    self.scratch_page, np.int32)
        self.lengths = np.zeros((max_slots,), np.int32)
        self.active: List[Optional[Sequence]] = [None] * max_slots
        self.waiting: List[Sequence] = []
        self.completed: Dict[int, List[int]] = {}
        self._next_sid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._handles: Dict[int, SequenceHandle] = {}
        self.max_pending = max_pending
        self._clock: Callable[[], float] = \
            clock if clock is not None else time.monotonic

        self.resolver_name = str(resolver)
        self._resolver: Optional[TiaraResolver] = None
        self._moe = None
        if resolver == "tiara":
            moe_specs = [s.moe for s in cfg.pattern
                         if s.mlp == "moe" and s.moe is not None]
            if moe_specs:
                spec = moe_specs[0]
                self._moe = expert_layout(
                    spec.n_experts,
                    max_k=min(spec.top_k, spec.n_experts))
            self._resolver = TiaraResolver(
                self.allocator, max_slots=max_slots,
                pages_per_seq=self.pages_per_seq, n_homes=n_homes,
                moe=self._moe, deadline_s=resolver_deadline_s,
                clock=clock, sleep=sleep, placement=placement,
                rehome=rehome, rehome_every=rehome_every,
                device=self.device, mesh=mesh)
        elif resolver != "host":
            raise ValueError(
                f"unknown resolver {resolver!r} (use 'host' or 'tiara')")

    # -- client API -------------------------------------------------------

    def submit(self, prompt: List[int], *, max_new: int = 32,
               deadline_s: Optional[float] = None,
               tenant: str = "default") -> SequenceHandle:
        """Admit one sequence; returns its :class:`SequenceHandle`
        (``ServingLoop.submit`` semantics: exactly one terminal status
        per submission).  An already-full waiting queue
        (``max_pending``) rejects with ``STATUS_EAGAIN``; a
        ``deadline_s`` that expires before the sequence is admitted to
        a slot times out with ``STATUS_TIMEOUT`` and never prefills.

        The PR-9 deprecated positional form ``submit(prompt, max_new)``
        (which returned the bare ``sid``) is gone; ``max_new`` is
        keyword-only and the old int sid is ``handle.sid``.
        """
        return self._submit(prompt, max_new, deadline_s, tenant)

    def _submit(self, prompt: List[int], max_new: int,
                deadline_s: Optional[float],
                tenant: str) -> SequenceHandle:
        sid = self._next_sid
        self._next_sid += 1
        deadline = None if deadline_s is None \
            else self._clock() + float(deadline_s)
        handle = SequenceHandle(sid=sid, tenant=tenant, engine=self,
                                deadline=deadline)
        self._handles[sid] = handle
        seq = Sequence(sid=sid, prompt=list(prompt), max_new=max_new)
        if self.max_pending is not None \
                and len(self.waiting) >= self.max_pending:
            self.completed[sid] = []
            handle.done, handle.status = True, isa.STATUS_EAGAIN
            return handle
        if deadline is not None and deadline <= self._clock():
            self.completed[sid] = []
            handle.done, handle.status = True, isa.STATUS_TIMEOUT
            return handle
        self.waiting.append(seq)
        return handle

    def handle(self, sid: int) -> SequenceHandle:
        return self._handles[sid]

    def _tokens_of(self, sid: int) -> List[int]:
        if sid in self.completed:
            return list(self.completed[sid])
        for seq in list(self.waiting) + [s for s in self.active if s]:
            if seq.sid == sid:
                return list(seq.output)
        raise KeyError(f"unknown sequence {sid}")

    def finished(self) -> bool:
        return not self.waiting and all(s is None for s in self.active)

    # -- scheduling ---------------------------------------------------------

    def _finish(self, seq: Sequence, *, status: int = isa.STATUS_OK,
                fault: Optional[isa.FaultInfo] = None) -> None:
        """Terminal transition for one sequence: record output, release
        its slot/pages, resolve its handle with ``status``."""
        seq.done = True
        self.completed[seq.sid] = list(seq.output)
        handle = self._handles.get(seq.sid)
        if handle is not None:
            handle.done = True
            handle.status = int(status)
            handle.fault = fault
        if seq.slot is not None:
            slot = seq.slot
            if seq.pages:
                self.allocator.free(seq.pages)
            self.active[slot] = None
            self.lengths[slot] = 0
            self.block_tables[slot] = self.scratch_page
            if self._resolver is not None:
                self._resolver.unbind(slot)

    def _admit(self) -> None:
        for slot in range(self.max_slots):
            if self.active[slot] is not None:
                continue
            while self.waiting:
                seq = self.waiting.pop(0)
                handle = self._handles.get(seq.sid)
                if handle is not None and handle.deadline is not None \
                        and handle.deadline <= self._clock():
                    # expired while queued: times out, never prefills
                    # (the ServingLoop's expired-before-launch rule)
                    self._finish(seq, status=isa.STATUS_TIMEOUT)
                    continue
                need = self.pages_per_seq
                try:
                    pages = self.allocator.alloc(need, seq.sid)
                except Exception:
                    self.waiting.insert(0, seq)
                    return
                seq.slot, seq.pages = slot, pages
                self.block_tables[slot] = np.asarray(pages, np.int32)
                if self._resolver is not None:
                    self._resolver.bind(slot, pages)
                self._prefill(seq)
                self.active[slot] = seq
                break

    def _prefill(self, seq: Sequence) -> None:
        assert seq.slot is not None
        slot = seq.slot
        plen = len(seq.prompt)
        # bucket prompt length as the reference does (there it limits
        # compilations; here it keeps both engines doing identical work)
        bucket = max(self.cfg.page_size,
                     1 << int(np.ceil(np.log2(max(plen, 1)))))
        bucket = min(bucket, self.max_seq)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = seq.prompt
        batch = {
            "tokens": self._put(toks),
            "caches": self._slot_caches(slot),
            "block_tables": self._put(self.block_tables[slot:slot + 1]),
            "lengths": self._put(np.asarray([plen], np.int32)),
        }
        with torch.no_grad():
            out = tf.apply_model(self.params, self.cfg, batch,
                                 mode="prefill")
        self._merge_slot_caches(slot, out.caches)
        self.lengths[slot] = plen
        nxt = sample_tokens(out.logits[0, plen - 1][None], self._gen,
                            self.temperature)[0]
        seq.output.append(int(nxt))

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # Per-slot cache views: pages are global (shared pool), so attention
    # caches pass through whole; only batch-indexed leaves (none for
    # attention-only archs) would need slicing.
    def _slot_caches(self, slot: Optional[int]) -> Any:
        return self.caches

    def _merge_slot_caches(self, slot: Optional[int], new_caches: Any
                           ) -> None:
        self.caches = new_caches

    # -- disaggregated resolution (resolver="tiara") -----------------------

    def _expert_request(self, seq: Sequence) -> List[int]:
        """The expert routes this step resolves through the fabric.
        The real router's top-k runs inside the decode step; the
        descriptor-level resolution here derives a deterministic route
        from the step's input token, so the *translation layer* (the
        expert-id -> slab indirection of paper §4.5) is exercised and
        audited end to end without forking the decode step."""
        assert self._moe is not None
        basis = seq.output[-1] if seq.output else \
            (seq.prompt[-1] if seq.prompt else 0)
        return [(int(basis) + j) % self._moe.n_experts
                for j in range(self._moe.max_k)]

    def _resolve_block_tables(self, slots: List[int]) -> np.ndarray:
        """One fabric round trip: resolve every active slot's block
        table (and expert routes) through the endpoint; sequences whose
        resolution fails (timeout / fault / flush / reject) terminate
        with that status through their handles.  Returns the decode
        step's block tables built from the fabric replies."""
        assert self._resolver is not None
        expert_reqs: Dict[int, List[int]] = {}
        if self._moe is not None:
            for slot in slots:
                seq = self.active[slot]
                assert seq is not None
                expert_reqs[slot] = self._expert_request(seq)
        kv, experts = self._resolver.resolve_step(slots, expert_reqs)
        bt = self.block_tables.copy()
        for slot in slots:
            seq = self.active[slot]
            assert seq is not None
            res = kv[slot]
            failed: Optional[Completion] = None
            if isinstance(res, Completion):
                failed = res
            elif experts.get(slot) is not None:
                failed = experts[slot]
            if failed is not None:
                self._finish(seq, status=int(failed.status),
                             fault=failed.fault)
                continue
            bt[slot] = np.asarray(res, np.int32)
        return bt

    # -- engine step -----------------------------------------------------------

    def step(self) -> Dict[int, List[int]]:
        """Admit + decode one token for every active sequence."""
        self._admit()
        slots = [i for i, s in enumerate(self.active) if s is not None]
        if not slots:
            return self.results()
        if self._resolver is not None:
            bt = self._resolve_block_tables(slots)
            slots = [i for i, s in enumerate(self.active)
                     if s is not None]
            if not slots:
                return self.results()
        else:
            bt = self.block_tables
        tokens = np.zeros((self.max_slots, 1), np.int32)
        for i, seq in enumerate(self.active):
            if seq is not None and seq.output:
                tokens[i, 0] = seq.output[-1]
        batch = {
            "tokens": self._put(tokens),
            "caches": self.caches,
            "block_tables": self._put(bt),
            "lengths": self._put(self.lengths),
        }
        with torch.no_grad():
            out = tf.apply_model(self.params, self.cfg, batch,
                                 mode="decode")
        self.caches = out.caches
        nxt = sample_tokens(out.logits[:, 0], self._gen, self.temperature)
        for slot in slots:
            seq = self.active[slot]
            assert seq is not None
            self.lengths[slot] += 1
            tok = int(nxt[slot])
            seq.output.append(tok)
            if (tok == self.eos_id
                    or len(seq.output) >= seq.max_new
                    or self.lengths[slot] >= self.max_seq - 1):
                self._finish(seq)
        return self.results()

    def results(self) -> Dict[int, List[int]]:
        out = dict(self.completed)
        for seq in list(self.waiting) + [s for s in self.active if s]:
            out[seq.sid] = list(seq.output)
        return out

    def run_until(self, sid: int, max_steps: int = 10_000
                  ) -> SequenceHandle:
        """Step the engine until sequence ``sid`` reaches a terminal
        state (bounded; raises rather than hangs)."""
        handle = self._handles[sid]
        steps = 0
        while not handle.done and not self.finished():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"sequence {sid} did not finish in "
                    f"{max_steps} steps")
        if not handle.done:
            # engine drained without the sequence reaching a slot
            raise RuntimeError(f"sequence {sid} was never scheduled")
        return handle

    def run_to_completion(self, max_steps: int = 10_000
                          ) -> Dict[int, List[int]]:
        steps = 0
        while not self.finished() and steps < max_steps:
            self.step()
            steps += 1
        return self.results()

    # -- audits -----------------------------------------------------------

    @property
    def resolver(self) -> Optional[TiaraResolver]:
        """The tiara resolver backing this engine (None on the host
        path) — exposed for benches/tests that instrument the fabric
        (``resolver.on_wave``) or drive faults."""
        return self._resolver

    def resolver_audit(self) -> Dict[str, float]:
        """The tiara resolver's rehome/traffic audit (empty dict on the
        host path)."""
        return {} if self._resolver is None else self._resolver.audit()
