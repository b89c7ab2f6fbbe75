"""Tiara-backed KV / expert resolution for the serving engine.

This is the end-to-end disaggregated decode path of paper §4.5–4.6: the
engine's block tables and KV page pool live as *endpoint regions* on a
memory node, and every decode step resolves its paged-KV block table by
posting the stock :class:`~repro_torch.core.operators.PagedKVFetch` operator
from a per-sequence session (queue pair) through the
:class:`~repro_torch.core.serving_loop.ServingLoop` — admission control,
deadlines, QoS, fault semantics, and the registration-time no-conflict
proofs all apply unchanged.  MoE models additionally resolve each step's
expert routes through :class:`~repro_torch.core.operators.MoEExpertGather`.

What travels over the simulated fabric is the *indirection layer*: the
region geometry comes from :meth:`BlockAllocator.region_layout`, the
memory node holds the block table (logical block -> physical page) plus
one descriptor word per KV page / expert slab, and the operator's
remote-reply MEMCPY streams the resolved descriptors straight to the
requesting client's device row — one round trip per step, resolution
chained on the memory side (the paper's disaggregated PagedAttention
configuration, at descriptor granularity so every fetched word is
checkable against the host-resolved truth).

Adaptive re-homing (INDIGO-style): every resolution audits which device
accessed which region (:meth:`TiaraEndpoint.note_access`); every
``rehome_every`` steps the resolver migrates a sequence's regions to its
hottest accessor via the endpoint's control-path
:meth:`~repro_torch.core.endpoint.TiaraEndpoint.rehome`, turning cross-device
reply traffic into home-local traffic while the engine keeps serving.
The same audit feeds the cost model's home-skew EWMA, which
``choose_placement`` prices sharded waves with.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import costmodel as cm
from repro_torch.core import isa
from repro_torch.core import serving_loop as sl
from repro_torch.core.endpoint import (Completion, EndpointError, Session,
                                       TiaraEndpoint)
from repro_torch.core.memory import RegionTable
from repro_torch.core.operators import MoEExpertGather
from repro_torch.serving.allocator import BlockAllocator

#: A resolved slot: the block-table row (ndarray) on success, or the
#: failed Completion (timed out / flushed / faulted / rejected).
ResolvedKV = Union[np.ndarray, Completion]

_KV_REGIONS = ("req", "blocktable", "kvpool", "reply")
_EXP_REGIONS = ("expert_ids", "expert_table", "weights", "reply")


def expert_layout(n_experts: int, *, max_k: int,
                  slab_bytes: int = isa.WORD_BYTES,
                  reply_slots: int = 1) -> MoEExpertGather:
    """The endpoint-registrable layout for an expert routing table: a
    :class:`MoEExpertGather` workload sized for ``n_experts`` experts
    with top-``max_k`` routing.  The serving resolver uses descriptor
    slabs (``slab_bytes=8``, one word per expert) so the route — not
    the weights — crosses the fabric; benches size ``slab_bytes`` up to
    the paper's 8 KB slabs."""
    return MoEExpertGather(
        n_experts=int(n_experts), max_k=int(max_k),
        slab_words=max(1, int(slab_bytes) // isa.WORD_BYTES),
        reply_slots=int(reply_slots))


class TiaraResolver:
    """Per-sequence-session KV/expert resolution over one endpoint.

    One slot = one decode lane of the engine = one tenant (queue pair)
    ``seq<i>`` holding its own req/blocktable/kvpool-descriptor/reply
    regions (plus ``exp<i>`` regions when MoE routing is on).  ``bind``
    writes a sequence's block table to the slot's home device;
    ``resolve_step`` posts one ``paged_kv_fetch`` per active slot (and
    one ``moe_expert_gather`` per expert request) through the serving
    loop, drains, and returns each slot's resolved block-table row read
    from the *client* device the operator's remote reply streamed to.

    ``device`` is where the endpoint keeps its pool — the CUDA card unless
    named (``device="cpu"`` in the tests); on the card every wave's
    gather chain runs the ``tiara_gather`` kernel.  ``mesh`` is the
    endpoint's: the ``n_homes``-shard mesh ``placement="sharded"`` (or
    ``"auto"``) runs the waves on.
    """

    def __init__(self, allocator: BlockAllocator, *, max_slots: int,
                 pages_per_seq: int, n_homes: int = 1,
                 moe: Optional[MoEExpertGather] = None,
                 deadline_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None,
                 loop_config: Optional[sl.ServingConfig] = None,
                 qos: Optional[Dict[str, sl.TenantQoS]] = None,
                 placement: str = "single",
                 rehome: bool = True, rehome_every: int = 8,
                 min_rehome_share: float = 0.5, device=None,
                 mesh=None) -> None:
        self.allocator = allocator
        self.max_slots = int(max_slots)
        self.pages_per_seq = int(pages_per_seq)
        self.n_homes = int(n_homes)
        self.deadline_s = deadline_s
        self.rehome_enabled = bool(rehome)
        self.rehome_every = int(rehome_every)
        self.min_rehome_share = float(min_rehome_share)
        # descriptor-granularity KV geometry: 8-byte blocks, so one pool
        # word per page and the reply row IS the block-table row
        self.kv = allocator.region_layout(
            block_bytes=isa.WORD_BYTES, max_req_blocks=self.pages_per_seq)
        self.moe = moe
        named: List[Tuple[str, RegionTable]] = [
            (self._kv_tenant(s), self.kv.regions())
            for s in range(self.max_slots)]
        if moe is not None:
            named += [(self._exp_tenant(s), moe.regions())
                      for s in range(self.max_slots)]
        kwargs: Dict[str, object] = {}
        if clock is not None:
            kwargs["clock"] = clock
        if sleep is not None:
            kwargs["sleep"] = sleep
        self.ep, sessions = TiaraEndpoint.for_tenants(
            named, n_devices=self.n_homes, device=device, mesh=mesh,
            **kwargs)
        self.kv_sessions: List[Session] = [
            sessions[self._kv_tenant(s)] for s in range(self.max_slots)]
        self.exp_sessions: List[Session] = [] if moe is None else [
            sessions[self._exp_tenant(s)] for s in range(self.max_slots)]
        for slot, sess in enumerate(self.kv_sessions):
            sess.register(self.kv.build(sess.view, remote_reply=True))
            self._seed_kv(slot, device=0)
        for slot, sess in enumerate(self.exp_sessions):
            assert moe is not None
            sess.register(moe.build(sess.view, remote_reply=True))
            self._seed_exp(slot, device=0)
        posts_per_step = self.max_slots * (2 if moe is not None else 1)
        cfg = loop_config if loop_config is not None else sl.ServingConfig(
            ring_size=max(1, posts_per_step),
            max_inflight_waves=1,
            max_pending=max(64, 2 * posts_per_step),
            placement=placement,
            opportunistic_poll=False)
        self.loop = sl.ServingLoop(self.ep, cfg, qos=qos)
        self.steps = 0
        self.waves = 0
        # modeled fabric time: cost-model prediction per launched wave
        # plus one client->node submit RTT (benches charge this to a
        # virtual clock via ``on_wave``)
        self.fabric_us = 0.0
        self.on_wave: Optional[Callable[[sl.PumpReport], None]] = None

    # -- naming -----------------------------------------------------------

    def _kv_tenant(self, slot: int) -> str:
        return f"seq{slot}"

    def _exp_tenant(self, slot: int) -> str:
        return f"exp{slot}"

    def _kv_region(self, slot: int, name: str) -> str:
        return f"{self._kv_tenant(slot)}{self.ep.sep}{name}"

    def _exp_region(self, slot: int, name: str) -> str:
        return f"{self._exp_tenant(slot)}{self.ep.sep}{name}"

    def client_of(self, slot: int) -> int:
        """The device row slot ``slot``'s decode lane reads replies
        from (the "client GPU" of the disaggregated setup)."""
        return slot % self.n_homes

    def home_of(self, slot: int) -> int:
        """The device row currently homing slot ``slot``'s regions."""
        return self.ep.home_of(self._kv_region(slot, "kvpool"))

    # -- region content (descriptor tables) --------------------------------

    def _seed_kv(self, slot: int, *, device: int) -> None:
        sess = self.kv_sessions[slot]
        bw = self.kv.block_words
        # req: the decode lane always asks for its full logical table
        sess.write_region("req", list(range(self.pages_per_seq)),
                          device=device)
        # kvpool descriptors: word p of the pool names page p, so the
        # operator's gather returns exactly the physical page ids the
        # host-resolved path computes — bit-checkable indirection
        sess.write_region(
            "kvpool",
            [p // bw if p % bw == 0 else 0
             for p in range(self.allocator.n_pages * bw)],
            device=device)

    def _seed_exp(self, slot: int, *, device: int) -> None:
        assert self.moe is not None
        sess = self.exp_sessions[slot]
        sw = self.moe.slab_words
        # identity translation table + slab descriptors (slab e names e)
        sess.write_region(
            "expert_table",
            [e * sw for e in range(self.moe.n_experts)], device=device)
        sess.write_region(
            "weights",
            [w // sw if w % sw == 0 else 0
             for w in range(self.moe.n_experts * sw)], device=device)

    # -- binding -----------------------------------------------------------

    def bind(self, slot: int, pages: Sequence[int]) -> None:
        """Install a sequence's block table on slot ``slot``'s home:
        logical block j -> word offset of physical page ``pages[j]`` in
        the KV pool.  Resets the slot's sessions if a prior sequence
        errored them, and migrates the slot off a failed home device
        first (control-path recovery — the blade's DRAM row is still
        host-readable)."""
        if len(pages) != self.pages_per_seq:
            raise EndpointError(
                f"bind: slot {slot} expects {self.pages_per_seq} pages, "
                f"got {len(pages)}")
        sess = self.kv_sessions[slot]
        if sess.in_error:
            sess.reset()
        if self.exp_sessions and self.exp_sessions[slot].in_error:
            self.exp_sessions[slot].reset()
        home = self.home_of(slot)
        if home in self.ep.failed_devices:
            healthy = sorted(set(range(self.n_homes))
                             - self.ep.failed_devices)
            if not healthy:
                raise EndpointError(
                    f"bind: no healthy device to home slot {slot}")
            home = healthy[slot % len(healthy)]
            self._migrate(slot, home)
        bw = self.kv.block_words
        sess.write_region("blocktable",
                          [int(p) * bw for p in pages], device=home)

    def unbind(self, slot: int) -> None:
        """Release slot ``slot`` (the block-table row is overwritten by
        the next bind; nothing to tear down)."""

    # -- resolution (the per-decode-step data path) ------------------------

    def resolve_step(self, kv_slots: Sequence[int],
                     expert_reqs: Optional[
                         Dict[int, Sequence[int]]] = None
                     ) -> Tuple[Dict[int, ResolvedKV],
                                Dict[int, Optional[Completion]]]:
        """Resolve one decode step: post a ``paged_kv_fetch`` for every
        slot in ``kv_slots`` (and a ``moe_expert_gather`` for every
        ``slot -> expert ids`` entry in ``expert_reqs``) through the
        serving loop, drain, and collect.

        Returns ``(kv, experts)``: ``kv[slot]`` is the resolved
        block-table row (int32 ndarray) or the failed
        :class:`Completion`; ``experts[slot]`` is None on success (the
        gathered slab descriptors matched the requested expert ids) or
        the failed Completion."""
        expert_reqs = dict(expert_reqs or {})
        bw = self.kv.block_words
        # control-path writes strictly precede the wave launch
        for slot, eids in expert_reqs.items():
            self.exp_sessions[slot].write_region(
                "expert_ids", [int(e) for e in eids],
                device=self.home_of(slot))
        kv_posts: Dict[int, Completion] = {}
        exp_posts: Dict[int, Completion] = {}
        for slot in kv_slots:
            home, client = self.home_of(slot), self.client_of(slot)
            kv_posts[slot] = self.loop.submit(
                self._kv_tenant(slot), "paged_kv_fetch",
                [self.pages_per_seq, client], home=home,
                deadline_s=self.deadline_s)
            self.ep.note_access(self._kv_region(slot, "kvpool"), client,
                                self.pages_per_seq * bw)
        for slot, eids in expert_reqs.items():
            home, client = self.home_of(slot), self.client_of(slot)
            assert self.moe is not None
            exp_posts[slot] = self.loop.submit(
                self._exp_tenant(slot), "moe_expert_gather",
                [len(eids), client], home=home,
                deadline_s=self.deadline_s)
            self.ep.note_access(self._exp_region(slot, "weights"), client,
                                len(eids) * self.moe.slab_words)
        self._drain()
        kv_out: Dict[int, ResolvedKV] = {}
        for slot, c in kv_posts.items():
            if not c.ok:
                kv_out[slot] = c
                continue
            reply = self.kv_sessions[slot].read_region(
                "reply", device=self.client_of(slot),
                count=self.pages_per_seq * bw)
            kv_out[slot] = np.asarray(reply[0::bw], dtype=np.int32)
        exp_out: Dict[int, Optional[Completion]] = {}
        for slot, c in exp_posts.items():
            if not c.ok:
                exp_out[slot] = c
                continue
            assert self.moe is not None
            sw = self.moe.slab_words
            eids = [int(e) for e in expert_reqs[slot]]
            reply = self.exp_sessions[slot].read_region(
                "reply", device=self.client_of(slot),
                count=len(eids) * sw)
            got = [int(x) for x in reply[0::sw]]
            if got != eids:
                raise EndpointError(
                    f"expert gather integrity: slot {slot} asked "
                    f"{eids}, fabric returned {got}")
            exp_out[slot] = None
        for sess in self.kv_sessions:
            sess.poll_cq()
        for sess in self.exp_sessions:
            sess.poll_cq()
        self.steps += 1
        if self.rehome_enabled and self.rehome_every > 0 \
                and self.steps % self.rehome_every == 0:
            self.maybe_rehome()
        return kv_out, exp_out

    def _drain(self) -> None:
        """Launch and retire everything submitted this step (stalled
        tenants wait through the endpoint's sleep hook; bounded, never
        hangs)."""
        loop = self.loop
        pumps = 0
        while loop.backlog > 0:
            report = loop.pump(force=True)
            if report.launched:
                self.waves += 1
                self.fabric_us += report.predicted_us \
                    + cm.DEFAULT_HW.rtt_us
                if self.on_wave is not None:
                    self.on_wave(report)
            elif loop.backlog > 0:
                now = self.ep._clock()
                stalls = [u for u in self.ep._stalls.values() if u > now]
                self.ep._sleep((min(stalls) - now) if stalls
                               else loop.config.block_poll_s)
            pumps += 1
            if pumps > 10_000:
                raise RuntimeError(
                    f"resolver drain did not converge "
                    f"(backlog {loop.backlog})")
        self.ep.wait_all()
        self.loop.harvest()

    # -- adaptive re-homing ------------------------------------------------

    def _migrate(self, slot: int, device: int) -> int:
        moved = 0
        for name in _KV_REGIONS:
            moved += self.ep.rehome(self._kv_region(slot, name), device)
        if self.moe is not None:
            for name in _EXP_REGIONS:
                moved += self.ep.rehome(self._exp_region(slot, name),
                                        device)
        return moved

    def maybe_rehome(self) -> int:
        """One migration sweep: move every slot whose access audit shows
        a dominant (``min_rehome_share``) remote accessor to that
        device.  Returns the words migrated."""
        moved = 0
        for slot in range(self.max_slots):
            counts = self.ep.access_counts(self._kv_region(slot, "kvpool"))
            total = int(counts.sum())
            if total <= 0:
                continue
            hot = int(counts.argmax())
            if hot == self.home_of(slot) or hot in self.ep.failed_devices:
                continue
            if int(counts[hot]) < total * self.min_rehome_share:
                continue
            moved += self._migrate(slot, hot)
        return moved

    def audit(self) -> Dict[str, float]:
        """The rehome/traffic audit: migrations performed, words moved,
        cross-device reply words served, the learned home skew, and the
        modeled fabric time."""
        skew = self.ep.cost_model.home_skew()
        return {
            "rehomes": float(self.ep.rehome_count),
            "rehomed_words": float(self.ep.rehomed_words),
            "cross_device_words": float(self.ep.cross_device_words),
            "home_skew": float(skew) if skew is not None else 0.0,
            "fabric_us": float(self.fabric_us),
            "waves": float(self.waves),
        }
