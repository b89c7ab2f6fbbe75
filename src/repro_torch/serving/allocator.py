"""Paged KV block allocator — vLLM-style free list over the page pool.

This block table is exactly the paper's "block-indirection table": the
engine registers it (and the KV pool) as Tiara memory regions so a remote
node can resolve logical block -> physical page on the *memory side* in
one round trip.  :meth:`BlockAllocator.region_layout` is the one place
that maps an allocator's pool geometry to the endpoint region layout the
stock :class:`~repro_torch.core.operators.PagedKVFetch` operator runs
against — the serving resolver (serving/resolver.py) constructs its
tables through it, as the reference's example and benchmarks do, so the
region geometry and the serving path cannot drift.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import isa
from repro_torch.core.operators import PagedKVFetch


class OutOfPages(RuntimeError):
    """Pool exhausted.  Carries the structured demand so callers can
    size backpressure decisions (``needed`` pages requested vs ``free``
    pages available) instead of parsing the message."""

    def __init__(self, needed: int, free: int) -> None:
        super().__init__(f"need {needed} pages, {free} free")
        self.needed = int(needed)
        self.free = int(free)


class BlockAllocator:
    def __init__(self, n_pages: int) -> None:
        self.n_pages = int(n_pages)
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._owner: Dict[int, int] = {}     # page -> seq id

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int, owner: int) -> List[int]:
        if n > len(self._free):
            raise OutOfPages(n, len(self._free))
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = owner
        return pages

    def alloc_many(self, owners: Sequence[Tuple[int, int]]
                   ) -> Dict[int, List[int]]:
        """Batch allocation: ``owners`` is ``[(owner, n_pages), ...]``.
        All-or-nothing — either every owner gets its pages or the pool
        is left untouched and :class:`OutOfPages` carries the *total*
        demand, so a scheduler admitting a batch of sequences never
        half-admits."""
        need = sum(int(n) for _, n in owners)
        if need > len(self._free):
            raise OutOfPages(need, len(self._free))
        return {int(owner): self.alloc(int(n), int(owner))
                for owner, n in owners}

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p in self._owner:
                del self._owner[p]
                self._free.append(p)

    def owned_by(self, owner: int) -> List[int]:
        return [p for p, o in self._owner.items() if o == owner]

    def utilization(self) -> float:
        return 1.0 - len(self._free) / self.n_pages

    def region_layout(self, *, block_bytes: int = isa.WORD_BYTES,
                      max_req_blocks: Optional[int] = None,
                      reply_slots: int = 1) -> PagedKVFetch:
        """The endpoint-registrable layout for THIS pool: a
        :class:`~repro_torch.core.operators.PagedKVFetch` workload whose
        block-table and KV-pool regions are sized by the allocator's
        page count.  Callers get ``.regions()`` for registration and
        ``.build()`` for the resolver operator from one object, so the
        region geometry the engine serves against is definitionally the
        geometry the operator was verified against."""
        return PagedKVFetch(
            n_blocks_pool=self.n_pages,
            block_bytes=int(block_bytes),
            max_req_blocks=int(max_req_blocks if max_req_blocks is not None
                               else self.n_pages),
            reply_slots=int(reply_slots))
