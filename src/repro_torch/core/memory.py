"""Region-based disaggregated memory model.

A memory *pool* is the flat word-addressed DRAM of one host (one row of the
``(n_devices, pool_words)`` int64 array the VM executes against).  Hosts in
a Tiara deployment register *regions* — power-of-two-sized windows — and
grant sets of regions to tenants.  Operators address memory exclusively as
``(device, region_id, offset)``; the region id must be statically declared
(verified at registration), and the offset is masked by the region size, so
the data path performs no bounds check (DESIGN.md §2).

The same layout is shared by every host in the pool (a common simplification
for symmetric memory blades); per-host private layouts would only change the
bookkeeping here, not the ISA or the VM.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import isa


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def align_base(cursor: int, size: int) -> int:
    """First naturally aligned base >= ``cursor`` for a region of
    ``size`` words — THE alignment rule; every allocation walk
    (``RegionTable.register``, ``packed_table``, ``aligned_end``)
    shares it so capacity pre-checks can never diverge from the
    allocator."""
    if size <= 0:
        return cursor
    return (cursor + size - 1) & ~(size - 1)


@dataclasses.dataclass(frozen=True)
class Region:
    """A registered memory window (word granularity, power-of-two size)."""

    rid: int
    name: str
    base: int           # word offset within the host pool
    size: int           # words, power of two
    writable: bool = True

    def __post_init__(self):
        if not _is_pow2(self.size):
            raise ValueError(f"region {self.name}: size {self.size} not a power of two")
        if self.base < 0:
            raise ValueError(f"region {self.name}: negative base")

    @property
    def mask(self) -> int:
        return self.size - 1

    @property
    def end(self) -> int:
        return self.base + self.size


class RegionTable:
    """Host-side region registry; the static side of the memory subsystem.

    The table compiles to three dense int64 vectors (base/mask/writable)
    which the VM closes over as compile-time constants — region metadata
    never travels on the data path.
    """

    def __init__(self, pool_words: int):
        if pool_words <= 0:
            raise ValueError("pool must be non-empty")
        self.pool_words = int(pool_words)
        self._regions: List[Region] = []
        self._by_name: Dict[str, Region] = {}

    def register(self, name: str, size_words: int, *, base: Optional[int] = None,
                 writable: bool = True, align: bool = True) -> Region:
        """Register a region; allocates after the current high-water mark."""
        if name in self._by_name:
            raise ValueError(f"region {name!r} already registered")
        if base is None:
            base = self.high_water
            if align:
                # Align the base to the region size so wrapped offsets stay
                # inside naturally aligned hardware pages.
                base = align_base(base, size_words)
        region = Region(rid=len(self._regions), name=name, base=base,
                        size=size_words, writable=writable)
        if region.end > self.pool_words:
            raise ValueError(
                f"region {name!r} [{region.base}, {region.end}) exceeds pool "
                f"of {self.pool_words} words")
        for other in self._regions:
            if region.base < other.end and other.base < region.end:
                raise ValueError(f"region {name!r} overlaps {other.name!r}")
        self._regions.append(region)
        self._by_name[name] = region
        return region

    @property
    def high_water(self) -> int:
        return max((r.end for r in self._regions), default=0)

    def __len__(self) -> int:
        return len(self._regions)

    def __iter__(self):
        return iter(self._regions)

    def __getitem__(self, key) -> Region:
        if isinstance(key, str):
            return self._by_name[key]
        return self._regions[key]

    def rid(self, name: str) -> int:
        return self._by_name[name].rid

    def names(self) -> List[str]:
        return [r.name for r in self._regions]

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(base, mask, writable) int64 vectors, one entry per region."""
        n = len(self._regions)
        base = np.zeros(n, dtype=np.int64)
        mask = np.zeros(n, dtype=np.int64)
        writable = np.zeros(n, dtype=np.int64)
        for r in self._regions:
            base[r.rid] = r.base
            mask[r.rid] = r.mask
            writable[r.rid] = int(r.writable)
        return base, mask, writable


@dataclasses.dataclass(frozen=True)
class Grant:
    """A tenant's capability: which regions it may read / write.

    The verifier checks an operator's statically declared region accesses
    against its tenant's grant at registration time; after that the data
    path runs with no per-access check (the paper's multi-tenant story).
    """

    tenant: str
    readable: frozenset
    writable: frozenset

    @staticmethod
    def of(tenant: str, readable: Iterable[int],
           writable: Iterable[int] = ()) -> "Grant":
        readable = frozenset(int(r) for r in readable)
        writable = frozenset(int(w) for w in writable)
        return Grant(tenant=tenant, readable=readable | writable,
                     writable=writable)

    @staticmethod
    def all_of(table: RegionTable, tenant: str = "root") -> "Grant":
        rids = [r.rid for r in table]
        wids = [r.rid for r in table if r.writable]
        return Grant.of(tenant, rids, wids)


class RegionView:
    """A tenant-namespaced view of a shared :class:`RegionTable`.

    In a multi-tenant deployment every tenant's regions live in the *one*
    host pool behind the NIC, but each tenant programs against its own
    region names.  A view resolves name ``n`` to ``prefix + n`` in the
    backing table, so a stock workload builder (which hardcodes names like
    ``"reply"``) can target its slice of a combined table unmodified.
    Region ids stay global — programs built through a view carry the
    combined table's rids, which is exactly what the verifier checks a
    tenant grant against.  Iteration yields only the tenant's regions, so
    ``Grant.all_of(view)`` is the tenant's capability, not the pool's.
    """

    def __init__(self, table: RegionTable, prefix: str = ""):
        self._table = table
        self.prefix = prefix

    @property
    def table(self) -> RegionTable:
        return self._table

    @property
    def pool_words(self) -> int:
        return self._table.pool_words

    def rid(self, name: str) -> int:
        return self._table.rid(self.prefix + name)

    def __getitem__(self, key) -> Region:
        if isinstance(key, str):
            return self._table[self.prefix + key]
        return self._table[key]

    def __iter__(self):
        return (r for r in self._table if r.name.startswith(self.prefix))

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def names(self) -> List[str]:
        return [r.name for r in self]

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The *backing table's* arrays: rids in programs built through a
        view are global, so engines must see the full table."""
        return self._table.as_arrays()


def merge_tables(named: Sequence[Tuple[str, RegionTable]], *,
                 sep: str = "/") -> Tuple[RegionTable, Dict[str, RegionView]]:
    """Pack several per-tenant region layouts into one shared pool.

    ``named`` is ``[(tenant, table), ...]``; each tenant's regions are
    re-registered as ``tenant/sep/name`` in one combined table (packed, in
    order).  Returns the combined table plus per-tenant views — the setup
    a multi-tenant registry wants: register operators built against the
    views, grant each tenant ``Grant.all_of(view)``, and run every
    tenant's requests against one ``make_pool(n, combined)``.

    Tenant names must be unique and must not contain ``sep``: the view
    prefix is the isolation boundary, so a name like ``"a/b"`` next to
    tenant ``"a"`` would leak ``a/b``'s regions into ``a``'s grant.
    """
    seen = set()
    for tenant, _ in named:
        if sep in tenant:
            raise ValueError(
                f"tenant name {tenant!r} must not contain {sep!r} "
                f"(it would collide with another tenant's namespace)")
        if tenant in seen:
            raise ValueError(f"duplicate tenant name {tenant!r}")
        seen.add(tenant)
    specs: List[Tuple[str, int]] = []
    for tenant, table in named:
        for r in table:
            specs.append((f"{tenant}{sep}{r.name}", r.size))
    combined = packed_table(specs)
    views = {tenant: RegionView(combined, f"{tenant}{sep}")
             for tenant, _ in named}
    return combined, views


def aligned_end(cursor: int, regions: Iterable[Region]) -> int:
    """Pool end after appending ``regions`` at ``cursor`` with the same
    naturally-aligned walk :meth:`RegionTable.register` performs (every
    :class:`Region` size is a power of two >= 1 by construction).  The
    one place capacity pre-checks (e.g. endpoint tenant admission) and
    the allocator share the alignment rule."""
    for r in regions:
        cursor = align_base(cursor, r.size) + r.size
    return cursor


def next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def packed_table(specs: Sequence[Tuple[str, int]], *,
                 extra_words: int = 0) -> RegionTable:
    """Build a RegionTable sized exactly for ``specs`` (name, size_words
    rounded up to a power of two), accounting for natural alignment."""
    cursor = 0
    layout = []
    specs = [(name, next_pow2(size)) for name, size in specs]
    for name, size in specs:
        base = align_base(cursor, size)
        layout.append((name, base, size))
        cursor = base + size
    rt = RegionTable(pool_words=cursor + extra_words)
    for name, base, size in layout:
        rt.register(name, size, base=base)
    return rt


def make_pool(n_devices: int, table: RegionTable,
              fill: int = 0) -> np.ndarray:
    """Allocate the (n_devices, pool_words) int64 backing store."""
    mem = np.full((n_devices, table.pool_words), fill, dtype=np.int64)
    return mem


def pool_sharding(mesh, axis: str = "pool"):
    """The pool's mesh placement: the leading ``n_devices`` axis split
    over the 1-D device mesh (shard ``d`` holds row ``d`` — its blade's
    DRAM), words replicated along no other axis."""
    from repro_torch.distributed.mesh import P
    del mesh
    return P(axis, None)


def shard_pool(mem, mesh=None, axis: str = "pool"):
    """Place a ``(n_devices, pool_words)`` pool on a device mesh with
    :func:`pool_sharding` — shard-aware pool construction for the
    sharded VM engine (shard ``d`` owns ``mem[d]`` on mesh device
    ``d``).  ``mem`` is a numpy array, a tensor (a row already on its
    shard's device is a view, not a copy) or an already sharded pool,
    which passes through.  With no ``mesh`` a 1-D mesh over the first
    ``n_devices`` CUDA cards is built (raises when fewer are visible)."""
    import torch

    from repro_torch.distributed import mesh as _mesh
    if isinstance(mem, _mesh.Sharded):
        if mesh is not None and mem.mesh is not mesh:
            raise ValueError("the pool is sharded over another mesh")
        return mem
    if mesh is None:
        mesh = _mesh.make_device_mesh(int(mem.shape[0]), axis)
    if int(mem.shape[0]) != mesh.size:
        raise ValueError(f"a pool of {int(mem.shape[0])} rows on a mesh "
                         f"of {mesh.size} shards")
    if not isinstance(mem, torch.Tensor):
        mem = torch.from_numpy(np.asarray(mem, dtype=np.int64))
    return mesh.put(mem.to(torch.int64), pool_sharding(mesh, axis))


def write_region(mem: np.ndarray, table: RegionTable, device: int,
                 region: str, data: Sequence[int], offset: int = 0) -> None:
    """Host-side (control path) helper to populate a region."""
    r = table[region]
    data = np.asarray(data, dtype=np.int64)
    if offset + data.size > r.size:
        raise ValueError(f"write of {data.size} words at {offset} exceeds "
                         f"region {region!r} ({r.size} words)")
    mem[device, r.base + offset: r.base + offset + data.size] = data


def read_region(mem: np.ndarray, table: RegionTable, device: int,
                region: str, offset: int = 0,
                count: Optional[int] = None) -> np.ndarray:
    r = table[region]
    if count is None:
        count = r.size - offset
    if offset + count > r.size:
        raise ValueError("read exceeds region")
    return np.asarray(mem[device, r.base + offset: r.base + offset + count])


def bytes_to_words(n_bytes: int) -> int:
    return (n_bytes + isa.WORD_BYTES - 1) // isa.WORD_BYTES
