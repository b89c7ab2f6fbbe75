"""Device meshes, ``shard_map`` and the collectives — the port's
counterpart of ``repro.jaxcompat`` and of the JAX sharding machinery it
wraps (``Mesh``, ``PartitionSpec``, ``shard_map``, ``lax.psum`` ...).

The execution model is the reference's: **one process drives every
shard** (single controller).  A :class:`Mesh` is an array of
``torch.device``s with axis names — 1-D ``("pool",)`` for the sharded
engine, ``("data", "model")`` or ``("pod", "data")`` for the distributed
layer.  Several shards may name the same device (``[cuda:0] * 4`` runs
four shards on one card, as the reference's tests run several shards on
forced host devices of one CPU); the code is the same on four cards.

:func:`shard_map` runs ``f`` once per shard, each in its own host
thread.  Each input is split onto its shard's device by its spec (one
entry per leading dimension: an axis name, a tuple of names, or ``None``),
an input that is already per shard (:class:`Sharded`) passes through
with no copy, and each output either stays per shard (a :class:`Sharded`,
never concatenated on one device) or, when its spec names no axis, is
taken from shard 0.

Inside ``f`` the collectives :func:`psum`, :func:`pmax`, :func:`pmean`,
:func:`all_gather` and :func:`all_to_all`, and :func:`axis_index` /
:func:`axis_size`, act on the calling shard's group.  Exactly one shard
thread runs at a time: it runs to its next collective, publishes its
value and hands over to the next shard in rank order, so a round of
turns is one collective, after which every shard reads its group's
values.  Every shard must therefore make the same collectives in the
same order (SPMD, as in ``shard_map``).  Threads that take turns, rather
than run at once, keep the host's interpreter lock uncontended and the
launches of one card in one stream order.  Sums and maxima are taken in
ascending shard order, so every member of a group gets the same bits
every time.  A shard that raises fails the call with its error; every
wait has a timeout, and a shard that returns while another makes a
collective fails the call too, so no call hangs.  Nothing falls back: a
mesh never shrinks and a failed collective raises.

The mesh counts each collective call, the bytes its shards read from
other shards, and each call's result bytes on one device
(:attr:`Mesh.stats`) — the counterpart of counting the collectives in the
reference's compiled HLO (``roofline/analysis.py`` reads the last as the
reference reads the result shapes there).  On one card those bytes are
device copies (or no copy at all), not interconnect traffic.

A shard thread runs under the caller's grad mode and ``TorchDispatchMode``
stack (a FLOP or byte counter entered around a ``shard_map`` call sees
every shard's work), which are per thread in PyTorch.
"""

from __future__ import annotations

import contextlib
import math
import threading
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.utils._python_dispatch as _pydispatch

DEFAULT_TIMEOUT_S = 600.0

AxisNames = Union[str, Tuple[str, ...]]


class P:
    """A partition spec: one entry per leading dimension of a value —
    an axis name (the dimension is split over that mesh axis), a tuple of
    names (split over their product, the first one major), or ``None``
    (whole).  Missing trailing entries are ``None``; ``P()`` is
    replicated."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(tuple(e) if isinstance(e, list) else e
                             for e in entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and _norm(self) == _norm(other)

    def __hash__(self) -> int:
        return hash(_norm(self))

    def __repr__(self) -> str:
        return f"P{self.entries!r}"

    def names(self, i: int) -> Tuple[str, ...]:
        """The mesh axes dimension ``i`` is split over (``()`` = whole)."""
        e = self.entries[i] if i < len(self.entries) else None
        if e is None:
            return ()
        return (e,) if isinstance(e, str) else tuple(e)

    def axes(self) -> Tuple[str, ...]:
        return tuple(a for i in range(len(self.entries))
                     for a in self.names(i))


def _norm(spec: Optional[P]) -> Tuple:
    if spec is None:
        return ()
    out = [spec.names(i) for i in range(len(spec))]
    while out and not out[-1]:
        out.pop()
    return tuple(out)


class Mesh:
    """An n-D array of ``torch.device``s with axis names.  Shard ``rank``
    is the row-major position in that array; ``shape`` maps each axis to
    its size, as the JAX mesh's does."""

    def __init__(self, devices, axis_names: Sequence[str]):
        shape = np.asarray(devices, dtype=object).shape
        flat = _flatten(devices.tolist() if isinstance(devices, np.ndarray)
                        else devices)
        arr = np.empty(len(flat), dtype=object)
        for i, d in enumerate(flat):
            arr[i] = torch.device(d)
        arr = arr.reshape(shape)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {arr.shape} needs "
                             f"{arr.ndim} axis names, got "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"duplicate axis names {self.axis_names}")
        self.devices = arr
        self.shape: Dict[str, int] = dict(zip(self.axis_names, arr.shape))
        self.size = int(arr.size)
        self.stats: Dict[str, Counter] = {"calls": Counter(),
                                          "bytes": Counter(),
                                          "result_bytes": Counter()}
        self._stats_lock = threading.Lock()
        self._groups: Dict[Tuple[int, Tuple[str, ...]], List[int]] = {}

    def device(self, rank: int) -> torch.device:
        return self.devices.reshape(-1)[rank]

    @property
    def flat_devices(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    def coords(self, rank: int) -> Dict[str, int]:
        idx = np.unravel_index(rank, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def rank_of(self, coords: Dict[str, int]) -> int:
        return int(np.ravel_multi_index(
            tuple(coords[a] for a in self.axis_names), self.devices.shape))

    def reset_stats(self) -> None:
        with self._stats_lock:
            self.stats = {"calls": Counter(), "bytes": Counter(),
                          "result_bytes": Counter()}

    def collective_counts(self) -> Dict[str, int]:
        """Collective calls since the last :meth:`reset_stats`, by the
        HLO name of the operation (``all-reduce`` for psum / pmax /
        pmean)."""
        return dict(self.stats["calls"])

    def collective_bytes(self) -> Dict[str, int]:
        """Bytes the shards read from other shards, by operation."""
        return dict(self.stats["bytes"])

    def collective_result_bytes(self) -> Dict[str, int]:
        """The result bytes of each collective call on one participating
        shard, summed by operation: what the reference's
        ``roofline.analysis.collective_bytes`` reads off each collective's
        result shape in the compiled HLO."""
        return dict(self.stats["result_bytes"])

    def put(self, x: torch.Tensor, spec: P) -> "Sharded":
        """Place a global tensor on the mesh by ``spec`` (the counterpart
        of ``jax.device_put`` with a ``NamedSharding``): each shard gets
        its block on its device — a view, with no copy, where ``x``
        already lies on that device."""
        return Sharded(self, spec, [
            _local_block(self, x, spec, r).to(self.device(r))
            for r in range(self.size)])

    def __repr__(self) -> str:
        devs = [str(d) for d in self.flat_devices]
        return f"Mesh({self.shape}, devices={devs})"


def _flatten(x) -> List[Any]:
    if isinstance(x, (list, tuple)):
        return [y for e in x for y in _flatten(e)]
    return [x]


def device_count(device_type: str = "cuda") -> int:
    """The devices of ``device_type`` this process sees (the counterpart
    of ``jaxcompat.device_count``); the CPU counts as one."""
    if device_type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
    return 1


def make_device_mesh(n_devices: int, axis: str = "pool",
                     devices: Optional[Sequence] = None,
                     device_type: str = "cuda") -> Mesh:
    """A 1-D mesh of ``n_devices`` shards: over ``devices`` when given
    (several shards may name one device), else over the first
    ``n_devices`` visible devices of ``device_type``.  Raises, as
    ``jaxcompat.make_device_mesh`` does, when fewer are visible — the
    mesh never quietly shrinks."""
    n = int(n_devices)
    if devices is not None:
        devices = list(devices)
        if len(devices) != n:
            raise ValueError(f"a mesh of {n} shards needs {n} devices, "
                             f"got {len(devices)}")
        return Mesh(devices, (axis,))
    have = device_count(device_type)
    if have < n:
        raise RuntimeError(
            f"sharded execution needs {n} devices but this process sees "
            f"{have} {device_type} device(s); pass devices= (e.g. "
            f"['cuda:0'] * {n} or ['cpu'] * {n}) to run several shards on "
            f"one device")
    if device_type == "cuda":
        return Mesh([torch.device("cuda", i) for i in range(n)], (axis,))
    return Mesh([torch.device(device_type)] * n, (axis,))


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Sequence) -> Mesh:
    """An n-D mesh of ``prod(shape)`` shards over the flat ``devices``
    list (row-major), e.g. ``make_mesh((2, 2), ("data", "model"),
    ["cuda:0"] * 4)``."""
    devices = list(devices)
    n = math.prod(int(s) for s in shape)
    if len(devices) != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} devices, got "
                         f"{len(devices)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return Mesh(arr.reshape(tuple(int(s) for s in shape)), axis_names)


# ---------------------------------------------------------------------------
# per-shard values
# ---------------------------------------------------------------------------


def _split_index(mesh: Mesh, names: Tuple[str, ...], rank: int
                 ) -> Tuple[int, int]:
    """(piece index, number of pieces) of shard ``rank`` over ``names``."""
    c = mesh.coords(rank)
    idx, k = 0, 1
    for a in names:
        idx = idx * mesh.shape[a] + c[a]
        k *= mesh.shape[a]
    return idx, k


def _local_block(mesh: Mesh, x: torch.Tensor, spec: Optional[P],
                 rank: int) -> torch.Tensor:
    if spec is None:
        return x
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the value's "
                         f"{x.dim()} dimensions")
    for i in range(len(spec)):
        names = spec.names(i)
        if not names:
            continue
        for a in names:
            if a not in mesh.shape:
                raise ValueError(f"spec {spec} names axis {a!r}, not in "
                                 f"the mesh's {mesh.axis_names}")
        idx, k = _split_index(mesh, names, rank)
        size = int(x.shape[i])
        if size % k:
            raise ValueError(f"dimension {i} of size {size} does not "
                             f"split over {names} ({k} pieces)")
        x = x.narrow(i, idx * (size // k), size // k)
    return x


class Sharded:
    """A value kept per shard: ``shards[r]`` is shard ``r``'s block on
    its mesh device, laid out by ``spec`` (shards that differ only on
    axes the spec does not name hold replicas).  It stays per shard
    across calls; :meth:`full` is the explicit gather onto one device."""

    def __init__(self, mesh: Mesh, spec: P, shards: Sequence[torch.Tensor]):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of "
                             f"{mesh.size}")
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P()
        self.shards = list(shards)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def is_cuda(self) -> bool:
        return self.shards[0].is_cuda

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        for i in range(len(s)):
            names = self.spec.names(i)
            if names:
                s[i] *= math.prod(self.mesh.shape[a] for a in names)
        return torch.Size(s)

    def __getitem__(self, i: int) -> "Sharded":
        """Index a leading dimension the spec does not split (e.g. the
        layer of a stacked weight): the same index on every shard."""
        if not isinstance(i, int) or self.spec.names(0):
            raise TypeError("a Sharded value takes an int index on an "
                            "unsplit leading dimension only")
        return Sharded(self.mesh, P(*self.spec.entries[1:]),
                       [s[i] for s in self.shards])

    def canonical_ranks(self) -> List[int]:
        """One rank per distinct block: the replica at coordinate 0 of
        every axis the spec does not name."""
        named = set(self.spec.axes())
        return [r for r in range(self.mesh.size)
                if all(v == 0 for a, v in self.mesh.coords(r).items()
                       if a not in named)]

    def full(self, device=None) -> torch.Tensor:
        """The global value gathered onto ``device`` (shard 0's unless
        named) — a copy, made only where a caller asks for it."""
        dev = torch.device(device) if device is not None else self.device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for r in self.canonical_ranks():
            blk = out
            for i in range(len(self.spec)):
                names = self.spec.names(i)
                if names:
                    idx, k = _split_index(self.mesh, names, r)
                    n = int(self.shape[i]) // k
                    blk = blk.narrow(i, idx * n, n)
            blk.copy_(self.shards[r])
        return out

    def cpu(self) -> torch.Tensor:
        return self.full("cpu")

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.spec}, mesh={self.mesh.shape})")


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

_local = threading.local()


class _Aborted(Exception):
    """The call was aborted while this shard waited in a collective:
    another shard raised, stalled or took another branch."""


class _Run:
    """The shared state of one shard_map call.  Exactly one shard thread
    runs at a time — it holds the baton — and runs to its next collective
    (or its end), then passes the baton to the next shard in rank order
    still running.  A turn of every shard is one collective round."""

    def __init__(self, mesh: Mesh, timeout: float):
        n = mesh.size
        self.mesh = mesh
        self.timeout = timeout
        # go[r] is held while shard r must wait; releasing it hands r
        # the baton
        self.go = [threading.Lock() for _ in range(n)]
        for g in self.go:
            g.acquire()
        self.state = ["run"] * n        # run | coll | done | error
        self.calls = [0] * n            # collectives made (final at end)
        self.slots: List[List[Any]] = [[None] * n, [None] * n]
        self.aborted: Optional[str] = None
        self.lock = threading.Lock()
        self.live = n
        self.all_done = threading.Event()

    def next_live(self, r: int) -> Optional[int]:
        n = self.mesh.size
        for i in range(1, n + 1):
            j = (r + i) % n
            if self.state[j] not in ("done", "error"):
                return j
        return None

    def abort(self, why: str) -> None:
        """Fail the call: every waiting shard wakes and raises."""
        if self.aborted is None:
            self.aborted = why
        for r, st in enumerate(self.state):
            if st not in ("done", "error"):
                try:
                    self.go[r].release()
                except RuntimeError:        # not held: r is running
                    pass


class _Shard:
    def __init__(self, run: _Run, rank: int):
        self.run = run
        self.rank = rank
        self.coords = run.mesh.coords(rank)
        self.device = run.mesh.device(rank)
        self.calls = 0


def _ctx() -> _Shard:
    c = getattr(_local, "ctx", None)
    if c is None:
        raise RuntimeError("collectives run only inside shard_map")
    return c


def _axes(a: AxisNames) -> Tuple[str, ...]:
    return (a,) if isinstance(a, str) else tuple(a)


def axis_index(a: AxisNames) -> int:
    """The calling shard's index along ``a`` (a tuple of axes: the
    linear index over them, the first major)."""
    c = _ctx()
    idx, _ = _split_index(c.run.mesh, _axes(a), c.rank)
    return idx


def axis_size(a: AxisNames) -> int:
    mesh = _ctx().run.mesh
    return math.prod(mesh.shape[n] for n in _axes(a))


def _group(c: _Shard, axes: Tuple[str, ...]) -> List[int]:
    """The ranks of the calling shard's group over ``axes``, in linear
    order over them (the first axis major)."""
    mesh = c.run.mesh
    key = (c.rank, axes)
    grp = mesh._groups.get(key)
    if grp is None:
        grp = mesh._groups[key] = _make_group(mesh, c.coords, axes)
    return grp


def _make_group(mesh: Mesh, coords: Dict[str, int],
                axes: Tuple[str, ...]) -> List[int]:
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"unknown mesh axis {a!r}; the mesh has "
                             f"{mesh.axis_names}")
    sizes = [mesh.shape[a] for a in axes]
    out = []
    for idx in np.ndindex(*sizes):
        co = dict(coords)
        co.update(zip(axes, (int(i) for i in idx)))
        out.append(mesh.rank_of(co))
    return out


def _yield(c: _Shard, state: str) -> None:
    """End this shard's turn: pass the baton to the next running shard
    and, unless this shard has finished, wait for it to come back."""
    run, r = c.run, c.rank
    with run.lock:
        run.state[r] = state
        run.calls[r] = c.calls
        if state == "error":
            run.abort("shard_map: a shard raised")
        elif state == "done":
            if any(run.state[j] == "coll" and run.calls[j] > c.calls
                   for j in range(run.mesh.size)):
                run.abort("shard_map: the shards diverged: a shard "
                          "returned while another made a collective")
        elif any(run.state[j] == "done" and run.calls[j] < c.calls
                 for j in range(run.mesh.size)):
            run.abort("shard_map: the shards diverged: a shard made a "
                      "collective after another returned")
        if state in ("done", "error"):
            run.live -= 1
            if run.live == 0:
                run.all_done.set()
        if run.aborted is None:
            nxt = run.next_live(r)
            if nxt is not None and nxt != r:
                run.go[nxt].release()
            elif nxt == r:
                run.go[r].release()         # the only shard left
    if state in ("done", "error"):
        return
    if not run.go[r].acquire(timeout=run.timeout):
        with run.lock:
            run.abort(f"shard_map: shard {r} waited more than "
                      f"{run.timeout} s for the others")
    if run.aborted is not None:
        raise _Aborted()


def _exchange(x) -> List[Any]:
    """Publish ``x`` in this shard's slot, wait until every shard has
    published its own, and return every shard's value (by rank).  The
    slots alternate between two buffers: round ``k + 1`` cannot begin to
    overwrite round ``k``'s before every shard has read it."""
    c = _ctx()
    run = c.run
    slot = run.slots[c.calls % 2]
    c.calls += 1
    slot[c.rank] = x
    if run.mesh.size > 1:
        _yield(c, "coll")
    return list(slot)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _count(c: _Shard, op: str, moved: int,
           result: torch.Tensor) -> torch.Tensor:
    """Tally one collective and its result's bytes (once, by rank 0) and
    the bytes this shard read from other shards; returns ``result``."""
    mesh = c.run.mesh
    with mesh._stats_lock:
        if c.rank == 0:
            mesh.stats["calls"][op] += 1
            mesh.stats["result_bytes"][op] += _nbytes(result)
        mesh.stats["bytes"][op] += moved
    return result


def _reduce(x: torch.Tensor, axes: AxisNames, fn) -> torch.Tensor:
    c = _ctx()
    vals = _exchange(x)
    grp = _group(c, _axes(axes))
    if grp != sorted(grp):
        grp = sorted(grp)
    acc = vals[grp[0]].to(c.device)
    for r in grp[1:]:
        acc = fn(acc, vals[r].to(c.device))
    return _count(c, "all-reduce",
                  sum(_nbytes(vals[r]) for r in grp if r != c.rank), acc)


def psum(x: torch.Tensor, axes: AxisNames) -> torch.Tensor:
    """Sum over the group, in ascending shard order (the same bits on
    every member)."""
    return _reduce(x, axes, torch.add)


def pmax(x: torch.Tensor, axes: AxisNames) -> torch.Tensor:
    return _reduce(x, axes, torch.maximum)


def pmean(x: torch.Tensor, axes: AxisNames) -> torch.Tensor:
    return psum(x, axes) / axis_size(axes)


def all_gather(x: torch.Tensor, axes: AxisNames, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every member's ``x`` in group order: stacked at a new dimension
    ``axis``, or concatenated along it with ``tiled``."""
    c = _ctx()
    vals = _exchange(x)
    grp = _group(c, _axes(axes))
    parts = [vals[r].to(c.device) for r in grp]
    out = torch.cat(parts, dim=axis) if tiled \
        else torch.stack(parts, dim=axis)
    return _count(c, "all-gather",
                  sum(_nbytes(vals[r]) for r in grp if r != c.rank), out)


def all_to_all(x: torch.Tensor, axes: AxisNames, split_axis: int,
               concat_axis: int, *, tiled: bool = False) -> torch.Tensor:
    """Split ``x`` along ``split_axis`` into one chunk per member; member
    ``j`` receives chunk ``j`` of every member, concatenated along
    ``concat_axis`` in group order (without ``tiled`` the chunks are of
    size one, dropped and stacked at ``concat_axis``)."""
    c = _ctx()
    vals = _exchange(x)
    grp = _group(c, _axes(axes))
    g, me = len(grp), grp.index(c.rank)
    size = int(x.shape[split_axis])
    if size % g:
        raise ValueError(f"all_to_all: dimension {split_axis} of size "
                         f"{size} does not split in {g}")
    n = size // g
    if not tiled and n != 1:
        raise ValueError("all_to_all without tiled needs the split "
                         "dimension's size to equal the group's")
    parts = [vals[r].narrow(split_axis, me * n, n) for r in grp]
    moved = sum(_nbytes(p) for r, p in zip(grp, parts) if r != c.rank)
    parts = [p.to(c.device) for p in parts]
    if tiled:
        out = torch.cat(parts, dim=concat_axis)
    else:
        out = torch.stack([p.squeeze(split_axis) for p in parts],
                          dim=concat_axis)
    return _count(c, "all-to-all", moved, out)


def _is_spec(s) -> bool:
    return s is None or isinstance(s, P)


def _map_spec(fn: Callable[[Optional[P], Any], Any], spec, x):
    """Apply ``fn(spec, leaf)`` over ``x``; ``spec`` is a prefix of
    ``x``'s tree (a spec, or a dict / tuple / list of them)."""
    if _is_spec(spec):
        return _map_leaves(lambda leaf: fn(spec, leaf), x)
    if isinstance(spec, dict):
        return {k: _map_spec(fn, spec[k], x[k]) for k in x}
    if isinstance(spec, (tuple, list)):
        if len(spec) != len(x):
            raise ValueError(f"spec tree {spec!r} does not match a value "
                             f"of {len(x)} entries")
        vals = [_map_spec(fn, s, v) for s, v in zip(spec, x)]
        if hasattr(x, "_fields"):           # a NamedTuple
            return type(x)(*vals)
        return type(x)(vals)
    raise TypeError(f"bad spec {spec!r}")


def _map_leaves(fn, x):
    if isinstance(x, dict):
        return {k: _map_leaves(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        vals = [_map_leaves(fn, v) for v in x]
        if hasattr(x, "_fields"):
            return type(x)(*vals)
        return type(x)(vals)
    return fn(x)


def _local_in(mesh: Mesh, rank: int, spec: Optional[P], x):
    if isinstance(x, Sharded):
        if x.mesh is not mesh:
            raise ValueError("a Sharded input belongs to another mesh")
        if _norm(x.spec) != _norm(spec):
            raise ValueError(f"a Sharded input laid out as {x.spec} is "
                             f"passed where the spec is {spec}")
        return x.shards[rank]
    if isinstance(x, torch.Tensor):
        return _local_block(mesh, x, spec, rank).to(mesh.device(rank))
    return x


def _shard_out(mesh: Mesh, spec: Optional[P], vals: List[Any]):
    if not _norm(spec) or not isinstance(vals[0], torch.Tensor):
        return vals[0]
    return Sharded(mesh, spec, vals)


def _out_tree(mesh: Mesh, spec, results: List[Any]):
    if _is_spec(spec):
        first = results[0]
        if isinstance(first, (dict, tuple, list)):
            return _zip_leaves(lambda vals: _shard_out(mesh, spec, vals),
                               results)
        return _shard_out(mesh, spec, results)
    if isinstance(spec, dict):
        return {k: _out_tree(mesh, spec[k], [r[k] for r in results])
                for k in results[0]}
    vals = [_out_tree(mesh, s, [r[i] for r in results])
            for i, s in enumerate(spec)]
    first = results[0]
    if hasattr(first, "_fields"):
        return type(first)(*vals)
    return type(first)(vals)


def _zip_leaves(fn, results: List[Any]):
    first = results[0]
    if isinstance(first, dict):
        return {k: _zip_leaves(fn, [r[k] for r in results]) for k in first}
    if isinstance(first, (tuple, list)):
        vals = [_zip_leaves(fn, [r[i] for r in results])
                for i in range(len(first))]
        if hasattr(first, "_fields"):
            return type(first)(*vals)
        return type(first)(vals)
    return fn(results)


def shard_map(f: Callable, mesh: Mesh, in_specs, out_specs, *,
              timeout: float = DEFAULT_TIMEOUT_S) -> Callable:
    """``f`` run once per shard of ``mesh`` (see the module docstring).
    ``in_specs`` holds one spec (or spec tree) per positional argument
    (a single spec for a single argument); ``out_specs`` mirrors ``f``'s
    result.  ``timeout`` bounds every wait, in seconds."""
    specs_in = tuple(in_specs) if isinstance(in_specs, (tuple, list)) \
        else (in_specs,)

    def run(*args):
        if len(args) != len(specs_in):
            raise TypeError(f"shard_map: {len(args)} arguments for "
                            f"{len(specs_in)} in_specs")
        if getattr(_local, "ctx", None) is not None:
            raise RuntimeError("shard_map does not nest")
        local = [[_map_spec(lambda s, x, r=r: _local_in(mesh, r, s, x),
                            spec, a)
                  for spec, a in zip(specs_in, args)]
                 for r in range(mesh.size)]
        results = _run_shards(f, mesh, local, timeout)
        return _out_tree(mesh, out_specs, results)

    return run


@contextlib.contextmanager
def _caller_modes(grad: bool, modes: List[Any]):
    """The calling thread's grad mode and dispatch-mode stack, entered in
    a shard thread (both are per thread in PyTorch)."""
    with torch.set_grad_enabled(grad):
        for m in modes:
            _pydispatch._push_mode(m)
        try:
            yield
        finally:
            for _ in modes:
                _pydispatch._pop_mode()


def _on_device(dev: torch.device, f: Callable, args: List[Any]):
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            return f(*args)
    return f(*args)


def _run_shards(f: Callable, mesh: Mesh, local: List[List[Any]],
                timeout: float) -> List[Any]:
    run = _Run(mesh, timeout)
    n = mesh.size
    results: List[Any] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n
    grad = torch.is_grad_enabled()
    modes = list(_pydispatch._get_current_dispatch_mode_stack())

    def body(rank: int) -> None:
        c = _local.ctx = _Shard(run, rank)
        dev = mesh.device(rank)
        state = "done"
        try:
            if n > 1:
                if not run.go[rank].acquire(timeout=timeout):
                    run.abort("shard_map: a shard never got its turn")
                if run.aborted is not None:
                    raise _Aborted()
            if n == 1:                      # the caller's own thread
                results[rank] = _on_device(dev, f, local[rank])
            else:
                with _caller_modes(grad, modes):
                    results[rank] = _on_device(dev, f, local[rank])
        except BaseException as e:          # noqa: BLE001 - re-raised
            errors[rank] = e
            state = "error"
        finally:
            _local.ctx = None
            if n > 1:
                _yield(c, state)

    if n == 1:
        body(0)
    else:
        threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                    name=f"shard-{r}") for r in range(n)]
        for t in threads:
            t.start()
        run.go[0].release()                 # shard 0 starts
        if not run.all_done.wait(timeout):
            with run.lock:
                run.abort(f"shard_map: a shard ran more than {timeout} s "
                          f"without reaching a collective or its end")
            raise TimeoutError(run.aborted)
        for t in threads:
            t.join(timeout)
    real = [e for e in errors if e is not None and not isinstance(e,
                                                                   _Aborted)]
    if real:
        raise real[0]
    if run.aborted is not None:
        raise RuntimeError(run.aborted)
    return results
