"""One-round remote indirection resolution — Tiara's 1-RTT across the
mesh (port of ``repro.distributed.tiara_fetch``).

The pod-level Indirection Wall: a consumer shard holds *logical* block
ids whose translation table and payload pages live on owner shards
(co-partitioned: logical id i and its physical page belong to the same
owner, as each memory node resolves into its own DRAM — the paper's
setting).  Client-side resolution (one-sided-RDMA style) costs one
collective round per indirection level:

    round 1: gather table entries from owners   (ids -> physical)
    round 2: gather payload rows from owners    (physical -> data)

``make_tiara_fetch`` ships the *request* to the owner instead — the
paper's pre-registered operator executing on the memory side:

    all_to_all(requests) -> owner resolves locally (the two chained
    loads, pool[table[id]], as ONE ``tiara_gather`` launch on its own
    shards) -> all_to_all(payloads)

Two collectives total, *independent of indirection depth*, and only
(requests + payloads) cross between shards — never intermediate
pointers.  :func:`client_side_fetch` is the baseline on the same layout,
as explicit rounds on the mesh (the reference leaves it to GSPMD).

Layout (per shard, axis size S): table (T/S,) int32 — logical id i owned
by shard i // (T/S); pool (N/S, R) — physical row p owned by shard
p // (N/S); ids (n,) per shard, any logical ids.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.distributed import mesh as dmesh
from repro_torch.distributed.mesh import P
from repro_torch.kernels.tiara_gather.ops import tiara_gather


def _owner_route(ids: torch.Tensor, owner: torch.Tensor, n_shards: int,
                 quota: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bucket ids by owner shard with a fixed per-destination quota.
    Returns (routed (n_shards, quota) int32 with -1 padding, each id's
    flat position, and whether it fit its owner's quota).  An id past
    the quota is parked on its bucket's last slot as a -1; where several
    ids land on one slot the last one wins, as the reference's scatter
    does."""
    n = int(ids.shape[0])
    dev = ids.device
    onehot = (owner[:, None] == torch.arange(n_shards, device=dev)[None, :]
              ).to(torch.int64)
    rank = onehot.cumsum(0) - onehot
    slot = (rank * onehot).sum(1)                             # (n,)
    ok = slot < quota
    flat_pos = owner.to(torch.int64) * quota + slot.clamp(max=quota - 1)
    lane = torch.full((n_shards * quota,), -1, dtype=torch.int64,
                      device=dev)
    lane.scatter_reduce_(0, flat_pos, torch.arange(n, device=dev),
                         "amax")
    val = torch.where(ok, ids.to(torch.int32),
                      torch.full_like(ids, -1, dtype=torch.int32))
    routed = torch.where(lane >= 0, val[lane.clamp(min=0)],
                         torch.full_like(lane, -1, dtype=torch.int32))
    return routed.reshape(n_shards, quota), flat_pos, ok


def owner_resolve(table_l: torch.Tensor, pool_l: torch.Tensor,
                  loff: torch.Tensor, live: torch.Tensor,
                  row_base: int) -> torch.Tensor:
    """The owner's two chained loads, ``pool_l[table_l[loff] - row_base]``
    for every live request, as one ``tiara_gather`` launch (its plain
    version on a CPU shard); dead requests and entries outside this
    shard give zero rows, as the reference's ``masked_row_gather``
    does."""
    t_shard, r_shard = int(table_l.shape[0]), int(pool_l.shape[0])
    local = table_l.to(torch.int64) - row_base
    mine = (local >= 0) & (local < r_shard)
    ok = live & (loff >= 0) & (loff < t_shard)
    idx = torch.where(ok, loff, torch.zeros_like(loff)).to(torch.int32)
    ok = ok & mine[idx.long()]
    rows = tiara_gather(pool_l.contiguous(), local.clamp(0, r_shard - 1),
                        idx.contiguous())
    return torch.where(ok[:, None], rows, torch.zeros_like(rows))


def make_tiara_fetch(mesh: dmesh.Mesh, axis: str, n_logical: int,
                     n_rows: int, quota: int):
    """Build the one-round fetch for a pool sharded over ``axis``:
    ``run(table, pool, ids)`` with table ``(T,)``, pool ``(N, R)`` and ids
    ``(S * n,)`` split over the axis (global tensors or
    :class:`~repro_torch.distributed.mesh.Sharded`); the rows come back
    per shard."""
    n_shards = mesh.shape[axis]
    t_shard = n_logical // n_shards
    r_shard = n_rows // n_shards

    def local(table_l, pool_l, ids):
        my = dmesh.axis_index(axis)
        owner = torch.div(ids.to(torch.int64), t_shard,
                          rounding_mode="floor")
        routed, flat_pos, ok = _owner_route(ids, owner, n_shards, quota)
        # --- round trip 1 of 1: ship requests to owners ----------------
        reqs = dmesh.all_to_all(routed, axis, 0, 0, tiled=True)
        reqs = reqs.reshape(-1).to(torch.int64)
        # --- memory-side resolution: the chained loads in one kernel ----
        live = reqs >= 0
        loff = torch.where(live, reqs - my * t_shard,
                           torch.zeros_like(reqs))
        rows = owner_resolve(table_l, pool_l, loff, live, my * r_shard)
        # --- reply travels back with the second half of the round trip --
        back = dmesh.all_to_all(rows.reshape(n_shards, quota, -1), axis,
                                0, 0, tiled=True)
        back = back.reshape(n_shards * quota, -1)
        return back[flat_pos] * ok[:, None].to(back.dtype)

    return dmesh.shard_map(local, mesh, in_specs=(P(axis), P(axis, None),
                                                  P(axis)),
                           out_specs=P(axis))


def client_side_fetch(mesh: dmesh.Mesh, axis: str, table, pool, ids):
    """Baseline: client-side resolution on the same layout, one round
    trip per indirection level (the reference's GSPMD lowering of
    ``pool[table[ids]]``): every shard's ids gather to the owners, the
    owners answer masked, the answers sum back — first the table entries,
    then, from the pointers those give, the payload rows."""

    def remote_rows(src_l, idx, per_shard):
        me = dmesh.axis_index(axis)
        req = dmesh.all_gather(idx, axis)                  # (S, n)
        loc = req - me * per_shard
        own = (loc >= 0) & (loc < per_shard)
        rows = src_l[loc.clamp(0, per_shard - 1)]
        shape = tuple(own.shape) + (1,) * (rows.dim() - own.dim())
        rows = torch.where(own.reshape(shape), rows, torch.zeros_like(rows))
        return dmesh.psum(rows, axis)[me]

    def local(table_l, pool_l, ids):
        phys = remote_rows(table_l, ids.to(torch.int64),
                           int(table_l.shape[0]))          # round 1
        return remote_rows(pool_l, phys.to(torch.int64),
                           int(pool_l.shape[0]))           # round 2

    return dmesh.shard_map(local, mesh, in_specs=(P(axis), P(axis, None),
                                                  P(axis)),
                           out_specs=P(axis))(table, pool, ids)


def reference_fetch(table, pool, ids):
    return np.asarray(pool)[np.asarray(table)[np.asarray(ids)]]
