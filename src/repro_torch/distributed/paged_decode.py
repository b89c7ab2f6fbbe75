"""Sequence-parallel paged decode attention — the Tiara one-round path
(port of ``repro.distributed.paged_decode``).

The baseline decode keeps the whole KV pool in one place and gathers
``k_pages[block_tables]``.  This module applies the paper's move — *ship
the request to the memory, not the memory to the request*:

  * pages are sharded over ALL mesh axes (each shard owns pool/shards
    whole pages and never sends them anywhere);
  * every shard resolves the block table against its own pages
    (register-chained load: table entry -> local page) and computes a
    partial flash-attention over the tokens it owns;
  * partials merge with one small online-softmax reduction (pmax/psum of
    (B, H, D) accumulators) — the only collectives.

Per layer the collectives carry O(B x QH x D) floats instead of O(KV
bytes).  The partial runs outside any kernel, as the reference's does
(plain torch; the unsharded decode it is held against runs the
``paged_attention`` kernel).
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.distributed import mesh as dmesh
from repro_torch.distributed.mesh import P, Sharded

NEG = -1e30


def _masked_rows(pages: torch.Tensor, loff: torch.Tensor) -> torch.Tensor:
    """``pages[loff]`` with indices outside the shard's pages zeroed (the
    reference's ``masked_row_gather``)."""
    n = pages.shape[0]
    ok = (loff >= 0) & (loff < n)
    rows = pages[loff.clamp(0, n - 1)]
    shape = tuple(ok.shape) + (1,) * (rows.dim() - ok.dim())
    return torch.where(ok.reshape(shape), rows, torch.zeros_like(rows))


def _partial_paged_attention(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        bt_local: torch.Tensor, lengths: torch.Tensor, *, base_page: int,
        scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash partial over the locally-owned pages.

    q (B, KVH, G, D); k/v_pages (pp_local, page, KVH, D); bt_local
    (B, maxp) GLOBAL page ids; returns unnormalized (acc, m, l)."""
    pp_local, page = k_pages.shape[0], k_pages.shape[1]
    maxp = bt_local.shape[1]
    dev = q.device
    loff = bt_local.long() - base_page
    mine = (loff >= 0) & (loff < pp_local)
    # the compiled gather-chain superoperator: block table -> local pages
    k = _masked_rows(k_pages, loff)          # (B, maxp, page, KVH, D)
    v = _masked_rows(v_pages, loff)
    s = torch.einsum("bhgd,bmphd->bhgmp", q.float() * scale, k.float())
    pos = (torch.arange(maxp, device=dev)[:, None] * page
           + torch.arange(page, device=dev)[None, :])[None]
    valid = (pos < lengths.long()[:, None, None]) & mine[..., None]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG))
    m = s.amax(dim=(-2, -1))                             # (B, KVH, G)
    p = torch.exp(s - m[..., None, None])
    p = torch.where(valid[:, None, None], p, torch.zeros_like(p))
    l = p.sum(dim=(-2, -1))
    acc = torch.einsum("bhgmp,bmphd->bhgd", p, v.float())
    return acc, m, l


def _partial_paged_attention_sliced(
        q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
        bt: torch.Tensor, lengths: torch.Tensor, *, base_page: int,
        base_local: int, maxp: int, scale: float
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Contiguous-slab variant.  With the pool laid out (dp-major,
    model-minor) and per-sequence page slabs, each model rank's
    ``pp_local`` pages form one contiguous chunk of exactly ONE local
    sequence (requires B_local <= model size).  The rank attends its own
    pages against that sequence's query only and contributes -inf/0
    partials for every other sequence."""
    b = q.shape[0]
    pp_local, page = k_pages.shape[0], k_pages.shape[1]
    if not (pp_local <= maxp and maxp % pp_local == 0):
        raise ValueError("contiguous decode requires B_local <= model-axis "
                         "size")
    dev = q.device
    seq_local = base_local // maxp
    col0 = base_local % maxp
    cols = bt[seq_local, col0:col0 + pp_local].long()
    loff = cols - base_page
    mine = (loff >= 0) & (loff < pp_local)
    k = _masked_rows(k_pages, loff)                # (pp, page, KVH, D)
    v = _masked_rows(v_pages, loff)
    qrow = q[seq_local]
    length = lengths[seq_local].long()
    s = torch.einsum("hgd,mphd->hgmp", qrow.float() * scale, k.float())
    pos = ((col0 + torch.arange(pp_local, device=dev))[:, None] * page
           + torch.arange(page, device=dev)[None, :])
    valid = (pos < length) & mine[:, None]
    s = torch.where(valid[None, None], s, torch.full_like(s, NEG))
    m1 = s.amax(dim=(-2, -1))                             # (KVH, G)
    p = torch.exp(s - m1[..., None, None])
    p = torch.where(valid[None, None], p, torch.zeros_like(p))
    l1 = p.sum(dim=(-2, -1))
    acc1 = torch.einsum("hgmp,mphd->hgd", p, v.float())
    # scatter the single-sequence partial into the (B_local, ...) slots
    onehot = torch.arange(b, device=dev) == seq_local
    m = torch.where(onehot[:, None, None], m1[None],
                    torch.full_like(m1[None], NEG))
    l = torch.where(onehot[:, None, None], l1[None], torch.zeros_like(l1))
    acc = torch.where(onehot[:, None, None, None], acc1[None],
                      torch.zeros_like(acc1))
    return acc, m, l


def sharded_paged_attention(mesh: dmesh.Mesh, dp_axes: Tuple[str, ...],
                            model_axis: str = "model", *,
                            contiguous: bool = False,
                            batch_sharded: bool = True
                            ) -> Callable[..., Any]:
    """Builds fn(q, k_pages, v_pages, new_k, new_v, bt, lengths) -> (out,
    k_pages, v_pages): appends the new token's KV to its owning shard and
    attends, all pages staying local.

    q: (B, QH, D); pages: (pool, page, KVH, D) split over (dp..., model)
    on the pool dim — :class:`~repro_torch.distributed.mesh.Sharded`
    (:func:`shard_pages`), updated in place and returned per shard; bt:
    (B, maxp); lengths: (B,).  ``out`` comes back as one tensor on
    ``q``'s device, as the model's next layer takes it.

    ``contiguous``: the serving allocator gives every sequence a
    per-rank-contiguous page slab (model rank m owns block-table columns
    [m*maxp/M, (m+1)*maxp/M)), so each rank slices its own 1/M of the
    table instead of gathering over all maxp pages."""
    all_axes = tuple(dp_axes) + (model_axis,)

    def local(q, k_pages, v_pages, new_k, new_v, bt, lengths):
        # linear rank over (dp..., model); the pool is laid out in the
        # same axis order, so contiguous page ranges land per rank
        rank = dmesh.axis_index(all_axes)
        pp_local = int(k_pages.shape[0])
        base = rank * pp_local
        b, qh, hd = q.shape
        kvh = k_pages.shape[2]
        group = qh // kvh
        page = k_pages.shape[1]
        maxp = bt.shape[1]

        # -- append the new token's KV on the owning shard, in place ----
        col = (lengths.long() // page).clamp(0, maxp - 1)
        pidx = bt.long().gather(1, col[:, None])[:, 0]
        poff = lengths.long() % page
        lp = pidx - base
        own = (lp >= 0) & (lp < pp_local)
        # no data-dependent shapes (the dry-run traces this on meta): a
        # row this shard does not own repeats the first owned row's
        # write, or, with none owned, rewrites one slot as it is — equal
        # values to one slot, so the result is exact whichever lands
        src = torch.where(own, torch.arange(b, device=own.device),
                          torch.argmax(own.int()))
        tp, to = lp[src].clamp(0, pp_local - 1), poff[src]
        any_own = own.any()
        for pages, new in ((k_pages, new_k), (v_pages, new_v)):
            keep = pages[tp, to]
            pages[tp, to] = torch.where(any_own, new[src].to(pages.dtype),
                                        keep)

        # -- partial attention over owned pages --------------------------
        qg = q.reshape(b, kvh, group, hd)
        if contiguous:
            midx = dmesh.axis_index(model_axis)
            # offset of this rank's pool slice within ITS batch rows: when
            # the batch is dp-sharded the dp part of `base` aligns with
            # the local rows; when replicated the global base indexes the
            # single shared sequence directly
            base_local = midx * pp_local if batch_sharded else base
            acc, m, l = _partial_paged_attention_sliced(
                qg, k_pages, v_pages, bt, lengths + 1, base_page=base,
                base_local=base_local, maxp=maxp, scale=hd ** -0.5)
        else:
            acc, m, l = _partial_paged_attention(
                qg, k_pages, v_pages, bt, lengths + 1, base_page=base,
                scale=hd ** -0.5)

        # -- one-round combine: online-softmax merge across the axes that
        # hold partials (model always; the dp axes too when the batch is
        # replicated and its pages are spread over dp) -------------------
        merge_axes = (model_axis,) if batch_sharded else all_axes
        mg = m
        for ax in merge_axes:
            mg = dmesh.pmax(mg, ax)
        w = torch.exp(m - mg)
        acc = dmesh.psum(acc * w[..., None], merge_axes)
        l = dmesh.psum(l * w, merge_axes)
        out = acc / l.clamp_min(1e-30)[..., None]
        return out.reshape(b, qh, hd).to(q.dtype), k_pages, v_pages

    dp = tuple(dp_axes) if batch_sharded else None
    pages = P(all_axes, None, None, None)
    fn = dmesh.shard_map(
        local, mesh,
        in_specs=(P(dp, None, None),                # q (replicated/model)
                  pages, pages,                     # k_pages, v_pages
                  P(dp, None, None),                # new_k (B, KVH, D)
                  P(dp, None, None),                # new_v
                  P(dp, None),                      # block tables
                  P(dp)),                           # lengths
        out_specs=(P(dp, None, None), pages, pages))

    def run(q, k_pages, v_pages, new_k, new_v, bt, lengths):
        out, k_pages, v_pages = fn(q, k_pages, v_pages, new_k, new_v, bt,
                                   lengths)
        if isinstance(out, Sharded):
            out = out.full(q.device)
        return out, k_pages, v_pages

    return run


def shard_pages(mesh: dmesh.Mesh, caches, axes: Tuple[str, ...]):
    """The model's stacked caches with every paged KV pool placed on the
    mesh, its pool dimension split over ``axes`` (the decode's
    ``dp_axes + (model_axis,)``): each shard keeps its pages across
    decode steps.  A pool already on a shard's device is split into
    views, not copied."""
    out = []
    spec = P(None, tuple(axes), None, None, None)
    for c in caches:
        if c.paged is None:
            out.append(c)
            continue
        kp, vp = c.paged
        out.append(c._replace(paged=type(c.paged)(mesh.put(kp, spec),
                                                  mesh.put(vp, spec))))
    return tuple(out)
