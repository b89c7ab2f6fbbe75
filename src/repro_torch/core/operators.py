"""Stock Tiara operators — the paper's workload suite (Table 1).

Each workload bundles:
  * a region layout (`regions()`),
  * the operator program (`build()`), written against the builder DSL the
    way the paper's OpenCL-C frontend would emit it,
  * a memory populator for tests/benchmarks (`populate()`),
  * a numpy reference model (`reference()`).

Word-level layouts:
  graph traversal   64 B nodes = 8 words: [key, next_off, payload x6]
  page-table walk   three 8 B-entry levels; entries hold word offsets into
                    the next level / the data region; 4 KB pages
  distributed lock  region "lock": [latch, state, ...]; replicas hold the
                    same layout on other hosts
  paged KV fetch    block table: bid -> word offset into the KV pool;
                    blocks are ``block_bytes`` big (multiple DMA bursts if
                    > 32 KB, like a real DMA engine segmenting a transfer)
  MoE gather        expert table: expert id -> word offset of an 8 KB slab
  NSA select        score-then-select: fetch block i iff score[i] >= thr
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import isa, memory
from repro_torch.core.isa import Alu
from repro_torch.core.memory import RegionTable
from repro_torch.core.program import OperatorBuilder, TiaraProgram

NODE_WORDS = 8                 # 64-byte graph nodes
PAGE_WORDS = 512               # 4 KB pages
MOE_SLAB_WORDS = 1024          # 8 KB expert slabs


def _chunks(total_words: int) -> List[int]:
    """Split a transfer into DMA bursts of at most MAX_MEMCPY_WORDS."""
    out = []
    left = int(total_words)
    while left > 0:
        c = min(left, isa.MAX_MEMCPY_WORDS)
        out.append(c)
        left -= c
    return out


# ===========================================================================
# 1. Graph traversal (pointer chasing) — paper §4.2
# ===========================================================================

@dataclasses.dataclass
class GraphWalk:
    n_nodes: int = 4096
    max_depth: int = 64
    reply_words: int = 64      # widen for batched serving (one slot/request)

    def regions(self) -> RegionTable:
        return memory.packed_table([("graph", self.n_nodes * NODE_WORDS),
                                    ("reply", self.reply_words)])

    def build(self, rt: RegionTable, *,
              reply_param: bool = False) -> TiaraProgram:
        """params: r0 = start node offset (words), r1 = depth; with
        ``reply_param``, r2 = reply word offset — batched requests write
        disjoint reply slots instead of all landing on slot 0."""
        b = OperatorBuilder("graph_walk", n_params=3 if reply_param else 2,
                            regions=rt)
        cur = b.mov(b.reg(), b.param(0))
        nxt = b.reg()
        with b.loop((b.param(1), self.max_depth)):
            b.load(nxt, "graph", cur, 1)       # register-chained load
            b.mov(cur, nxt)
        key = b.load(b.reg(), "graph", cur, 0)
        dst = b.param(2) if reply_param else b.const(0)
        b.memcpy(dst_region="reply", dst_off=dst,
                 src_region="graph", src_off=cur, n_words=NODE_WORDS)
        b.ret(key)
        return b.build()

    def populate(self, mem: np.ndarray, rt: RegionTable, *, device: int = 0,
                 seed: int = 0) -> np.ndarray:
        """Random ring permutation; returns the node order (offsets/8)."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(self.n_nodes)
        graph = np.zeros(self.n_nodes * NODE_WORDS, dtype=np.int64)
        for i in range(self.n_nodes):
            node, nxt = order[i], order[(i + 1) % self.n_nodes]
            graph[node * NODE_WORDS + 0] = 10_000 + node
            graph[node * NODE_WORDS + 1] = nxt * NODE_WORDS
            graph[node * NODE_WORDS + 2: node * NODE_WORDS + 8] = \
                rng.integers(0, 1 << 32, size=6)
        memory.write_region(mem, rt, device, "graph", graph)
        return order

    def reference(self, order: np.ndarray, start_idx: int, depth: int) -> int:
        i = int(np.where(order == start_idx)[0][0])
        node = order[(i + depth) % self.n_nodes]
        return 10_000 + int(node)


# ===========================================================================
# 2. Three-level page-table walk — paper §4.3
# ===========================================================================

@dataclasses.dataclass
class PageTableWalk:
    """Block-indirection table over a disaggregated pool (paper §2.1).

    VA layout (word-addressed): [i1 : i2 : i3 : page offset], fanout
    entries per level, 4 KB (512-word) pages.
    """

    fanout: int = 64
    n_pages: int = 256
    reply_pages: int = 1       # widen for batched serving (one page/request)

    def __post_init__(self):
        self.page_shift = int(np.log2(PAGE_WORDS))
        self.bits = int(np.log2(self.fanout))

    def regions(self) -> RegionTable:
        return memory.packed_table([
            ("pt1", self.fanout),
            ("pt2", self.fanout * self.fanout),
            ("pt3", max(self.fanout ** 3 // 64, self.fanout ** 2)),
            ("data", self.n_pages * PAGE_WORDS),
            ("reply", PAGE_WORDS * self.reply_pages),
        ])

    def build_translate_only(self, rt: RegionTable) -> TiaraProgram:
        """Translation without the data fetch — the paper's Fig. 8
        throughput experiment ('each translation is one network message')."""
        b = OperatorBuilder("ptw3_translate", n_params=1, regions=rt)
        va = b.param(0)
        s1 = self.page_shift + 2 * self.bits
        s2 = self.page_shift + self.bits
        m = self.fanout - 1
        i1 = b.band(b.reg(), b.shr(b.reg(), va, s1), m)
        l2 = b.load(b.reg(), "pt1", i1)
        i2 = b.band(b.reg(), b.shr(b.reg(), va, s2), m)
        e2 = b.load(b.reg(), "pt2", b.add(b.reg(), l2, i2))
        i3 = b.band(b.reg(), b.shr(i2, va, self.page_shift), m)
        ppage = b.load(b.reg(), "pt3", b.add(l2, e2, i3))
        b.ret(ppage)
        return b.build()

    def build(self, rt: RegionTable, *,
              reply_param: bool = False) -> TiaraProgram:
        """params: r0 = virtual address (words). Returns physical page base.
        With ``reply_param``, r1 = reply word offset so batched requests
        stream their pages into disjoint reply slots."""
        b = OperatorBuilder("ptw3", n_params=2 if reply_param else 1,
                            regions=rt)
        va = b.param(0)
        s1 = self.page_shift + 2 * self.bits
        s2 = self.page_shift + self.bits
        m = self.fanout - 1
        i1 = b.band(b.reg(), b.shr(b.reg(), va, s1), m)
        l2 = b.load(b.reg(), "pt1", i1)              # chained loads: the
        i2 = b.band(b.reg(), b.shr(b.reg(), va, s2), m)
        e2 = b.load(b.reg(), "pt2", b.add(b.reg(), l2, i2))   # loaded value
        i3 = b.band(b.reg(), b.shr(i2, va, self.page_shift), m)
        ppage = b.load(b.reg(), "pt3", b.add(l2, e2, i3))     # is the next
        dst = b.param(1) if reply_param else b.movi(i2, 0)    # address
        b.memcpy(dst_region="reply", dst_off=dst,
                 src_region="data", src_off=ppage, n_words=PAGE_WORDS)
        b.ret(ppage)
        return b.build()

    def populate(self, mem: np.ndarray, rt: RegionTable, *, device: int = 0,
                 seed: int = 0) -> Dict[int, int]:
        """Maps ``n_pages`` random VAs; returns {va_words: phys_page_off}."""
        rng = np.random.default_rng(seed)
        f = self.fanout
        pt1 = np.zeros(f, dtype=np.int64)
        pt2 = np.zeros(f * f, dtype=np.int64)
        pt3 = np.zeros(rt["pt3"].size, dtype=np.int64)
        l2_alloc = 0
        l3_alloc = 0
        l2_of: Dict[int, int] = {}
        l3_of: Dict[Tuple[int, int], int] = {}
        va_map: Dict[int, int] = {}
        phys = rng.permutation(self.n_pages)
        for p in range(self.n_pages):
            i1, i2, i3 = (rng.integers(0, f), rng.integers(0, f),
                          rng.integers(0, f))
            if i1 not in l2_of:
                l2_of[i1] = l2_alloc * f
                pt1[i1] = l2_of[i1]
                l2_alloc += 1
            if (i1, i2) in l3_of:
                l3b = l3_of[(i1, i2)]
            else:
                l3b = l3_alloc * f
                if l3b + f > pt3.size:
                    continue
                l3_of[(i1, i2)] = l3b
                pt2[l2_of[i1] + i2] = l3b
                l3_alloc += 1
            ppage = int(phys[p]) * PAGE_WORDS
            pt3[l3b + i3] = ppage
            va = (int(i1) << (self.page_shift + 2 * self.bits)) | \
                 (int(i2) << (self.page_shift + self.bits)) | \
                 (int(i3) << self.page_shift)
            va_map[va] = ppage
        memory.write_region(mem, rt, device, "pt1", pt1)
        memory.write_region(mem, rt, device, "pt2", pt2)
        memory.write_region(mem, rt, device, "pt3", pt3)
        data = rng.integers(0, 1 << 40, size=self.n_pages * PAGE_WORDS)
        memory.write_region(mem, rt, device, "data", data.astype(np.int64))
        return va_map


# ===========================================================================
# 3. Distributed lock with replication — paper §4.4, Fig. 5
# ===========================================================================

@dataclasses.dataclass
class DistLock:
    max_retries: int = 8

    def regions(self) -> RegionTable:
        return memory.packed_table([("lock", 64)])   # [latch, state, ...]

    def build(self, rt: RegionTable) -> TiaraProgram:
        """params (Fig. 5): r0=latch_off, r1=state_off, r2=newVal,
        r3=replica1 dev, r4=replica1 off, r5=replica2 dev, r6=replica2 off."""
        b = OperatorBuilder("dist_lock", n_params=7, regions=rt)
        latch, state, new_val = b.param(0), b.param(1), b.param(2)
        r1d, r1o, r2d, r2o = (b.param(3), b.param(4), b.param(5), b.param(6))
        zero, one = b.const(0), b.const(1)
        ok = b.reg()
        acquired = b.mklabel("acquired")
        with b.loop(self.max_retries):                 # bounded CAS retry
            b.cas(ok, "lock", latch, cmp=zero, swap=one)
            b.jump(acquired, ok, Alu.EQ, 0)
        b.ret(ok, status=isa.STATUS_FAIL)              # Ret(FAIL)
        b.bind(acquired)
        old = b.load(b.reg(), "lock", state)
        b.store(new_val, "lock", state)
        b.memcpy(dst_region="lock", dst_off=r1o, dst_dev=r1d,   # async
                 src_region="lock", src_off=state, n_words=1, is_async=True)
        b.memcpy(dst_region="lock", dst_off=r2o, dst_dev=r2d,   # async
                 src_region="lock", src_off=state, n_words=1, is_async=True)
        b.wait(0)                                      # both replicas ACK
        b.store(zero, "lock", latch)                   # release
        b.ret(old)
        return b.build()


# ===========================================================================
# 4. Disaggregated PagedAttention KV fetch — paper §4.6
# ===========================================================================

@dataclasses.dataclass
class PagedKVFetch:
    """Resolve block ids through the Block Table and gather KV blocks.

    Layout: "req" holds the request's logical block-id list; "blocktable"
    maps logical block id -> word offset in "kvpool"; the operator streams
    each block to "reply" with async Memcpy, pipelining resolution with
    transfer (paper §3.4), and returns the block count.
    """

    n_blocks_pool: int = 512
    block_bytes: int = 8192
    max_req_blocks: int = 64
    reply_slots: int = 1       # widen for batched serving (slot/request)

    @property
    def block_words(self) -> int:
        return self.block_bytes // isa.WORD_BYTES

    def regions(self) -> RegionTable:
        return memory.packed_table([
            ("req", max(self.max_req_blocks, 64)),
            ("blocktable", max(self.n_blocks_pool, 64)),
            ("kvpool", self.n_blocks_pool * self.block_words),
            ("reply",
             self.max_req_blocks * self.block_words * self.reply_slots),
        ])

    def build(self, rt: RegionTable, *, remote_reply: bool = False,
              reply_param: bool = False) -> TiaraProgram:
        """params: r0 = n_blocks (dynamic, capped); with ``remote_reply``,
        r1 = the requester's device id and every KV block streams straight
        to the caller's reply region (an RDMA write per block) — no local
        staging copy, the deployment configuration of paper §4.6.  With
        ``reply_param``, the next param is the reply word offset so
        batched requests stream into disjoint reply slots."""
        n_params = 1 + int(remote_reply) + int(reply_param)
        b = OperatorBuilder("paged_kv_fetch", n_params=n_params,
                            regions=rt)
        n = b.param(0)
        client = b.param(1) if remote_reply else None
        i = b.const(0)
        bid = b.reg()
        paddr = b.reg()
        dst = b.mov(b.reg(), b.param(n_params - 1)) if reply_param \
            else b.const(0)
        with b.loop((n, self.max_req_blocks)):
            b.load(bid, "req", i)                      # logical block id
            b.load(paddr, "blocktable", bid)           # chained: id -> phys
            prev = 0
            for c in _chunks(self.block_words):
                # segment large blocks into DMA bursts; all async —
                # resolution of block i+1 overlaps transfer of block i
                if prev:
                    b.add(paddr, paddr, prev)
                if remote_reply:
                    b.memcpy(dst_region="reply", dst_off=dst, dst_dev=client,
                             src_region="kvpool", src_off=paddr,
                             n_words=c, is_async=True)
                else:
                    b.memcpy(dst_region="reply", dst_off=dst,
                             src_region="kvpool", src_off=paddr,
                             n_words=c, is_async=True)
                b.add(dst, dst, c)
                prev = c
            b.add(i, i, 1)
        b.wait(0)
        b.ret(n)
        return b.build()

    def populate(self, mem: np.ndarray, rt: RegionTable, *, device: int = 0,
                 seed: int = 0) -> np.ndarray:
        """Shuffled block table; returns the table (logical -> word offset)."""
        rng = np.random.default_rng(seed)
        table = rng.permutation(self.n_blocks_pool) * self.block_words
        memory.write_region(mem, rt, device, "blocktable",
                            table.astype(np.int64))
        pool = rng.integers(0, 1 << 40,
                            size=self.n_blocks_pool * self.block_words)
        memory.write_region(mem, rt, device, "kvpool", pool.astype(np.int64))
        return table.astype(np.int64)

    def make_request(self, mem: np.ndarray, rt: RegionTable,
                     block_ids: Sequence[int], *, device: int = 0) -> None:
        memory.write_region(mem, rt, device, "req",
                            np.asarray(block_ids, dtype=np.int64))

    def reference(self, mem_before: np.ndarray, rt: RegionTable,
                  table: np.ndarray, block_ids: Sequence[int],
                  *, device: int = 0) -> np.ndarray:
        pool = memory.read_region(mem_before, rt, device, "kvpool")
        out = [pool[int(table[int(b)]): int(table[int(b)]) + self.block_words]
               for b in block_ids]
        return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


# ===========================================================================
# 5. MoE expert gather — paper §4.5
# ===========================================================================

@dataclasses.dataclass
class MoEExpertGather:
    """Fetch k expert-weight slabs through a translation table."""

    n_experts: int = 256
    max_k: int = 64
    slab_words: int = MOE_SLAB_WORDS   # 8 KB slabs by default
    reply_slots: int = 1       # widen for batched serving (slot/request)

    def regions(self) -> RegionTable:
        return memory.packed_table([
            ("expert_ids", max(self.max_k, 64)),
            ("expert_table", max(self.n_experts, 64)),
            ("weights", self.n_experts * self.slab_words),
            ("reply", self.max_k * self.slab_words * self.reply_slots),
        ])

    def build(self, rt: RegionTable, *, remote_reply: bool = False,
              reply_param: bool = False) -> TiaraProgram:
        """params: r0 = k (dynamic, capped); with ``remote_reply``, r1 = the
        requester's device and slabs stream straight to the caller.  With
        ``reply_param``, the next param is the reply word offset (disjoint
        slots for batched serving)."""
        n_params = 1 + int(remote_reply) + int(reply_param)
        b = OperatorBuilder("moe_expert_gather",
                            n_params=n_params, regions=rt)
        k = b.param(0)
        client = b.param(1) if remote_reply else None
        i = b.const(0)
        eid, paddr = b.reg(), b.reg()
        dst = b.mov(b.reg(), b.param(n_params - 1)) if reply_param \
            else b.const(0)
        with b.loop((k, self.max_k)):
            b.load(eid, "expert_ids", i)
            b.load(paddr, "expert_table", eid)          # paged translation
            if remote_reply:
                b.memcpy(dst_region="reply", dst_off=dst, dst_dev=client,
                         src_region="weights", src_off=paddr,
                         n_words=self.slab_words, is_async=True)
            else:
                b.memcpy(dst_region="reply", dst_off=dst,
                         src_region="weights", src_off=paddr,
                         n_words=self.slab_words, is_async=True)
            b.add(dst, dst, self.slab_words)
            b.add(i, i, 1)
        b.wait(0)
        b.ret(k)
        return b.build()

    def populate(self, mem: np.ndarray, rt: RegionTable, *, device: int = 0,
                 seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        table = rng.permutation(self.n_experts) * self.slab_words
        memory.write_region(mem, rt, device, "expert_table",
                            table.astype(np.int64))
        w = rng.integers(0, 1 << 40, size=self.n_experts * self.slab_words)
        memory.write_region(mem, rt, device, "weights", w.astype(np.int64))
        return table.astype(np.int64)


# ===========================================================================
# 6. NSA score-then-select — paper §2.1 (Table 1)
# ===========================================================================

@dataclasses.dataclass
class NSASelect:
    """Fetch KV block i iff its compressed-key score clears a threshold —
    the decision of *what to read* depends on remote data."""

    n_scores: int = 64
    block_words: int = 512

    def regions(self) -> RegionTable:
        return memory.packed_table([
            ("scores", max(self.n_scores, 64)),
            ("blockmap", max(self.n_scores, 64)),
            ("kvpool", self.n_scores * self.block_words),
            ("reply", self.n_scores * self.block_words),
        ])

    def build(self, rt: RegionTable) -> TiaraProgram:
        """params: r0 = n (capped), r1 = threshold. Returns count fetched."""
        b = OperatorBuilder("nsa_select", n_params=2, regions=rt)
        n, thr = b.param(0), b.param(1)
        i, cnt = b.const(0), b.const(0)
        s, paddr, dst = b.reg(), b.reg(), b.reg()
        with b.loop((n, self.n_scores)):
            skip = b.mklabel("skip")
            b.load(s, "scores", i)
            b.jump(skip, s, Alu.LT, thr)                # score < thr: skip
            b.load(paddr, "blockmap", i)
            b.mul(dst, cnt, self.block_words)
            b.memcpy(dst_region="reply", dst_off=dst,
                     src_region="kvpool", src_off=paddr,
                     n_words=self.block_words, is_async=True)
            b.add(cnt, cnt, 1)
            b.bind(skip)
            b.add(i, i, 1)
        b.wait(0)
        b.ret(cnt)
        return b.build()

    def populate(self, mem: np.ndarray, rt: RegionTable, *, device: int = 0,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(seed)
        scores = rng.integers(0, 100, size=self.n_scores).astype(np.int64)
        blockmap = (rng.permutation(self.n_scores)
                    * self.block_words).astype(np.int64)
        memory.write_region(mem, rt, device, "scores", scores)
        memory.write_region(mem, rt, device, "blockmap", blockmap)
        pool = rng.integers(0, 1 << 40, size=self.n_scores * self.block_words)
        memory.write_region(mem, rt, device, "kvpool", pool.astype(np.int64))
        return scores, blockmap


ALL_WORKLOADS = {
    "graph_walk": GraphWalk,
    "ptw3": PageTableWalk,
    "dist_lock": DistLock,
    "paged_kv_fetch": PagedKVFetch,
    "moe_expert_gather": MoEExpertGather,
    "nsa_select": NSASelect,
}
