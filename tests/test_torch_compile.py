"""The port's trace compiler against the JAX package.

Every compilable stock operator runs through the port's compiled path
(the plain row gather, as on the CPU) and is held bit for bit against the
JAX compiled path — plain (``impl="xla"``) and, for the gather chains,
the Pallas kernel in interpret mode — and against the JAX package's
``pyvm`` oracle, at B=1 and B=4.  Small shapes: a JAX compiled trace
grows with the unrolled loop, so loop caps stay low.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import compile as jtc
from repro.core import isa as jisa
from repro.core import memory as jmemory
from repro.core import operators as jops
from repro.core import pyvm as jpyvm
from repro.core import vm as jvm
from repro.core.memory import Grant as JGrant
from repro.core.program import OperatorBuilder as JBuilder
from repro.core.verifier import verify as jverify
from repro_torch import convert
from repro_torch.core import compile as tc
from repro_torch.core import vm
from repro_torch.core.memory import Grant
from repro_torch.core.verifier import verify
from torch_wide_region import compiled_matches_pyvm_past_2_31


def carry(jprog, jrt):
    jv = jverify(jprog, grant=JGrant.all_of(jrt), regions=jrt)
    prt = convert.regions_from(jrt)
    pprog = convert.program_from_code(
        jprog.code, jprog.name, jprog.n_params, jrt,
        regions_read=jprog.regions_read,
        regions_written=jprog.regions_written)
    return jv, verify(pprog, grant=Grant.all_of(prt), regions=prt), prt


def fault_row(f):
    return [-1, 0, 0, 0] if f is None else [f.pc, f.opcode, f.addr, f.device]


def oracle(jv, jrt, mem, params, homes=None, failed=None):
    mem = mem.copy()
    rs = [jpyvm.run(jv, jrt, mem, list(p),
                    home=0 if homes is None else homes[b], failed=failed)
          for b, p in enumerate(params)]
    return mem, dict(ret=[r.ret for r in rs], status=[r.status for r in rs],
                     steps=[r.steps for r in rs],
                     regs=[list(r.regs) for r in rs],
                     fault=[fault_row(r.fault) for r in rs])


def assert_same(res, mem, want):
    assert np.array_equal(res.mem.cpu().numpy(), np.asarray(mem))
    for k in ("ret", "status", "steps", "regs", "fault"):
        assert np.array_equal(np.asarray(getattr(res, k)),
                              np.asarray(want[k], np.int64)), k


def _graph_walk(B):
    w = jops.GraphWalk(n_nodes=32, max_depth=4, reply_words=4 * 8)
    rt = w.regions()
    mem = jmemory.make_pool(1, rt)
    order = w.populate(mem, rt, seed=31)
    return (w.build(rt, reply_param=True), rt, mem,
            [[int(order[5 * i]) * 8, 1 + i, 8 * i] for i in range(B)])


def _ptw(B):
    p = jops.PageTableWalk(fanout=8, n_pages=8, reply_pages=4)
    rt = p.regions()
    mem = jmemory.make_pool(1, rt)
    vas = sorted(p.populate(mem, rt, seed=32))
    return (p.build(rt, reply_param=True), rt, mem,
            [[vas[i % len(vas)], 512 * i] for i in range(B)])


def _lock(B):
    lk = jops.DistLock(max_retries=2)
    rt = lk.regions()
    mem = jmemory.make_pool(2, rt)
    # disjoint latches/states per lane: conflict-free, so the compiled
    # trace's no-conflict assumption holds
    return (lk.build(rt), rt, mem,
            [[8 * i, 8 * i + 1, 40 + i, 1, 8 * i + 2, 1, 8 * i + 3]
             for i in range(B)])


def _kv(B, max_req_blocks=4):
    k = jops.PagedKVFetch(n_blocks_pool=16, block_bytes=256,
                          max_req_blocks=max_req_blocks, reply_slots=4)
    rt = k.regions()
    mem = jmemory.make_pool(1, rt)
    k.populate(mem, rt, seed=33)
    k.make_request(mem, rt, [6, 1, 14, 2][:max_req_blocks]
                   + list(range(max_req_blocks - 4)))
    slot = max_req_blocks * k.block_words
    return (k.build(rt, reply_param=True), rt, mem,
            [[max_req_blocks - i % 4, i * slot] for i in range(B)])


def _moe(B, max_k=4):
    m = jops.MoEExpertGather(n_experts=16, max_k=max_k, slab_words=32,
                             reply_slots=4)
    rt = m.regions()
    mem = jmemory.make_pool(1, rt)
    m.populate(mem, rt, seed=34)
    jmemory.write_region(mem, rt, 0, "expert_ids",
                         [(5 * j + 3) % 16 for j in range(max_k)])
    return (m.build(rt, reply_param=True), rt, mem,
            [[max_k - i % 3, i * max_k * 32] for i in range(B)])


def _nsa(B):
    n = jops.NSASelect(n_scores=8, block_words=16)
    rt = n.regions()
    mem = jmemory.make_pool(1, rt)
    n.populate(mem, rt, seed=35)
    return n.build(rt), rt, mem, [[8, 40]] * min(B, 1)


OPS = {"graph_walk": _graph_walk, "ptw3": _ptw, "dist_lock": _lock,
       "paged_kv_fetch": _kv, "moe_expert_gather": _moe,
       "nsa_select": _nsa}


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("name", sorted(OPS))
def test_compiled_matches_jax_and_pyvm(name, B):
    jprog, jrt, mem, params = OPS[name](B)
    jv, pv, prt = carry(jprog, jrt)
    assert tc.compilable(pv) and jtc.compilable(jv)
    want_mem, want = oracle(jv, jrt, mem, params)
    got = tc.invoke_compiled(pv, prt, mem, params, device="cpu")
    assert_same(got, want_mem, want)
    jres = jtc.invoke_compiled(jv, jrt, mem.copy(), params, impl="xla")
    assert_same(got, jres.mem, {k: getattr(jres, k) for k in
                                ("ret", "status", "steps", "regs",
                                 "fault")})


@pytest.mark.parametrize("name", ["paged_kv_fetch", "moe_expert_gather"])
def test_gather_chain_matches_jax_kernel_interpret(name):
    """The gather chain's kernel route in the reference (Pallas, interpret
    mode) and the port's plain route give the same wave."""
    jprog, jrt, mem, params = OPS[name](4)
    jv, pv, prt = carry(jprog, jrt)
    assert tc.superop_report(pv) == jtc.superop_report(jv)
    jres = jtc.invoke_compiled(jv, jrt, mem.copy(), params,
                               impl="kernel_interpret")
    got = tc.invoke_compiled(pv, prt, mem, params, impl="torch",
                             device="cpu")
    assert_same(got, jres.mem, {k: getattr(jres, k) for k in
                                ("ret", "status", "steps", "regs",
                                 "fault")})


@pytest.mark.parametrize("name", ["paged_kv_fetch", "moe_expert_gather"])
def test_kernel_route_has_no_cpu_fallback(name):
    jprog, jrt, mem, params = OPS[name](2)
    _, pv, prt = carry(jprog, jrt)
    with pytest.raises(ValueError, match="CUDA"):
        tc.invoke_compiled(pv, prt, mem, params, impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        tc.build_compiled(pv, prt, 1, 2, impl="xla")


def test_double_buffer_bit_parity():
    """Chains longer than one chunk take the chunked schedule; it stays
    bit-identical to the monolithic trace and to pyvm."""
    jprog, jrt, mem, params = _moe(4, max_k=3 * tc.DBUF_CHUNK)
    jv, pv, prt = carry(jprog, jrt)
    want_mem, want = oracle(jv, jrt, mem, params)
    mono = tc.invoke_compiled(pv, prt, mem, params, device="cpu")
    dbuf = tc.invoke_compiled(pv, prt, mem, params, double_buffer=True,
                              device="cpu")
    assert_same(mono, want_mem, want)
    assert_same(dbuf, want_mem, want)


@pytest.mark.parametrize("double_buffer", [False, True])
def test_gather_chain_unaligned_translation_matches_pyvm(double_buffer):
    """A translation entry need not be block-aligned: the chain copies
    the W words starting at the translated offset itself, as pyvm's
    MEMCPY does, on the monolithic and the chunked schedule."""
    jprog, jrt, mem, params = _kv(4, max_req_blocks=2 * tc.DBUF_CHUNK)
    W = jrt["kvpool"].size // 16
    table = jmemory.read_region(mem, jrt, 0, "blocktable").copy()
    table[1] = 5 * W + 3
    table[14] = 7
    jmemory.write_region(mem, jrt, 0, "blocktable", table)
    jv, pv, prt = carry(jprog, jrt)
    want_mem, want = oracle(jv, jrt, mem, params)
    assert all(s == jisa.STATUS_OK for s in want["status"])
    got = tc.invoke_compiled(pv, prt, mem, params, device="cpu",
                             double_buffer=double_buffer)
    assert_same(got, want_mem, want)
    jres = jtc.invoke_compiled(jv, jrt, mem.copy(), params, impl="xla",
                               double_buffer=double_buffer)
    assert_same(got, jres.mem, {k: getattr(jres, k) for k in
                                ("ret", "status", "steps", "regs",
                                 "fault")})


@pytest.mark.parametrize("name", ["graph_walk", "paged_kv_fetch"])
def test_compiled_fault_lane_matches_pyvm(name):
    """A lane whose access leaves its region faults with pyvm's FaultInfo
    (fused gather-chain sites included); the others complete."""
    jprog, jrt, mem, params = OPS[name](4)
    if name == "graph_walk":
        params[1] = [1 << 20, 2, 8]
    else:
        params[1] = [4, jrt["reply"].size - 8]      # dst window overruns
    jv, pv, prt = carry(jprog, jrt)
    want_mem, want = oracle(jv, jrt, mem, params)
    got = tc.invoke_compiled(pv, prt, mem, params, device="cpu")
    assert_same(got, want_mem, want)
    assert want["status"][1] == jisa.STATUS_PROT_FAULT


def test_compiled_failed_device_matches_pyvm():
    jprog, jrt, m1, params = _kv(4)
    mem = np.concatenate([m1, m1])
    homes = [0, 1, 1, 0]
    jv, pv, prt = carry(jprog, jrt)
    want_mem, want = oracle(jv, jrt, mem, params, homes=homes, failed={1})
    got = tc.invoke_compiled(pv, prt, mem, params, homes=homes, failed={1},
                             device="cpu")
    assert_same(got, want_mem, want)


def test_compiled_shr_is_logical():
    rt = jmemory.packed_table([("out", 64)])
    b = JBuilder("shr", n_params=2, regions=rt)
    y = b.reg()
    b.shr(y, b.param(0), b.param(1))
    b.store(y, "out", b.const(0))
    b.ret(y)
    jv, pv, prt = carry(b.build(), rt)
    mem = jmemory.make_pool(1, rt)
    params = [[-8, 1], [-8, 0], [-1, 63], [-3, 65]]
    want_mem = mem
    rets = []
    for p in params:
        want_mem, want = oracle(jv, rt, want_mem, [p])
        rets.append(want["ret"][0])
    got = tc.invoke_compiled(pv, prt, mem, params, device="cpu")
    assert list(got.ret) == rets
    assert rets[0] == (1 << 63) - 4


def test_det_scatter_last_live_lane_wins():
    rng = np.random.default_rng(5)
    size = 16
    for _ in range(4):
        idx = rng.integers(0, size, (3, 5)).astype(np.int64)
        val = rng.integers(-100, 100, (3, 5)).astype(np.int64)
        live = rng.random((3, 5)) < 0.7
        base = rng.integers(0, 9, size).astype(np.int64)
        with jvm.x64():
            want = np.asarray(jtc.det_scatter(jnp.asarray(base),
                                              jnp.asarray(idx),
                                              jnp.asarray(val),
                                              jnp.asarray(live)))
        memx = torch.from_numpy(np.concatenate([base, [0]]))
        tc.det_scatter(memx, torch.from_numpy(idx), torch.from_numpy(val),
                       torch.from_numpy(live))
        assert np.array_equal(memx[:-1].numpy(), want)


def test_masked_row_gather_matches_jax():
    rng = np.random.default_rng(6)
    pool = rng.integers(0, 50, (6, 3)).astype(np.int32)
    idx = rng.integers(-2, 8, (2, 5))
    live = rng.random((2, 5)) < 0.8
    want = np.asarray(jtc.masked_row_gather(jnp.asarray(pool),
                                            jnp.asarray(idx),
                                            jnp.asarray(live)))
    got = tc.masked_row_gather(torch.from_numpy(pool), torch.from_numpy(idx),
                               torch.from_numpy(live))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_mixed_batch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 4, 11)
    homes = rng.integers(0, 3, 11)
    for kw in ({}, {"homes": homes, "n_devices": 3}):
        a, b = tc.plan_mixed_batch(ids, **kw), jtc.plan_mixed_batch(ids, **kw)
        assert np.array_equal(a.order, b.order)
        assert np.array_equal(a.inverse, b.inverse)
        assert [dataclass_tuple(s) for s in a.segments] == \
            [dataclass_tuple(s) for s in b.segments]
        assert a.batch_per_device == b.batch_per_device


def dataclass_tuple(seg):
    return (seg.op_id, seg.start, seg.end, seg.home)


@pytest.mark.parametrize("name", sorted(OPS))
def test_superop_reports_match_jax(name):
    jprog, jrt, _, _ = OPS[name](1)
    jv, pv, _ = carry(jprog, jrt)
    assert tc.superop_report(pv) == jtc.superop_report(jv)
    assert [g.__dict__ for g in tc.find_gather_chains(pv)] == \
        [g.__dict__ for g in jtc.find_gather_chains(jv)]


def test_compiled_cache_keys():
    jprog, jrt, mem, params = _ptw(2)
    _, pv, prt = carry(jprog, jrt)
    assert not tc.compiled_cached(pv, prt, 1, 2, impl="torch")
    tc.invoke_compiled(pv, prt, mem, params, impl="torch", device="cpu")
    assert tc.compiled_cached(pv, prt, 1, 2, impl="torch")
    assert not tc.compiled_cached(pv, prt, 1, 3, impl="torch")
    assert vm.engine_key(pv, prt, 1, 2) == vm.engine_key(pv, prt, 1, 2)



@pytest.mark.parametrize("superops,double_buffer",
                         [(False, False), (False, True), (True, False),
                          (True, True)],
                         ids=["memcpy", "memcpy_dbuf", "chain", "chain_dbuf"])
def test_compiled_reads_regions_past_2_31_words(superops, double_buffer):
    """The compiled trace keeps MEMCPY source offsets int64: a traced
    MEMCPY (superoperators off) and the gather chain, under ``compiled``
    and ``compiled_dbuf``, read a region of 2**32 words at offsets past
    2**31 and equal pyvm bit for bit (``tests/torch_wide_region.py``)."""
    compiled_matches_pyvm_past_2_31(superops, double_buffer,
                                    torch.device("cpu"))
