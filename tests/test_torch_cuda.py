"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (``gpu`` marker) and skip without one.  The
file imports only ``torch`` and the port, so it runs on the GPU machine,
which has no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import compile as tc
from repro_torch.core import isa, memory, pyvm
from repro_torch.core import operators as ops
from repro_torch.core.memory import Grant
from repro_torch.core.verifier import verify
from repro_torch.kernels.tiara_gather import (tiara_gather, tiara_gather_ref,
                                              tiara_gather_window,
                                              tiara_gather_window_ref)
from torch_wide_region import compiled_matches_pyvm_past_2_31

SHAPES = [(4, 16, 8), (7, 32, 128), (1, 4, 256), (9, 64, 1024), (5, 8, 3)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int64, torch.float32,
                                   torch.bfloat16, torch.int32])
@pytest.mark.parametrize("n,rows,r", SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, dtype, n, rows, r):
    rng = np.random.default_rng(n + rows + r)
    pool = torch.from_numpy(rng.standard_normal((rows, r))) \
        .to(cuda_device, dtype) if dtype.is_floating_point else \
        torch.from_numpy(rng.integers(0, 1 << 30, (rows, r))) \
        .to(cuda_device, dtype)
    table = torch.from_numpy(rng.permutation(rows).astype(np.int32)) \
        .to(cuda_device)
    ids = torch.from_numpy(rng.integers(0, rows, n).astype(np.int32)) \
        .to(cuda_device)
    before = kernels.launch_counts()["tiara_gather"]
    out = tiara_gather(pool, table, ids)
    torch.cuda.synchronize()
    assert torch.equal(out, tiara_gather_ref(pool, table, ids))
    assert kernels.launch_counts()["tiara_gather"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int64, torch.float32,
                                   torch.bfloat16, torch.int32])
@pytest.mark.parametrize("width,mask", [(8, 63), (5, 63), (64, 63),
                                        (1024, 4095)])
def test_cuda_window_kernel_matches_plain(cuda_device, dtype, width, mask):
    """Unaligned offsets and windows that wrap inside the region."""
    rng = np.random.default_rng(width + mask)
    n_words = 2 * (mask + 1) + 1
    pool = torch.from_numpy(rng.integers(0, 1 << 30, n_words)) \
        .to(cuda_device, dtype)
    table = torch.from_numpy(
        rng.integers(0, mask + 1, 12).astype(np.int32)).to(cuda_device)
    table[0] = mask                         # wraps unless width == 1
    table[1] = 0
    bases = torch.from_numpy(rng.integers(0, 2, 12) * (mask + 1)) \
        .to(cuda_device)
    ids = torch.from_numpy(rng.integers(0, 12, 9).astype(np.int32)) \
        .to(cuda_device)
    ids[0], ids[1] = 0, 1
    out = tiara_gather_window(pool, table, bases, ids, width=width, mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(out, tiara_gather_window_ref(pool, table, bases, ids,
                                                    width=width, mask=mask))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int64, torch.float32])
def test_cuda_window_kernel_per_entry_masks_matches_plain(cuda_device,
                                                          dtype):
    """The lockstep engine's form: one mask per entry."""
    rng = np.random.default_rng(21)
    pool = torch.from_numpy(rng.integers(0, 1 << 30, 200)) \
        .to(cuda_device, dtype)
    masks = torch.tensor([15, 3, 63, 7, 0, 31], device=cuda_device)
    bases = torch.tensor([0, 16, 20, 84, 92, 100], device=cuda_device)
    table = (torch.from_numpy(rng.integers(0, 1 << 20, 6))
             .to(cuda_device) & masks).to(torch.int32)
    table[0] = 14                           # wraps in its region
    ids = torch.tensor([0, 5, 1, 2, 4, 3, 0], dtype=torch.int32,
                       device=cuda_device)
    for width in (1, 5):
        out = tiara_gather_window(pool, table, bases, ids, width=width,
                                  mask=masks)
        torch.cuda.synchronize()
        assert torch.equal(out, tiara_gather_window_ref(
            pool, table, bases, ids, width=width, mask=masks))


@pytest.mark.gpu
def test_cuda_window_kernel_int64_offsets_past_2_31(cuda_device):
    """int64 offsets in a region of 2**32 words (a bf16 pool of 8 GiB):
    one window past word 2**31 and one that wraps at the region's end."""
    n = 1 << 32
    pool = torch.zeros(n, dtype=torch.bfloat16, device=cuda_device)
    pool[:4] = torch.arange(1, 5, device=cuda_device)
    pool[n - 4:] = torch.arange(5, 9, device=cuda_device)
    pool[(1 << 31) + 5:(1 << 31) + 9] = torch.arange(9, 13,
                                                     device=cuda_device)
    table = torch.tensor([(1 << 31) + 5, n - 2], device=cuda_device)
    masks = torch.full((2,), n - 1, device=cuda_device)
    bases = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    ids = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device)
    for mask in (masks, n - 1):
        out = tiara_gather_window(pool, table, bases, ids, width=4,
                                  mask=mask)
        torch.cuda.synchronize()
        assert out.float().tolist() == [[9, 10, 11, 12], [7, 8, 1, 2]]
    del pool
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("superops,double_buffer",
                         [(False, False), (False, True), (True, False),
                          (True, True)],
                         ids=["memcpy", "memcpy_dbuf", "chain", "chain_dbuf"])
def test_cuda_compiled_reads_regions_past_2_31_words(cuda_device, superops,
                                                     double_buffer):
    """The compiled trace on the card hands the kernel int64 offsets: a
    traced MEMCPY and the gather chain, under ``compiled`` and
    ``compiled_dbuf``, read a region of 2**32 words past word 2**31
    through ``tiara_gather`` and equal pyvm bit for bit (the CPU test's
    case, ``tests/torch_wide_region.py``)."""
    kernels.reset_launch_counts()
    compiled_matches_pyvm_past_2_31(superops, double_buffer, cuda_device)
    n = kernels.launch_counts()["tiara_gather"]
    assert n == (2 if double_buffer else 1) if superops else n >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("double_buffer", [False, True])
def test_cuda_gather_chain_unaligned_matches_pyvm(cuda_device,
                                                  double_buffer):
    """The compiled gather chain on the card with translation entries
    that are not block-aligned: one kernel launch per chunk, and the
    wave equals pyvm bit for bit."""
    k = ops.PagedKVFetch(n_blocks_pool=16, block_bytes=256,
                         max_req_blocks=2 * tc.DBUF_CHUNK, reply_slots=4)
    rt = k.regions()
    mem = memory.make_pool(1, rt)
    table = k.populate(mem, rt, seed=33)
    W = k.block_words
    table[1], table[14] = 5 * W + 3, 7
    memory.write_region(mem, rt, 0, "blocktable", table)
    k.make_request(mem, rt, [6, 1, 14, 2] + list(range(12)))
    v = verify(k.build(rt, reply_param=True), grant=Grant.all_of(rt),
               regions=rt)
    slot = k.max_req_blocks * W
    params = [[16 - i, i * slot] for i in range(4)]
    want = mem.copy()
    rs = [pyvm.run(v, rt, want, p) for p in params]
    assert all(r.status == isa.STATUS_OK for r in rs)
    kernels.reset_launch_counts()
    got = tc.invoke_compiled(v, rt, mem, params, device=cuda_device,
                             double_buffer=double_buffer)
    assert kernels.launch_counts()["tiara_gather"] == \
        (2 if double_buffer else 1)
    assert np.array_equal(got.mem.cpu().numpy(), want)
    assert list(np.asarray(got.ret)) == [r.ret for r in rs]
    assert list(np.asarray(got.steps)) == [r.steps for r in rs]


# -- tiara_gather's two regimes and its launch path --------------------------

# (width, offset kind): the small regime at and below its widest window;
# the stream regime's bulk interiors (8 KiB rows, aligned), its vector path
# (an interior under kBulkMinBytes), element by element (source and
# destination misaligned mod 16 bytes) and wrapping windows; and windows
# longer than one 8 KiB unit
REGIME_CASES = [(1, "any"), (2, "any"), (31, "wrap"), (32, "aligned"),
                (33, "off8"), (33, "aligned"), (1024, "aligned"),
                (1024, "off8"), (1025, "any"), (1024, "wrap"),
                (3000, "aligned"), (5000, "off8")]


def _regime_case(dev, dtype, width, kind, n, seed):
    rng = np.random.default_rng(seed)
    region = 1 << max(12, int(np.ceil(np.log2(width + 1))) + 1)
    elem = torch.empty((), dtype=dtype).element_size()
    per16 = 16 // elem
    pool = torch.from_numpy(rng.integers(0, 1 << 30, 3 * region + 7)) \
        .to(dev, dtype)
    T = n + 5
    off = rng.integers(0, region - width, T)
    if kind == "aligned":
        off = off // per16 * per16
    elif kind == "off8":
        off = off // per16 * per16 + 8 // elem
    elif kind == "wrap":
        off[::2] = region - 1 - rng.integers(0, width, off[::2].shape)
    table = torch.from_numpy(off.astype(np.int32)).to(dev)
    bases = torch.from_numpy(rng.integers(0, 3, T) * region).to(dev)
    masks = torch.full((T,), region - 1, dtype=torch.int64, device=dev)
    masks[1::3] = region // 2 - 1               # per-entry regions
    return pool, table, bases, masks, region - 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.int64, torch.float32,
                                   torch.bfloat16, torch.int32])
@pytest.mark.parametrize("width,kind", REGIME_CASES)
def test_cuda_tiara_gather_regimes_match_plain(cuda_device, dtype, width,
                                               kind):
    """Each regime and copy path, bit-equal to the plain version: with ids
    (duplicates among them) and without (entry i is id i, equal to
    ``arange``), one shared mask and per-entry masks; two calls give the
    same bits and each call adds one launch."""
    n = 300 if width <= 33 else 40
    pool, table, bases, masks, mask = _regime_case(cuda_device, dtype, width,
                                                   kind, n, width)
    ids = torch.randint(0, n + 5, (n,), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(width)) \
        .to(cuda_device)
    ids[: n // 4] = ids[0]
    arange = torch.arange(n + 5, dtype=torch.int32, device=cuda_device)
    for m in (mask, masks):
        for i in (ids, None, arange):
            before = kernels.launch_counts()["tiara_gather"]
            out = tiara_gather_window(pool, table, bases, i, width=width,
                                      mask=m)
            again = tiara_gather_window(pool, table, bases, i, width=width,
                                        mask=m)
            torch.cuda.synchronize()
            assert kernels.launch_counts()["tiara_gather"] == before + 2
            want = tiara_gather_window_ref(pool, table, bases, i,
                                           width=width, mask=m)
            assert torch.equal(out, want) and torch.equal(again, out)
        assert torch.equal(
            tiara_gather_window(pool, table, bases, width=width, mask=m),
            tiara_gather_window(pool, table, bases, arange, width=width,
                                mask=m))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 16, 132, 264, 4096])
def test_cuda_tiara_gather_path_rows_both_forms(cuda_device, n):
    """8 KiB int64 rows (the compiled gather chain's) at entry counts
    below, at and above the persistent grid's blocks: the window form
    without ids and the row form with them, bit-equal to the plain
    version and to each other."""
    rng = np.random.default_rng(n)
    rows, R = 8192, 1024
    flat = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, rows * R + 1)) \
        .to(cuda_device)
    blocks = torch.from_numpy(rng.choice(rows, n, replace=False)
                              .astype(np.int32)).to(cuda_device)
    zero = torch.zeros(n, dtype=torch.int64, device=cuda_device)
    win = tiara_gather_window(flat, blocks * R, zero, width=R,
                              mask=rows * R - 1)
    pool2d = flat[:rows * R].view(rows, R)
    ids = torch.arange(n, dtype=torch.int32, device=cuda_device)
    row = tiara_gather(pool2d, blocks, ids)
    torch.cuda.synchronize()
    assert torch.equal(win, tiara_gather_ref(pool2d, blocks, ids))
    assert torch.equal(row, win)


@pytest.mark.gpu
def test_cuda_tiara_gather_raises_on_what_it_does_not_take(cuda_device):
    """A CUDA operand the kernel does not take raises; nothing falls back
    to the plain version."""
    from repro_torch.kernels.tiara_gather import (tiara_gather_kernel,
                                                  tiara_gather_window_kernel)
    d = cuda_device
    pool = torch.zeros(64, dtype=torch.int64, device=d)
    t = torch.zeros(4, dtype=torch.int32, device=d)
    b = torch.zeros(4, dtype=torch.int64, device=d)
    bad = [
        lambda: tiara_gather_window_kernel(pool.double(), t, b, width=2,
                                           mask=15),
        lambda: tiara_gather_window_kernel(pool.view(8, 8), t, b, width=2,
                                           mask=15),
        lambda: tiara_gather_window_kernel(pool, t.long().double(), b,
                                           width=2, mask=15),
        lambda: tiara_gather_window_kernel(pool, t, b, t.long(), width=2,
                                           mask=15),
        lambda: tiara_gather_window_kernel(pool, t, b[:3], width=2, mask=15),
        lambda: tiara_gather_window_kernel(pool, t, b, width=2,
                                           mask=b[:3]),
        lambda: tiara_gather_window_kernel(pool, t, b, width=2,
                                           mask=b.int()),
        lambda: tiara_gather_window_kernel(pool, t.cpu(), b, width=2,
                                           mask=15),
        lambda: tiara_gather_window_kernel(pool, t, b, t.cpu(), width=2,
                                           mask=15),
        lambda: tiara_gather_window_kernel(pool[::2], t, b, width=2,
                                           mask=15),
        lambda: tiara_gather_window_kernel(
            pool, torch.zeros(8, dtype=torch.int32, device=d)[::2], b,
            width=2, mask=15),
        lambda: tiara_gather_window_kernel(pool, t, b, width=-1, mask=15),
        lambda: tiara_gather_window_kernel(pool, t, b, width=2, mask=-3),
        lambda: tiara_gather_kernel(pool, t, t),
        lambda: tiara_gather_kernel(pool.view(8, 8), t, None),
        lambda: tiara_gather_kernel(pool.view(8, 8).t(), t, t),
    ]
    before = kernels.launch_counts()["tiara_gather"]
    for i, call in enumerate(bad):
        with pytest.raises(ValueError):
            call()
            pytest.fail(f"case {i} did not raise")
    assert kernels.launch_counts()["tiara_gather"] == before


@pytest.mark.gpu
def test_cuda_engines_pass_no_ids(cuda_device, monkeypatch):
    """The engines' window reads (a traced MEMCPY, the gather chain, the
    lockstep host loop) pass no ``ids`` (no ``arange`` per call) and
    launch ``tiara_gather`` once per read, as before."""
    from repro_torch.core import lockstep_corpus as corpus
    from repro_torch.kernels.tiara_gather import ops as tops
    calls = []
    real = tops.tiara_gather_window_kernel

    def spy(pool, table, bases, ids=None, **kw):
        calls.append(ids)
        return real(pool, table, bases, ids, **kw)
    monkeypatch.setattr(tops, "tiara_gather_window_kernel", spy)
    for superops in (False, True):
        k = ops.PagedKVFetch(n_blocks_pool=16, block_bytes=256,
                             max_req_blocks=4, reply_slots=4)
        rt = k.regions()
        mem = memory.make_pool(1, rt)
        k.populate(mem, rt, seed=3)
        k.make_request(mem, rt, [6, 1, 14, 2])
        v = verify(k.build(rt, reply_param=True), grant=Grant.all_of(rt),
                   regions=rt)
        params = [[4, i * 4 * k.block_words] for i in range(4)]
        want = mem.copy()
        rs = [pyvm.run(v, rt, want, p) for p in params]
        calls.clear()
        kernels.reset_launch_counts()
        got = tc.invoke_compiled(v, rt, mem, params, device=cuda_device,
                                 superops=superops)
        assert np.array_equal(got.mem.cpu().numpy(), want)
        assert list(np.asarray(got.ret)) == [r.ret for r in rs]
        assert calls and all(i is None for i in calls)
        assert kernels.launch_counts()["tiara_gather"] == len(calls)
        if superops:
            assert len(calls) == 1
    w = next(w for w in corpus.stock_waves(7, block_bytes=256)
             if w.name.startswith("paged_kv_fetch"))
    eng = w.engine()
    mem = torch.from_numpy(w.mem.copy()).to(cuda_device)
    calls.clear()
    kernels.reset_launch_counts()
    got = eng.run_host_loop(mem, *w.args())
    want = eng.run_host_loop(torch.from_numpy(w.mem.copy()), *w.args())
    assert torch.equal(got.mem.cpu(), want.mem)
    assert calls and all(i is None for i in calls)
    assert kernels.launch_counts()["tiara_gather"] == len(calls)


# -- attention kernels -------------------------------------------------------

ATTN_TOL = {torch.float32: 3e-5, torch.bfloat16: 0.05}


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape)).to(device, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,qh,kvh,d,pages,page,maxp", [
    (2, 4, 4, 32, 8, 8, 3),      # MHA
    (3, 8, 2, 64, 16, 8, 5),     # GQA 4:1
    (1, 7, 1, 16, 4, 4, 2),      # MQA, G = 7
    (2, 4, 2, 128, 8, 16, 4),    # head_dim 128
    (3, 12, 4, 64, 40, 16, 9),   # tiny-lm's heads, lengths past one chunk
    (3, 10, 2, 128, 8, 128, 3),  # Llama-4 Scout's G = 5, D = 128, page 128
    (3, 28, 4, 128, 12, 128, 3),  # Qwen2-VL's G = 7, D = 128, page 128
    (3, 16, 16, 64, 12, 128, 3),  # SeamlessM4T's G = 1, D = 64, page 128
])
def test_cuda_paged_attention_matches_plain(cuda_device, dtype, b, qh, kvh,
                                            d, pages, page, maxp):
    from repro_torch.kernels.paged_attention import paged_attention
    rng = np.random.default_rng(b * 1000 + qh * 10 + d)
    q = _randn(rng, (b, qh, d), dtype, cuda_device)
    k = _randn(rng, (pages, page, kvh, d), dtype, cuda_device)
    v = _randn(rng, (pages, page, kvh, d), dtype, cuda_device)
    bt = torch.from_numpy(rng.integers(0, pages, (b, maxp))
                          .astype(np.int32)).to(cuda_device)
    ln = rng.integers(1, maxp * page + 1, (b,)).astype(np.int32)
    ln[0] = 0                                       # a length-0 row
    if b > 1:
        ln[1] = maxp * page                         # every page live
    ln = torch.from_numpy(ln).to(cuda_device)
    before = kernels.launch_counts()["paged_attention"]
    out = paged_attention(q, k, v, bt, ln)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_attention"] == before + 1
    want = paged_attention(q.cpu(), k.cpu(), v.cpu(), bt.cpu(), ln.cpu())
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.cpu().float(), want.float(), atol=tol,
                               rtol=tol)
    assert torch.all(out[0] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,qh,kvh,s,d", [
    (2, 4, 2, 64, 32),
    (1, 8, 8, 128, 64),
    (2, 6, 2, 96, 16),
    (1, 4, 2, 200, 128),         # ragged: 200 is no multiple of the tile
    (2, 3, 1, 37, 64),
    (1, 10, 2, 150, 128),        # Llama-4 Scout's G = 5, D = 128
])
def test_cuda_flash_attention_matches_plain(cuda_device, dtype, causal, b,
                                            qh, kvh, s, d):
    from repro_torch.kernels.flash_attention import flash_attention
    rng = np.random.default_rng(b * 1000 + s + d)
    q = _randn(rng, (b, qh, s, d), dtype, cuda_device)
    k = _randn(rng, (b, kvh, s, d), dtype, cuda_device)
    v = _randn(rng, (b, kvh, s, d), dtype, cuda_device)
    ln = rng.integers(1, s + 1, (b,)).astype(np.int32)
    if b > 1:
        ln[1] = 0                                   # every row masked
    ln = torch.from_numpy(ln).to(cuda_device)
    before = kernels.launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, ln, causal=causal)
    full = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == before + 2
    tol = ATTN_TOL[dtype]
    for got, lens in ((out, ln.cpu()), (full, None)):
        want = flash_attention(q.cpu(), k.cpu(), v.cpu(), lens,
                               causal=causal)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   atol=tol, rtol=tol)
    if b > 1:
        assert torch.all(out[1] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(1, 150), (1, 64), (70, 200), (300, 37)])
def test_cuda_flash_attention_cross_shapes(cuda_device, dtype, sq, sk):
    """Cross attention's launches: non-causal, Sq != Sk (Sq = 1 in every
    decode step: one live row in a tile of 64), SeamlessM4T's 16/16 heads
    of 64, keys masked past ragged lengths that are no multiple of the
    tile, one of them 0 (that request's rows are 0).  Equal to the plain
    version (a row stored past Sq would land in the next head's rows) and
    the same bits twice."""
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_ref)
    rng = np.random.default_rng(sq * 1000 + sk)
    q = _randn(rng, (3, 16, sq, 64), dtype, cuda_device)
    k = _randn(rng, (3, 16, sk, 64), dtype, cuda_device)
    v = _randn(rng, (3, 16, sk, 64), dtype, cuda_device)
    ln = torch.tensor([sk, 0, max(1, sk - 29)], dtype=torch.int32,
                      device=cuda_device)
    out = flash_attention_kernel(q, k, v, ln, causal=False)
    again = flash_attention_kernel(q, k, v, ln, causal=False)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(
        out.float(), flash_attention_ref(q, k, v, ln, causal=False).float(),
        atol=tol, rtol=tol)
    assert torch.equal(out, again)
    assert torch.all(out[1] == 0)


@pytest.mark.gpu
def test_cuda_attention_impl_torch_raises(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    q = torch.zeros((1, 2, 16, 16), device=cuda_device)
    with pytest.raises(ValueError, match="CPU tensors"):
        flash_attention(q, q, q, impl="torch")
    pages = torch.zeros((2, 4, 2, 16), device=cuda_device)
    bt = torch.zeros((1, 2), dtype=torch.int32, device=cuda_device)
    ln = torch.ones((1,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="CPU tensors"):
        paged_attention(q[:, :, 0], pages, pages, bt, ln, impl="torch")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :8].contiguous(), q[..., :8].contiguous(),
                        q[..., :8].contiguous())
    with pytest.raises(ValueError, match="head_dim"):
        paged_attention(q[:, :, 0, :8].contiguous(),
                        pages[..., :8].contiguous(),
                        pages[..., :8].contiguous(), bt, ln)


@pytest.mark.gpu
def test_cuda_paged_attention_matches_flash_on_same_kv(cuda_device):
    """Decode over a paged layout == the last row of full attention over
    the equivalent contiguous KV, both kernels on the card."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    rng = np.random.default_rng(5)
    b, qh, kvh, d, page, maxp = 2, 4, 2, 32, 8, 4
    s = maxp * page
    k_lin = _randn(rng, (b, kvh, s, d), torch.float32, cuda_device)
    v_lin = _randn(rng, (b, kvh, s, d), torch.float32, cuda_device)
    q1 = _randn(rng, (b, qh, d), torch.float32, cuda_device)
    bt = (torch.arange(b)[:, None] * maxp + torch.arange(maxp)[None]) \
        .to(cuda_device, torch.int32)
    k_pages = k_lin.permute(0, 2, 1, 3).reshape(b * maxp, page, kvh, d) \
        .contiguous()
    v_pages = v_lin.permute(0, 2, 1, 3).reshape(b * maxp, page, kvh, d) \
        .contiguous()
    ln = torch.tensor([s, s - 5], dtype=torch.int32, device=cuda_device)
    out_paged = paged_attention(q1, k_pages, v_pages, bt, ln)
    out_flash = flash_attention(q1[:, :, None, :].contiguous(), k_lin,
                                v_lin, ln, causal=False)[:, :, 0]
    torch.testing.assert_close(out_paged, out_flash, atol=3e-5, rtol=3e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("partition_tokens", [64, 128, 256])
def test_cuda_paged_attention_partitions(cuda_device, monkeypatch, dtype,
                                         partition_tokens):
    """The sequence split at every partition size: a length 0, one shorter
    than a partition, exact multiples of T, one past a multiple, and the
    whole table, whose 21 pages x 16 = 336 tokens are no multiple of T;
    against the plain version and the plain partition-and-combine."""
    from repro_torch.kernels.paged_attention import (kernel,
                                                     paged_attention_kernel,
                                                     paged_attention_ref)
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_partitioned_ref)
    T = partition_tokens
    monkeypatch.setattr(kernel, "PARTITION_TOKENS", T)
    rng = np.random.default_rng(T)
    b, kvh, g, d, pages, page, maxp = 6, 2, 3, 64, 160, 16, 21
    q = _randn(rng, (b, kvh, g, d), dtype, cuda_device)
    k = _randn(rng, (pages, page, kvh, d), dtype, cuda_device)
    v = _randn(rng, (pages, page, kvh, d), dtype, cuda_device)
    bt = torch.from_numpy(rng.permutation(pages)[:b * maxp]
                          .reshape(b, maxp).astype(np.int32)).to(cuda_device)
    n_tok = maxp * page
    ln = torch.tensor([0, 5, T, min(2 * T, n_tok), T + 1, n_tok],
                      dtype=torch.int32, device=cuda_device)
    out = paged_attention_kernel(q, k, v, bt, ln)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(),
                               paged_attention_ref(q, k, v, bt, ln).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(
        out.float(), paged_attention_partitioned_ref(
            q, k, v, bt, ln, partition_tokens=T).float(), atol=tol, rtol=tol)
    assert torch.all(out[0] == 0)
    assert torch.isfinite(out.float()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("partition_tokens", [128, 256])
def test_cuda_paged_attention_is_deterministic(cuda_device, monkeypatch,
                                               partition_tokens):
    """Two calls on the same inputs give the same bits: the partitions are
    combined in order, with no atomics."""
    from repro_torch.kernels.paged_attention import (kernel,
                                                     paged_attention_kernel)
    monkeypatch.setattr(kernel, "PARTITION_TOKENS", partition_tokens)
    rng = np.random.default_rng(17)
    b, kvh, g, d, page, maxp = 8, 4, 3, 64, 16, 128
    q = _randn(rng, (b, kvh, g, d), torch.float32, cuda_device)
    k = _randn(rng, (b * maxp, page, kvh, d), torch.float32, cuda_device)
    v = _randn(rng, (b * maxp, page, kvh, d), torch.float32, cuda_device)
    bt = torch.from_numpy(rng.permutation(b * maxp).reshape(b, maxp)
                          .astype(np.int32)).to(cuda_device)
    ln = torch.from_numpy(rng.integers(0, maxp * page + 1, b)
                          .astype(np.int32)).to(cuda_device)
    a = paged_attention_kernel(q, k, v, bt, ln)
    c = paged_attention_kernel(q, k, v, bt, ln)
    torch.cuda.synchronize()
    assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(256, 256), (70, 150), (150, 70)])
def test_cuda_flash_attention_tf32_shapes(cuda_device, dtype, causal, sq,
                                          sk):
    """The tensor-core kernel at the short prefill bucket and with Sq != Sk
    (both ragged), every key live or lengths short of Sk; two calls give
    the same bits."""
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_ref)
    rng = np.random.default_rng(sq + sk)
    q = _randn(rng, (2, 6, sq, 64), dtype, cuda_device)
    k = _randn(rng, (2, 2, sk, 64), dtype, cuda_device)
    v = _randn(rng, (2, 2, sk, 64), dtype, cuda_device)
    ln = torch.tensor([sk, sk // 3], dtype=torch.int32, device=cuda_device)
    tol = ATTN_TOL[dtype]
    for lens in (None, ln):
        out = flash_attention_kernel(q, k, v, lens, causal=causal)
        again = flash_attention_kernel(q, k, v, lens, causal=causal)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out.float(), flash_attention_ref(q, k, v, lens,
                                             causal=causal).float(),
            atol=tol, rtol=tol)
        assert torch.equal(out, again)


# bf16 flash_attention (csrc/flash_attention_bf16.cu) against its plain
# version within two bf16 ulps, chip_smoke.py's SCOUT_ATTN_TOL (atol, rtol):
# both sum in f32 and round the output to bf16 once, the kernel's P split
# in two bf16 parts (tests/test_torch_flash_bf16_split.py); its lse within
# LSE_TOL of the plain log-sum-exp.
BF16_ATTN_TOL = (1e-4, 2 ** -6)
LSE_TOL = (1e-5, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,qh,kvh,sq,sk,d,causal,lens", [
    (2, 10, 2, 300, 300, 128, True, (300, 0)),        # G = 5, D = 128
    (2, 14, 2, 257, 257, 128, True, (257, 100)),      # G = 7, ragged
    (3, 8, 4, 200, 333, 64, False, (333, 0, 150)),    # Sq != Sk, full
    (3, 16, 16, 1, 1000, 64, False, (1000, 0, 300)),  # Sq = 1, ragged
    (2, 14, 2, 1, 257, 128, True, None),              # Sq = 1, G = 7
    (2, 4, 2, 130, 77, 32, True, None),               # D = 32, Sq > Sk
    (1, 2, 1, 70, 70, 16, False, (70,)),              # D = 16
])
def test_cuda_flash_attention_bf16_route(cuda_device, b, qh, kvh, sq, sk, d,
                                         causal, lens):
    """The bf16 route at G = 5 and 7, D from 16 to 128, Sq != Sk, Sq = 1,
    ragged S and a length of 0 (its rows 0, their lse +inf): out within
    two bf16 ulps of the plain version, lse within LSE_TOL, and the same
    bits on every call, with or without lse."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_kernel, flash_attention_lse_ref, flash_attention_ref)
    rng = np.random.default_rng(sq * 1000 + sk + d)
    q = _randn(rng, (b, qh, sq, d), torch.bfloat16, cuda_device)
    k = _randn(rng, (b, kvh, sk, d), torch.bfloat16, cuda_device)
    v = _randn(rng, (b, kvh, sk, d), torch.bfloat16, cuda_device)
    ln = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=cuda_device)
    out, lse = flash_attention_kernel(q, k, v, ln, causal=causal,
                                      return_lse=True)
    again = flash_attention_kernel(q, k, v, ln, causal=causal)
    torch.cuda.synchronize()
    atol, rtol = BF16_ATTN_TOL
    torch.testing.assert_close(
        out.float(), flash_attention_ref(q, k, v, ln, causal=causal).float(),
        atol=atol, rtol=rtol)
    assert torch.equal(out, again)
    want = flash_attention_lse_ref(q, k, ln, causal=causal)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    live = torch.isfinite(want)
    torch.testing.assert_close(lse[live], want[live], atol=LSE_TOL[0],
                               rtol=LSE_TOL[1])
    if lens is not None and 0 in lens:
        row = lens.index(0)
        assert torch.all(out[row] == 0) and torch.all(torch.isinf(lse[row]))


# -- the serving engine on the card ------------------------------------------


@pytest.mark.gpu
def test_cuda_engine_tiara_matches_host(cuda_device):
    """Reduced tiny-lm on the card: greedy tokens under resolver="tiara"
    equal resolver="host"; prefill launches flash_attention once per layer
    per prompt, every decode step launches paged_attention once per
    layer, and the tiara resolver's waves launch a tiara kernel
    (tiara_gather from a compiled trace, lockstep_vm for a lockstep
    wave), the host resolver's none."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine
    cfg = reduce_config(get_config("tiny-lm"))
    params = tf.init_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(3)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, 4 + 9 * i)))
               for i in range(3)]
    outs, counts = {}, {}
    for resolver in ("host", "tiara"):
        eng = ServingEngine(cfg, params, max_slots=2, max_seq=64, eos_id=-1,
                            temperature=0.0, resolver=resolver,
                            device=cuda_device)
        steps = [0]
        step = eng.step

        def counted():
            if any(s is not None for s in eng.active) or eng.waiting:
                steps[0] += 1
            return step()
        eng.step = counted
        kernels.reset_launch_counts()
        hs = [eng.submit(p, max_new=5) for p in prompts]
        outs[resolver] = eng.run_to_completion()
        torch.cuda.synchronize()
        counts[resolver] = kernels.launch_counts()
        assert all(h.ok for h in hs)
        assert counts[resolver]["flash_attention"] == \
            cfg.n_layers * len(prompts)
        assert counts[resolver]["paged_attention"] == \
            cfg.n_layers * steps[0]
    assert outs["tiara"] == outs["host"]
    assert counts["host"]["tiara_gather"] == 0
    assert counts["host"]["lockstep_vm"] == 0
    assert counts["tiara"]["tiara_gather"] \
        + counts["tiara"]["lockstep_vm"] >= 1


@pytest.mark.gpu
def test_cuda_moe_engine_tiara_matches_host(cuda_device):
    """Reduced Llama-4 Scout on the card: greedy tokens under
    resolver="tiara" equal resolver="host"; the tiara resolver's waves,
    which also resolve expert routes, launch a tiara kernel (tiara_gather
    from a compiled trace, lockstep_vm for a lockstep wave), the host
    resolver's none."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine
    cfg = reduce_config(get_config("llama4-scout-17b-a16e"))
    params = tf.init_params(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(4)
    prompts = [list(map(int, rng.integers(1, cfg.vocab, 4 + 9 * i)))
               for i in range(3)]
    outs, counts = {}, {}
    for resolver in ("host", "tiara"):
        eng = ServingEngine(cfg, params, max_slots=2, max_seq=64, eos_id=-1,
                            temperature=0.0, resolver=resolver,
                            device=cuda_device)
        kernels.reset_launch_counts()
        hs = [eng.submit(p, max_new=4) for p in prompts]
        outs[resolver] = eng.run_to_completion()
        torch.cuda.synchronize()
        counts[resolver] = kernels.launch_counts()
        assert all(h.ok for h in hs)
    assert outs["tiara"] == outs["host"]
    assert counts["host"]["tiara_gather"] == 0
    assert counts["host"]["lockstep_vm"] == 0
    assert counts["tiara"]["tiara_gather"] \
        + counts["tiara"]["lockstep_vm"] >= 1
    assert eng.resolver.moe is not None
    assert eng.resolver.loop.stats.executed > 0


@pytest.mark.gpu
def test_cuda_engine_cost_measured_defaults_to_the_card(cuda_device,
                                                        monkeypatch):
    """With no device named, EngineCost.measured times a launch on the
    card (it synchronizes the card after every launch)."""
    from repro_torch.core.costmodel import EngineCost
    synced = []
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: synced.append(d) or sync(d))
    cost = EngineCost.measured(reps=3)
    assert cost.launch_us >= 1.0
    assert len(synced) == 4 and all(torch.device(d).type == "cuda"
                                    for d in synced)


@pytest.mark.gpu
def test_cuda_engine_tf32_guard_applies_to_f32_only(cuda_device,
                                                    monkeypatch):
    """With TF32 matmuls allowed, the engine refuses an f32 model (its
    products would round to TF32) and serves a bf16 one, whose products
    the flag does not touch."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    cfg = reduce_config(get_config("llama4-scout-17b-a16e"))
    with pytest.raises(ValueError, match="allow_tf32"):
        ServingEngine(cfg, tf.init_params(cfg, seed=0), device=cuda_device)
    cfg = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    eng = ServingEngine(cfg, tf.init_params(cfg, seed=0), max_slots=2,
                        max_seq=64, eos_id=-1, device=cuda_device)
    assert len(eng.submit([1, 2, 3], max_new=2).result()) == 2


# -- the recurrent families on the card --------------------------------------

# The card against the port on the CPU, both f32 (no TF32): cuBLAS and the
# CPU BLAS sum in other orders, the kernels' online softmax against the
# plain two-pass one; the recurrences do not amplify it (decays in (0, 1)).
RECURRENT_CARD_TOL = 1e-4


def _recurrent_leaves(caches):
    return [t for c in caches for f in c if f is not None for t in f]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-1.6b"])
def test_cuda_recurrent_model_matches_cpu(cuda_device, arch):
    """Reduced Jamba (one period: 1 attention + 7 Mamba layers, top-2 MoE)
    and RWKV-6 on the card, through init_caches, prefill with ragged
    lengths and two decode steps: logits and every carried state equal
    the port on the CPU with the same weights.  Jamba's prefill launches
    flash_attention once per attention layer, each decode step
    paged_attention once per attention layer; the prefill and each decode
    step launch selective_scan once per Mamba layer and wkv6 once per
    RWKV layer (RWKV-6 launches no attention kernel)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import tree_map
    cfg = reduce_config(get_config(arch))
    cfg = cfg.replace(n_layers=len(cfg.pattern))
    n_attn = sum(s.kind == "attn" for s in cfg.pattern)
    n_mamba = sum(s.kind == "mamba" for s in cfg.pattern)
    n_rwkv = sum(s.kind == "rwkv" for s in cfg.pattern)
    params = tf.init_params(cfg, seed=0)
    b, maxp = 3, 4
    rng = np.random.default_rng(8)
    toks = [rng.integers(1, cfg.vocab, (b, 20))] + \
        [rng.integers(1, cfg.vocab, (b, 1)) for _ in range(2)]
    lengths = np.array([20, 13, 1])
    got = {}
    for dev in (cuda_device, torch.device("cpu")):
        p = tree_map(lambda a: a.to(dev), params)
        caches = tf.init_caches(cfg, b, maxp, device=dev)
        bt = tf.default_block_tables(cfg, b, maxp, device=dev)
        kernels.reset_launch_counts()
        logits = []
        for step in range(3):
            fn = tf.prefill if step == 0 else tf.decode_step
            out = fn(p, cfg, dict(
                tokens=torch.from_numpy(toks[step]).to(dev), caches=caches,
                block_tables=bt,
                lengths=torch.from_numpy(lengths + max(step - 1, 0))
                .to(dev, torch.int32)))
            logits.append(out.logits.cpu())
            if dev.type == "cuda":
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                assert counts["flash_attention"] == n_attn
                assert counts["paged_attention"] == n_attn * step
                assert counts["selective_scan"] == n_mamba * (step + 1)
                assert counts["wkv6"] == n_rwkv * (step + 1)
        got[dev.type] = (logits,
                         [t.cpu() for t in _recurrent_leaves(caches)])
    (lc, sc), (lh, sh) = got["cuda"], got["cpu"]
    for a, c in zip(lc + sc, lh + sh):
        assert torch.allclose(a, c, atol=RECURRENT_CARD_TOL,
                              rtol=RECURRENT_CARD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "seamless-m4t-medium"])
def test_cuda_multimodal_model_matches_cpu(cuda_device, arch):
    """Reduced Qwen2-VL (M-RoPE with distinct t/h/w streams, an image
    prefix of embeddings) and SeamlessM4T (an encoder over ragged frames,
    one request with encoder length 0; cross attention) on the card,
    through init_caches, a ragged prefill and two decode steps: logits and
    every cache leaf equal the port on the CPU with the same weights.
    Launches: flash_attention once per attention layer per prefill
    (SeamlessM4T: encoder, decoder self and cross attention), and per
    decode step paged_attention once per decoder layer plus, for
    SeamlessM4T, one cross-attention flash_attention per layer."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import tree_map
    cfg = reduce_config(get_config(arch))
    params = tf.init_params(cfg, seed=0)
    b, s, maxp, s_enc = 3, 20, 4, 13
    rng = np.random.default_rng(10)
    toks = [rng.integers(1, cfg.vocab, (b, s))] + \
        [rng.integers(1, cfg.vocab, (b, 1)) for _ in range(2)]
    lengths = np.array([20, 13, 1])
    # t/h/w ids: an image prefix of 2 x 3 patches, then text from 3 on
    pos = np.zeros((3, b, s + 2), np.int64)
    pos[1, :, :6], pos[2, :, :6] = np.arange(6) // 3, np.arange(6) % 3
    pos[:, :, 6:] = 3 + np.arange(s - 4)
    emb = np.zeros((b, s, cfg.d_model), np.float32)
    emb[:, :6] = rng.standard_normal((b, 6, cfg.d_model))
    enc = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)
    enc_len = np.array([13, 0, 6], np.int32)
    n_dec = cfg.n_layers
    n_prefill = n_dec + (n_dec + cfg.n_enc_layers if cfg.enc_dec else 0)
    got = {}
    for dev in (cuda_device, torch.device("cpu")):
        p = tree_map(lambda a: a.to(dev), params)
        caches = tf.init_caches(cfg, b, maxp, device=dev,
                                cross_len=s_enc if cfg.enc_dec else 0)
        bt = tf.default_block_tables(cfg, b, maxp, device=dev)
        kernels.reset_launch_counts()
        logits = []
        for step in range(3):
            ln = lengths + max(step - 1, 0)
            batch = dict(tokens=torch.from_numpy(toks[step]).to(dev),
                         caches=caches, block_tables=bt,
                         lengths=torch.from_numpy(ln).to(dev, torch.int32))
            if cfg.rope == "mrope":
                p3 = pos[:, :, :s] if step == 0 else \
                    pos[:, np.arange(b), ln][:, :, None]
                batch["positions3"] = torch.from_numpy(
                    np.ascontiguousarray(p3)).to(dev)
                if step == 0:
                    batch["embeds"] = torch.from_numpy(emb).to(dev)
            if cfg.enc_dec:
                batch["enc_lengths"] = torch.from_numpy(enc_len).to(dev)
                if step == 0:
                    batch["enc_embeds"] = torch.from_numpy(enc).to(dev)
            fn = tf.prefill if step == 0 else tf.decode_step
            logits.append(fn(p, cfg, batch).logits.cpu())
            if dev.type == "cuda":
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                per_step = n_dec if cfg.enc_dec else 0
                assert counts["flash_attention"] == n_prefill \
                    + per_step * step
                assert counts["paged_attention"] == n_dec * step
        got[dev.type] = (logits, [t.cpu() for c in caches for f in c
                                  if f is not None
                                  for t in ([f] if torch.is_tensor(f)
                                            else f)])
    (lc, sc), (lh, sh) = got["cuda"], got["cpu"]
    assert len(sc) == (4 if cfg.enc_dec else 2)
    for a, c in zip(lc + sc, lh + sh):
        assert torch.allclose(a, c, atol=RECURRENT_CARD_TOL,
                              rtol=RECURRENT_CARD_TOL)


@pytest.mark.gpu
def test_cuda_recurrent_functions_match_cpu(cuda_device):
    """mamba_forward, rwkv_time_mix and rwkv_channel_mix on the card
    against the CPU at a width of 256 with a 300-token ragged prefill from
    a cache; also in bf16, within 2**-6 relative (two bf16 ulps: both
    round the same f32 recurrence to bf16 at the same points)."""
    from repro_torch.models import mamba, rwkv
    from repro_torch.models.param import materialize, tree_map
    d = 256
    mspec = mamba.MambaSpec(d_state=16, d_conv=4, expand=2)
    rspec = rwkv.RWKVSpec(head_size=64, decay_lora=32)
    gen = torch.Generator().manual_seed(9)
    for dtype, tol in ((torch.float32, RECURRENT_CARD_TOL),
                       (torch.bfloat16, 2 ** -6)):
        mw = materialize(mamba.mamba_defs(d, mspec), gen, dtype)
        tw = materialize(rwkv.rwkv_time_defs(d, rspec), gen, dtype)
        cw = materialize(rwkv.rwkv_channel_defs(d, 3 * d), gen, dtype)
        x = torch.randn((2, 300, d), generator=gen).to(dtype)
        ln = torch.tensor([300, 117])
        mc = mamba.init_mamba_cache(2, d, mspec, dtype)
        rc = rwkv.init_rwkv_cache(2, d, rspec, dtype)
        outs = {}
        for dev in (cuda_device, torch.device("cpu")):
            def on(t):
                return tree_map(lambda a: a.to(dev), t)
            m = mamba.mamba_forward(on(mw), x.to(dev), mspec,
                                    mamba.MambaCache(*on(tuple(mc))),
                                    lengths=ln.to(dev))
            r = rwkv.rwkv_time_mix(on(tw), x.to(dev), rspec,
                                   rwkv.RWKVCache(*on(tuple(rc))),
                                   lengths=ln.to(dev))
            c = rwkv.rwkv_channel_mix(on(cw), x.to(dev), None,
                                      lengths=ln.to(dev))
            outs[dev.type] = [t.float().cpu() for t in
                              (m[0], *m[1], r[0], *r[1], *c)]
        for a, c in zip(outs["cuda"], outs["cpu"]):
            assert torch.allclose(a, c, atol=tol, rtol=tol), dtype


# -- training: the flash_attention backward, the train step, the trainer ----

# The backward kernel against flash_attention_bwd_ref: in f32 within 1e-4
# of each gradient's largest entry (both sum in f32, in other orders, over
# up to Sq query rows); in bf16 within two bf16 ulps of the f32 plain
# result (2**-6 relative, both round an f32 sum once), plus the same 1e-4
# for entries near 0.
BWD_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-4, 2 ** -6)}
# The forward's lse against its plain version, (atol, rtol): both sum in
# f32 in other orders, the kernel's products in 3xTF32 (errors about 1e-6
# on rows whose lse is about 5).
LSE_TOL = (1e-5, 1e-5)
# The forward's output against its plain version, (atol, rtol): in bf16
# both compute in f32 and round once, so two bf16 ulps.
FWD_TOL = {torch.float32: (3e-5, 3e-5), torch.bfloat16: (1e-4, 2 ** -6)}


def _bwd_close(got, want, dtype):
    atol, rtol = BWD_TOL[dtype]
    want = want.float().cpu()
    torch.testing.assert_close(got.float().cpu(), want, rtol=rtol,
                               atol=atol * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,qh,kvh,sq,sk,d", [
    (2, 4, 2, 64, 64, 32),
    (1, 6, 2, 200, 130, 128),    # Sq > Sk, ragged tiles
    (2, 7, 1, 70, 150, 64),      # G = 7, Sq < Sk
    (3, 3, 3, 37, 37, 16),       # G = 1
])
def test_cuda_flash_attention_bwd_matches_plain(cuda_device, dtype, causal,
                                                b, qh, kvh, sq, sk, d):
    """The backward kernel against its plain version at every head dim,
    GQA group, causal or full, Sq != Sk, ragged lengths with a 0 (whose
    gradients are 0); the same bits twice; the forward's output the same
    bits with and without lse, within FWD_TOL of the plain forward, and
    its lse against the plain log-sum-exp (+inf on a row with no live
    key).  The plain backward takes the plain lse, so a wrong lse cannot
    pass on both sides, and the kernel's output: in bf16 the backward's
    rowsum(dO o) carries o's rounding, so the plain forward's output (an
    ulp away) would move the gradients by more than two ulps."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_bwd_ref,
        flash_attention_kernel, flash_attention_lse_ref,
        flash_attention_ref)
    rng = np.random.default_rng(b * 1000 + sq + sk + d)
    q = _randn(rng, (b, qh, sq, d), dtype, cuda_device)
    k = _randn(rng, (b, kvh, sk, d), dtype, cuda_device)
    v = _randn(rng, (b, kvh, sk, d), dtype, cuda_device)
    do = _randn(rng, (b, qh, sq, d), dtype, cuda_device)
    ln = rng.integers(1, sk + 1, (b,)).astype(np.int32)
    if b > 1:
        ln[1] = 0
    ln = torch.from_numpy(ln).to(cuda_device)
    out0 = flash_attention_kernel(q, k, v, ln, causal=causal)
    out, lse = flash_attention_kernel(q, k, v, ln, causal=causal,
                                      return_lse=True)
    before = kernels.launch_counts()["flash_attention_bwd"]
    got = flash_attention_bwd_kernel(q, k, v, out, lse, do, ln,
                                     causal=causal)
    again = flash_attention_bwd_kernel(q, k, v, out, lse, do, ln,
                                       causal=causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_bwd"] == before + 2
    assert torch.equal(out0, out)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    want_lse = flash_attention_lse_ref(q, k, ln, causal=causal)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    live = torch.isfinite(want_lse)
    torch.testing.assert_close(lse[live], want_lse[live], atol=LSE_TOL[0],
                               rtol=LSE_TOL[1])
    torch.testing.assert_close(
        out.float(), flash_attention_ref(q, k, v, ln, causal=causal).float(),
        atol=FWD_TOL[dtype][0], rtol=FWD_TOL[dtype][1])
    want = flash_attention_bwd_ref(q, k, v, out, want_lse, do, ln,
                                   causal=causal)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _bwd_close(g, w, dtype)
    if b > 1:
        assert torch.isinf(lse[1]).all()
        assert not any(g[1].any() for g in got)


@pytest.mark.gpu
def test_cuda_flash_attention_autograd_runs_both_kernels(cuda_device):
    """With gradients on, flash_attention on the card runs the forward
    kernel and, in the backward, the backward kernel: one launch each."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd_kernel, flash_attention_kernel)
    rng = np.random.default_rng(3)
    q, k, v = (_randn(rng, s, torch.float32, cuda_device).requires_grad_()
               for s in ((2, 6, 96, 64), (2, 2, 96, 64), (2, 2, 96, 64)))
    do = _randn(rng, (2, 6, 96, 64), torch.float32, cuda_device)
    ln = torch.tensor([96, 40], dtype=torch.int32, device=cuda_device)
    kernels.reset_launch_counts()
    out = flash_attention(q, k, v, ln, causal=True)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["flash_attention"], counts["flash_attention_bwd"]) == \
        (1, 1)
    with torch.no_grad():
        o, lse = flash_attention_kernel(q, k, v, ln, return_lse=True)
        want = flash_attention_bwd_kernel(q, k, v, o, lse, do, ln)
    assert torch.equal(out.detach(), o)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def _np_state(cfg, seed):
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step
    init, _ = make_train_step(cfg, AdamWConfig(lr=lambda s: 1e-3))
    return train_state_to_numpy(init(seed, device="cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tiny-lm", "seamless-m4t-medium"])
def test_cuda_train_step_matches_cpu(cuda_device, arch):
    """One train step of a reduced model on the card and on the CPU from
    the same state and batch: loss and every gradient within 1e-3 of the
    leaf's largest entry (cuBLAS and the kernels sum in other orders than
    the CPU's BLAS and the plain attention, through the forward and the
    backward).  Launches per step under remat "full": flash_attention
    forward twice per checkpointed attention call (the recompute), once
    per encoder layer, and the backward once per attention call."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.models.param import tree_leaves
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import make_train_step
    cfg = reduce_config(get_config(arch))
    np_state = _np_state(cfg, 4)
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 40)),
             "labels": rng.integers(0, cfg.vocab, (2, 40))}
    if cfg.enc_dec:
        batch["enc_embeds"] = rng.standard_normal(
            (2, 24, cfg.d_model)).astype(np.float32)
        batch["enc_lengths"] = np.array([24, 9], np.int32)
    got = {}
    for dev in (cuda_device, torch.device("cpu")):
        caught = {}

        def catch(g, caught=caught):
            caught["g"] = g
            return g
        _, step = make_train_step(cfg, AdamWConfig(lr=lambda s: 1e-3),
                                  grad_compressor=catch)
        state = train_state_from_numpy(np_state, device=dev)
        kernels.reset_launch_counts()
        state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                for k, v in batch.items()})
        if dev.type == "cuda":
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
        got[dev.type] = (float(m["loss"]),
                         [g.cpu() for g in tree_leaves(caught["g"])])
    n_dec = cfg.n_layers * (2 if cfg.enc_dec else 1)
    assert counts["flash_attention"] == 2 * n_dec + cfg.n_enc_layers
    assert counts["flash_attention_bwd"] == n_dec + cfg.n_enc_layers
    assert counts["paged_attention"] == counts["tiara_gather"] == 0
    (lc, gc), (lh, gh) = got["cuda"], got["cpu"]
    assert abs(lc - lh) <= 1e-3 * abs(lh)
    for a, c in zip(gc, gh):
        torch.testing.assert_close(a, c, rtol=1e-3,
                                   atol=1e-3 * float(c.abs().max()))


@pytest.mark.gpu
def test_cuda_trainer_restart_equals_the_uninterrupted_run(cuda_device,
                                                           tmp_path):
    """Reduced tiny-lm through Trainer on the card: 6 steps with a
    checkpoint at 3; a restart from the step-3 checkpoint (copied alone
    into a fresh directory) ends on the uninterrupted run's parameters bit
    for bit — every kernel of the step is deterministic."""
    import shutil
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data import DataConfig
    from repro_torch.models.param import tree_leaves
    from repro_torch.training import Trainer, TrainerConfig
    cfg = reduce_config(get_config("tiny-lm"))
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=96, global_batch=4)

    def tcfg(d):
        return TrainerConfig(total_steps=6, ckpt_every=3, ckpt_dir=str(d),
                             peak_lr=2e-3, warmup=2, log_every=1)
    full = Trainer(cfg, tcfg(tmp_path / "a"), dcfg).run()
    assert tree_leaves(full.params)[0].is_cuda
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_00000003",
                    tmp_path / "b" / "step_00000003")
    tr = Trainer(cfg, tcfg(tmp_path / "b"), dcfg)
    resumed = tr.init_or_restore()
    assert int(resumed.step) == 3
    resumed = tr.run(resumed)
    assert int(resumed.step) == 6
    assert all(torch.equal(a, c) for a, c in
               zip(tree_leaves(full.params), tree_leaves(resumed.params)))


@pytest.mark.gpu
def test_cuda_init_params_defaults_to_the_card(cuda_device):
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.param import tree_leaves
    params = tf.init_params(reduce_config(get_config("tiny-lm")), seed=0)
    assert all(p.is_cuda for p in tree_leaves(params))


# -- the sharded pool and the distributed layer on the card -------------------


@pytest.mark.gpu
def test_cuda_sharded_wave_matches_cpu(cuda_device):
    """A contended mixed wave with cross-home MEMCPYs on 4 shards of one
    card: the same pool, rets, statuses, steps and registers as the same
    wave on 4 CPU shards (the host loop), the card's wave as one
    ``lockstep_vm`` launch over the shards' rows, its window copies inside
    the wave (no ``tiara_gather`` launch)."""
    from repro_torch.core.endpoint import TiaraEndpoint
    from repro_torch.core.program import OperatorBuilder
    from repro_torch.distributed.mesh import Sharded, make_device_mesh
    rt = memory.packed_table([("latch", 8), ("data", 64), ("reply", 64)])

    def build(s):
        b = OperatorBuilder("rcpy", n_params=3, regions=s.view)
        b.memcpy(dst_region="reply", dst_off=b.param(1), src_region="data",
                 src_off=b.param(0), n_words=4, src_dev=b.param(2))
        b.ret(b.param(1))
        s.register(b.build())
        b = OperatorBuilder("rcas", n_params=2, regions=s.view)
        zero = b.const(0)
        old = b.reg()
        b.cas(old, "latch", zero, cmp=zero, swap=b.param(0), disp=2,
              dev=b.param(1))
        b.ret(old)
        s.register(b.build())

    results = {}
    for dev in ("cpu", cuda_device):
        ep, ss = TiaraEndpoint.for_tenants(
            [(f"t{i}", rt) for i in range(2)], n_devices=4, device=dev,
            mesh=make_device_mesh(4, devices=[dev] * 4))
        for s in ss.values():
            build(s)
            for d in range(4):
                s.write_region("data", np.arange(64) * (d + 1) + 5, device=d)
        rng = np.random.default_rng(0)
        cs = []
        for i in range(48):
            s = ss[f"t{i % 2}"]
            if i % 3:
                cs.append(s.post("rcpy", [int(rng.integers(0, 60)),
                                          4 * (i % 16),
                                          int(rng.integers(0, 4))],
                                 home=int(rng.integers(0, 4))))
            else:
                cs.append(s.post("rcas", [100 + i, int(rng.integers(0, 4))],
                                 home=int(rng.integers(0, 4))))
        kernels.reset_launch_counts()
        ep.doorbell(placement="sharded")
        assert isinstance(ep._dev_mem, Sharded)
        counts = kernels.launch_counts()
        launches = (counts["lockstep_vm"], counts["tiara_gather"])
        results[str(dev)] = (ep._host_view().copy(),
                             [(c.ret, c.status, c.steps, tuple(c.regs))
                              for c in cs], launches)
    cpu, card = results["cpu"], results[str(cuda_device)]
    assert np.array_equal(cpu[0], card[0]) and cpu[1] == card[1]
    assert cpu[2] == (0, 0) and card[2] == (1, 0)


@pytest.mark.gpu
def test_cuda_tiara_fetch_launches_tiara_gather(cuda_device):
    from repro_torch.distributed import mesh as dmesh
    from repro_torch.distributed import tiara_fetch as tfetch
    mesh = dmesh.make_device_mesh(4, devices=[cuda_device] * 4)
    rng = np.random.default_rng(0)
    T = N = 256
    table = np.concatenate([s * 64 + rng.permutation(64)
                            for s in range(4)]).astype(np.int32)
    pool = rng.standard_normal((N, 32)).astype(np.float32)
    ids = rng.integers(0, T, 4 * 64).astype(np.int32)
    fetch = tfetch.make_tiara_fetch(mesh, "pool", T, N, quota=64)
    kernels.reset_launch_counts()
    out = fetch(*(torch.from_numpy(a).to(cuda_device)
                  for a in (table, pool, ids)))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["tiara_gather"] == 4     # one per owner
    assert np.array_equal(out.full().cpu().numpy(),
                          tfetch.reference_fetch(table, pool, ids))


@pytest.mark.gpu
def test_cuda_dryrun_cross_check_at_a_small_cell(cuda_device):
    """The chip smoke's phase 14(b) at one small cell: tiny-lm's decode
    step over 4 x 512 tokens.  ``card_check`` raises where the dry-run's
    argument bytes or FLOPs differ from the card step's, its argument +
    temp bytes are off the step's peak by more than 10%, or its roofline
    floor exceeds 1.05 x the median wall on either route."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch import dryrun
    kernels.reset_launch_counts()
    rec = dryrun.card_check(get_config("tiny-lm"),
                            ShapeSpec("decode_512", "decode", 512, 4),
                            cuda_device, reps=3)
    assert rec["card_flops"] == rec["flops"] > 0
    assert rec["card_arg_bytes"] == rec["arg_bytes"]
    # the kernels' route launched the paged kernel, 12 layers per step
    assert kernels.launch_counts()["paged_attention"] >= 12


# -- the recurrent scans -----------------------------------------------------

SCAN_TOL = 1e-5


def _scan_tensor(rng, dev, *shape, lo=-1.0, hi=1.0):
    return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)) \
        .to(dev)


def _scan_valid(s, lengths, dev):
    if lengths is None:
        return None
    return (torch.arange(s)[None] < torch.tensor(lengths)[:, None]).to(dev)


def _same_bits_and_close(kernel_fn, plain_fn, name):
    before = kernels.launch_counts()[name]
    got, again = kernel_fn(), kernel_fn()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] == before + 2
    want = plain_fn()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert torch.allclose(g, w, atol=SCAN_TOL, rtol=SCAN_TOL), \
            float((g - w).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16, 8, 3, 32])
@pytest.mark.parametrize("b,s,d,lengths", [(8, 1, 8192, None),
                                           (3, 300, 200, (300, 0, 129)),
                                           (2, 1024, 512, (1024, 700))])
def test_cuda_selective_scan_matches_plain(cuda_device, n, b, s, d,
                                           lengths):
    """selective_scan against its plain version on the card at f32: B and C
    as strided views of one projection, a length-0 row, one decode step
    at Jamba's 8192 channels, the same bits twice, one launch a call."""
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_plain)
    rng = np.random.default_rng(n * 7 + s)
    t = functools.partial(_scan_tensor, rng, cuda_device)
    xdb = t(b, s, 4 + 2 * n)
    args = (t(b, d, n), t(b, s, d, lo=0.0, hi=2.0), t(b, s, d),
            xdb[..., 4:4 + n], xdb[..., 4 + n:], -t(d, n, lo=0.1, hi=3.0),
            _scan_valid(s, lengths, cuda_device))
    assert not args[3].is_contiguous()
    _same_bits_and_close(lambda: selective_scan(*args),
                         lambda: selective_scan_plain(*args),
                         "selective_scan")


@pytest.mark.gpu
@pytest.mark.parametrize("hs", [64, 32, 8, 40])
@pytest.mark.parametrize("b,s,nh,lengths", [(8, 1, 32, None),
                                            (3, 300, 4, (300, 0, 129)),
                                            (2, 1024, 2, (1024, 17))])
def test_cuda_wkv6_matches_plain(cuda_device, hs, b, s, nh, lengths):
    """wkv6 against its plain version on the card at f32: heads of 64
    (RWKV-6's), 32 and padded ones, a length-0 row, one decode step at
    RWKV-6's 32 heads, the same bits twice, one launch a call."""
    from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
    rng = np.random.default_rng(hs * 7 + s)
    t = functools.partial(_scan_tensor, rng, cuda_device)
    args = (t(b, nh, hs, hs), t(b, s, nh, hs), t(b, s, nh, hs),
            t(b, s, nh, hs), t(b, s, nh, hs, lo=0.3, hi=0.999), t(nh, hs),
            _scan_valid(s, lengths, cuda_device))
    _same_bits_and_close(lambda: wkv6(*args), lambda: wkv6_plain(*args),
                         "wkv6")


@pytest.mark.gpu
def test_cuda_scans_under_gradients_raise(cuda_device):
    """No backward kernel: on the card under gradients both ``impl="auto"``
    and ``impl="cuda"`` raise before anything launches; with no gradient
    the same call launches the kernel once."""
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.kernels.wkv6 import wkv6
    rng = np.random.default_rng(9)
    t = functools.partial(_scan_tensor, rng, cuda_device)
    ss = [t(2, 6, 4), t(2, 5, 6, lo=0.0), t(2, 5, 6), t(2, 5, 4),
          t(2, 5, 4), -t(6, 4, lo=0.1), None]
    wk = [t(2, 2, 8, 8), t(2, 5, 2, 8), t(2, 5, 2, 8), t(2, 5, 2, 8),
          t(2, 5, 2, 8, lo=0.3), t(2, 8), None]
    for fn, args, name in ((selective_scan, ss, "selective_scan"),
                           (wkv6, wk, "wkv6")):
        args[1] = args[1].requires_grad_(True)
        before = kernels.launch_counts()[name]
        for impl in ("auto", "cuda"):
            with pytest.raises(ValueError, match="no backward kernel"):
                fn(*args, impl=impl)
        assert kernels.launch_counts()[name] == before
        with torch.no_grad():
            fn(*args)
        assert kernels.launch_counts()[name] == before + 1
