"""The port's tiara_gather against the JAX package's, on the CPU.

The port's wrapper runs its plain version on CPU tensors; it must equal
the JAX gather (plain and Pallas interpret mode) exactly on the same
numpy-seeded inputs, over the dtype sweep of ``test_kernels.py``.  The
CUDA kernel itself runs only on the card: ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.tiara_gather import tiara_gather as jax_tiara_gather
from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.tiara_gather import (tiara_gather,
                                              tiara_gather_kernel,
                                              tiara_gather_ref,
                                              tiara_gather_window,
                                              tiara_gather_window_kernel)

SHAPES = [(4, 16, 8), (7, 32, 128), (1, 4, 256)]


def _inputs(seed, dtype_name, n, rows, r):
    rng = np.random.default_rng(seed)
    if dtype_name == "int32":
        pool = rng.integers(0, 1000, (rows, r)).astype(np.int32)
    else:
        pool = rng.standard_normal((rows, r)).astype(np.float32)
    table = rng.permutation(rows).astype(np.int32)
    ids = rng.integers(0, rows, n).astype(np.int32)
    return pool, table, ids


_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n,rows,r", SHAPES)
def test_gather_matches_jax(dtype, n, rows, r):
    pool, table, ids = _inputs(rows * 7 + r, dtype, n, rows, r)
    jp = jnp.asarray(pool, _JNP[dtype])
    ref = jax_tiara_gather(jp, jnp.asarray(table), jnp.asarray(ids),
                           impl="xla")
    ker = jax_tiara_gather(jp, jnp.asarray(table), jnp.asarray(ids),
                           impl="kernel_interpret")
    tp = torch.from_numpy(pool).to(_TORCH[dtype])
    out = tiara_gather(tp, torch.from_numpy(table), torch.from_numpy(ids))
    assert out.dtype == tp.dtype and tuple(out.shape) == (n, r)
    got = out.float().numpy() if dtype != "int32" else out.numpy()
    want = np.asarray(ref, np.float32) if dtype != "int32" \
        else np.asarray(ref)
    assert np.array_equal(got, want)
    assert np.array_equal(want, np.asarray(ker, want.dtype))


@pytest.mark.parametrize("r", [1, 3, 1024])
def test_gather_int64_rows(r):
    """The main path's dtype: int64 pool words (JAX runs 32-bit here, so
    the reference is numpy's double indexing)."""
    rng = np.random.default_rng(r)
    pool = rng.integers(-(1 << 62), 1 << 62, (12, r), dtype=np.int64)
    table = rng.permutation(12).astype(np.int32)
    ids = rng.integers(0, 12, 5).astype(np.int32)
    out = tiara_gather(torch.from_numpy(pool), torch.from_numpy(table),
                       torch.from_numpy(ids))
    assert np.array_equal(out.numpy(), pool[table[ids]])


def test_cpu_route_does_not_count_launches():
    kernels.reset_launch_counts()
    pool = torch.arange(12, dtype=torch.int64).view(4, 3)
    t = torch.tensor([3, 2, 1, 0], dtype=torch.int32)
    tiara_gather(pool, t, t)
    tiara_gather_ref(pool, t, t)
    assert kernels.launch_counts() == {"tiara_gather": 0, "paged_attention": 0,
                                       "flash_attention": 0,
                                       "flash_attention_bwd": 0,
                                       "lockstep_vm": 0, "selective_scan": 0,
                                       "wkv6": 0}


def test_no_fallback_on_cpu_tensors():
    """impl='cuda' (and the kernel itself) never quietly runs the plain
    version: on CPU tensors it raises."""
    pool = torch.zeros((4, 2), dtype=torch.int64)
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tiara_gather(pool, t, t, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tiara_gather_kernel(pool, t, t)
    with pytest.raises(ValueError, match="unknown impl"):
        tiara_gather(pool, t, t, impl="xla")


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolkit the build raises a clear error (it is
    never attempted at import)."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    if (_build.Path("/usr/local/cuda/bin/nvcc")).exists():
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.nvcc_path()


def test_library_names_follow_source():
    """One library for every kernel source, named by their hash."""
    a = _build.lib_path()
    assert a == _build.lib_path()
    assert a.parent == _build.BUILD_DIR
    assert a.name.startswith("libtorch_kernels_") and a.suffix == ".so"
    names = {p.name for p in _build.sources()}
    assert {"tiara_gather.cu", "paged_attention.cu",
            "flash_attention.cu"} <= names


@pytest.mark.parametrize("width,mask", [(4, 15), (5, 15), (16, 15), (3, 63)])
def test_window_gather_matches_word_loop(width, mask):
    """The gather chain's form: word w of row i is
    pool[bases[id] + ((table[id] + w) & mask)], at any alignment and
    wrapping inside the region — the interpreter's MEMCPY word loop."""
    rng = np.random.default_rng(width * 100 + mask)
    pool = rng.integers(-(1 << 62), 1 << 62, 3 * (mask + 1) + 1)
    table = rng.integers(0, mask + 1, 6).astype(np.int32)
    bases = rng.integers(0, 3, 6) * (mask + 1)
    ids = np.array([5, 0, 3, 3, 1], np.int32)
    want = np.array([[pool[bases[i] + ((table[i] + w) & mask)]
                      for w in range(width)] for i in ids])
    out = tiara_gather_window(torch.from_numpy(pool),
                              torch.from_numpy(table),
                              torch.from_numpy(bases), torch.from_numpy(ids),
                              width=width, mask=mask)
    assert np.array_equal(out.numpy(), want)


def test_window_gather_per_entry_masks_match_word_loop():
    """The lockstep engine's form: each entry in its own region, so each
    has its own mask (wrapping lanes included)."""
    rng = np.random.default_rng(4)
    pool = rng.integers(-(1 << 62), 1 << 62, 200)
    masks = np.array([15, 3, 63, 7, 0, 31])
    bases = np.array([0, 16, 20, 84, 92, 100])
    table = (rng.integers(0, 1 << 20, 6) & masks).astype(np.int32)
    table[0] = 14                            # wraps in its 16-word region
    ids = np.array([0, 5, 1, 2, 4, 3, 0], np.int32)
    width = 5
    want = np.array([[pool[bases[i] + ((table[i] + w) & masks[i])]
                      for w in range(width)] for i in ids])
    out = tiara_gather_window(torch.from_numpy(pool),
                              torch.from_numpy(table),
                              torch.from_numpy(bases), torch.from_numpy(ids),
                              width=width, mask=torch.from_numpy(masks))
    assert np.array_equal(out.numpy(), want)


def test_lockstep_memcpy_keeps_offsets_past_2_31():
    """The lockstep engine's MEMCPY read keeps its masked offsets int64,
    so a region of 2**31 words or more reads the right words.  A base
    below 0 lets a 64-word pool stand for a region of 2**32 words: only
    the index arithmetic is under test."""
    from repro_torch.core.vm import _DenseOps
    memx = torch.arange(100, 164, dtype=torch.int64)
    ops = _DenseOps(1, 64)
    out = ops.readv_win(memx, torch.tensor([0, 0]),
                        torch.tensor([-(1 << 31), 0]),
                        torch.tensor([(1 << 32) + (1 << 31) + 3, 61]),
                        torch.tensor([(1 << 32) - 1, 63]), 4)
    assert out.tolist() == [[103, 104, 105, 106], [161, 162, 163, 100]]


def test_window_gather_row_form_agrees():
    """With aligned offsets and no wrap the window form is the row form."""
    rng = np.random.default_rng(9)
    pool = rng.integers(0, 1000, (8, 4))
    table = rng.permutation(8).astype(np.int32)
    ids = np.array([2, 7, 0], np.int32)
    rows = tiara_gather(torch.from_numpy(pool), torch.from_numpy(table),
                        torch.from_numpy(ids))
    win = tiara_gather_window(torch.from_numpy(pool.reshape(-1)),
                              torch.from_numpy(table * 4),
                              torch.zeros(8, dtype=torch.int64),
                              torch.from_numpy(ids), width=4, mask=31)
    assert torch.equal(rows, win)


def test_window_no_fallback_on_cpu_tensors():
    pool = torch.zeros(16, dtype=torch.int64)
    t = torch.zeros(4, dtype=torch.int32)
    b = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        tiara_gather_window(pool, t, b, t, width=2, mask=15, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tiara_gather_window_kernel(pool, t, b, t, width=2, mask=15)


def test_window_gather_without_ids_is_arange():
    """``ids`` absent means entry i is id i: the same words as ``arange``,
    under one mask and per-entry masks."""
    rng = np.random.default_rng(5)
    pool = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, 300))
    table = torch.from_numpy(rng.integers(0, 64, 9))
    bases = torch.from_numpy(rng.integers(0, 4, 9) * 64)
    masks = torch.from_numpy(np.array([63, 7, 31, 63, 0, 15, 63, 3, 1]))
    ar = torch.arange(9, dtype=torch.int32)
    for mask in (63, masks):
        for width in (1, 5, 70):
            assert torch.equal(
                tiara_gather_window(pool, table, bases, width=width,
                                    mask=mask),
                tiara_gather_window(pool, table, bases, ar, width=width,
                                    mask=mask))


def test_engines_pass_no_ids(monkeypatch):
    """The engines' window reads (a traced MEMCPY, the gather chain, the
    lockstep host loop) hand the gather no ``ids``: no ``arange`` is built
    per call."""
    from repro_torch.core import compile as tc
    from repro_torch.core import lockstep_corpus as corpus
    from repro_torch.core import memory, pyvm
    from repro_torch.core import operators as ops
    from repro_torch.core.memory import Grant
    from repro_torch.core.verifier import verify
    from repro_torch.kernels.tiara_gather import ops as tops
    calls = []
    real = tops.tiara_gather_window_ref

    def spy(pool, table, bases, ids=None, **kw):
        calls.append(ids)
        return real(pool, table, bases, ids, **kw)
    monkeypatch.setattr(tops, "tiara_gather_window_ref", spy)
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
    for superops in (False, True):
        calls.clear()
        got = tc.invoke_compiled(v, rt, mem.copy(), params, device="cpu",
                                 superops=superops)
        assert np.array_equal(np.asarray(got.mem), want)
        assert list(np.asarray(got.ret)) == [r.ret for r in rs]
        assert calls and all(i is None for i in calls)
    w = next(w for w in corpus.stock_waves(7, block_bytes=256)
             if w.name.startswith("paged_kv_fetch"))
    calls.clear()
    w.engine().run_host_loop(torch.from_numpy(w.mem.copy()), *w.args())
    assert calls and all(i is None for i in calls)
