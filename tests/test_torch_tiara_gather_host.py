"""The ``tiara_gather`` kernel's own source on the CPU.

``csrc/tiara_gather.cuh`` holds the algorithm of both of the kernel's
regimes; ``tests/tiara_gather_host.cpp`` runs it on host threads (a
block's threads as std::threads meeting at a barrier, the bulk copy
engine as memcpy), built with g++ here.  Every output must equal the
plain version (``tiara_gather_window_ref``) bit for bit and, in the row
form, the JAX package's ``tiara_gather``, on numpy-seeded inputs: both
regimes, widths around the small regime's edge and past one copy unit,
2-, 4- and 8-byte elements, offsets aligned, 8 bytes past 16 and wrapping
their region, per-entry masks, int64 offsets past 2**31, duplicate ids,
no ids against ``arange``, and the persistent grid's runs and batches
cutting windows in the middle.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.tiara_gather import tiara_gather as jax_tiara_gather
from repro_torch.kernels.tiara_gather import kernel as tk
from repro_torch.kernels.tiara_gather import (tiara_gather_ref,
                                              tiara_gather_window_ref)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "src", "repro_torch", "kernels",
                    "tiara_gather", "csrc")

# the card's stream regime but for its threads: 64 a block in warps of
# 32, units of 8 KiB, 8 ring slots, at most 6 blocks
CARD = dict(threads=64, ws=32, blocks=6, unit_bytes=8192, slots=8)
# a grid that cuts small windows into several units and each block's run
# into several batches: 32 threads in warps of 8, units of 64 bytes,
# 3 slots (the fewest the ring takes), 5 blocks
EDGES = dict(threads=32, ws=8, blocks=5, unit_bytes=64, slots=3)

_TORCH = {2: torch.bfloat16, 4: torch.float32, 8: torch.int64}
_BITS = {2: np.int16, 4: np.int32, 8: np.int64}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    out = tmp_path_factory.mktemp("tiara_gather_host") / "lib.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{CSRC}", "-o", str(out),
                    os.path.join(HERE, "tiara_gather_host.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int64
    lib.tiara_gather_host_run.argtypes = [p] + [i] * 6
    lib.tiara_gather_host_run.restype = ctypes.c_int
    return lib


def _ptr(a):
    return None if a is None else a.ctypes.data


def host_run(lib, pool, table, bases, ids, *, width, mask, stride=1,
             regime, threads=64, ws=32, blocks=6, unit_bytes=8192, slots=8):
    """The kernel's algorithm on numpy buffers; ``mask`` an int or an int64
    array shaped like ``table``; returns the (n, width) output."""
    n = table.shape[0] if ids is None else ids.shape[0]
    out = np.zeros((n, width), pool.dtype)
    masks = mask if isinstance(mask, np.ndarray) else None
    ops = dict(pool=_ptr(pool), table=_ptr(table),
               table_bytes=table.itemsize, ids=_ptr(ids), bases=_ptr(bases),
               masks=_ptr(masks), out=_ptr(out), n=n, width=width,
               stride=stride, mask=0 if masks is not None else mask,
               elem_bytes=pool.itemsize, regime=regime)
    packed = (ctypes.c_int64 * len(tk.OPERANDS))(
        *(ops[k] or 0 for k in tk.OPERANDS))
    err = lib.tiara_gather_host_run(packed, len(tk.OPERANDS), threads, ws,
                                    blocks, unit_bytes, slots)
    assert err == 0
    return out


def _ref(pool, table, bases, ids, *, width, mask, elem):
    """The plain version on torch tensors of the element's type, as raw
    bits."""
    tp = torch.from_numpy(pool).view(_TORCH[elem])
    m = torch.from_numpy(mask) if isinstance(mask, np.ndarray) else mask
    out = tiara_gather_window_ref(
        tp, torch.from_numpy(table), torch.from_numpy(bases),
        None if ids is None else torch.from_numpy(ids), width=width, mask=m)
    return out.view(_TORCH[elem] if elem == 8 else
                    {2: torch.int16, 4: torch.int32}[elem]).numpy()


def _window_case(rng, elem, n, width, *, region, align, wrap, per_entry,
                 dup_ids):
    """A flat pool of three regions of ``region`` elements (a power of
    two), ``n`` entries into them at the asked alignment: "aligned" (a
    multiple of 16 bytes), "off8" (8 bytes past 16), "any"; ``wrap`` puts
    every other window across its region's end."""
    bits = _BITS[elem]
    info = np.iinfo(bits)
    pool = rng.integers(info.min, info.max, 3 * region + 5, dtype=bits)
    T = n + 3
    per16 = 16 // elem
    hi = max(region - width, 1)
    off = rng.integers(0, hi, T)
    if align == "aligned":
        off = off // per16 * per16
    elif align == "off8":
        off = off // per16 * per16 + (8 // elem if elem < 16 else 0)
        off = np.minimum(off, region - 1)
    if wrap:
        off[::2] = region - 1 - rng.integers(0, min(width, region) - 1 + 1,
                                             off[::2].shape)
        off[::2] = np.maximum(off[::2], 0)
    table = off.astype(np.int32)
    bases = rng.integers(0, 3, T) * region
    if per_entry:
        # each entry in a region of its own size (a power of two at most
        # `region`), its offset masked into it
        sizes = 1 << rng.integers(0, int(np.log2(region)) + 1, T)
        mask = (sizes - 1).astype(np.int64)
        table = (table & mask).astype(np.int32)
    else:
        mask = region - 1
    if dup_ids:
        ids = rng.integers(0, T, n).astype(np.int32)
        ids[: n // 2] = ids[0]
    else:
        ids = rng.permutation(T)[:n].astype(np.int32)
    return pool, table, bases, ids, mask


WIDTHS = (1, 2, 31, 32, 33, 1024, 1025)


@pytest.mark.parametrize("elem", [2, 4, 8])
@pytest.mark.parametrize("width", WIDTHS)
def test_window_regimes_match_plain(host_lib, elem, width):
    """Both regimes (the small one up to its widest window) over aligned,
    8-past-16, unaligned and wrapping windows, shared and per-entry masks,
    duplicate ids, at the card's stream shape and at the edge-cutting
    one."""
    rng = np.random.default_rng(elem * 10007 + width)
    region = 4096 if width > 32 else 256
    n = 24 if width > 32 else 257
    regimes = (0, 1) if width <= tk.SMALL_MAX_WIDTH else (1,)
    for align, wrap, per_entry, dup in (("aligned", False, False, False),
                                        ("off8", False, False, True),
                                        ("any", True, False, False),
                                        ("any", True, True, True)):
        pool, table, bases, ids, mask = _window_case(
            rng, elem, n, width, region=region, align=align, wrap=wrap,
            per_entry=per_entry, dup_ids=dup)
        want = _ref(pool, table, bases, ids, width=width, mask=mask,
                    elem=elem)
        for regime in regimes:
            for shape in (CARD, EDGES):
                got = host_run(host_lib, pool, table, bases, ids,
                               width=width, mask=mask, regime=regime,
                               **shape)
                assert np.array_equal(got.view(want.dtype), want), \
                    (align, wrap, per_entry, dup, regime, shape)


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 1000, 4096])
def test_entry_counts_match_plain(host_lib, n):
    """n from 1 to 4096 over a small pool: one-word windows in the small
    regime (the resolvers' shape), 33-word windows through the stream
    regime's batches, and the bulk interior of 40-word windows."""
    rng = np.random.default_rng(n)
    for width, regime, shape in ((1, 0, CARD), (33, 1, EDGES),
                                 (40, 1, dict(CARD, unit_bytes=256))):
        pool, table, bases, ids, mask = _window_case(
            rng, 8, n, width, region=512, align="any", wrap=True,
            per_entry=False, dup_ids=True)
        want = _ref(pool, table, bases, ids, width=width, mask=mask, elem=8)
        got = host_run(host_lib, pool, table, bases, ids, width=width,
                       mask=mask, regime=regime, **shape)
        assert np.array_equal(got, want), (width, regime)


@pytest.mark.parametrize("width,regime", [(1, 0), (7, 0), (300, 1)])
def test_no_ids_equals_arange(host_lib, width, regime):
    """``ids`` absent is entry i -> id i: the same output as ``arange``,
    and as the plain version with ids None."""
    rng = np.random.default_rng(width)
    pool, table, bases, _, mask = _window_case(
        rng, 8, 70, width, region=1024, align="any", wrap=True,
        per_entry=True, dup_ids=False)
    ar = np.arange(table.shape[0], dtype=np.int32)
    for shape in (CARD, EDGES):
        none = host_run(host_lib, pool, table, bases, None, width=width,
                        mask=mask, regime=regime, **shape)
        got = host_run(host_lib, pool, table, bases, ar, width=width,
                       mask=mask, regime=regime, **shape)
        assert np.array_equal(none, got)
        assert np.array_equal(none, _ref(pool, table, bases, None,
                                         width=width, mask=mask, elem=8))


@pytest.mark.parametrize("regime,width", [(0, 4), (1, 40)])
def test_int64_offsets_past_2_31(host_lib, regime, width):
    """int64 offsets in a region of 2**32 words: a base 2**31 words below
    the pool's start lets a small pool stand for it (only the index
    arithmetic is under test), windows past word 2**31 through an int64
    table, under one shared mask and under per-entry masks (one entry
    wrapping a small region of its own)."""
    pool = np.arange(100, 100 + 256, dtype=np.int64)
    table = np.array([(1 << 31) + 3, (1 << 32) - 2, (1 << 31) + 17],
                     np.int64)
    bases = np.array([-(1 << 31), 0, -(1 << 31)], np.int64)
    masks = np.array([(1 << 32) - 1, 255, (1 << 32) - 1], np.int64)
    for ids, mask in ((np.array([0, 2, 0], np.int32), (1 << 32) - 1),
                      (np.array([0, 2, 1, 0], np.int32), masks)):
        want = _ref(pool, table, bases, ids, width=width, mask=mask, elem=8)
        assert want[0, 0] == pool[3] and want[1, 0] == pool[17]
        for shape in (CARD, EDGES):
            got = host_run(host_lib, pool, table, bases, ids, width=width,
                           mask=mask, regime=regime, **shape)
            assert np.array_equal(got, want)


_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
        "int32": torch.int32}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("n,rows,r", [(9, 32, 3), (40, 64, 32),
                                      (17, 48, 33), (6, 12, 2048)])
def test_row_form_matches_jax(host_lib, dtype, n, rows, r):
    """The row form (stride = width = R, no wrap, no bases) on both
    regimes where R allows, with duplicate ids, against the JAX package's
    ``tiara_gather`` and the plain version."""
    rng = np.random.default_rng(rows * 31 + r)
    if dtype == "int32":
        pool = rng.integers(0, 1 << 30, (rows, r)).astype(np.int32)
    else:
        pool = rng.standard_normal((rows, r)).astype(np.float32)
    table = rng.permutation(rows).astype(np.int32)
    ids = rng.integers(0, rows, n).astype(np.int32)
    ids[: n // 3] = ids[0]
    want = np.asarray(jax_tiara_gather(jnp.asarray(pool, _JNP[dtype]),
                                       jnp.asarray(table), jnp.asarray(ids),
                                       impl="xla"))
    tp = torch.from_numpy(pool).to(_TDT[dtype])
    plain = tiara_gather_ref(tp, torch.from_numpy(table),
                             torch.from_numpy(ids))
    bits = tp.view({"float32": torch.int32, "bfloat16": torch.int16,
                    "int32": torch.int32}[dtype]).numpy()
    regimes = (0, 1) if r <= tk.SMALL_MAX_WIDTH else (1,)
    for regime in regimes:
        for shape in (CARD, EDGES):
            got = host_run(host_lib, bits.reshape(-1), table, None, ids,
                           width=r, mask=-1, stride=r, regime=regime,
                           **shape)
            gt = torch.from_numpy(got).view(_TDT[dtype])
            assert torch.equal(gt, plain)
            assert np.array_equal(gt.float().numpy(),
                                  np.asarray(want, np.float32))


def test_constants_match_the_wrapper():
    """The wrapper's regime edge and operand order are the source's."""
    src = open(os.path.join(CSRC, "tiara_gather.cuh")).read()
    assert f"kSmallMaxWidth = {tk.SMALL_MAX_WIDTH};" in src
    body = re.search(r"enum Operand : int64_t \{(.*?)\};", src, re.S).group(1)
    names = [w.strip().split("=")[0].strip()[2:].lower()
             for w in body.split(",") if w.strip()]
    assert names[-1] == "count" and tuple(names[:-1]) == tk.OPERANDS
