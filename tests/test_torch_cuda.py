"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (``gpu`` marker) and skip without one.  The
file imports only ``torch`` and the port, so it runs on the GPU machine,
which has no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

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
