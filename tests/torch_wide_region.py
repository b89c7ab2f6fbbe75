"""The compiled trace's reads past word 2**31, shared by the CPU test
(``tests/test_torch_compile.py``) and the card test
(``tests/test_torch_cuda.py``).  Imports only ``torch``, numpy and the
port, as the card's test file must."""

import numpy as np
import torch

from repro_torch.core import compile as tc
from repro_torch.core import isa, memory, pyvm
from repro_torch.core import operators as ops
from repro_torch.core.memory import Grant
from repro_torch.core.verifier import verify


class WideRegion:
    """A region table in which region ``name`` claims 2**32 words: its
    base moves 2**31 words down, so offset 2**31 + o names word o of the
    real region.  A small pool then stands for a region of 2**32 words;
    only the index arithmetic is under test (as in
    ``test_lockstep_memcpy_keeps_offsets_past_2_31``).  Both pyvm and the
    compiled trace read a table through ``as_arrays()`` alone."""

    def __init__(self, rt, name):
        base, mask, writable = (a.copy() for a in rt.as_arrays())
        base[rt.rid(name)] -= 1 << 31
        mask[rt.rid(name)] = (1 << 32) - 1
        self._arrays = base, mask, writable

    def as_arrays(self):
        return self._arrays


def compiled_matches_pyvm_past_2_31(superops, double_buffer, device):
    """A wave of 4 ``PagedKVFetch`` posts whose block table points past
    word 2**31 of a ``WideRegion`` KV pool (one entry unaligned), through
    ``build_compiled`` on ``device`` with the traced MEMCPY
    (``superops=False``) or the gather chain, under ``compiled`` or
    ``compiled_dbuf``: memory, rets, statuses and steps equal pyvm's bit
    for bit."""
    k = ops.PagedKVFetch(n_blocks_pool=16, block_bytes=256,
                         max_req_blocks=2 * tc.DBUF_CHUNK, reply_slots=4)
    rt = k.regions()
    mem = memory.make_pool(1, rt)
    table = k.populate(mem, rt, seed=33) + (1 << 31)
    table[1] += 3                                # unaligned, as pyvm reads
    memory.write_region(mem, rt, 0, "blocktable", table)
    k.make_request(mem, rt, [6, 1, 14, 2] + list(range(12)))
    pv = verify(k.build(rt, reply_param=True), grant=Grant.all_of(rt),
                regions=rt)
    wide = WideRegion(rt, "kvpool")
    slot = k.max_req_blocks * k.block_words
    params = [[16 - i, i * slot] for i in range(4)]
    want = mem.copy()
    rs = [pyvm.run(pv, wide, want, p) for p in params]
    assert all(r.status == isa.STATUS_OK for r in rs)
    assert not np.array_equal(want, mem)
    fn = tc.build_compiled(pv, wide, 1, len(params), superops=superops,
                           double_buffer=double_buffer)
    got = fn(torch.from_numpy(mem).to(device),
             torch.tensor(params, device=device),
             torch.zeros(len(params), dtype=torch.int64, device=device),
             torch.zeros(1, dtype=torch.bool, device=device))
    assert np.array_equal(got.mem.cpu().numpy(), want)
    assert got.ret.cpu().tolist() == [r.ret for r in rs]
    assert got.status.cpu().tolist() == [r.status for r in rs]
    assert got.steps.cpu().tolist() == [r.steps for r in rs]
