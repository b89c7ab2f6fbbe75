"""The reference's end-to-end paged-decode fault cases
(``tests/test_e2e_paged.py``) that the port's other tests lack, replayed on
the port on the CPU: the exactly-one-CQE identity through the tiara
resolver's serving loop under a device failure, and a mid-decode device
failure surfacing through every ``SequenceHandle`` without a hang.

The reference's other cases live elsewhere: the allocator API, the
submit surface and single-home parity in ``tests/test_torch_serving.py``,
the sharded homes with re-homing in ``tests/test_torch_sharded_endpoint.py``
and the MoE expert gather in ``tests/test_torch_moe.py``
(``test_scout_engine_tiara_matches_host``,
``test_scout_engine_tiara_gathers_experts``).  Weights come from the
port's seeded ``init_params`` (a seed in place of a PRNG key).
"""

import numpy as np
import pytest

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import faults, isa
from repro_torch.core.endpoint import EndpointError
from repro_torch.core.serving_loop import VirtualClock
from repro_torch.models import transformer as tf
from repro_torch.serving import BlockAllocator, ServingEngine, TiaraResolver


@pytest.fixture(scope="module")
def tiny():
    cfg = reduce_config(get_config("tiny-lm"))
    return cfg, tf.init_params(cfg, seed=0, device="cpu")


def _prompts(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, cfg.vocab, 4 + i)))
            for i in range(n)]


def _engine(cfg, params, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq", 64)
    return ServingEngine(cfg, params, temperature=0.0, eos_id=-1,
                         device="cpu", **kw)


def test_exactly_one_cqe_per_post_including_faults():
    vc = VirtualClock()
    a = BlockAllocator(8)
    r = TiaraResolver(a, max_slots=2, pages_per_seq=4, n_homes=2,
                      clock=vc, sleep=vc.sleep, device="cpu")
    r.bind(0, [0, 1, 2, 3])
    r.bind(1, [4, 5, 6, 7])
    kv, _ = r.resolve_step([0, 1])
    assert all(isinstance(v, np.ndarray) for v in kv.values())
    assert list(kv[1]) == [4, 5, 6, 7]
    # kill slot 0's home mid-serve: its post must still retire exactly
    # one CQE (a failed one), and slot 1 keeps resolving
    r.ep.inject(faults.fail_devices(0))
    kv2, _ = r.resolve_step([0, 1])
    assert not isinstance(kv2[0], np.ndarray)
    assert int(kv2[0].status) in (isa.STATUS_PROT_FAULT,
                                  isa.STATUS_FLUSHED)
    st = r.loop.stats
    assert st.submitted == 4
    assert st.submitted == (st.executed + st.flushed + st.timed_out
                            + st.rejected + st.shed)


def test_mid_decode_device_failure_surfaces_cleanly(tiny):
    cfg, params = tiny
    eng = _engine(cfg, params, resolver="tiara", n_homes=1)
    hs = [eng.submit(p, max_new=8) for p in _prompts(cfg, 2)]
    eng.step()                      # healthy first decode step
    assert eng.resolver is not None
    eng.resolver.ep.inject(faults.fail_devices(0))
    out = eng.run_to_completion(max_steps=100)   # bounded: never hangs
    assert eng.finished()
    for h in hs:
        assert h.done and (h.faulted or h.flushed)
        assert h.status in (isa.STATUS_PROT_FAULT, isa.STATUS_FLUSHED)
        with pytest.raises(EndpointError):
            h.result()
        assert out[h.sid] == h.tokens   # partial output is preserved
