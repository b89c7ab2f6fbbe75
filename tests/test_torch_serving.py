"""The port's serving engine against the JAX engine, on reduced tiny-lm.

Greedy tokens of ``repro_torch.serving.ServingEngine(device="cpu")`` equal
the reference engine's on the seeded prompts of ``tests/test_e2e_paged.py``
(the same weights, carried across as numpy).  Equal tokens are expected,
not lucky: ``tests/test_torch_models.py`` holds the logits within 1e-4 of
the reference, and the test below checks that every greedy choice it
compares wins by a top-2 margin larger than that.  The port's
``resolver="tiara"`` is bit-identical to its ``resolver="host"``; the
admission statuses and the allocator API mirror the reference's tests.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import transformer as jtf
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import isa
from repro_torch.core.endpoint import EndpointError
from repro_torch.models import transformer as ttf
from repro_torch.serving import (BlockAllocator, OutOfPages, ServingEngine,
                                 TiaraResolver)

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-4      # tests/test_torch_models.py's logit tolerance


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_reduce_config(jax_get_config("tiny-lm"))
    cfg = reduce_config(get_config("tiny-lm"))
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


def _prompts(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, cfg.vocab, 4 + i)))
            for i in range(n)]


def _engine(cfg, params, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("device", "cpu")
    return ServingEngine(cfg, params, temperature=0.0, eos_id=-1, **kw)


@pytest.fixture(scope="module")
def host_run(tiny):
    _, _, cfg, params = tiny
    eng = _engine(cfg, params)
    hs = [eng.submit(p, max_new=4) for p in _prompts(cfg, 3)]
    out = eng.run_to_completion()
    assert all(h.ok for h in hs)
    return out


# -- parity with the reference -------------------------------------------


def test_greedy_tokens_match_jax_engine(tiny, host_run):
    jcfg, jparams, cfg, params = tiny
    jeng = JaxEngine(jcfg, jparams, max_slots=2, max_seq=64,
                     temperature=0.0, eos_id=-1)
    for p in _prompts(cfg, 3):
        jeng.submit(p, max_new=4)
    assert host_run == jeng.run_to_completion()


def test_greedy_choices_clear_the_logit_tolerance(tiny, host_run):
    """Every compared greedy choice wins by more than the cross-framework
    logit tolerance (replayed as one full-sequence forward)."""
    _, _, cfg, params = tiny
    for sid, p in enumerate(_prompts(cfg, 3)):
        toks = p + host_run[sid]
        logits = ttf.apply_model(params, cfg, {
            "tokens": torch.tensor([toks[:-1]])}).logits[0]
        chosen = logits[len(p) - 1:]
        top2 = torch.topk(chosen, 2, dim=-1).values
        assert chosen.argmax(-1).tolist() == host_run[sid]
        assert float((top2[:, 0] - top2[:, 1]).min()) > 2 * LOGIT_TOL


def test_tiara_resolver_matches_host(tiny, host_run):
    _, _, cfg, params = tiny
    eng = _engine(cfg, params, resolver="tiara")
    hs = [eng.submit(p, max_new=4) for p in _prompts(cfg, 3)]
    assert eng.run_to_completion() == host_run
    assert all(h.ok for h in hs)
    assert isinstance(eng.resolver, TiaraResolver)
    aud = eng.resolver_audit()
    assert aud["waves"] >= 1 and eng.resolver.steps >= 3


# -- engine surface (mirrors tests/test_e2e_paged.py) ----------------------


def test_submit_returns_handle_and_positional_gone(tiny):
    _, _, cfg, params = tiny
    eng = _engine(cfg, params)
    h = eng.submit(_prompts(cfg, 1)[0], max_new=3)
    assert h.sid == 0 and not h.done
    toks = h.result()
    assert h.ok and h.status == isa.STATUS_OK and toks == h.tokens
    assert len(toks) == 3
    with pytest.raises(TypeError):
        eng.submit(_prompts(cfg, 1)[0], 3)  # type: ignore[misc]
    h2 = eng.submit(_prompts(cfg, 1)[0], max_new=3)
    assert h2.sid == 1
    out = eng.run_to_completion()
    assert out[h2.sid] == h2.tokens


def test_submit_admission_statuses(tiny):
    _, _, cfg, params = tiny
    eng = _engine(cfg, params, max_pending=0)
    h = eng.submit(_prompts(cfg, 1)[0], max_new=3)
    assert h.rejected and h.status == isa.STATUS_EAGAIN
    with pytest.raises(EndpointError):
        h.result()
    assert h.result(check=False) == []
    eng2 = _engine(cfg, params)
    h2 = eng2.submit(_prompts(cfg, 1)[0], max_new=3, deadline_s=0.0)
    assert h2.timed_out and h2.status == isa.STATUS_TIMEOUT


def test_engine_needs_a_device(tiny, monkeypatch):
    """No device named and no card: the engine raises rather than fall
    back to the CPU."""
    _, _, cfg, params = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)


def test_engine_cost_measured_needs_a_device(monkeypatch):
    """EngineCost.measured times a launch on the card unless a device is
    named: with no card and no device named it raises, as every entry
    point of the port does; named, it runs there."""
    from repro_torch.core.costmodel import EngineCost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineCost.measured()
    assert EngineCost.measured(reps=2, device="cpu").launch_us >= 1.0


def test_finished_slot_parks_on_scratch_page(tiny):
    """A finished sequence's slot goes back to length 0 and the scratch
    page, where the batched decode's inactive writes land."""
    _, _, cfg, params = tiny
    eng = _engine(cfg, params)
    assert eng.caches[0].paged.k_pages.shape[1] == eng.scratch_page + 1
    h = eng.submit(_prompts(cfg, 1)[0], max_new=2)
    h.result()
    assert (eng.lengths == 0).all()
    assert (eng.block_tables == eng.scratch_page).all()


# -- allocator API ------------------------------------------------------------


def test_alloc_many_all_or_nothing():
    a = BlockAllocator(8)
    got = a.alloc_many([(1, 3), (2, 4)])
    assert sorted(got) == [1, 2]
    assert len(got[1]) == 3 and len(got[2]) == 4
    assert a.free_pages == 1
    with pytest.raises(OutOfPages) as ei:
        a.alloc_many([(3, 1), (4, 1)])
    assert ei.value.needed == 2 and ei.value.free == 1
    assert a.free_pages == 1 and a.owned_by(3) == [] \
        and a.owned_by(4) == []


def test_out_of_pages_structured_fields():
    a = BlockAllocator(4)
    a.alloc(3, owner=1)
    with pytest.raises(OutOfPages) as ei:
        a.alloc(2, owner=2)
    assert (ei.value.needed, ei.value.free) == (2, 1)
    assert "2 pages" in str(ei.value) and "1 free" in str(ei.value)


def test_region_layout_export():
    k = BlockAllocator(16).region_layout(max_req_blocks=4)
    rt = k.regions()
    for region in ("req", "blocktable", "kvpool", "reply"):
        assert rt[region].size >= 1
    assert k.block_words == 1


# -- launcher ---------------------------------------------------------------


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--requests", "2", "--max-new", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["seq 0", "seq 1"]
    assert all(len(ast.literal_eval(ln.split(": ", 1)[1])) == 3
               for ln in lines)
