"""The port's example entry points on the CPU, against the reference's.

``examples/serve_paged_torch.py`` serves the reduced tiny-lm under both
resolvers (the same tokens, every handle ok, no page leaked);
``examples/train_tiny_lm_torch.py`` trains the reduced tiny-lm, then a
second call resumes from its checkpoint; ``examples/disaggregated_kv_torch.py``
gives the figures the reference example prints, to the printed digit,
and delivers the blocks the reference's operator lays out at the requested
ids.
Each raises, instead of running on the CPU, when no device is named and
there is no card."""

import hashlib
import importlib.util
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.training import TrainerConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def served():
    """The reduced tiny-lm served on the CPU under each resolver."""
    ex = _load("serve_paged_torch")
    return {r: ex.main(["--device", "cpu", "--requests", "3", "--slots",
                        "2", "--max-new", "3", "--resolver", r])
            for r in ("host", "tiara")}


@pytest.mark.parametrize("resolver", ["host", "tiara"])
def test_serve_paged_runs_on_cpu(served, resolver):
    out = served[resolver]
    assert out["ok"] and len(out["tokens"]) == 3
    assert all(len(t) == 3 for t in out["tokens"].values())
    assert set(out["statuses"].values()) == {0}
    assert out["steps"] > 0 and out["tok_per_s"] > 0
    # the CPU runs every kernel's plain version and counts no launch
    assert not any(out["launches"].values())
    assert bool(out["audit"]) == (resolver == "tiara")


def test_serve_paged_tiara_tokens_equal_host(served):
    assert served["tiara"]["tokens"] == served["host"]["tokens"]


def test_train_tiny_lm_resumes_from_its_checkpoint(tmp_path, monkeypatch,
                                                   capsys):
    ex = _load("train_tiny_lm_torch")
    monkeypatch.setattr(ex, "get_config",
                        lambda name: reduce_config(get_config(name)))
    monkeypatch.setattr(ex, "TrainerConfig", lambda **kw: TrainerConfig(
        **dict(kw, ckpt_every=1)))
    ckpt = str(tmp_path / "ckpt")
    common = ["--device", "cpu", "--batch", "2", "--seq", "32", "--ckpt",
              ckpt]
    first = ex.main(["--steps", "2"] + common)
    assert first["start_step"] == 0 and first["final_step"] == 2
    assert first["logged_steps"] == [0, 1]
    assert len(first["step_walls_s"]) == 2
    for k in ("first_loss", "last_loss"):
        assert math.isfinite(first[k]) and 0 < first[k] < 20
    second = ex.main(["--steps", "3"] + common)
    assert second["start_step"] == 2 and second["final_step"] == 3
    assert second["logged_steps"] == [2]
    assert "resuming from the step-2 checkpoint" in capsys.readouterr().out


def _numbers(line):
    return [float(x) for x in re.findall(r"-?\d+(?:\.\d+)?", line)]


def test_disaggregated_kv_matches_the_reference_example(capsys):
    _load("disaggregated_kv").main()
    ref = capsys.readouterr().out.splitlines()
    got = _load("disaggregated_kv_torch").main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == ref
    # the returned figures, at the precision the reference prints them
    node_lines = [ln for ln in ref if ln.startswith("node ")]
    assert len(node_lines) == len(got["nodes"]) == 4
    for ln, n in zip(node_lines, got["nodes"]):
        assert _numbers(ln) == [n["node"], n["blocks"],
                                round(n["latency_us"], 1),
                                round(n["wire_bytes"] / 1e6, 2)]
    figures = {ln.split(":")[0].strip(): _numbers(ln.split(":")[1])[0]
               for ln in ref if ln.startswith("  ") and ":" in ln}
    assert figures == {
        "tiara (parallel nodes, 1 invocation each)":
            round(got["tiara_us"], 1),
        "stop-and-wait RDMA (as deployed, Table 1)":
            round(got["stop_and_wait_us"], 1),
        "optimally batched RDMA (2 RTTs + WR build)":
            round(got["batched_us"], 1)}
    assert _numbers(ref[-1])[:2] == [round(got["over_stop_and_wait"], 1),
                                     round(got["over_batched"], 2)]
    # the paper's §4.6 figures as the reference prints them on this model
    assert [n["blocks"] for n in got["nodes"]] == [33, 39, 45, 43]
    assert [round(n["latency_us"], 1) for n in got["nodes"]] == \
        [33.0, 37.8, 42.7, 41.0]
    assert (round(got["tiara_us"], 1), round(got["stop_and_wait_us"], 1),
            round(got["batched_us"], 1)) == (42.7, 509.2, 306.2)
    assert (round(got["over_stop_and_wait"], 1),
            round(got["over_batched"], 2)) == (11.9, 7.18)
    assert got["device"] == "cpu" and got["fetched"] == 160
    # the delivered blocks: the reference operator's pools, block tables
    # and request, node by node, in the order the example fetches them
    from repro.core import memory
    from repro.core.operators import PagedKVFetch
    k = PagedKVFetch(n_blocks_pool=64, block_bytes=8192, max_req_blocks=160)
    mem = memory.make_pool(5, k.regions())
    tables = [k.populate(mem, k.regions(), device=d, seed=d)
              for d in range(4)]
    want = np.random.default_rng(0).integers(0, 4 * 64, 160)
    blocks = hashlib.sha256()
    for node in range(4):
        ids = [int(b % 64) for b in want if b // 64 == node]
        blocks.update(k.reference(mem, k.regions(), tables[node], ids,
                                  device=node).tobytes())
    assert got["delivered_sha256"] == blocks.hexdigest()


@pytest.mark.parametrize("example", ["serve_paged_torch",
                                     "train_tiny_lm_torch",
                                     "disaggregated_kv_torch"])
def test_example_needs_a_device(example, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--ckpt", str(tmp_path)] if example.startswith("train") else []
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(example).main(argv)
