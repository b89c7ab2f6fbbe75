"""``examples/quickstart_torch.py`` runs end to end on the CPU: steps 1-9
of the reference quickstart on the port (register, post, doorbell and
poll, cycle-sim timing, sharded placement over CPU shards, split-phase,
the fault walk and the overload run), each step asserting its own
result against the reference walk; without a device named and no card
it raises instead of running on the CPU."""

import importlib.util
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_on_cpu(capsys):
    out = _quickstart().main(["--device", "cpu"])
    st = out["stats"]
    assert st["submitted"] == 24 and st["executed"] == st["ok"] > 0
    assert st["timed_out"] + st["rejected"] + st["shed"] > 0
    printed = capsys.readouterr().out
    for line in ("sharded wave over 4 shards on cpu", "torn pointer",
                 "after reset + repair", "serving under injected overload"):
        assert line in printed, line


def test_quickstart_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _quickstart().main([])
