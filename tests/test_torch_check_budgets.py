"""``tools/check_budgets_torch.py``, the port's line-rate budget gate:
its certificates equal the reference gate's entry for entry and field for
field, it passes against the committed ``tools/wcet_baseline.json``, and
it fails against a copy whose certificate was lowered (the ratchet),
read through the tool's ``BASELINE`` and never written."""

import importlib.util
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "tools" / "wcet_baseline.json"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gate():
    return _load("check_budgets_torch")


@pytest.fixture(scope="module")
def certs(gate):
    return gate.certify_all()


def test_certificates_equal_the_reference(certs):
    assert certs == _load("check_budgets").certify_all()


def test_certificates_equal_the_committed_baseline(certs):
    assert certs == json.loads(COMMITTED.read_text())


def test_gate_passes_against_the_committed_baseline(gate, capsys):
    before = COMMITTED.read_bytes()
    assert gate.main([]) == 0
    assert "budget gate passed (7 stock operators" in capsys.readouterr().out
    assert COMMITTED.read_bytes() == before


@pytest.mark.parametrize("name", sorted(json.loads(COMMITTED.read_text())))
def test_gate_fails_when_a_certificate_grew(gate, name, tmp_path,
                                            monkeypatch, capsys):
    base = json.loads(COMMITTED.read_text())
    base[name]["wcet_cycles"] -= 1
    lowered = tmp_path / "wcet_baseline.json"
    lowered.write_text(json.dumps(base))
    monkeypatch.setattr(gate, "BASELINE", lowered)
    assert gate.main([]) == 1
    out = capsys.readouterr().out
    assert f"{name}: certified wcet_cycles grew" in out
    assert "1 budget/ratchet failure(s)" in out


def test_gate_fails_without_a_baseline(gate, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(gate, "BASELINE", tmp_path / "missing.json")
    assert gate.main([]) == 1
    assert "missing.json missing" in capsys.readouterr().out
