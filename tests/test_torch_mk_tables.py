"""``experiments/mk_tables_torch.py`` renders the port's dry-run records
(``experiments/dryrun_torch/``): 32 ok rows on each mesh, the 8 skipped
cells of the single pod with their reasons, and every row as the
reference's ``experiments/mk_tables.py`` formats the same record."""

import importlib.util
import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tables():
    return _load("experiments/mk_tables_torch.py", "mk_tables_torch").main([])


def test_tables_count_every_record(tables):
    assert tables["ok_rows"] == {"pod16x16": 32, "pod2x16x16": 32}
    assert len(tables["skipped"]) == 8
    assert all(shape == "long_500k" and why
               for _, shape, why in tables["skipped"])
    assert tables["variant_rows"] == 0
    lines = tables["markdown"].splitlines()
    assert sum(ln.startswith("| ") and "**" in ln for ln in lines) == 64
    assert sum(ln.startswith("- ") for ln in lines) == 8


def test_rows_format_as_the_reference_formats_them(tables, tmp_path,
                                                   monkeypatch, capsys):
    # the reference script reads experiments/dryrun/ under the working
    # directory when it is loaded; an empty one gives it nothing to print
    monkeypatch.chdir(tmp_path)
    ref = _load("experiments/mk_tables.py", "mk_tables")
    capsys.readouterr()
    recs = [json.loads(p.read_text()) for p in
            sorted((ROOT / "experiments" / "dryrun_torch").glob("*.json"))]
    for mesh in ("pod16x16", "pod2x16x16"):
        want = ref.fmt(recs, mesh, [])
        got = tables["markdown"].split(want[0])[
            1 if mesh == "pod16x16" else 2].strip().splitlines()
        assert got[:len(want) - 1] == want[1:]
        assert len(want) == 2 + 32
