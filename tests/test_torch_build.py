"""The kernel library's name, on the CPU: ``_build.lib_path()`` hashes
every CUDA source and every header the sources share, so an edited file
of either kind builds a new library instead of loading a stale one."""

import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc_copy(monkeypatch, tmp_path):
    """A copy of flash_attention's csrc/ tree, which ``_build`` then
    takes for the port's kernels."""
    pkg = tmp_path / "kernels"
    csrc = pkg / "flash_attention" / "csrc"
    shutil.copytree(_build._PKG / "flash_attention" / "csrc", csrc)
    monkeypatch.setattr(_build, "_PKG", pkg)
    return csrc


def test_the_shared_header_is_hashed():
    assert "wgmma.cuh" in {p.name for p in _build.headers()}


@pytest.mark.parametrize("name", ["wgmma.cuh", "flash_attention_bwd.cu"])
def test_editing_a_file_renames_the_library(csrc_copy, name):
    before = _build.lib_path()
    assert before == _build.lib_path()
    path = csrc_copy / name
    text = path.read_text()
    path.write_text(text + "\n// edited\n")
    edited = _build.lib_path()
    assert edited != before and edited.parent == _build.BUILD_DIR
    path.write_text(text)
    assert _build.lib_path() == before


def test_a_new_header_renames_the_library(csrc_copy):
    before = _build.lib_path()
    (csrc_copy / "extra.cuh").write_text("#pragma once\n")
    assert _build.lib_path() != before
