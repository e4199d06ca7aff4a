"""The kernels' build keys: a library is rebuilt when its source, any header
under csrc/ or the compiler flags change, and only then. Needs no nvcc."""

import shutil

import pytest

from stan_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path):
    """A copy of the port's csrc/ that a test may edit."""
    return shutil.copytree(_build.CSRC, tmp_path / "csrc")


def keys(csrc):
    return {src.stem: _build.library_path(csrc / src.name).name
            for src in _build.sources()}


def test_both_sweeps_share_one_header():
    names = {p.name for p in _build.CSRC.iterdir()}
    assert {"stencil_sweep.cu", "theta_sweep.cu", "sweep_tile.cuh"} <= names
    for stem in ("stencil_sweep", "theta_sweep"):
        assert '#include "sweep_tile.cuh"' in (
            _build.CSRC / f"{stem}.cu").read_text()


def test_copy_has_the_same_keys(csrc):
    assert keys(csrc) == {src.stem: _build.library_path(src).name
                          for src in _build.sources()}


def test_header_edit_changes_every_key(csrc):
    before = keys(csrc)
    header = csrc / "sweep_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = keys(csrc)
    assert set(after) == set(before) == {"general_apply", "stencil_sweep",
                                         "theta_sweep"}
    assert all(after[k] != before[k] for k in before)


def test_new_header_changes_every_key(csrc):
    before = keys(csrc)
    (csrc / "extra.h").write_text("#pragma once\n")
    after = keys(csrc)
    assert all(after[k] != before[k] for k in before)


@pytest.mark.parametrize("edited", ["general_apply", "stencil_sweep",
                                    "theta_sweep"])
def test_source_edit_changes_only_its_key(csrc, edited):
    before = keys(csrc)
    src = csrc / f"{edited}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = keys(csrc)
    for stem in before:
        assert (after[stem] != before[stem]) == (stem == edited)


def test_every_source_has_its_entry_points():
    """Each csrc/*.cu is bound: its float and double entries and its error
    string are declared there with C linkage, and listed in _ENTRIES."""
    assert set(_build._ENTRIES) == {src.stem for src in _build.sources()}
    for src in _build.sources():
        text = src.read_text()
        for name in (*_build._ENTRIES[src.stem], f"{src.stem}_error_string"):
            assert 'extern "C"' in text and f" {name}(" in text, name
