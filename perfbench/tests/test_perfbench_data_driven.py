"""A configuration, a cell, a per-layer metric and a traffic driver are
added as new files and new entries alone, and the harness and the cells'
tests find and run them; every driver declares its own rehearsal."""

import filecmp
import json
import shutil

import pytest

from perfbench import harness
from perfbench.tests import test_perfbench_cells as cells_test

DRIVERS = sorted(p.stem for p in (harness.HERE / "drivers").glob("*.py")
                 if p.stem != "__init__")


def _copy(tmp_path):
    """A copy of BENCHMARK.json and perfbench/ and its parsed BENCHMARK.json."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "perfbench", json.loads(
        (tmp_path / "BENCHMARK.json").read_text())


def _files(pb):
    return {p.relative_to(pb) for p in pb.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("name", DRIVERS)
def test_every_driver_declares_its_rehearsal(name):
    drv = harness.driver_class(name)
    for size in ("TINY", "SMALL"):
        grid = drv.__dict__.get(size)
        assert isinstance(grid, tuple) and len(grid) == 3, (name, size)
        assert all(isinstance(n, int) and n > 0 for n in grid), (name, size)
    faults = drv.__dict__.get("FAULTS")
    assert isinstance(faults, tuple), name
    assert all(isinstance(f, str) and f.isidentifier() for f in faults), name


def test_new_files_and_entries_alone(tmp_path):
    pb, bench = _copy(tmp_path)
    config = json.loads((pb / "configs" / "beam70.json").read_text())
    config.update(name="beam8", grid=[8, 4, 4])
    (pb / "configs" / "beam8.json").write_text(json.dumps(config))
    cell = json.loads((pb / "workloads" / "beam70-loadcases.json").read_text())
    cell.update(config="beam8")
    cell["traffic"].update(name="loadcases-kept", keep_share=1.0,
                           profile_cases=1)
    (pb / "workloads" / "beam8-loadcases.json").write_text(json.dumps(cell))
    (pb / "metrics" / "kept_cases.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    bench["configs"].append({"name": "beam8", "source": "a test",
                             "file": "perfbench/configs/beam8.json",
                             "reduced": ["grid"], "why": "a test"})
    bench["workloads"].append({"name": "beam8-loadcases", "config": "beam8",
                               "traffic": "loadcases-kept", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "kept_cases", "unit": "cases",
                               "better": "higher", "source": "host_clock",
                               "layer": "solvers/cg.py", "moves": "loadcase_s",
                               "workloads": ["beam8-loadcases"]})
    bench["end_to_end"][0]["workloads"].append("beam8-loadcases")
    bench["end_to_end"][1]["workloads"].append("beam8-loadcases")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    found = harness.find_cell("beam8-loadcases", tmp_path)
    assert found.config["grid"] == [8, 4, 4]
    assert "kept_cases" in {m["name"] for m in found.per_layer}
    code, res = harness.run_cell("beam8-loadcases", 5, 0.2, True,
                                 device="cpu", root=tmp_path)
    assert code == 0 and res["correct"] is True
    assert res["metrics"]["kept_cases"]["value"] >= 1
    code, res = harness.run_cell("beam8-loadcases", 5, 0.2, False,
                                 device="cpu", root=tmp_path)
    assert set(res["metrics"]) == {"loadcase_s", "loadcase_p90_s", "setup_s"}


def test_a_new_driver_is_a_new_file(tmp_path):
    """A cell whose traffic driver is a new module (a copy of linear_solve
    with a rehearsal of its own): the harness loads it from the copy, and
    the cells' tests list and rehearse it, with no file there edited."""
    pb, bench = _copy(tmp_path)
    before = _files(pb)
    source = (pb / "drivers" / "linear_solve.py").read_text()
    (pb / "drivers" / "solve_copy.py").write_text(
        source + "\n\nDriver.TINY = (4, 2, 2)\n")
    config = json.loads((pb / "configs" / "beam70.json").read_text())
    config.update(name="beam4", grid=[4, 2, 2])
    (pb / "configs" / "beam4.json").write_text(json.dumps(config))
    cell = json.loads((pb / "workloads" / "beam70-solve.json").read_text())
    cell.update(config="beam4", driver="solve_copy")
    (pb / "workloads" / "beam4-solve.json").write_text(json.dumps(cell))
    bench["configs"].append({"name": "beam4", "source": "a test",
                             "file": "perfbench/configs/beam4.json",
                             "reduced": ["grid"], "why": "a test"})
    bench["workloads"].append({"name": "beam4-solve", "config": "beam4",
                               "traffic": "solves-copy", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("solve_s", "setup_phase_s"):
            m["workloads"].append("beam4-solve")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(filecmp.cmp(pb / f, harness.HERE / f, shallow=False)
               for f in before)

    found = harness.find_cell("beam4-solve", tmp_path)
    assert found.workload["driver"] == "solve_copy"
    assert cells_test.rehearsal("beam4-solve", tmp_path).TINY == (4, 2, 2)
    res = cells_test._run("beam4-solve", root=tmp_path)
    assert res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"solve_s", "setup_s"}
    res = cells_test._run("beam4-solve", True, root=tmp_path)
    assert res["correct"] is True and "setup_phase_s" in res["metrics"]
    res = cells_test._run("beam4-solve", variant="unchanged", root=tmp_path)
    assert res["correct"] is False, res["checks"]

    new = "beam4-solve"
    assert cells_test.cells(tmp_path) == cells_test.cells() + [new]
    assert cells_test.fault_cases(tmp_path) == cells_test.fault_cases() + [
        (new, "unchanged"), (new, "altered")]
    assert cells_test.acceptance_cells(tmp_path) == (
        cells_test.acceptance_cells())
