"""A configuration, a cell and a per-layer metric are added as new files
and new entries alone, and the harness finds and runs them."""

import json
import shutil

from perfbench import harness


def test_new_files_and_entries_alone(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "perfbench"
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
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
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
