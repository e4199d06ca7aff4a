"""Every cell rehearsed on the CPU at a tiny size (the program's plain
sweeps, the reference on the CPU): a well-formed result line, correct for
the program; not correct with the timed path broken underneath, once for
each fault the cell can have; and not correct with the control, the
reference in the precision below the configuration's in the program's
place, here and on a card at a small size (the chip runs at the cells' own
sizes are perfbench/tools/readings.py's, in PERF.md)."""

import json
import math
import pathlib

import pytest
import torch

from perfbench import harness


def cells(root=harness.ROOT):
    bench = harness.load_json(pathlib.Path(root) / "BENCHMARK.json")
    return [w["name"] for w in bench["workloads"]]


def rehearsal(cell, root=harness.ROOT):
    """The cell's traffic driver, which declares TINY, SMALL and FAULTS."""
    return harness.driver_class(
        harness.find_cell(cell, root).workload["driver"], root)


def _faults(cell, root=harness.ROOT):
    """The faults a cell can have: half of a batch of one chain is none. A
    driver without FAULTS has none here; the drivers' own test fails it."""
    one = harness.find_cell(cell, root).workload["traffic"].get(
        "chains", 2) == 1
    return [f for f in getattr(rehearsal(cell, root), "FAULTS", ())
            if not (one and f == "half")]


def fault_cases(root=harness.ROOT):
    return [(c, f) for c in cells(root) for f in _faults(c, root)]


def acceptance_cells(root=harness.ROOT):
    """The cells whose check counts the Metropolis step's decision errors."""
    return [c for c in cells(root)
            if "decision_errors" in harness.find_cell(c, root).workload[
                "limits"]]


def _run(cell, trace=False, variant="program", seed=2 ** 31 + 11,
         root=harness.ROOT):
    code, res = harness.run_cell(cell, seed, 0.2, trace, device="cpu",
                                 variant=variant,
                                 scale=rehearsal(cell, root).TINY, root=root)
    assert code == 0
    return json.loads(json.dumps(res))  # what the last line would carry


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", cells())
def test_rehearsal_prints_a_well_formed_line(cell, trace):
    res = _run(cell, trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    c = harness.find_cell(cell)
    want = c.per_layer if trace else c.end_to_end
    for m in res["metrics"]:
        assert m in {w["name"] for w in want}
        assert math.isfinite(res["metrics"][m]["value"])
    if not trace:
        assert set(res["metrics"]) == {m["name"] for m in want}
    else:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert res["device"]["window_s"] > 0
    for name, v in res["checks"].items():
        assert set(v) == {"value", "limit"}


@pytest.mark.parametrize("cell,fault", fault_cases())
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = _run(cell, variant=fault)
    assert res["correct"] is False, res["checks"]


def _flipped(la):
    return -la


def _refused(la):
    return torch.full_like(la, -math.inf)


@pytest.mark.parametrize("broken", [_flipped, _refused])
@pytest.mark.parametrize("cell", acceptance_cells())
def test_a_broken_acceptance_is_not_correct(cell, broken, monkeypatch):
    """The program's Metropolis step broken underneath (ΔH's sign flipped;
    every proposal refused): the chains' log posteriors, gradients and
    leapfrog stay sound, and the check of every transition's decision
    catches it."""
    from stan_tpu_torch.infer import hmc

    log_accept = hmc._log_accept
    monkeypatch.setattr(hmc, "_log_accept",
                        lambda *a: broken(log_accept(*a)))
    res = _run(cell)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["decision_errors"]["value"] > 0
    assert all(v["value"] <= v["limit"] for n, v in res["checks"].items()
               if n != "decision_errors")


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(cell):
    """The reference in the precision below the configuration's, in the
    program's place, at a tiny size on the CPU."""
    for seed in (101, 102, 103):
        res = _run(cell, variant="control", seed=seed)
        assert res["correct"] is False, res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct_on_the_card(cell, card):
    for seed in (101,):
        code, res = harness.run_cell(cell, seed, 0.5, False, device=card,
                                     variant="control",
                                     scale=rehearsal(cell).SMALL)
        assert code == 0 and res["correct"] is False, res["checks"]
