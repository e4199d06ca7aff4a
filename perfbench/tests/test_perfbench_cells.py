"""Every cell rehearsed on the CPU at a tiny size (the program's plain
sweeps, the reference on the CPU): a well-formed result line, correct for
the program; not correct with the timed path broken underneath, once for
each fault the cell can have; and not correct with the control, the
reference in the precision below the configuration's in the program's
place, here and on a card at a small size (the chip runs at the cells' own
sizes are perfbench/tools/readings.py's, in PERF.md)."""

import json
import math

import pytest
import torch

from perfbench import harness

TINY = {"linear_cases": (6, 4, 4), "linear_solve": (6, 4, 4), "hmc": (5, 3, 3)}
FAULTS = {"linear_cases": ("unchanged", "altered"),
          "linear_solve": ("unchanged", "altered"),
          "hmc": ("unchanged", "half", "altered")}
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _driver(cell):
    return harness.find_cell(cell).workload["driver"]


def _faults(cell):
    """The faults a cell can have: half of a batch of one chain is none."""
    one = harness.find_cell(cell).workload["traffic"].get("chains", 2) == 1
    return [f for f in FAULTS[_driver(cell)] if not (one and f == "half")]


def _run(cell, trace=False, variant="program", seed=2 ** 31 + 11):
    code, res = harness.run_cell(cell, seed, 0.2, trace, device="cpu",
                                 variant=variant, scale=TINY[_driver(cell)])
    assert code == 0
    return json.loads(json.dumps(res))  # what the last line would carry


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
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


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in _faults(c)])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = _run(cell, variant=fault)
    assert res["correct"] is False, res["checks"]


def _flipped(la):
    return -la


def _refused(la):
    return torch.full_like(la, -math.inf)


@pytest.mark.parametrize("broken", [_flipped, _refused])
@pytest.mark.parametrize("cell", [c for c in CELLS if _driver(c) == "hmc"])
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


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in the precision below the configuration's, in the
    program's place, at a tiny size on the CPU."""
    for seed in (101, 102, 103):
        res = _run(cell, variant="control", seed=seed)
        assert res["correct"] is False, res["checks"]


SMALL = {"linear_cases": (24, 24, 24), "linear_solve": (24, 24, 24),
         "hmc": (16, 16, 16)}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell, card):
    for seed in (101,):
        code, res = harness.run_cell(cell, seed, 0.5, False, device=card,
                                     variant="control",
                                     scale=SMALL[_driver(cell)])
        assert code == 0 and res["correct"] is False, res["checks"]
