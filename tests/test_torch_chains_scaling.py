"""Port parity: the chains-scaling measurement (stan_tpu_torch.chains_scaling)
against tools/chains_scaling.py, on the CPU.

The posterior's inputs are held to the reference's construction (stan_tpu,
float64, grid 3): the observed nodes and directions equal, y to 1e-7 of
max|y| (both forwards solve to cg_tol 1e-8). The record must carry every
key of the reference's record, read from the tool's source. One in-process
measurement on ["cpu"] * 8 at grid 2 (2 + 2 draws of one leapfrog step):
the placed 8-chain draws equal the unplaced ones bit for bit, and only the
placed run takes a mesh. The program runs once in a subprocess at the
same size.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.infer import calibrate as jcalibrate
from stan_tpu.infer import forward as jforward
from stan_tpu_torch import chains_scaling
from stan_tpu_torch.infer import calibrate, hmc

F64 = torch.float64
REPO = pathlib.Path(__file__).resolve().parent.parent
TOOL = REPO / "tools" / "chains_scaling.py"


def reference_keys() -> list:
    """The keys of the record tools/chains_scaling.py prints (its `rec`)."""
    tree = ast.parse(TOOL.read_text())
    rec = next(node.value for node in ast.walk(tree)
               if isinstance(node, ast.Assign)
               and [getattr(t, "id", None) for t in node.targets] == ["rec"])
    return [k.value for k in rec.keys]


def _reference_posterior(n):
    """tools/chains_scaling.py:56-74, as the tool builds it."""
    model = jmeshgen.hex_beam(n, n, n)
    true_theta = np.array([np.log(190000.0), 0.28, 0.0])
    fwd = jforward.build_forward(model, cg_tol=1e-8)
    assert isinstance(fwd, jforward.StencilForwardProblem)
    u_true = np.asarray(jforward.displacement_fn(fwd, model.nelem)(
        jnp.asarray(true_theta)))
    total = np.linalg.norm(u_true, axis=1)
    nodes = np.nonzero(total > 0.3 * total.max())[0][:64]
    obs_nodes = np.repeat(nodes, 3)
    obs_dirs = np.tile([0, 1, 2], len(nodes))
    rng = np.random.default_rng(0)
    sigma = 1e-5
    y = u_true[obs_nodes, obs_dirs] + sigma * rng.normal(size=len(obs_nodes))
    return jcalibrate.make_problem(model, obs_nodes, obs_dirs, y, sigma)


def test_posterior_inputs_match_reference():
    jprob = _reference_posterior(3)
    model, obs_nodes, obs_dirs, y = chains_scaling.posterior_inputs(3, "cpu")
    prob = calibrate.make_problem(model, obs_nodes, obs_dirs, y,
                                  chains_scaling.SIGMA, dtype=F64,
                                  device="cpu", cg_tol=chains_scaling.CG_TOL)
    np.testing.assert_array_equal(prob.obs_idx, np.asarray(jprob.obs_idx))
    y_ref = np.asarray(jprob.y)
    np.testing.assert_allclose(prob.y.numpy(), y_ref, rtol=0,
                               atol=1e-7 * np.abs(y_ref).max())
    assert prob.sigma_obs == float(jprob.sigma_obs) == 1e-5


@pytest.fixture(scope="module")
def cpu_run():
    """measure() on ["cpu"] * 8 at grid 2, one torch thread, with every
    run_hmc call's chain count and mesh recorded."""
    calls = []
    inner = hmc.run_hmc

    def spy(logp, theta0, seed, **kw):
        calls.append((theta0.shape[0], kw.get("mesh")))
        return inner(logp, theta0, seed, **kw)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(hmc, "run_hmc", spy)
            rec, runs = chains_scaling.measure(2, n_samples=2, n_warmup=2,
                                               n_leapfrog=1, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return rec, runs, calls


def test_record_has_every_reference_key(cpu_run):
    rec, _, _ = cpu_run
    keys = reference_keys()
    assert "scaling_efficiency" in keys and "sharded_vs_vmap" in keys
    assert set(keys) <= set(rec)
    assert rec["platform"] == "cpu-mesh" and rec["devices"] == 8
    assert rec["metric"] == "hmc_chains_scaling_cpu_mesh"
    assert (rec["grid"], rec["ndof"], rec["n_samples"], rec["n_leapfrog"]) \
        == (2, 81, 2, 1)
    assert rec["scaling_efficiency"] == pytest.approx(
        rec["samples_per_s_8chains_8dev"] / 8 / rec["samples_per_s_1chain"])
    assert rec["sharded_vs_vmap"] == pytest.approx(
        rec["seconds"]["8chains_unplaced"] / rec["seconds"]["8chains_placed"])
    assert rec["mesh_devices"] == ["cpu"] and rec["torch_threads"] == 1
    assert rec["device"] == {"kind": "cpu"} and rec["dtype"] == "float64"
    # The CPU takes the kernels' plain versions: no launch is counted.
    assert list(rec["launches"]) == list(chains_scaling.RUNS)
    for counts in rec["launches"].values():
        assert set(counts.values()) == {0}
    json.dumps(rec)


def test_placed_draws_equal_unplaced_and_one_chain_takes_no_mesh(cpu_run):
    rec, runs, calls = cpu_run
    placed = runs["8chains_placed"].samples
    unplaced = runs["8chains_unplaced"].samples
    assert placed.shape == (8, 2, 3) and np.isfinite(placed).all()
    assert placed.tobytes() == unplaced.tobytes()
    assert rec["placed_vs_unplaced_max_abs"] == 0.0
    # Untimed, then timed: 1 chain unplaced, 8 placed, 8 unplaced.
    assert [(c, m is not None) for c, m in calls] == [
        (1, False), (8, True), (8, False)] * 2
    mesh = calls[1][1]
    assert mesh.shape == {"chains": 8, "domain": 1}
    assert {str(d) for d in mesh.devices.flat} == {"cpu"}
    assert runs["1chain"].samples.shape == (1, 2, 3)


def test_json_out_refuses_the_recorded_figure(monkeypatch, capsys):
    recorded = REPO / "SCALING.json"
    before = recorded.read_bytes()

    def never(*a, **kw):
        raise AssertionError("measured before refusing --json-out")

    monkeypatch.setattr(chains_scaling, "measure", never)
    for path in (str(recorded), os.path.relpath(recorded)):
        with pytest.raises(SystemExit) as exc:
            chains_scaling.main(["--device", "cpu", "--json-out", path])
        assert exc.value.code == 2
        assert "SCALING.json" in capsys.readouterr().err
    assert recorded.read_bytes() == before


def test_json_out_and_run_log_get_the_record(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(chains_scaling, "measure",
                        lambda *a: ({"grid": a[0], "platform": "cpu-mesh"},
                                    {}))
    out, log = tmp_path / "scaling.json", tmp_path / "runlog.jsonl"
    assert chains_scaling.main(["--device", "cpu", "--grid", "4",
                                "--json-out", str(out),
                                "--runlog", str(log)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == {"grid": 4, "platform": "cpu-mesh"}
    assert out.read_text() == line + "\n"
    logged = json.loads(log.read_text())
    assert logged["kind"] == "chains_scaling" and logged["grid"] == 4


def _program(args, cwd, timeout):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "stan_tpu_torch.chains_scaling", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)


def test_program_runs_on_the_cpu(tmp_path):
    out = _program(["--device", "cpu", "--grid", "2", "--n-samples", "2",
                    "--n-warmup", "2", "--n-leapfrog", "1"], tmp_path, 300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(reference_keys()) <= set(rec)
    assert (rec["platform"], rec["grid"], rec["n_leapfrog"]) == (
        "cpu-mesh", 2, 1)
    assert rec["placed_vs_unplaced_max_abs"] == 0.0
    logged = json.loads((tmp_path / "runlog.jsonl").read_text())
    assert logged["kind"] == "chains_scaling"
    assert logged["sharded_vs_vmap"] == rec["sharded_vs_vmap"]


def test_program_without_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = _program(["--device", "cuda"], tmp_path, 120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not out.stdout.strip()
    assert not (tmp_path / "runlog.jsonl").exists()
