"""Port parity: the port's benchmark (stan_tpu_torch.bench) and its
large-calibration run (stan_tpu_torch.calib_large) against bench.py and
tools/cpu_baseline.py, on the CPU.

bench.py is imported as a module (its JAX imports sit inside its
functions). The calibration problem is held to bench.py's in float64 (y to
1e-5 of max|y|: both sides solve to cg_tol 1e-6); the posterior summary and
the steady rate to 1e-12 on one numpy-made result; cg_fixed after 20
iterations to a JAX transcription of bench.py's cg_fixed on the JAX
StencilOperator (its sweep through the plain jnp twin: interpret-mode
Pallas costs minutes here) to 1e-10; the baseline's K to the one
tools/cpu_baseline.py builds, run on a small beam, to 1e-12 of max|K|.
The whole program runs once, --small --device cpu with short sampler
blocks, in a subprocess; its chains_scaling block runs the measurement on
["cpu"] * 8 and must carry every key of tools/chains_scaling.py's record.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import jax
import jax.numpy as jnp

import bench as jbench
from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.fem import stencil as jstencil
from stan_tpu_torch import bench, calib_large
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.fem import stencil
from test_torch_chains_scaling import reference_keys

F64 = torch.float64
REPO = pathlib.Path(__file__).resolve().parent.parent
BLOCKS = ["headline", "cpu_baseline", "solve_to_tol_1e6", "hmc_1", "hmc_2",
          "nuts", "chains_scaling"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_calibration_problem_matches_reference():
    _, jprob = jbench._calibration_problem(8)
    _, prob = bench._calibration_problem(8, device="cpu", dtype=F64)
    np.testing.assert_array_equal(prob.obs_idx, np.asarray(jprob.obs_idx))
    y_ref = np.asarray(jprob.y)
    np.testing.assert_allclose(prob.y.numpy(), y_ref, rtol=0,
                               atol=1e-5 * np.abs(y_ref).max())
    assert prob.sigma_obs == pytest.approx(jprob.sigma_obs, rel=1e-5)
    assert prob.y.dtype == F64 and len(y_ref) == 384


def _fake_result(seed=3):
    rng = np.random.default_rng(seed)
    samples = np.stack([np.log(190000.0) + 1e-3 * rng.normal(size=(4, 30)),
                        -0.9 + 0.01 * rng.normal(size=(4, 30)),
                        np.zeros((4, 30))], axis=-1)
    return types.SimpleNamespace(
        samples=samples, ess=np.array([57.3, 91.0, 120.0]),
        rhat=np.array([1.01, 1.002, 1.0]),
        chunk_seconds=[5.0, 1.25, 1.5, 1.0], chunk_sizes=[6, 6, 6, 12])


def test_posterior_summary_and_steady_rate_match_reference():
    res = _fake_result()
    mine = bench._posterior_summary(res, 4)
    ref = jbench._posterior_summary(res, 4)
    assert mine.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, dict):
            assert mine[k] == v
        else:
            assert mine[k] == pytest.approx(v, rel=1e-12, abs=0.0), k
    assert bench._steady_sps(res, 4) == pytest.approx(
        jbench._steady_sps(res, 4), rel=1e-12)
    res.chunk_seconds = [3.0]
    assert bench._steady_sps(res, 4) == jbench._steady_sps(res, 4) == 0.0


def _jax_cg_fixed(op, b, niters):
    """bench.py's cg_fixed (bench.py:86-108), on the JAX operator."""
    diag = op.diagonal()
    inv_diag = jnp.where(diag != 0, 1.0 / diag, 0.0)
    x = jnp.zeros_like(b)
    r = b
    z = inv_diag * r
    p = z
    rz = jnp.sum(r * z)

    def body(_, state):
        x, r, p, rz = state
        Ap = op.apply(p)
        alpha = rz / jnp.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = jnp.sum(r * z)
        p = z + (rz_new / rz) * p
        return (x, r, p, rz_new)

    x, r, _, _ = jax.lax.fori_loop(0, niters, body, (x, r, p, rz))
    return x, jnp.sqrt(jnp.sum(r * r))


def test_cg_fixed_matches_reference(monkeypatch):
    jax.clear_caches()
    monkeypatch.setattr(
        jstencil.StencilOperator, "apply_raw",
        lambda self, u: jstencil._stencil_apply_jnp(self.tables, self.deltas,
                                                    u))
    m = meshgen.hex_beam(6, 4, 4)
    jop = jstencil.build_stencil_operator(jmeshgen.hex_beam(6, 4, 4))
    op = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    loads = m.load_vector()
    jb = jop.free_mask * jop.to_grid(jnp.asarray(loads))
    b = op.free_mask * op.to_grid(torch.as_tensor(loads, dtype=F64))
    jx, jrn = _jax_cg_fixed(jop, jb, 20)
    x, rn = bench.cg_fixed(op, b, 20)
    jx = np.asarray(jx)
    np.testing.assert_allclose(x.numpy(), jx, rtol=0,
                               atol=1e-10 * np.abs(jx).max())
    assert float(rn) == pytest.approx(float(jrn), rel=1e-10)
    # 20 iterations leave the residual well above rounding.
    assert float(rn) > 1e-6 * float(torch.linalg.vector_norm(b))
    jax.clear_caches()


def test_apply_chain_rescales_each_apply():
    m = meshgen.hex_beam(4, 3, 3)
    op = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (3, *op.node_shape)))
    want = op.apply(op.apply(u) * 1e-3) * 1e-3
    torch.testing.assert_close(bench.apply_chain(op, u, 2), want, rtol=0,
                               atol=0)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("beam", [(4, 3, 3), (12, 3, 3)])
def test_cpu_baseline_system_matches_tool(beam, monkeypatch, capsys):
    """tools/cpu_baseline.py, run with its beam replaced by a small one,
    hands scipy's cg its K, f and M: the port builds the same, and the
    50-iteration residuals agree (on 12 x 3 x 3, 50 iterations leave the
    residual far above rounding; on 4 x 3 x 3 they reach it)."""
    tool = _load_tool("cpu_baseline")
    seen = {}

    def spy_cg(K, f, **kw):
        seen.update(K=K, f=f, M=kw["M"])
        seen["x"], info = spla.cg(K, f, **kw)
        return seen["x"], info

    monkeypatch.setattr(tool, "meshgen", types.SimpleNamespace(
        hex_beam=lambda *a: jmeshgen.hex_beam(*beam)))
    monkeypatch.setattr(tool, "spla", types.SimpleNamespace(cg=spy_cg))
    tool.main()
    assert "50 iters" in capsys.readouterr().out

    K, f, Minv = bench.baseline_system(meshgen.hex_beam(*beam))
    K_ref = seen["K"].tocsr()
    scale = abs(K_ref).max()
    assert K.shape == K_ref.shape
    assert abs(K - K_ref).max() <= 1e-12 * scale
    np.testing.assert_allclose(f, seen["f"], rtol=0,
                               atol=1e-12 * np.abs(seen["f"]).max())
    np.testing.assert_allclose(Minv.diagonal(), seen["M"].diagonal(),
                               rtol=1e-12)
    # The port's CG call on the tool's system is the tool's, bit for bit.
    x_tool, iters, _ = bench.baseline_cg(K_ref, seen["f"], seen["M"])
    assert iters == 50
    np.testing.assert_array_equal(x_tool, seen["x"])
    # On the port's own K (equal to rounding): 50 iterations of CG move x
    # by ~1e-9 of max|x| and the residual's norm by up to ~1% for a
    # perturbation of K at 1e-16 (measured on these beams), so x is held
    # to 1e-7 of max|x| and the residual to 5%.
    x, _, _ = bench.baseline_cg(K, f, Minv)
    np.testing.assert_allclose(x, seen["x"], rtol=0,
                               atol=1e-7 * np.abs(seen["x"]).max())
    fn = np.linalg.norm(f)
    rel = np.linalg.norm(f - K @ x) / fn
    rel_ref = np.linalg.norm(seen["f"] - K_ref @ seen["x"]) / fn
    assert rel == pytest.approx(rel_ref, rel=5e-2, abs=1e-12)
    assert rel_ref > 1e-8 or beam == (4, 3, 3)


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_bench_small_runs_end_to_end_on_the_cpu():
    """python -m stan_tpu_torch.bench --small --device cpu, the sampler
    blocks cut to 2 warmup iterations and 2 draws: every block's line and
    the final line parse, on the CPU, and none claims a card."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "stan_tpu_torch.bench", "--small", "--device",
         "cpu", "--lengths", "2", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = _lines(out.stdout)
    *blocks, final = lines
    assert [b["block"] for b in blocks] == BLOCKS
    for line in lines:
        assert line["device"] == {"kind": "cpu"}
        assert "error" not in line and "skipped" not in line
    for b in blocks:
        assert b["block_seconds"] > 0
    solve = blocks[BLOCKS.index("solve_to_tol_1e6")]
    assert solve["seconds"] == solve["seconds_runs"][1]
    assert solve == {**final["solve_to_tol_1e6"], "block": solve["block"],
                     "block_seconds": solve["block_seconds"],
                     "launches": solve["launches"], "device": solve["device"]}
    for word in ("cuda", "H100", "NVIDIA"):
        assert word not in out.stdout
    assert final["failed"] == []
    assert final["ndof"] == 3 * 13 ** 3 and final["value"] > 0
    assert final["vs_baseline"] == pytest.approx(
        final["value"] / final["cpu_baseline"]["iters_per_s"])
    assert final["cpu_baseline"]["iters"] == 50
    cert = final["solve_to_tol_1e6"]["certified"]
    assert cert["converged"] and cert["rel_residual_device_f64"] <= 1e-6
    assert abs(cert["rel_residual_host_f64_crosscheck"]
               - cert["rel_residual_device_f64"]) <= 1e-8
    assert [r["n_chains"] for r in final["hmc"]["rows"]] == [1, 2]
    assert final["nuts"]["n_chains"] == 2
    # The chains-scaling measurement on the CPU mesh, --small: grid 3, 2 + 2.
    scaling = final["chains_scaling"]
    assert set(reference_keys()) <= set(scaling)
    assert (scaling["platform"], scaling["grid"], scaling["n_warmup"],
            scaling["n_samples"]) == ("cpu-mesh", 3, 2, 2)
    assert scaling["mesh_devices"] == ["cpu"]
    assert scaling["placed_vs_unplaced_max_abs"] == 0.0
    # The CPU takes the kernels' plain versions: no launch is counted.
    assert set(final["launches"]) == set(BLOCKS)
    for counts in final["launches"].values():
        assert counts == dict.fromkeys(bench.KERNELS, 0)


@pytest.mark.parametrize("module", ["bench", "calib_large"])
def test_entry_point_without_device_needs_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run([sys.executable, "-m", f"stan_tpu_torch.{module}"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not _lines(out.stdout)


def _cheap_blocks(monkeypatch, headline):
    monkeypatch.setattr(bench, "headline", headline)
    monkeypatch.setattr(bench, "cpu_baseline",
                        lambda n: {"iters_per_s": 4.0})
    monkeypatch.setattr(bench, "solve_to_tol", lambda n, dev: {"iters": 1})
    monkeypatch.setattr(bench, "hmc_row", lambda *a: {"n_chains": a[2]})
    monkeypatch.setattr(bench, "nuts_block", lambda *a: {"n_chains": 4})
    monkeypatch.setattr(bench, "chains_scaling", lambda *a: {"grid": 12})


def test_a_failed_block_prints_its_error_and_the_run_exits_nonzero(
        monkeypatch, capsys):
    def broken(n, small, dev):
        raise ValueError("broken on purpose")

    _cheap_blocks(monkeypatch, broken)
    assert bench.main(["--device", "cpu"]) == 1
    *blocks, final = _lines(capsys.readouterr().out)
    assert blocks[0] == {"block": "headline",
                         "error": "ValueError: broken on purpose",
                         "device": {"kind": "cpu"}}
    assert [b["block"] for b in blocks[1:]] == [
        "cpu_baseline", "solve_to_tol_1e6", "hmc_1", "hmc_4", "hmc_16",
        "nuts", "chains_scaling"]
    assert final["failed"] == ["headline"]
    assert final["vs_baseline"] is None and "headline" not in final["launches"]
    assert [r["n_chains"] for r in final["hmc"]["rows"]] == [1, 4, 16]


def test_blocks_after_the_deadline_are_skipped(monkeypatch):
    _cheap_blocks(monkeypatch, lambda n, small, dev: {"value": 8.0})
    monkeypatch.setattr(bench, "DEADLINE_S", -1.0)
    lines = []
    record, failed = bench.run(device="cpu", emit=lines.append)
    assert failed == []
    assert [json.loads(ln) for ln in lines] == [
        {"block": b, "skipped": "deadline", "device": {"kind": "cpu"}}
        for b in ["headline", "cpu_baseline", "solve_to_tol_1e6", "hmc_1",
                  "hmc_4", "hmc_16", "nuts", "chains_scaling"]]
    assert record["launches"] == {} and record["vs_baseline"] is None
    assert record["hmc"]["rows"] == [None, None, None]


def test_blocks_not_asked_for_are_skipped(monkeypatch, capsys):
    _cheap_blocks(monkeypatch, lambda n, small, dev: {"value": 8.0})
    assert bench.main(["--device", "cpu", "--blocks", "cpu_baseline",
                       "hmc_4"]) == 0
    *blocks, final = _lines(capsys.readouterr().out)
    ran = [b["block"] for b in blocks if "skipped" not in b]
    assert ran == ["cpu_baseline", "hmc_4"]
    assert all(b["skipped"] == "not asked for" for b in blocks
               if b["block"] not in ran)
    assert final["hmc"]["rows"] == [None, {"n_chains": 4}, None]
    assert set(final["launches"]) == {"cpu_baseline", "hmc_4"}
    assert final["vs_baseline"] is None and final["failed"] == []


def test_sweep_bound_is_set_by_bytes_at_70_cubed():
    ms, by = bench.sweep_bound_ms((73, 73, 73), torch.float32)
    nbytes = (3 * 75 ** 3 + 3 * 73 ** 3 + 27 * 27 * 9) * 4
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / bench.HBM_BYTES_PER_S * 1e3)


def test_calib_large_runs_on_the_cpu_and_appends_its_record(tmp_path,
                                                            capsys):
    log = tmp_path / "runs.jsonl"
    assert calib_large.main(["--n", "4", "--chains", "2", "--samples", "2",
                             "--warmup", "2", "--leapfrog", "2",
                             "--device", "cpu", "--runlog", str(log)]) == 0
    printed = _lines(capsys.readouterr().out)[-1]
    (logged,) = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert logged["kind"] == "calib_large"
    assert {k: logged[k] for k in printed} == printed
    assert printed["metric"] == "hmc_calibration_4cubed"
    assert printed["ndof"] == 3 * 5 ** 3 and printed["n_chains"] == 2
    assert printed["device"] == {"kind": "cpu"}
    assert np.isfinite(printed["posterior_E_mean"])
