"""Port parity: the CLI of stan_tpu_torch (solve --log-json, calibrate with
every sampler, import, export, strip-results, info) and the host modules
behind it (io/nastran.py, utils/runlog.py) against stan_tpu's, on the CPU.

The .bdf cases are tests/test_io.py:63-127 on the port's parser, whose
models equal the reference's pure-Python parse; the runlog case is
tests/test_aux.py:152 with tensor-valued fields; strip-results is
tests/test_post.py:109-135 through the port's CLI.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.io import nastran as jnastran
from stan_tpu_torch import cli
from stan_tpu_torch.analysis.linear import solve_linear_statics
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.io import nastran, stdb, vtu
from stan_tpu_torch.utils import runlog
from stan_tpu_torch.utils.timing import PhaseTimer

F64 = torch.float64

QUIRKY = "\n".join([
    "$ comment with CHEXA inside should still parse next cards",
    "GRID    1               0.0     0.0     0.0",
    "GRID    2               1.0-0   0.0     0.0",
    "GRID    3               1.0     1.0     0.0",
    "GRID    4               .0      1.0     0.0",
    "GRID    5               0.0     0.0     1.0",
    "GRID    6               1.0     0.0     1.0",
    "GRID    7               1.0     1.0     1.0",
    "GRID    8               0.0     1.0     1.0",
    "CHEXA   10      1       1       2       3       4       5       6+",
    "+       7       8",
    "ENDDATA",
])
BAD = "\n".join([
    "GRID    1               0.0     0.0     0.0",
    "GRID    XX              oops",
    "CHEXA   1       1       1       2",  # too few nodes
    "ENDDATA",
])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_model(a, b):
    for name in ("node_ids", "coords", "elem_ids", "conn", "elem_pid",
                 "elem_mat"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.elem_type == b.elem_type
    assert a.import_errors == b.import_errors
    assert sorted(a.part_info) == sorted(b.part_info)
    for k in a.part_info:
        assert vars(a.part_info[k]) == vars(b.part_info[k])


# ------------------------------------------------------------------ .bdf

def test_bdf_roundtrip(tmp_path):
    m = meshgen.hex_beam(3, 2, 2)
    path = str(tmp_path / "mesh.bdf")
    nastran.write_bdf(m, path)
    m2 = nastran.read_bdf(path)
    np.testing.assert_array_equal(m.node_ids, m2.node_ids)
    np.testing.assert_allclose(m.coords, m2.coords, atol=1e-4)
    np.testing.assert_array_equal(m.conn, m2.conn)
    assert m2.elem_type == ["HEX8_G2"] * m.nelem  # default (Element.cs:58)


def test_bdf_number_quirks():
    # .bdf scientific notation without 'e' and leading '.' (Node.cs:40-63)
    for text in ("1.23-4", "-1.23-4", "1.23+4", ".5", "-.5", "2.0"):
        assert nastran._parse_bdf_number(text) == pytest.approx(
            jnastran._parse_bdf_number(text))
    assert nastran._parse_bdf_number("1.23+4") == pytest.approx(1.23e4)
    assert nastran._parse_bdf_number("-.5") == pytest.approx(-0.5)


def test_bdf_parse_quirky_file(tmp_path):
    """Continuation lines, comments, blank CP field, embedded exponents."""
    path = tmp_path / "quirky.bdf"
    path.write_text(QUIRKY)
    m = nastran.read_bdf(str(path))
    assert m.nnode == 8 and m.nelem == 1
    assert m.import_errors == []
    np.testing.assert_array_equal(m.elem_ids, [10])
    np.testing.assert_array_equal(m.conn[0], [0, 1, 2, 3, 4, 5, 6, 7])
    assert m.coords[1, 0] == pytest.approx(1.0)
    assert m.part_info.keys() == {1}


def test_bdf_bad_card_collected_not_fatal(tmp_path):
    path = tmp_path / "bad.bdf"
    path.write_text(BAD)
    m = nastran.read_bdf(str(path))
    assert m.nnode == 1 and m.nelem == 0
    assert len(m.import_errors) == 2


@pytest.mark.parametrize("case", ["beam", "tet", "quirky", "bad", "strict"])
def test_read_bdf_equals_reference_python_parse(tmp_path, case):
    """The port's read_bdf (its native parser; the Python one for a file
    with errors) gives the reference's Python parse of the same file."""
    path = tmp_path / f"{case}.bdf"
    strict = case == "strict"
    if case in ("beam", "strict"):
        jnastran.write_bdf(jmeshgen.hex_beam(3, 2, 2), str(path))
    elif case == "tet":
        path.write_text(QUIRKY.replace(
            "CHEXA   10      1       1       2       3       4       5       "
            "6+\n+       7       8",
            "CTETRA  10      2       1       2       3       5"))
    else:
        path.write_text(QUIRKY if case == "quirky" else BAD)
    _same_model(nastran.read_bdf(str(path), strict=strict),
                jnastran.read_bdf(str(path), strict=strict,
                                  use_native=False))


# ---------------------------------------------------------------- runlog

def test_runlog_roundtrip(tmp_path):
    """tests/test_aux.py:152, with tensor-valued fields: a one-element
    tensor goes out as its number, a larger one as a list (a tensor's
    ``size`` is a method, so the reference's test would write its repr)."""
    m = meshgen.hex_beam(2, 2, 2)
    timer = PhaseTimer(verbose=False)
    with timer.phase("Assembly", nnz=123):
        pass
    path = str(tmp_path / "runs" / "log.jsonl")
    rec = runlog.make_record(
        "solve", model=m, timer=timer, iters=np.int64(17),
        residual=torch.tensor(1e-7, dtype=torch.float32), converged=True,
        per_chain=torch.tensor([1.5, 2.5], dtype=F64),
        counts=np.array([1, 2]))
    runlog.append(path, rec)
    runlog.append(path, runlog.make_record("calibrate", samples_per_s=42.0))
    lines = [json.loads(line) for line in open(path)]
    assert len(lines) == 2
    assert lines[0]["kind"] == "solve"
    assert lines[0]["model"]["ndof"] == m.ndof
    assert lines[0]["iters"] == 17
    assert lines[0]["residual"] == pytest.approx(1e-7)
    assert lines[0]["per_chain"] == [1.5, 2.5]
    assert lines[0]["counts"] == [1, 2]
    assert lines[0]["phases"][0]["phase"] == "Assembly"
    assert lines[0]["phases"][0]["nnz"] == 123
    assert lines[1]["samples_per_s"] == 42.0


# ------------------------------------------------------------------- CLI

def _stdb(tmp_path, *n, solved=False):
    m = meshgen.hex_beam(*n)
    if solved:
        solve_linear_statics(m, device="cpu", dtype=F64)
    path = str(tmp_path / "beam.STdb")
    stdb.write(m, path)
    return path, m


def test_cli_solve_with_config_and_log(tmp_path):
    """tests/test_aux.py:210-222 through the port's CLI."""
    path, _ = _stdb(tmp_path, 3, 2, 2)
    cfgp = tmp_path / "run.toml"
    cfgp.write_text("[analysis]\ntolerance = 1e-8\n")
    logp = tmp_path / "run.jsonl"
    assert cli.main(["solve", path, "--config", str(cfgp), "--log-json",
                     str(logp), "--device", "cpu"]) == 0
    rec = json.loads(open(logp).read().splitlines()[0])
    assert rec["kind"] == "solve" and rec["converged"]
    assert rec["model"]["analysis"]["tolerance"] == 1e-8
    assert rec["operator"] == "stencil" and rec["iters"] > 0
    assert rec["true_residual"] <= 1e-8 and rec["device"] == "cpu"
    assert [p["phase"] for p in rec["phases"]][0] == "Read database"


def test_cli_solve_nonlinear(tmp_path, capsys):
    """solve --type Nonlinear_Statics --increments 2 on a tiny beam: the
    Newton summary, both increments stored in the STdb, the run record;
    the result is the library's."""
    from stan_tpu_torch.analysis.nonlinear import solve_nonlinear_statics

    path, _ = _stdb(tmp_path, 2, 2, 2)
    out, logp = str(tmp_path / "nl.STdb"), str(tmp_path / "run.jsonl")
    assert cli.main(["solve", path, "--type", "Nonlinear_Statics",
                     "--increments", "2", "--out", out, "--log-json", logp,
                     "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "Increment 2:" in text and "Newton iterations" in text
    solved = stdb.read(out)
    assert solved.analysis.type == "Nonlinear_Statics"
    assert solved.disp.shape[0] == 3 and solved.analysis.result_step_no == 2
    model = stdb.read(path)
    model.analysis.type, model.analysis.inc_numb = "Nonlinear_Statics", 2
    lib = solve_nonlinear_statics(model, device="cpu")
    np.testing.assert_array_equal(solved.disp[-1], lib.u)
    rec = json.loads(open(logp).read().splitlines()[0])
    assert rec["kind"] == "solve" and rec["converged"]
    assert rec["newton_iters"] == lib.newton_iters.tolist()
    assert max(rec["residuals"]) <= 1e-3
    assert [p["phase"] for p in rec["phases"]][2:4] == ["Increment 1",
                                                        "Increment 2"]


def test_cli_solve_domain(tmp_path, capsys):
    """solve --domain 2 on the CPU: the x-slab sharded stencil over two CPU
    slabs, reported with its width; the result is the library's."""
    path, _ = _stdb(tmp_path, 7, 2, 2)
    out, logp = str(tmp_path / "out.STdb"), str(tmp_path / "run.jsonl")
    assert cli.main(["solve", path, "--domain", "2", "--out", out,
                     "--log-json", logp, "--device", "cpu"]) == 0
    assert "Operator: sharded-stencilx2 (2 devices, cpu)" in \
        capsys.readouterr().out
    rec = json.loads(open(logp).read().splitlines()[0])
    assert rec["operator"] == "sharded-stencilx2" and rec["n_domain"] == 2
    assert rec["true_residual"] <= 1e-6
    lib = solve_linear_statics(stdb.read(path), device="cpu", n_domain=2)
    np.testing.assert_array_equal(stdb.read(out).disp[-1], lib.u)


@pytest.mark.parametrize("solver", ["Cholesky", "LU"])
def test_cli_solve_direct(tmp_path, capsys, solver):
    path, _ = _stdb(tmp_path, 3, 2, 2)
    logp = str(tmp_path / "run.jsonl")
    assert cli.main(["solve", path, "--solver", solver, "--log-json", logp,
                     "--device", "cpu"]) == 0
    assert f"Operator: dense-{solver.lower()}" in capsys.readouterr().out
    rec = json.loads(open(logp).read().splitlines()[0])
    assert rec["operator"] == f"dense-{solver.lower()}"
    assert rec["true_residual"] < 1e-5  # float32 factorisation
    model = stdb.read(path)
    model.analysis.lin_solver = solver
    lib = solve_linear_statics(model, device="cpu")
    np.testing.assert_array_equal(stdb.read(path).disp[-1], lib.u)


def test_cli_export(tmp_path, capsys):
    path, m = _stdb(tmp_path, 2, 2, 2, solved=True)
    prefix = str(tmp_path / "res")
    assert cli.main(["export", path, prefix, "--ascii", "--device",
                     "cpu"]) == 0
    assert "Wrote" in capsys.readouterr().out
    arrays = vtu.read_vtu_ascii(prefix + "_001.vtu")
    np.testing.assert_allclose(arrays["_anon0"].reshape(-1, 3),
                               m.coords + m.disp[1], atol=1e-6)
    assert "von Mises Stress INC 1" in arrays
    assert cli.main(["export", path, prefix + "u", "--ascii", "--undeformed",
                     "--device", "cpu"]) == 0
    arrays = vtu.read_vtu_ascii(prefix + "u_001.vtu")
    np.testing.assert_allclose(arrays["_anon0"].reshape(-1, 3), m.coords)
    # No results: refused with 2.
    bare, _ = _stdb(tmp_path, 2, 2, 2)
    assert cli.main(["export", bare, prefix, "--device", "cpu"]) == 2


def test_cli_import_and_info(tmp_path, capsys):
    bdf = str(tmp_path / "mesh.bdf")
    nastran.write_bdf(meshgen.hex_beam(3, 2, 2), bdf)
    out = str(tmp_path / "imported.STdb")
    assert cli.main(["import", bdf, out, "--E", "200000",
                     "--poisson", "0.25"]) == 0
    m = stdb.read(out)
    assert m.nnode == 36 and m.nelem == 12
    assert m.materials[1].E == 200000.0 and m.materials[1].poisson == 0.25
    assert (m.elem_mat == 1).all()
    assert all(info.mat_id == 1 for info in m.part_info.values())
    capsys.readouterr()
    assert cli.main(["info", out]) == 0
    text = capsys.readouterr().out
    assert "Analysis: Linear_Statics" in text and "Materials: 1" in text
    assert "Results:" not in text
    path, _ = _stdb(tmp_path, 2, 2, 2, solved=True)
    assert cli.main(["info", path]) == 0
    assert "Results: 2 increments (result_step_no=1)" in \
        capsys.readouterr().out


def test_strip_results_roundtrip(tmp_path):
    """tests/test_post.py:109-135: strip-results removes results, shrinks
    the STdb, and the stripped file re-solves to the same answer."""
    path, m = _stdb(tmp_path, 3, 2, 2, solved=True)
    u_ref = m.disp[1].copy()
    size_with = os.path.getsize(path)
    assert cli.main(["strip-results", path]) == 0
    assert os.path.getsize(path) < size_with
    m2 = stdb.read(path)
    assert m2.disp is None and m2.stress is None and m2.strain is None
    assert m2.analysis.result_step_no == 0
    solve_linear_statics(m2, device="cpu", dtype=F64)
    np.testing.assert_allclose(m2.disp[1], u_ref, rtol=1e-8, atol=1e-12)
    assert cli.main(["strip-results", path]) == 0  # a no-op now


def _short(module, name, **kw):
    """A sampler of the CLI with fewer steps than the CLI gives it."""
    return functools.partial(getattr(module, name), **kw)


def test_cli_calibrate_default_is_nuts(tmp_path, capsys, monkeypatch):
    """No --sampler: the config's default, NUTS, runs; its record and
    summary come out as HMC's do."""
    from stan_tpu_torch.infer import nuts

    monkeypatch.setattr(nuts, "run_nuts", _short(nuts, "run_nuts",
                                                 max_depth=3))
    path, _ = _stdb(tmp_path, 3, 2, 2)
    logp = tmp_path / "cal.jsonl"
    assert cli.main(["calibrate", path, "--synthetic", "--chains", "2",
                     "--warmup", "2", "--samples", "4", "--device", "cpu",
                     "--log-json", str(logp)]) == 0
    text = capsys.readouterr().out
    assert "Sample (nuts)" in text and "R-hat" in text
    assert "0 unconverged" in text
    rec = json.loads(open(logp).read().splitlines()[0])
    assert rec["kind"] == "calibrate" and rec["sampler"] == "nuts"
    assert rec["draws"] == 8 and rec["mesh"] is None
    assert rec["n_devices"] == torch.cuda.device_count()
    assert rec["rhat"] is not None
    st = rec["solve_stats"]
    assert st["forward_solves"] == st["adjoint_solves"] > 0


def test_cli_calibrate_default_holds_the_load(tmp_path, capsys, monkeypatch):
    """The default calibration, NUTS with the load fixed: log s is held, so
    the load scale reads 1 exactly while (E, ν) move (6 warmup steps adapt
    the step: with 2 every proposal diverges, held or not), and R-hat,
    over (E, ν) alone, is a number."""
    from stan_tpu_torch.infer import nuts

    monkeypatch.setattr(nuts, "run_nuts", _short(nuts, "run_nuts",
                                                 max_depth=3))
    path, _ = _stdb(tmp_path, 3, 2, 2)
    logp = tmp_path / "cal.jsonl"
    assert cli.main(["calibrate", path, "--synthetic", "--chains", "2",
                     "--warmup", "6", "--samples", "4", "--device", "cpu",
                     "--log-json", str(logp)]) == 0
    text = capsys.readouterr().out
    assert "load_scale: median 1   90% CI [1, 1]" in text
    assert float(text.split("accept: ")[1].split()[0]) > 0  # (E, ν) move
    rhat = float(text.split("R-hat: ")[1].split()[0])
    assert np.isfinite(rhat) and "(max over free params)" in text
    rec = json.loads(open(logp).read().splitlines()[0])
    assert rec["rhat"] == pytest.approx(rhat, abs=1e-4)


def test_cli_calibrate_vi(tmp_path, capsys):
    path, _ = _stdb(tmp_path, 3, 2, 2)
    logp = tmp_path / "cal.jsonl"
    assert cli.main(["calibrate", path, "--synthetic", "--sampler", "vi",
                     "--samples", "10", "--chains", "2", "--device", "cpu",
                     "--log-json", str(logp)]) == 0
    text = capsys.readouterr().out
    assert "draws: 512" in text and "POSTERIOR" in text
    rec = json.loads(open(logp).read().splitlines()[0])
    assert rec["sampler"] == "vi" and rec["draws"] == 512
    assert rec["rhat"] is None
    # 10 ELBO steps of 8 draws: one forward and one adjoint solve each.
    st = rec["solve_stats"]
    assert st["forward_solves"] == st["adjoint_solves"] == 80


def test_cli_calibrate_smc(tmp_path, capsys, monkeypatch):
    from stan_tpu_torch.infer import smc

    monkeypatch.setattr(smc, "run_smc", _short(smc, "run_smc", n_mcmc=1,
                                               max_stages=2))
    path, _ = _stdb(tmp_path, 3, 2, 2)
    logp = tmp_path / "cal.jsonl"
    assert cli.main(["calibrate", path, "--synthetic", "--sampler", "smc",
                     "--chains", "2", "--device", "cpu",
                     "--log-json", str(logp)]) == 0
    text = capsys.readouterr().out
    assert "draws: 256" in text  # max(chains * 64, 256) particles
    rec = json.loads(open(logp).read().splitlines()[0])
    assert rec["sampler"] == "smc" and rec["draws"] == 256
    # Particle likelihoods need no gradient: no adjoint solve.
    st = rec["solve_stats"]
    assert st["forward_solves"] > 0 and st["adjoint_solves"] == 0


def test_cli_calibrate_chain_sharded(tmp_path, capsys, monkeypatch):
    """tests/test_aux.py:250-270: the [sharding] section reaches the
    sampler; calibrate builds the (chains x domain) mesh, over eight CPU
    slots with --device cpu, and records it in the run log. HMC runs 2
    leapfrog steps (the CLI's: 16), 1 warmup transition and 4 draws."""
    from stan_tpu_torch.infer import hmc

    monkeypatch.setattr(hmc, "run_hmc", _short(hmc, "run_hmc",
                                               n_leapfrog=2))
    path, _ = _stdb(tmp_path, 3, 2, 2)
    cfgp = tmp_path / "run.toml"
    cfgp.write_text("[sharding]\nchains = 8\ndomain = 1\n")
    logp = tmp_path / "cal.jsonl"
    assert cli.main(["calibrate", path, "--synthetic", "--sampler", "hmc",
                     "--samples", "4", "--warmup", "1", "--chains", "8",
                     "--device", "cpu", "--config", str(cfgp),
                     "--log-json", str(logp)]) == 0
    assert "mesh chains=8 x domain=1 on 8 cpu" in capsys.readouterr().out
    rec = json.loads(open(logp).read().splitlines()[0])
    assert rec["mesh"] is not None and "chains=8" in rec["mesh"]
    assert rec["n_devices"] == torch.cuda.device_count()
    assert rec["rhat"] is not None
    st = rec["solve_stats"]
    assert st["forward_solves"] == st["adjoint_solves"] > 0


@pytest.mark.parametrize("toml,chains", [("chains = 8", "3"),
                                         ("chains = 2\ndomain = 2", "3")])
def test_cli_calibrate_refuses_indivisible_chains(tmp_path, capsys, toml,
                                                  chains):
    """tests/test_aux.py:273-285: chains the mesh's rows do not divide exit
    with code 2 and the reference's message."""
    path, _ = _stdb(tmp_path, 3, 2, 2)
    cfgp = tmp_path / "run.toml"
    cfgp.write_text(f"[sharding]\n{toml}\n")
    assert cli.main(["calibrate", path, "--synthetic", "--sampler", "hmc",
                     "--samples", "2", "--warmup", "2", "--chains", chains,
                     "--device", "cpu", "--config", str(cfgp)]) == 2
    assert "ERROR: chains=3 not divisible by the chains mesh axis" in \
        capsys.readouterr().out


@pytest.mark.parametrize("sampler", ["nuts", "smc"])
def test_cli_calibrate_on_a_cpu_mesh(tmp_path, capsys, monkeypatch,
                                     sampler):
    """NUTS and SMC placed on a 2 x 1 CPU mesh through the CLI, short (2 + 2
    draws; SMC 1 Metropolis step, at most 2 stages): exit code 0, the mesh
    line, the mesh in the record."""
    from stan_tpu_torch.infer import nuts, smc

    monkeypatch.setattr(nuts, "run_nuts", _short(nuts, "run_nuts",
                                                 max_depth=3))
    monkeypatch.setattr(smc, "run_smc", _short(smc, "run_smc", n_mcmc=1,
                                               max_stages=2))
    path, _ = _stdb(tmp_path, 3, 2, 2)
    cfgp = tmp_path / "run.toml"
    cfgp.write_text("[sharding]\nchains = 2\n")
    logp = tmp_path / "cal.jsonl"
    assert cli.main(["calibrate", path, "--synthetic", "--sampler", sampler,
                     "--chains", "2", "--warmup", "2", "--samples", "2",
                     "--device", "cpu", "--config", str(cfgp),
                     "--log-json", str(logp)]) == 0
    assert "mesh chains=2 x domain=1 on 2 cpu" in capsys.readouterr().out
    rec = json.loads(open(logp).read().splitlines()[0])
    assert rec["sampler"] == sampler and "chains=2" in rec["mesh"]
    assert rec["draws"] == (4 if sampler == "nuts" else 256)


def _reference_cli_log_prior(prob):
    """The SMC prior of the reference's CLI (stan_tpu/cli.py:256-260),
    verbatim, per particle [3] -> scalar in JAX."""
    import jax

    def log_prior(theta):
        lp = -0.5 * ((theta[0] - prob.mu_logE) / prob.sigma_logE) ** 2
        lp += jax.nn.log_sigmoid(theta[1]) + jax.nn.log_sigmoid(-theta[1])
        return lp - 0.5 * (theta[2] / prob.sigma_logs) ** 2

    return jax.vmap(log_prior)


def test_cli_smc_split_matches_the_posterior():
    """The calibration problem's SMC split, which the CLI's smc branch
    runs: log_prior equals the reference CLI's prior on the same θ (to
    1e-13), log_prior + log_likelihood is the log posterior, and the prior
    draws have the reference's prior moments (the logit of 2ν is standard
    logistic)."""
    import jax.numpy as jnp

    from stan_tpu_torch.infer import calibrate, forward

    m = meshgen.hex_beam(3, 2, 2)
    fwd = forward.build_forward(m, dtype=F64, device="cpu")
    u = forward.displacement_fn(fwd, m.nelem)(
        torch.tensor([np.log(190000.0), 0.28, 0.0])).numpy()
    for infer_load in (False, True):
        prob = calibrate.make_problem(m, [5, 6], [2, 2], u[[5, 6], [2, 2]],
                                      1e-4, dtype=F64, device="cpu",
                                      infer_load=infer_load)
        draws = prob.sample_prior(torch.Generator().manual_seed(0), 20000)
        assert draws.dtype == F64 and draws.shape == (20000, 3)
        np.testing.assert_allclose(draws.mean(0).numpy(),
                                   [prob.mu_logE, 0.0, 0.0], atol=0.05)
        np.testing.assert_allclose(draws.std(0).numpy(),
                                   [prob.sigma_logE, np.pi / np.sqrt(3.0),
                                    prob.sigma_logs], rtol=0.05)
        ref = np.asarray(_reference_cli_log_prior(prob)(
            jnp.asarray(draws[:500].numpy())))
        np.testing.assert_allclose(prob.log_prior(draws[:500]).numpy(), ref,
                                   rtol=1e-13, atol=1e-13)
        theta = draws[:3]
        np.testing.assert_allclose(
            (prob.log_prior(theta) + prob.log_likelihood(theta)).numpy(),
            prob.log_posterior(theta).numpy(), rtol=1e-12)
