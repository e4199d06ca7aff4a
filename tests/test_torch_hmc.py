"""Port parity: the chain-batched HMC sampler of stan_tpu_torch against
stan_tpu.infer.hmc, in float64 on the CPU.

JAX's threefry keys and torch's generators draw different streams, so the
samplers are compared where no random draw enters (the leapfrog given the
same numpy momenta, to 1e-10 relative; the warmup schedule, dual averaging
and diagnostics on fixed inputs, exactly or to rounding) and by statistics
(posterior moments of a Gaussian target within Monte-Carlo error).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stan_tpu.core import meshgen
from stan_tpu.infer import calibrate as jcalibrate
from stan_tpu.infer import hmc as jhmc
from stan_tpu.utils import checkpoint as ckpt
from stan_tpu_torch import cli
from stan_tpu_torch.infer import calibrate, forward, hmc

F64 = torch.float64
_COV = np.array([[1.0, 0.6], [0.6, 2.0]])
_COV_INV = np.linalg.inv(_COV)
_MEAN = np.array([1.0, -2.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: intra-op threads only add contention with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gauss_logp(theta):
    """Chain-batched correlated 2-D Gaussian log density, [C, 2] -> [C]."""
    d = theta - torch.as_tensor(_MEAN)
    return -0.5 * torch.einsum("ci,ij,cj->c", d, torch.as_tensor(_COV_INV), d)


def _jgauss_logp(theta):
    d = theta - jnp.asarray(_MEAN)
    return -0.5 * d @ jnp.asarray(_COV_INV) @ d


def _check_moments(samples, mean_tol, cov_tol):
    flat = samples.reshape(-1, samples.shape[-1])
    np.testing.assert_allclose(flat.mean(axis=0), _MEAN, atol=mean_tol)
    np.testing.assert_allclose(np.cov(flat.T), _COV, atol=cov_tol)


def _leapfrog_pair(port_lgb, jax_lgb, theta, seed, n_steps):
    """Both leapfrogs from the same state and numpy momenta. The start
    state's (logp, grad) is the port's, so the jitted reference holds one
    copy of the target (in its loop body) and compiles once; every later
    (logp, grad) on each side is its own."""
    rng = np.random.default_rng(seed)
    C, D = theta.shape
    p = rng.standard_normal((C, D))
    step = rng.uniform(0.5, 1.5, C) * 0.05
    inv_mass = rng.uniform(0.5, 2.0, (C, D))
    v, g = port_lgb(torch.as_tensor(theta))
    new, p1 = hmc._leapfrog(port_lgb, hmc.HMCState(torch.as_tensor(theta), v,
                                                   g),
                            torch.as_tensor(p), torch.as_tensor(step),
                            torch.as_tensor(inv_mass), n_steps)

    @jax.jit
    def reference(theta, logp, grad, p, step, inv_mass):
        state = jhmc.HMCState(theta, logp, grad)
        return jhmc._leapfrog(jax_lgb, state, p, step, inv_mass, n_steps)

    jnew, jp1 = reference(*(jnp.asarray(np.asarray(a)) for a in (
        theta, v, g, p, step, inv_mass)))
    for mine, ref in zip((*new, p1), (*jnew, jp1)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), rtol=1e-10,
                                   atol=1e-10 * np.abs(np.asarray(ref)).max())


def test_leapfrog_matches_reference_gaussian():
    theta = np.random.default_rng(1).standard_normal((4, 2))
    _leapfrog_pair(hmc.guarded_logp_grad_b(_gauss_logp),
                   jhmc.guarded_logp_grad_b(_jgauss_logp), theta, 2, 12)


@functools.lru_cache(maxsize=None)
def _fem_problems():
    """The port's and the reference's calibration posterior of hex_beam(3,
    2,2) on the same observations (σ = 1e-4)."""
    m = meshgen.hex_beam(3, 2, 2)
    fwd = forward.build_forward(m, dtype=F64, device="cpu")
    u = forward.displacement_fn(fwd, m.nelem)(
        torch.tensor([np.log(190000.0), 0.28, 0.0])).numpy()
    total = np.linalg.norm(u, axis=1)
    nodes = np.nonzero(total > 0.3 * total.max())[0]
    obs_nodes, obs_dirs = np.repeat(nodes, 3), np.tile([0, 1, 2], len(nodes))
    y = u[obs_nodes, obs_dirs] + 1e-4 * np.random.default_rng(0).normal(
        size=len(obs_nodes))
    prob = calibrate.make_problem(m, obs_nodes, obs_dirs, y, 1e-4, dtype=F64,
                                  device="cpu")
    jprob = jcalibrate.make_problem(m, obs_nodes, obs_dirs, y, 1e-4)
    return prob, jprob


def test_leapfrog_matches_reference_fem():
    prob, jprob = _fem_problems()
    theta = np.array([[np.log(200000.0), 0.1, 0.0],
                      [np.log(185000.0), -0.1, 0.0]])
    _leapfrog_pair(hmc.guarded_logp_grad_b(prob.log_posterior),
                   jhmc.guarded_logp_grad_b(jprob.log_posterior), theta, 3, 3)


@pytest.mark.parametrize("n_warmup", [0, 10, 19, 20, 64, 150, 500, 1000])
def test_warmup_window_flags_match_reference(n_warmup):
    np.testing.assert_array_equal(hmc.warmup_window_flags(n_warmup),
                                  jhmc.warmup_window_flags(n_warmup))


def test_dual_averaging_matches_reference():
    step0 = np.array([0.1, 0.5, 2.0])
    aps = np.random.default_rng(4).uniform(0.0, 1.0, (6, 3))
    s, js = hmc._dual_avg_init(torch.as_tensor(step0)), jhmc._dual_avg_init(
        jnp.asarray(step0))
    for ap in aps:
        s = hmc._dual_avg_update(s, torch.as_tensor(ap), target=0.8)
        js = jhmc._dual_avg_update(js, jnp.asarray(ap), target=0.8)
        for mine, ref in zip(s, js):
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                       rtol=1e-13)


def test_diagnostics_match_reference():
    x = np.random.default_rng(5).standard_normal((4, 101, 3)).cumsum(axis=1)
    for mine, ref in zip(hmc.diagnostics(x), jhmc.diagnostics(x)):
        np.testing.assert_array_equal(mine, ref)


def test_hmc_gaussian_moments():
    """tests/test_infer.py:41-49 with a seeded generator, and the same
    tolerances; 16 chains of 400 draws (the reference: 4 of 1500), since a
    transition costs the same for any number of chains."""
    res = hmc.run_hmc(_gauss_logp, torch.zeros((16, 2), dtype=F64), 0,
                      n_samples=400, n_warmup=300, n_leapfrog=12)
    assert res.samples.shape == (16, 400, 2)
    assert (res.accept_rate > 0.6).all()
    assert (res.rhat < 1.05).all()
    _check_moments(res.samples, mean_tol=0.12, cov_tol=0.35)
    assert (res.evals_per_sample == 12).all()


_KW = dict(n_warmup=30, n_leapfrog=6, init_step=0.1)


def test_checkpoint_resume_reproduces_straight_run(tmp_path):
    theta0 = torch.as_tensor(np.random.default_rng(6).standard_normal((3, 2)))
    straight = hmc.run_hmc(_gauss_logp, theta0, 8, n_samples=20, **_KW)
    path = str(tmp_path / "hmc.ckpt")
    first = hmc.run_hmc(_gauss_logp, theta0, 8, n_samples=10,
                        checkpoint_path=path, checkpoint_every=4, **_KW)
    np.testing.assert_array_equal(first.samples, straight.samples[:, :10])
    assert ckpt.load(path)["n_done"] == 10
    resumed = hmc.run_hmc(_gauss_logp, theta0, 8, n_samples=20,
                          checkpoint_path=path, checkpoint_every=4, **_KW)
    assert resumed.warmup_seconds == 0.0  # the warmup was not run again
    np.testing.assert_array_equal(resumed.samples, straight.samples)
    np.testing.assert_array_equal(resumed.step_size, straight.step_size)
    np.testing.assert_array_equal(resumed.inv_mass, straight.inv_mass)


def test_checkpoint_of_the_jax_sampler_is_not_resumed(tmp_path):
    """A checkpoint written under the reference's kernel_id, with the same
    run identity otherwise, starts a fresh run (the generators differ)."""
    theta0 = torch.as_tensor(np.random.default_rng(7).standard_normal((3, 2)))
    straight = hmc.run_hmc(_gauss_logp, theta0, 9, n_samples=8, **_KW)
    path = str(tmp_path / "jax.ckpt")
    ckpt.save(path, {"kernel": "hmc:leapfrog6", "n_warmup": 30,
                     "n_chains": 3, "dim": 2, "n_done": 4, "n_chunks": 1,
                     "theta": np.zeros((3, 2)), "step": np.ones(3),
                     "inv_mass": np.ones((3, 2)), "acc_sum": np.zeros(3),
                     "eval_sum": np.zeros(3)})
    ckpt.save_chunk(path, 0, np.full((3, 4, 2), 99.0))
    res = hmc.run_hmc(_gauss_logp, theta0, 9, n_samples=8,
                      checkpoint_path=path, checkpoint_every=4, **_KW)
    np.testing.assert_array_equal(res.samples, straight.samples)
    assert ckpt.load(path)["kernel"] == "torch-hmc:leapfrog6"


def test_short_fem_calibration():
    """2 chains, 10 warmup and 10 samples of 4 leapfrog steps on
    hex_beam(3,2,2)."""
    prob, _ = _fem_problems()
    theta0 = torch.tensor([[np.log(210000.0), 0.0, 0.0]] * 2, dtype=F64)
    res = hmc.run_hmc(prob.log_posterior, theta0, 6, n_samples=10,
                      n_warmup=10, n_leapfrog=4, solve_stats=prob.fwd.stats)
    assert res.samples.shape == (2, 10, 3)
    assert np.isfinite(res.samples).all()
    assert (res.accept_rate > 0).all()
    st = res.solve_stats
    # Every gradient evaluation is one chain-batched forward and adjoint
    # solve over both chains.
    assert st["forward_solves"] == st["adjoint_solves"] == 2 * res.grad_evals
    assert res.unconverged_forward == st["forward_unconverged"]


def test_cli_calibrate_synthetic(tmp_path, capsys, monkeypatch):
    from stan_tpu.io import stdb

    path = str(tmp_path / "beam.STdb")
    stdb.write(meshgen.hex_beam(3, 2, 2), path)
    assert cli.main(["calibrate", path, "--synthetic", "--sampler", "hmc",
                     "--chains", "2", "--warmup", "2", "--samples", "2",
                     "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "POSTERIOR" in text and "0 unconverged" in text
    assert "at cg_tol 1e-06" in text
    # A [sharding] device mesh places the chains: with --device cpu, over
    # two CPU slots (tests/test_aux.py:250-270); 2 leapfrog steps.
    monkeypatch.setattr(hmc, "run_hmc", functools.partial(hmc.run_hmc,
                                                          n_leapfrog=2))
    cfg = tmp_path / "run.toml"
    cfg.write_text("[sharding]\nchains = 2\n")
    assert cli.main(["calibrate", path, "--synthetic", "--sampler", "hmc",
                     "--chains", "2", "--warmup", "2", "--samples", "2",
                     "--config", str(cfg), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "mesh chains=2 x domain=1 on 2 cpu device(s)" in text
    assert "POSTERIOR" in text
