"""Port parity: the chains x domain calibration (forward.
ShardedStencilForwardProblem, calibrate.make_sharded_problem, obs_grids)
against stan_tpu, in float64 on the CPU, on meshes of ["cpu"] * n.

The log posterior and its gradient are held to JAX's unsharded
CalibrationProblem on its general forward (make_problem(prefer_stencil=
False)): the same posterior, at cg_tol 1e-12. JAX's sharded problem on a
2 x 2 mesh costs about 90 s to compile here and its stencil forward runs
Pallas in interpret mode (about a minute), against 5 s for its general
forward.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.fem import stencil as jstencil
from stan_tpu.infer import calibrate as jcalibrate
from stan_tpu.infer import forward as jforward
from stan_tpu_torch import convert
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.infer import calibrate, forward, hmc
from stan_tpu_torch.parallel import distributed

F64 = torch.float64
THETAS = np.array([[np.log(210000.0), 0.0, 0.0],
                   [np.log(190000.0), 0.5, 0.05],
                   [np.log(150000.0), -0.4, -0.1],
                   [np.log(250000.0), 1.0, 0.1]])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n_chains, n_domain):
    return distributed.device_mesh(n_chains, n_domain,
                                   devices=["cpu"] * (n_chains * n_domain))


@functools.lru_cache(maxsize=None)
def _observations(n=(7, 3, 3)):
    """24 strongly deflected nodes x 3 directions of the port's float64
    stencil solve at θ_true, with noise of 1e-5 (tests/test_sharded_infer.py
    's setting)."""
    m = meshgen.hex_beam(*n)
    fwd = forward.build_forward(m, dtype=F64, device="cpu", cg_tol=1e-12)
    u = forward.displacement_fn(fwd, m.nelem)(torch.tensor(
        [np.log(190000.0), 0.28, 0.0], dtype=F64)).numpy()
    total = np.linalg.norm(u, axis=1)
    nodes = np.nonzero(total > 0.3 * total.max())[0][:24]
    obs_nodes, obs_dirs = np.repeat(nodes, 3), np.tile([0, 1, 2], len(nodes))
    rng = np.random.default_rng(0)
    y = u[obs_nodes, obs_dirs] + 1e-5 * rng.normal(size=len(obs_nodes))
    return obs_nodes, obs_dirs, y, 1e-5


@functools.lru_cache(maxsize=None)
def _jax_logp_grad(infer_load):
    obs_nodes, obs_dirs, y, sigma = _observations()
    prob = jcalibrate.make_problem(jmeshgen.hex_beam(7, 3, 3), obs_nodes,
                                   obs_dirs, y, sigma, cg_tol=1e-12,
                                   infer_load=infer_load,
                                   prefer_stencil=False)
    v, g = jax.jit(jax.vmap(jax.value_and_grad(prob.log_posterior)))(
        jnp.asarray(THETAS))
    return np.asarray(v), np.asarray(g)


@pytest.mark.parametrize("infer_load", [False, True], ids=["E-nu", "load"])
def test_sharded_logp_grad_matches_reference(infer_load):
    """The 2 x 2 (chains x domain) log posterior and gradient at 4 θ, the
    domain sums of the slabs' cotangents included, against JAX's to 1e-8
    relative."""
    v_ref, g_ref = _jax_logp_grad(infer_load)
    obs_nodes, obs_dirs, y, sigma = _observations()
    prob = calibrate.make_sharded_problem(
        meshgen.hex_beam(7, 3, 3), _mesh(2, 2), obs_nodes, obs_dirs, y,
        sigma, dtype=F64, cg_tol=1e-12, infer_load=infer_load)
    v, g = prob.logp_grad_b()(torch.as_tensor(THETAS))
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=1e-8)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(g_ref).max())
    st = prob.fwd.stats
    assert st.forward_solves == st.adjoint_solves == 4
    assert st.forward_unconverged == st.adjoint_unconverged == 0


@functools.lru_cache(maxsize=None)
def _jax_sharded_forward():
    """JAX's sharded stencil forward of hex_beam(7, 3, 3) on a 2 x 2 mesh:
    its fields are whole grids, the same for any mesh."""
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                 axis_names=("chains", "domain"))
    return jforward.build_sharded_stencil_forward(
        jmeshgen.hex_beam(7, 3, 3), jmesh, cg_tol=1e-12)


@pytest.mark.parametrize("chains,domain", [(1, 4), (2, 2), (4, 1)])
def test_solve_batched_matches_single_device_forward(chains, domain):
    """The sharded solves, from the port's build and from JAX's sharded
    problem's fields (convert), against the single-device stencil
    forward."""
    m = meshgen.hex_beam(7, 3, 3)
    mesh = _mesh(chains, domain)
    jf = _jax_sharded_forward()
    probs = [
        calibrate.make_sharded_problem(m, mesh, [0], [0], [0.0], 1.0,
                                       dtype=F64, cg_tol=1e-12),
        calibrate.ShardedCalibrationProblem(
            fwd=convert.sharded_stencil_forward_from_numpy(
                *(np.asarray(getattr(jf, k)) for k in
                  ("free_mask", "d_lam", "d_mu", "f0")),
                jstencil._thaw_tables(jf.ft_lam),
                jstencil._thaw_tables(jf.ft_mu), jf.node_shape, jf.cg_tol,
                jf.cg_maxiter, mesh),
            w_grid=None, y_grid=None, sigma_obs=1.0)]
    single = forward.build_forward(m, dtype=F64, device="cpu", cg_tol=1e-12)
    theta = torch.as_tensor(THETAS)
    for prob in probs:
        u = prob.fwd.solve_batched(theta, prob.theta_to_material)
        lam, mu, s = prob.theta_to_material(theta)
        with torch.no_grad():
            ref = single.solve(lam, mu, single.f0 * s.view(4, 1, 1, 1, 1))
        assert u.shape == (4, 3) + single.node_shape
        torch.testing.assert_close(u, ref, rtol=1e-8,
                                   atol=1e-10 * float(ref.abs().max()))
        assert prob.fwd.cg_maxiter == single.cg_maxiter


def test_obs_grids_match_reference_and_refuse_duplicates():
    rng = np.random.default_rng(4)
    node_shape = (8, 4, 4)
    nodes = rng.choice(128, size=20, replace=False)
    dirs = rng.integers(0, 3, size=20)
    y = rng.standard_normal(20)
    w, yg = calibrate.obs_grids(node_shape, nodes, dirs, y)
    jw, jyg = jcalibrate.obs_grids(node_shape, nodes, dirs, y)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(yg, jyg)
    assert w.sum() == 20
    dup_nodes, dup_dirs = np.r_[nodes, nodes[:1]], np.r_[dirs, dirs[:1]]
    for fn in (calibrate.obs_grids, jcalibrate.obs_grids):
        with pytest.raises(ValueError, match="duplicate"):
            fn(node_shape, dup_nodes, dup_dirs, np.r_[y, 0.0])


def test_sharded_problem_refusals():
    m = meshgen.hex_beam(6, 3, 3)  # NNX = 7
    with pytest.raises(ValueError, match="does not qualify"):
        calibrate.make_sharded_problem(m, _mesh(1, 2), [0], [0], [0.0], 1.0,
                                       dtype=F64)
    prob = calibrate.make_sharded_problem(
        meshgen.hex_beam(7, 3, 3), _mesh(2, 2), [0], [0], [0.0], 1.0,
        dtype=F64)
    with pytest.raises(ValueError, match="divide"):
        prob.logp_grad_b()(torch.as_tensor(THETAS[:3]))


def test_sharded_hmc_tracks_single_device():
    """HMC on the 2 x 2 mesh through run_chains with the sharded
    logp_grad_b, and run_hmc on the single-device posterior, from the same
    seed and θ0: the draws agree to the solves' rounding."""
    n = (3, 2, 2)
    obs_nodes, obs_dirs, y, sigma = _observations(n)
    m = meshgen.hex_beam(*n)
    probs = calibrate.make_sharded_problem(m, _mesh(2, 2), obs_nodes,
                                           obs_dirs, y, sigma, dtype=F64,
                                           cg_tol=1e-10)
    prob1 = calibrate.make_problem(m, obs_nodes, obs_dirs, y, sigma,
                                   dtype=F64, device="cpu", cg_tol=1e-10)
    theta0 = torch.as_tensor(THETAS[:2])
    kw = dict(n_samples=3, n_warmup=1, init_step=0.02, target_accept=0.8)
    res_s = hmc.run_chains(probs.logp_grad_b(), hmc.hmc_kernel(2), theta0,
                           5, solve_stats=probs.fwd.stats, **kw)
    res_1 = hmc.run_hmc(prob1.log_posterior, theta0, 5, n_leapfrog=2,
                        solve_stats=prob1.fwd.stats, **kw)
    assert res_s.samples.shape == res_1.samples.shape == (2, 3, 3)
    np.testing.assert_allclose(res_s.samples, res_1.samples, rtol=1e-6,
                               atol=1e-8)
    assert res_s.grad_evals == res_1.grad_evals
    assert res_s.solve_stats["forward_solves"] == 2 * res_s.grad_evals
