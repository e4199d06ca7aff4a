"""Port parity: chains and particles placed over a device mesh (run_hmc,
run_nuts and run_smc with mesh=, calibrate.make_problem(mesh=)) against
the same runs without a mesh and against stan_tpu, in float64 on the CPU.

Every mesh is device_mesh(c, 1, devices=["cpu"] * c), the port's stand-in
for the reference's virtual CPU devices. The sampler's state and draws stay
on the mesh's first device and only the target is evaluated row by row, so
a placed run draws what the unplaced run draws (tests/test_infer.py:185-200
holds the reference to that at rtol 1e-12). JAX's threefry keys and torch's
generators draw different streams, so the port and JAX are compared by
moments, not draws.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from stan_tpu.infer import calibrate as jcalibrate
from stan_tpu.infer import hmc as jhmc
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.core.model import Material
from stan_tpu_torch.infer import calibrate, forward, hmc, nuts, smc
from stan_tpu_torch.parallel import distributed
from stan_tpu_torch.utils import checkpoint as ckpt

F64 = torch.float64
_COV = np.array([[1.0, 0.6], [0.6, 2.0]])
_COV_INV = np.linalg.inv(_COV)
_MEAN = np.array([1.0, -2.0])
ROWS = [2, 4, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(rows):
    return distributed.device_mesh(rows, 1, devices=["cpu"] * rows)


def _gauss_logp(theta):
    """Chain-batched correlated 2-D Gaussian log density, [C, 2] -> [C]."""
    d = theta - torch.as_tensor(_MEAN)
    return -0.5 * torch.einsum("ci,ij,cj->c", d, torch.as_tensor(_COV_INV), d)


def _theta0(n=8, seed=7):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal((n, 2)))


# ------------------------------------------------ placement changes no draw

_HMC_KW = dict(n_samples=40, n_warmup=40, n_leapfrog=6)


@functools.lru_cache(maxsize=None)
def _unplaced(sampler):
    if sampler == "hmc":
        return hmc.run_hmc(_gauss_logp, _theta0(), 8, **_HMC_KW)
    if sampler == "nuts":
        return nuts.run_nuts(_gauss_logp, _theta0(), 8, n_samples=30,
                             n_warmup=30, max_depth=4)
    return _smc(None)


def _smc(mesh):
    def log_prior(theta):
        return -0.5 * torch.sum((theta / 5.0) ** 2, dim=1)

    def sample_prior(gen, n):
        return 5.0 * torch.randn((n, 2), generator=gen, dtype=F64)

    return smc.run_smc(log_prior, _gauss_logp, sample_prior, 3,
                       n_particles=64, n_mcmc=5,
                       device=None if mesh else "cpu", mesh=mesh)


@pytest.mark.parametrize("rows", ROWS)
def test_hmc_placement_changes_no_draws(rows):
    """tests/test_infer.py:185-200: the placed run reproduces the unplaced
    samples and step sizes (same seed) to rtol 1e-12."""
    ref = _unplaced("hmc")
    res = hmc.run_hmc(_gauss_logp, _theta0(), 8, mesh=_mesh(rows),
                      **_HMC_KW)
    np.testing.assert_allclose(res.samples, ref.samples, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(res.step_size, ref.step_size, rtol=1e-12)
    assert res.grad_evals == ref.grad_evals


@pytest.mark.parametrize("rows", ROWS)
def test_nuts_placement_changes_no_draws(rows):
    """Each lockstep leaf evaluates the target row by row."""
    ref = _unplaced("nuts")
    res = nuts.run_nuts(_gauss_logp, _theta0(), 8, n_samples=30,
                        n_warmup=30, max_depth=4, mesh=_mesh(rows))
    np.testing.assert_allclose(res.samples, ref.samples, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(res.step_size, ref.step_size, rtol=1e-12)
    np.testing.assert_array_equal(res.evals_per_sample, ref.evals_per_sample)


@pytest.mark.parametrize("rows", ROWS)
def test_smc_placement_changes_no_draws(rows):
    """The particles' log prior and likelihood per row; weights, the ESS
    bisection, resampling and the walk scale global on the first device."""
    ref = _unplaced("smc")
    res = _smc(_mesh(rows))
    np.testing.assert_allclose(res.particles, ref.particles, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(res.temperatures, ref.temperatures)
    np.testing.assert_allclose(res.log_evidence, ref.log_evidence,
                               rtol=1e-12)


def test_placed_hmc_moments_match_jax():
    """The placed Gaussian HMC run (8 chains on a 2 x 1 mesh: the draws are
    those of any mesh, above) against JAX's run_hmc on its 8-device chains
    mesh: the means agree within four Monte-Carlo standard errors (from
    each run's ESS), and each run's moments are the target's within
    tests/test_infer.py:41-49's tolerances."""
    kw = dict(n_samples=200, n_warmup=150, n_leapfrog=8)
    res = hmc.run_hmc(_gauss_logp, torch.zeros((8, 2), dtype=F64), 0,
                      mesh=_mesh(2), **kw)

    def jlogp(theta):
        d = theta - jnp.asarray(_MEAN)
        return -0.5 * d @ jnp.asarray(_COV_INV) @ d

    jmesh = Mesh(np.array(jax.devices()[:8]), axis_names=("chains",))
    jres = jhmc.run_hmc(jlogp, jnp.zeros((8, 2)), jax.random.PRNGKey(0),
                        mesh=jmesh, **kw)
    se = []
    for r in (res, jres):
        samples = np.asarray(r.samples)
        assert samples.shape == (8, 200, 2)
        flat = samples.reshape(-1, 2)
        np.testing.assert_allclose(flat.mean(axis=0), _MEAN, atol=0.12)
        np.testing.assert_allclose(np.cov(flat.T), _COV, atol=0.35)
        se.append(np.sqrt(flat.var(axis=0) / np.asarray(r.ess)))
    gap = np.abs(res.samples.reshape(-1, 2).mean(axis=0)
                 - np.asarray(jres.samples).reshape(-1, 2).mean(axis=0))
    assert (gap <= 4.0 * np.hypot(*se)).all(), (gap, se)


def test_resume_on_a_mesh_reproduces_the_straight_run(tmp_path):
    """tests/test_torch_hmc.py's resume test on a 2 x 1 mesh: 10 draws in
    chunks of 4 end in a short chunk, then the run resumes to 22 (the
    reference's hmc.py:460-461 and :399-406 restore the placement in these
    two cases; here the state never leaves the first device)."""
    mesh = _mesh(2)
    kw = dict(n_warmup=30, n_leapfrog=6, init_step=0.1, mesh=mesh)
    theta0 = _theta0(4, 6)
    straight = hmc.run_hmc(_gauss_logp, theta0, 8, n_samples=22, **kw)
    path = str(tmp_path / "hmc.ckpt")
    first = hmc.run_hmc(_gauss_logp, theta0, 8, n_samples=10,
                        checkpoint_path=path, checkpoint_every=4, **kw)
    assert first.chunk_sizes == [4, 4, 2]
    np.testing.assert_array_equal(first.samples, straight.samples[:, :10])
    assert ckpt.load(path)["n_done"] == 10
    resumed = hmc.run_hmc(_gauss_logp, theta0, 8, n_samples=22,
                          checkpoint_path=path, checkpoint_every=4, **kw)
    assert resumed.warmup_seconds == 0.0
    assert resumed.chunk_sizes == [4, 4, 4]
    np.testing.assert_array_equal(resumed.samples, straight.samples)
    np.testing.assert_array_equal(resumed.step_size, straight.step_size)
    np.testing.assert_array_equal(resumed.inv_mass, straight.inv_mass)
    unplaced = hmc.run_hmc(_gauss_logp, theta0, 8, n_samples=22,
                           **{k: v for k, v in kw.items() if k != "mesh"})
    np.testing.assert_allclose(resumed.samples, unplaced.samples,
                               rtol=1e-12, atol=1e-12)


# ------------------------------------------- the calibration posterior


def _two_material(nx=3, ny=2, nz=2):
    """hex_beam with the x-upper half a second, softer material."""
    m = meshgen.hex_beam(nx, ny, nz, E=190000.0, poisson=0.3)
    m.materials[2] = Material(id=2, name="soft", E=95000.0, poisson=0.3)
    elem_mat = np.asarray(m.elem_mat).reshape(nx, ny, nz).copy()
    elem_mat[nx // 2:] = 2
    m.elem_mat = elem_mat.reshape(-1)
    return m


# route -> (model, make_problem kwargs, the forward class it must build)
ROUTES = {
    "stencil": (lambda: meshgen.hex_beam(3, 2, 2), {},
                forward.StencilForwardProblem),
    "field": (_two_material, {}, forward.StructuredFieldForwardProblem),
    "general": (lambda: meshgen.hex_beam(3, 2, 2),
                {"prefer_stencil": False}, forward.ForwardProblem),
}
THETAS = (np.array([np.log(200000.0), 0.1, 0.02])
          + np.random.default_rng(3).normal(0.0, 0.1, (8, 3)))


def _observations(m, sigma=1e-4):
    """Strongly deflected nodes x 3 directions of the port's float64 solve
    at θ_true, with noise of sigma."""
    fwd = forward.build_forward(m, dtype=F64, device="cpu")
    u = forward.displacement_fn(fwd, m.nelem)(torch.tensor(
        [np.log(190000.0), 0.28, 0.0], dtype=F64)).numpy()
    total = np.linalg.norm(u, axis=1)
    nodes = np.nonzero(total > 0.3 * total.max())[0]
    obs_nodes, obs_dirs = np.repeat(nodes, 3), np.tile([0, 1, 2], len(nodes))
    y = u[obs_nodes, obs_dirs] + sigma * np.random.default_rng(0).normal(
        size=len(obs_nodes))
    return obs_nodes, obs_dirs, y, sigma


def _value_grad(prob, thetas, mesh=None):
    lgb = hmc.guarded_logp_grad_b(prob.log_posterior)
    if mesh is not None:
        lgb = mesh.by_rows(lgb)
    v, g = lgb(torch.as_tensor(thetas))
    return v.numpy(), g.numpy()


@pytest.mark.parametrize("route", list(ROUTES))
def test_placed_posterior_matches_unplaced(route):
    """make_problem(mesh=) on a 2 x 1 mesh: the log posterior and gradient
    at 8 θ, each row's 4 chains solved as one batch, within 1e-10 relative
    of make_problem without a mesh; the same per-chain solve counts; the
    SMC split on the mesh sums to the posterior."""
    make, kw, cls = ROUTES[route]
    m = make()
    obs = _observations(m)
    mesh = _mesh(2)
    probs = {name: calibrate.make_problem(
        m, *obs, dtype=F64, cg_tol=1e-12, infer_load=True,
        device=None if name == "placed" else "cpu",
        mesh=mesh if name == "placed" else None, **kw)
        for name in ("placed", "unplaced")}
    assert type(probs["placed"].fwd) is cls
    assert probs["placed"].row_fwds == ()  # one forward: ["cpu"] * 2
    got = {name: _value_grad(p, THETAS, mesh if name == "placed" else None)
           for name, p in probs.items()}
    for a, b in zip(got["placed"], got["unplaced"]):
        np.testing.assert_allclose(a, b, rtol=1e-10,
                                   atol=1e-10 * np.abs(b).max())
    st = {name: p.fwd.stats for name, p in probs.items()}
    for key in ("forward_solves", "adjoint_solves", "forward_iters",
                "adjoint_iters", "forward_unconverged"):
        assert getattr(st["placed"], key) == getattr(st["unplaced"], key)
    assert st["placed"].forward_solves == 8
    # Two rows: two batched loops, each as long as its slowest chain.
    assert (st["placed"].forward_loop_iters
            >= st["unplaced"].forward_loop_iters)
    placed = probs["placed"]
    th = torch.as_tensor(THETAS)
    split = mesh.by_rows(lambda t: placed.log_prior(t)
                         + placed.log_likelihood(t))(th)
    np.testing.assert_allclose(split.numpy(), got["unplaced"][0],
                               rtol=1e-10)


def test_placed_stencil_posterior_matches_jax():
    """The stencil route on the 2 x 1 mesh against stan_tpu.infer.
    calibrate.make_problem's log posterior and jax.grad, at
    tests/test_torch_forward.py's tolerances (unplaced there). JAX's side
    takes its general forward (prefer_stencil=False), the same posterior:
    its stencil route runs Pallas in interpret mode here, about 28 s
    against 4 s, and test_torch_forward.py already holds it to the port's
    unplaced stencil forward."""
    m = meshgen.hex_beam(3, 2, 2)
    obs = _observations(m)
    mesh = _mesh(2)
    prob = calibrate.make_problem(m, *obs, dtype=F64, cg_tol=1e-12,
                                  mesh=mesh, mu_logE=np.log(210000.0))
    assert type(prob.fwd) is forward.StencilForwardProblem
    jprob = jcalibrate.make_problem(m, *obs, cg_tol=1e-12,
                                    mu_logE=np.log(210000.0),
                                    prefer_stencil=False)
    vg = jax.jit(jax.vmap(jax.value_and_grad(jprob.log_posterior)))
    v_ref, g_ref = (np.asarray(a) for a in vg(jnp.asarray(THETAS)))
    v, g = _value_grad(prob, THETAS, mesh)
    np.testing.assert_allclose(v, v_ref, rtol=1e-9)
    np.testing.assert_allclose(g, g_ref, rtol=1e-6,
                               atol=1e-9 * np.abs(g_ref).max())


_FEM_KW = dict(n_samples=3, n_warmup=3, init_step=0.1, target_accept=0.8)


@functools.lru_cache(maxsize=None)
def _fem_hmc(placed):
    """HMC (2 chains, 2 leapfrog steps, _FEM_KW) on hex_beam(3, 2, 2)'s
    posterior, on a 2 x 1 mesh or without one; seed 5."""
    m = meshgen.hex_beam(3, 2, 2)
    mesh = _mesh(2) if placed else None
    prob = calibrate.make_problem(m, *_observations(m), dtype=F64,
                                  cg_tol=1e-10,
                                  device=None if placed else "cpu",
                                  mesh=mesh)
    return hmc.run_hmc(prob.log_posterior, torch.as_tensor(THETAS[:2]), 5,
                       n_leapfrog=2, solve_stats=prob.fwd.stats, mesh=mesh,
                       **_FEM_KW)


def test_short_fem_hmc_on_a_mesh():
    """2 chains on 2 x 1, 3 warmup + 3 samples of 2 leapfrog steps, against
    the unplaced run of the same seed: samples within rtol 1e-8, and the
    run's solve counts as the contract says (SolveStats): per-chain counts
    equal, batched loops summed over the rows."""
    a, b = _fem_hmc(True), _fem_hmc(False)
    np.testing.assert_allclose(a.samples, b.samples, rtol=1e-8)
    assert a.grad_evals == b.grad_evals
    sa, sb = a.solve_stats, b.solve_stats
    for key in ("forward_solves", "adjoint_solves", "forward_iters",
                "adjoint_iters", "forward_unconverged", "adjoint_unconverged"):
        assert sa[key] == sb[key], key
    assert sa["forward_solves"] == 2 * a.grad_evals
    # One chain per row: each row's loop is its own chain's iterations.
    assert sa["forward_loop_iters"] == sa["forward_iters"]
    assert sb["forward_loop_iters"] <= sa["forward_loop_iters"]


def test_a_target_that_places_itself_takes_no_mesh():
    """ShardedCalibrationProblem.logp_grad_b() cuts its chains over the
    rows itself, so it goes to run_chains without mesh=. On the same 2 x 1
    mesh it draws what run_hmc(make_problem(mesh=).log_posterior, mesh=)
    draws, to the solves' rounding."""
    m = meshgen.hex_beam(3, 2, 2)
    probs = calibrate.make_sharded_problem(m, _mesh(2), *_observations(m),
                                           dtype=F64, cg_tol=1e-10)
    res_s = hmc.run_chains(probs.logp_grad_b(), hmc.hmc_kernel(2),
                           torch.as_tensor(THETAS[:2]), 5,
                           solve_stats=probs.fwd.stats, **_FEM_KW)
    res_p = _fem_hmc(True)
    np.testing.assert_allclose(res_s.samples, res_p.samples, rtol=1e-6,
                               atol=1e-8)
    assert res_s.grad_evals == res_p.grad_evals
    assert (res_s.solve_stats["forward_solves"]
            == res_p.solve_stats["forward_solves"] == 2 * res_s.grad_evals)


# ------------------------------------------------------------- refusals


def test_refusals():
    """Chains the rows do not divide (ValueError, the reference CLI's check
    moved to the split); θ0, an SMC device or a problem device that is not
    the mesh's first device; an unknown mesh axis."""
    mesh = _mesh(2)
    with pytest.raises(ValueError, match="not divisible"):
        hmc.run_hmc(_gauss_logp, _theta0(3), 0, n_samples=2, n_warmup=2,
                    mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        nuts.run_nuts(_gauss_logp, _theta0(3), 0, n_samples=2, n_warmup=2,
                      mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        smc.run_smc(_gauss_logp, _gauss_logp,
                    lambda gen, n: torch.zeros((n, 2), dtype=F64), 0,
                    n_particles=5, mesh=mesh)
    with pytest.raises(ValueError, match="first device"):
        hmc.run_hmc(_gauss_logp, _theta0().to("meta"), 0, n_samples=2,
                    n_warmup=2, mesh=mesh)
    with pytest.raises(ValueError, match="first device"):
        smc.run_smc(_gauss_logp, _gauss_logp, None, 0, device="meta",
                    mesh=mesh)
    with pytest.raises(ValueError, match="first device"):
        calibrate.make_problem(meshgen.hex_beam(3, 2, 2), [5], [2], [0.0],
                               1e-4, dtype=F64, device="meta", mesh=mesh)
    with pytest.raises(ValueError, match="no mesh axis"):
        mesh.chain_rows(_theta0(), "replicas")
    prob = calibrate.make_problem(meshgen.hex_beam(3, 2, 2), [5], [2], [0.0],
                                  1e-4, dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="forwards are on"):
        prob.log_posterior(torch.zeros((2, 3), dtype=F64, device="meta"))


def test_chain_rows_is_the_sharded_forward_cut():
    """chain_rows and per_chain cut the chains alike (one definition,
    row_blocks), and join_rows inverts chain_rows."""
    mesh = distributed.device_mesh(4, 2, devices=["cpu"] * 8)
    t = torch.arange(24.0).reshape(8, 3)
    rows = mesh.chain_rows(t)
    assert [b.shape[0] for b in rows] == [2] * 4
    for block, per in zip(rows, mesh.per_chain(t)):
        for p in per:
            assert torch.equal(block, p)
    assert torch.equal(mesh.join_rows(rows), t)
    assert [b.shape[0] for b in mesh.chain_rows(t, "domain")] == [4, 4]
    v, g = mesh.by_rows(lambda x: (x.sum(1), 2 * x))(t)
    assert torch.equal(v, t.sum(1)) and torch.equal(g, 2 * t)
