"""Port parity: the NUTS, ADVI and SMC samplers of stan_tpu_torch against
stan_tpu.infer.nuts / vi / smc, in float64 on the CPU.

JAX's threefry keys and torch's generators draw different streams, so the
samplers are compared in three ways: where no random draw decides the
answer (the NUTS subtree, the population std, the resampling index); on
fixed draws, with both sides' random functions replaced by one table (a
NUTS transition, 20 ADVI steps, a whole SMC run), to 1e-10 or closer; and
by statistics (moments of a Gaussian target, the closed-form mean-field
ADVI optimum) within Monte-Carlo error, with the reference's tolerances
where tests/test_infer.py states them.
"""

import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stan_tpu.infer import hmc as jhmc
from stan_tpu.infer import nuts as jnuts
from stan_tpu.infer import smc as jsmc
from stan_tpu.infer import vi as jvi
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.infer import calibrate, forward, hmc, nuts, smc, vi
from stan_tpu_torch.utils import checkpoint as ckpt

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
    d = theta - torch.as_tensor(_MEAN, dtype=theta.dtype)
    return -0.5 * torch.einsum("ci,ij,cj->c", d,
                               torch.as_tensor(_COV_INV, dtype=theta.dtype),
                               d)


def _check_moments(samples, mean_tol, cov_tol):
    flat = samples.reshape(-1, samples.shape[-1])
    np.testing.assert_allclose(flat.mean(axis=0), _MEAN, atol=mean_tol)
    np.testing.assert_allclose(np.cov(flat.T), _COV, atol=cov_tol)


# ---------------------------------------------------------------------------
# NUTS
# ---------------------------------------------------------------------------

def _trailing_ones(n):
    t = 0
    while n & 1:
        t += 1
        n >>= 1
    return t


def _bruteforce_stop(theta, p, step, max_depth):
    """tests/test_infer.py:77-133: an explicit numpy walk of the leapfrog
    trajectory of logp = -|θ|²/2 (inv_mass = 1) that checks every aligned
    span [n+1-2^k, n] directly; returns (leaves built, turning)."""
    leaves_p = []
    th, pp = theta.copy(), p.copy()
    n_max = 2 ** max_depth
    for _ in range(n_max):
        pp = pp + 0.5 * step * (-th)
        th = th + step * pp
        pp = pp + 0.5 * step * (-th)
        leaves_p.append(pp.copy())
    for n in range(n_max):
        for k in range(1, _trailing_ones(n) + 1):
            s = n + 1 - 2 ** k
            span = np.sum(leaves_p[s:n + 1], axis=0)
            if (span @ leaves_p[s] <= 0) or (span @ leaves_p[n] <= 0):
                return n + 1, True
    return n_max, False


def test_subtree_matches_reference_and_bruteforce():
    """The 8 trials of tests/test_infer.py:77-133 as ONE batch of 8 chains:
    each chain stops at the leaf where the reference's _build_subtree and
    the brute-force walk stop, with the same turning flag, although the
    batch keeps stepping until its last chain stops (the lockstep masks).
    Its edge leaf, log weight, momentum sum and sum of Metropolis ratios,
    which no draw decides, equal the reference's to 1e-12."""
    max_depth = 6
    rng = np.random.default_rng(3)
    theta = np.empty((8, 2))
    p = np.empty((8, 2))
    step = np.empty(8)
    for t in range(8):
        theta[t], p[t] = rng.normal(size=2), rng.normal(size=2)
        step[t] = float(rng.uniform(0.3, 1.2))
    brute = [_bruteforce_stop(theta[t], p[t], step[t], max_depth)
             for t in range(8)]

    def jlogp_grad(th):
        return -0.5 * jnp.sum(th ** 2), -th

    def jsub(th, pp, st, key):
        z0 = jnuts._Z(th, pp, *jlogp_grad(th))
        energy0 = -0.5 * (th @ th) - 0.5 * (pp @ pp)
        sub = jnuts._build_subtree(jlogp_grad, key, z0, jnp.int32(max_depth),
                                   st, jnp.ones(2), jnp.asarray(1.0),
                                   energy0, max_depth)
        return sub

    ref = jax.jit(jax.vmap(jsub))(
        jnp.asarray(theta), jnp.asarray(p), jnp.asarray(step),
        jax.random.split(jax.random.PRNGKey(0), 8))
    ref_n, ref_turn = ref.n_leaves, ref.turning

    n_calls = 0

    def target(th):
        nonlocal n_calls
        n_calls += 1
        return -0.5 * torch.sum(th ** 2, dim=1), -th

    th = torch.as_tensor(theta)
    pp = torch.as_tensor(p)
    z0 = nuts._Z(th, pp, *target(th))
    energy0 = -0.5 * torch.sum(th ** 2, 1) - 0.5 * torch.sum(pp ** 2, 1)
    gen = torch.Generator().manual_seed(0)
    active = torch.ones(8, dtype=torch.bool)
    sub = nuts._build_subtree(target, gen, z0, max_depth,
                              torch.as_tensor(step),
                              torch.ones((8, 2), dtype=F64),
                              torch.ones(8, dtype=F64), energy0, max_depth,
                              active)
    got_n = sub.n_leaves.numpy().astype(int).tolist()
    got_turn = sub.turning.numpy().tolist()
    assert got_n == [b[0] for b in brute] == np.asarray(ref_n).astype(
        int).tolist()
    assert got_turn == [b[1] for b in brute] == np.asarray(ref_turn).tolist()
    assert not sub.diverging.any()
    for name in ("theta", "p", "logp", "grad"):
        np.testing.assert_allclose(getattr(sub.z_end, name).numpy(),
                                   np.asarray(getattr(ref.z_end, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    for name in ("log_weight", "sum_p", "sum_accept"):
        np.testing.assert_allclose(getattr(sub, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    # One batched call per leaf of the longest chain.
    assert n_calls == 1 + max(got_n)
    # An inactive chain builds nothing and keeps its edge.
    active[2] = False
    sub2 = nuts._build_subtree(target, torch.Generator().manual_seed(0), z0,
                               max_depth, torch.as_tensor(step),
                               torch.ones((8, 2), dtype=F64),
                               torch.ones(8, dtype=F64), energy0, max_depth,
                               active)
    assert sub2.n_leaves[2] == 0 and not sub2.turning[2]
    assert torch.equal(sub2.z_end.theta[2], th[2])
    assert sub2.n_leaves.numpy().astype(int).tolist()[3:] == got_n[3:]


def test_trailing_ones_and_popcount_match_reference():
    for n in range(1 << 10):
        assert nuts._trailing_ones(n) == int(jnuts._trailing_ones(
            jnp.int32(n)))
        assert (n >> 1).bit_count() == int(jnuts._popcount16(
            jnp.int32(n) >> 1))


class _CountedKeys:
    """Stand-ins for jax.random inside stan_tpu.infer.nuts.nuts_transition:
    a key is (level, tag, chain) and split(k, n) gives (level + 1, i,
    chain) for i < n, so each draw can read the depth and leaf it belongs
    to and return the entry of a fixed table that the port's draw of the
    same depth and leaf returns (_TableDraws)."""

    def __init__(self, tables):
        self.t = {k: jnp.asarray(v) for k, v in tables.items()}

    def split(self, key, num=2):
        return jnp.stack([jnp.full(num, key[0] + 1, key.dtype),
                          jnp.arange(num, dtype=key.dtype),
                          jnp.full(num, key[2], key.dtype)], axis=1)

    def normal(self, key, shape=(), dtype=jnp.float64):
        return self.t["p0"][key[2]].astype(dtype)

    def bernoulli(self, key, p=0.5, shape=None):
        # nuts_transition's split(key, 4) at depth d gives level 2 + d.
        return self.t["forward"][key[2], key[0] - 2]

    def uniform(self, key, shape=(), dtype=jnp.float64, minval=0.0,
                maxval=1.0):
        # The combine key has tag 3 at level 2 + d; the take key of leaf n
        # of depth d has tag 1 at level 3 + d + n.
        return jnp.where(key[1] == 3,
                         self.t["combine"][key[2], key[0] - 2],
                         self.t["take"][key[2], key[0] - 3]).astype(dtype)


class _TableDraws:
    """torch.randn / torch.rand for the port's nuts_transition from the same
    tables, in its documented order: the momenta, then per depth the
    direction, the take-uniform of each leaf and the combine-uniform."""

    def __init__(self, tables):
        self.t = {k: torch.as_tensor(v) for k, v in tables.items()}
        self.depth, self.leaf, self.want_direction = -1, 0, True

    def randn(self, *args, **kw):
        return self.t["p0"].clone()

    def rand(self, *args, **kw):
        if sys._getframe(1).f_code.co_name == "_build_subtree":
            self.leaf += 1
            return self.t["take"][:, self.depth + self.leaf - 1]
        if self.want_direction:
            self.depth, self.leaf, self.want_direction = self.depth + 1, 0, \
                False
            return torch.where(self.t["forward"][:, self.depth], 0.25, 0.75
                               ).to(F64)
        self.want_direction = True
        return self.t["combine"][:, self.depth]


def test_transition_matches_reference_on_fixed_draws(monkeypatch):
    """nuts_transition of 8 chains against the reference's, vmapped, with
    both sides' draws replaced by one table (momenta, directions that mix
    forward and backward, take- and combine-uniforms): the same proposal,
    log density, gradient, accept statistic and gradient count per chain,
    to 1e-12. This holds the combine step to the reference's: rejecting a
    subtree that turned or diverged, the combined U-turn, the accept
    statistic over proposed leaves. Step sizes from 0.1 to 2.6 give
    trajectories that stop at every depth, and one that diverges."""
    C, D, max_depth = 8, 3, 6
    rng = np.random.default_rng(12)
    a = rng.normal(size=(D, D))
    prec = a @ a.T / D + np.eye(D)
    theta = rng.normal(size=(C, D))
    step = np.array([0.1, 0.2, 0.35, 0.5, 0.7, 0.9, 1.2, 2.6])
    inv_mass = rng.uniform(0.5, 1.5, (C, D))
    tables = {"p0": rng.normal(size=(C, D)),
              "forward": rng.uniform(size=(C, max_depth)) < 0.5,
              "take": rng.uniform(size=(C, max_depth + 2 ** max_depth)),
              "combine": rng.uniform(size=(C, max_depth))}

    def jlogp_grad(th):
        g = -jnp.asarray(prec) @ th
        return 0.5 * th @ g, g

    def jtrans(key, th, st, im):
        state = jhmc.HMCState(th, *jlogp_grad(th))
        return jnuts.nuts_transition(jlogp_grad, key, state, st, im,
                                     max_depth)

    fake = _CountedKeys(tables)
    with monkeypatch.context() as m:
        for name in ("split", "normal", "bernoulli", "uniform"):
            m.setattr(jax.random, name, getattr(fake, name))
        keys = jnp.stack([jnp.zeros(C, jnp.int32), jnp.zeros(C, jnp.int32),
                          jnp.arange(C, dtype=jnp.int32)], axis=1)
        ref_state, ref_acc, ref_n = jax.jit(jax.vmap(jtrans))(
            keys, jnp.asarray(theta), jnp.asarray(step),
            jnp.asarray(inv_mass))

    def target(th):
        g = -th @ torch.as_tensor(prec)
        return 0.5 * torch.sum(th * g, dim=1), g

    draws = _TableDraws(tables)
    th = torch.as_tensor(theta)
    state = hmc.HMCState(th, *target(th))
    with monkeypatch.context() as m:
        m.setattr(torch, "randn", draws.randn)
        m.setattr(torch, "rand", draws.rand)
        new, acc, n_evals = nuts.nuts_transition(
            target, None, state, torch.as_tensor(step),
            torch.as_tensor(inv_mass), max_depth)
    for name in ("theta", "logp", "grad"):
        np.testing.assert_allclose(getattr(new, name).numpy(),
                                   np.asarray(getattr(ref_state, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ref_acc), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(n_evals.numpy(), np.asarray(ref_n))
    # The cases the step sizes are there for: short and long trajectories,
    # and the divergent one, which proposes nothing it can accept.
    assert len(set(n_evals.tolist())) >= 4
    assert float(acc[-1]) < 1e-3 and float(acc[0]) > 0.9


def test_nuts_gaussian_moments():
    """tests/test_infer.py:52-59 with a seeded generator and the same
    tolerances; 16 chains of 200 draws (the reference: 4 of 1200), since a
    lockstep transition costs little more for more chains."""
    res = nuts.run_nuts(_gauss_logp, torch.zeros((16, 2), dtype=F64), 1,
                        n_samples=200, n_warmup=150, max_depth=5)
    assert res.samples.shape == (16, 200, 2)
    assert (res.rhat < 1.05).all()
    _check_moments(res.samples, mean_tol=0.15, cov_tol=0.4)
    eps = res.evals_per_sample
    assert (eps >= 1).all() and (eps <= 2 ** 5 - 1).all()
    assert (res.accept_rate > 0.5).all() and (res.accept_rate <= 1).all()


def test_nuts_dynamic_cost():
    """tests/test_infer.py:62-74: at max_depth 8 the gradient evaluations
    per draw sit far below the worst case of 255."""
    res = nuts.run_nuts(_gauss_logp, torch.zeros((16, 2), dtype=F64), 11,
                        n_samples=120, n_warmup=150, max_depth=8)
    assert float(res.evals_per_sample.mean()) < 100.0
    _check_moments(res.samples, mean_tol=0.3, cov_tol=0.9)
    # The lockstep batch evaluates as long as its slowest chain: at least
    # each chain's own leaves.
    assert res.grad_evals >= res.evals_per_sample.max() * 120


def test_nuts_refuses_bad_depth():
    for d in (0, 15):
        with pytest.raises(ValueError, match="1..14"):
            nuts.run_nuts(_gauss_logp, torch.zeros((2, 2), dtype=F64), 0,
                          max_depth=d)


def test_nuts_checkpoint_resume_reproduces_straight_run(tmp_path):
    """The draw order is fixed per transition, so a resumed run draws what
    a straight run draws; the checkpoint carries the port's own kernel id."""
    theta0 = torch.as_tensor(np.random.default_rng(6).standard_normal((3, 2)))
    kw = dict(n_warmup=30, max_depth=4, init_step=0.1)
    straight = nuts.run_nuts(_gauss_logp, theta0, 8, n_samples=12, **kw)
    path = str(tmp_path / "nuts.ckpt")
    first = nuts.run_nuts(_gauss_logp, theta0, 8, n_samples=6,
                          checkpoint_path=path, checkpoint_every=3, **kw)
    np.testing.assert_array_equal(first.samples, straight.samples[:, :6])
    assert ckpt.load(path)["kernel"] == "torch-nuts:maxdepth4"
    resumed = nuts.run_nuts(_gauss_logp, theta0, 8, n_samples=12,
                            checkpoint_path=path, checkpoint_every=3, **kw)
    assert resumed.warmup_seconds == 0.0
    np.testing.assert_array_equal(resumed.samples, straight.samples)
    np.testing.assert_array_equal(resumed.evals_per_sample,
                                  straight.evals_per_sample)


@functools.lru_cache(maxsize=None)
def _fem_problem():
    """The port's calibration posterior of hex_beam(3,2,2) (σ = 1e-4)."""
    m = meshgen.hex_beam(3, 2, 2)
    fwd = forward.build_forward(m, dtype=F64, device="cpu")
    u = forward.displacement_fn(fwd, m.nelem)(
        torch.tensor([np.log(190000.0), 0.28, 0.0])).numpy()
    total = np.linalg.norm(u, axis=1)
    nodes = np.nonzero(total > 0.3 * total.max())[0]
    obs_nodes, obs_dirs = np.repeat(nodes, 3), np.tile([0, 1, 2], len(nodes))
    y = u[obs_nodes, obs_dirs] + 1e-4 * np.random.default_rng(0).normal(
        size=len(obs_nodes))
    return calibrate.make_problem(m, obs_nodes, obs_dirs, y, 1e-4, dtype=F64,
                                  device="cpu", cg_tol=1e-10)


def test_short_fem_nuts():
    """2 chains of NUTS on the FEM posterior: finite draws, and every
    chain-batched evaluation is one forward and one adjoint solve of both
    chains (the frozen chains included)."""
    prob = _fem_problem()
    theta0 = torch.tensor([[np.log(200000.0), 0.1, 0.0],
                           [np.log(185000.0), -0.1, 0.0]], dtype=F64)
    res = nuts.run_nuts(prob.log_posterior, theta0, 5, n_samples=4,
                        n_warmup=3, max_depth=3, init_step=0.02,
                        solve_stats=prob.fwd.stats)
    assert res.samples.shape == (2, 4, 3) and np.isfinite(res.samples).all()
    st = res.solve_stats
    assert st["forward_solves"] == st["adjoint_solves"] == 2 * res.grad_evals
    assert st["forward_unconverged"] == st["adjoint_unconverged"] == 0
    assert ((res.evals_per_sample >= 1) & (res.evals_per_sample <= 7)).all()


# ---------------------------------------------------------------------------
# ADVI
# ---------------------------------------------------------------------------

def test_advi_gaussian_closed_form():
    """The mean-field optimum for a Gaussian target is μ = mean and
    σ_i = 1/sqrt((Σ⁻¹)_ii) ≈ (0.906, 1.281). The final iterate of 3000
    Adam steps of 8 draws wanders about it: over seeds 0-7, |μ - mean| up
    to 0.12 and σ within 10.3% (standard deviations 0.06 and 0.05), so μ
    is held to the reference's 0.1 (tests/test_infer.py:141) and σ to 15%.
    """
    res = vi.run_advi(_gauss_logp, torch.zeros(2, dtype=F64), 2,
                      n_steps=3000, learning_rate=2e-2)
    sigma_mf = 1.0 / np.sqrt(np.diag(_COV_INV))
    np.testing.assert_allclose(res.mu, _MEAN, atol=0.1)
    np.testing.assert_allclose(res.sigma, sigma_mf, rtol=0.15)
    assert res.elbo_trace.shape == (3000,)
    assert res.elbo_trace[-100:].mean() > res.elbo_trace[:100].mean()
    draws = res.sample(0, 4000)
    assert draws.shape == (4000, 2)
    np.testing.assert_allclose(draws.std(axis=0), res.sigma, rtol=0.05)
    np.testing.assert_array_equal(draws, res.sample(0, 4000))


@pytest.mark.parametrize("guarded", [False, True])
def test_advi_matches_reference_on_fixed_draws(monkeypatch, guarded):
    """20 steps of run_advi against stan_tpu.infer.vi.run_advi with both
    sides' ε [8, 2] per step taken from one table: μ, σ and the ELBO trace
    agree to 1e-10 (the Adam update, the entropy term, the reparameterised
    gradient). Guarded: logp is NaN for θ_0 > 0.15, which some draws of the
    first steps reach, so the -1e30 score and its zero gradient are held to
    the reference's too."""
    n_steps, S = 20, 8
    eps = np.random.default_rng(21).standard_normal((n_steps, S, 2))

    def jlogp(th):
        d = th - jnp.asarray(_MEAN)
        lp = -0.5 * d @ jnp.asarray(_COV_INV) @ d
        return jnp.where(th[0] > 0.15, jnp.nan, lp) if guarded else lp

    def logp(th):
        lp = _gauss_logp(th)
        return torch.where(th[:, 0] > 0.15, torch.nan, lp) if guarded else lp

    with monkeypatch.context() as m:
        m.setattr(jax.random, "split",
                  lambda key, num=2: jnp.arange(num))
        m.setattr(jax.random, "normal",
                  lambda key, shape=(), dtype=jnp.float64:
                  jnp.asarray(eps)[key].astype(dtype))
        ref = jvi.run_advi(jlogp, jnp.zeros(2), jnp.int32(0),
                           n_steps=n_steps, n_elbo_samples=S)
    table = iter(torch.as_tensor(eps))
    with monkeypatch.context() as m:
        m.setattr(torch, "randn", lambda *a, **kw: next(table))
        got = vi.run_advi(logp, torch.zeros(2, dtype=F64), 0,
                          n_steps=n_steps, n_elbo_samples=S)
    for name in ("mu", "sigma", "elbo_trace"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    assert (ref.elbo_trace < -1e28).any() == guarded


def test_advi_scores_non_finite_logp_low():
    """A non-finite log density scores -1e30 (the reference's guard), so
    the ELBO stays finite and the fit goes on."""

    def logp(theta):
        lp = _gauss_logp(theta)
        return torch.where(theta[:, 0] > 3.0, torch.nan, lp)

    res = vi.run_advi(logp, torch.zeros(2, dtype=F64), 0, n_steps=50)
    assert np.isfinite(res.mu).all() and np.isfinite(res.sigma).all()


# ---------------------------------------------------------------------------
# SMC
# ---------------------------------------------------------------------------

def test_smc_gaussian():
    """tests/test_infer.py:149-168 with the same particle count, Metropolis
    steps and tolerances."""

    def log_prior(theta):
        return -0.5 * torch.sum((theta / 5.0) ** 2, dim=1)

    def sample_prior(gen, n):
        return 5.0 * torch.randn((n, 2), generator=gen, dtype=F64)

    res = smc.run_smc(log_prior, _gauss_logp, sample_prior, 3,
                      n_particles=2048, n_mcmc=10, device="cpu")
    assert res.temperatures[-1] == 1.0
    assert (np.diff(res.temperatures) > 0).all()
    np.testing.assert_allclose(res.particles.mean(axis=0), _MEAN, atol=0.25)
    C = np.cov(res.particles.T)
    np.testing.assert_allclose(np.diag(C), np.diag(_COV), rtol=0.4)
    assert np.isfinite(res.log_evidence)
    assert ((res.acceptance > 0) & (res.acceptance <= 1)).all()


def test_smc_matches_reference_on_fixed_draws(monkeypatch):
    """run_smc against stan_tpu.infer.smc.run_smc from the same 256 prior
    particles, with both sides' draws taken from fixed tables (one
    resampling uniform; the Metropolis proposal normals [N, D] and
    acceptance uniforms [N], the same at every step): the same tempering
    schedule, log evidence, acceptance and particles, to 1e-10. This holds
    the host bisection, the evidence increment, the systematic resampling,
    the walk scale and the Metropolis step to the reference's."""
    N, D = 256, 2
    rng = np.random.default_rng(31)
    prior = 5.0 * rng.standard_normal((N, D))
    noise = rng.standard_normal((N, D))
    u_acc = rng.uniform(size=N)
    u_res = 0.37

    def jlog_prior(th):
        return -0.5 * jnp.sum((th / 5.0) ** 2)

    def jlog_like(th):
        d = th - jnp.asarray(_MEAN)
        return -0.5 * d @ jnp.asarray(_COV_INV) @ d

    def jfake_uniform(key, shape=(), dtype=jnp.float64, minval=0.0,
                      maxval=1.0):
        return (jnp.full(shape, u_res) if shape == () else
                jnp.asarray(u_acc)).astype(dtype)

    kw = dict(n_particles=N, n_mcmc=3, max_stages=50)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "uniform", jfake_uniform)
        m.setattr(jax.random, "normal",
                  lambda key, shape=(), dtype=jnp.float64:
                  jnp.asarray(noise).astype(dtype))
        ref = jsmc.run_smc(jlog_prior, jlog_like,
                           lambda key, n: jnp.asarray(prior),
                           jax.random.PRNGKey(0), **kw)

    def fake_rand(size, **k):
        return (torch.tensor(u_res, dtype=F64) if size == () else
                torch.as_tensor(u_acc))

    with monkeypatch.context() as m:
        m.setattr(torch, "rand", fake_rand)
        m.setattr(torch, "randn", lambda *a, **k: torch.as_tensor(noise))
        got = smc.run_smc(
            lambda th: -0.5 * torch.sum((th / 5.0) ** 2, dim=1), _gauss_logp,
            lambda gen, n: torch.as_tensor(prior), 0, device="cpu", **kw)
    assert len(got.temperatures) == len(ref.temperatures) >= 3
    for name in ("temperatures", "acceptance", "particles"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(got.log_evidence, ref.log_evidence,
                               rtol=1e-10)


def test_smc_walk_scale_is_the_population_std():
    """jnp.std (the reference's, smc.py:150) is the population std; torch's
    default would be the unbiased one, 1/sqrt(1 - 1/N) larger."""
    x = np.random.default_rng(4).normal(size=(5, 3)) * [1.0, 2.0, 3.0]
    got = smc._walk_scale(torch.as_tensor(x)).numpy()
    want = np.asarray(0.5 * jnp.std(jnp.asarray(x), axis=0) + 1e-8)
    np.testing.assert_allclose(got, want, rtol=1e-14)
    assert not np.allclose(got, 0.5 * x.std(axis=0, ddof=1) + 1e-8)


def test_smc_resample_index_clamped():
    """cum[-1] rounding below 1 lets a position land past the last weight:
    searchsorted returns n there, which the reference's gather clamps to
    n - 1 (JAX) and torch's indexing would refuse; the port clamps."""
    cum = torch.tensor([0.25, 0.5, 0.75, 1.0 - 1e-6], dtype=F64)
    positions = (0.9999999 + torch.arange(4, dtype=F64)) / 4
    assert int(torch.searchsorted(cum, positions)[-1]) == 4
    idx = smc._resample_index(cum, positions)
    want = jnp.asarray(np.arange(4.0))[
        jnp.searchsorted(jnp.asarray(cum.numpy()),
                         jnp.asarray(positions.numpy()))]
    assert idx.tolist() == [0, 1, 2, 3] == np.asarray(want).astype(
        int).tolist()
    particles = torch.arange(8, dtype=F64).reshape(4, 2)
    assert particles[idx].shape == (4, 2)
    # An exact cumulative sum resamples as the reference does.
    rng = np.random.default_rng(5)
    w = rng.uniform(size=16)
    cum = np.cumsum(w / w.sum())
    pos = (rng.uniform() + np.arange(16)) / 16
    np.testing.assert_array_equal(
        smc._resample_index(torch.as_tensor(cum), torch.as_tensor(pos)),
        np.asarray(jnp.searchsorted(jnp.asarray(cum), jnp.asarray(pos))))


def test_smc_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the refusal is for machines "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smc.run_smc(_gauss_logp, _gauss_logp, None, 0)
