"""Port parity: the calibration forward model and log posterior of
stan_tpu_torch against stan_tpu.infer, in float64 on the CPU.

The displacements and the gradient of Σu² are held against JAX's
StencilForwardProblem (rtol 1e-7 and 1e-6, the tolerances of
tests/test_infer.py:239-260), once for a problem carried across with
convert.stencil_forward_from_numpy and once for the port's own
build_forward. The gradient of log_posterior is held against central
finite differences (rel 2e-3, abs 1e-3, as tests/test_infer.py:227-236).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stan_tpu.core import meshgen
from stan_tpu.core.model import Material
from stan_tpu.fem import stencil as jstencil
from stan_tpu.infer import forward as jforward
from stan_tpu_torch import convert
from stan_tpu_torch.infer import calibrate, forward

F64 = torch.float64
THETA = np.array([np.log(190000.0), 0.28, 0.05])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: intra-op threads only add contention with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """JAX's stencil forward on hex_beam(4,3,3): the problem, u(θ) and the
    gradient of Σu² at THETA."""
    m = meshgen.hex_beam(4, 3, 3)
    sf = jforward.build_forward(m)
    assert isinstance(sf, jforward.StencilForwardProblem)

    def loss(th):  # one compile for u and the gradient
        u = jforward.displacement_fn(sf, m.nelem)(th)
        return jnp.sum(u ** 2), u

    g, u = jax.jit(jax.grad(loss, has_aux=True))(jnp.asarray(THETA))
    return m, sf, np.asarray(u), np.asarray(g)


def _port_forward(how):
    m, sf, _, _ = _jax_reference()
    if how == "convert":
        return convert.stencil_forward_from_numpy(
            np.asarray(sf.free_mask), np.asarray(sf.d_lam),
            np.asarray(sf.d_mu), np.asarray(sf.f0),
            jstencil._thaw_tables(sf.ft_lam), jstencil._thaw_tables(sf.ft_mu),
            sf.node_shape, sf.cg_tol, sf.cg_maxiter, device="cpu")
    return forward.build_forward(m, dtype=F64, device="cpu")


@pytest.mark.parametrize("how", ["convert", "build_forward"])
def test_displacement_and_gradient_match_jax(how):
    m, sf, u_ref, g_ref = _jax_reference()
    fwd = _port_forward(how)
    assert fwd.cg_tol == sf.cg_tol and fwd.cg_maxiter == sf.cg_maxiter
    th = torch.tensor(THETA, requires_grad=True)
    u = forward.displacement_fn(fwd, m.nelem)(th)
    torch.sum(u ** 2).backward()
    np.testing.assert_allclose(u.detach().numpy(), u_ref, rtol=1e-7,
                               atol=1e-9 * np.abs(u_ref).max())
    np.testing.assert_allclose(th.grad.numpy(), g_ref, rtol=1e-6)
    st = fwd.stats
    assert st.forward_solves == st.adjoint_solves == 1
    assert st.forward_unconverged == st.adjoint_unconverged == 0


def test_chain_batch_matches_single_solves():
    """θ [3, 3] in one chain-batched solve gives each θ's own solve."""
    m, _, _, _ = _jax_reference()
    fwd = forward.build_forward(m, dtype=F64, device="cpu")
    thetas = THETA + np.array([[0.0, 0.0, 0.0], [0.3, -0.05, 0.1],
                               [-0.2, 0.1, -0.3]])
    u_fn = forward.displacement_fn(fwd, m.nelem)
    batch = u_fn(torch.as_tensor(thetas))
    assert batch.shape == (3, m.nnode, 3)
    for c in range(3):
        one = u_fn(torch.as_tensor(thetas[c]))
        np.testing.assert_allclose(batch[c].numpy(), one.numpy(), rtol=0,
                                   atol=1e-12 * float(one.abs().max()))


def _small_problem(sigma_obs=1e-5, infer_load=False, dtype=F64):
    """The port's twin of tests/test_infer.py's _small_problem."""
    m = meshgen.hex_beam(3, 2, 2)
    fwd = forward.build_forward(m, dtype=dtype, device="cpu")
    u_true = forward.displacement_fn(fwd, m.nelem)(
        torch.tensor([np.log(190000.0), 0.28, 0.0])).numpy()
    total = np.linalg.norm(u_true, axis=1)
    nodes = np.nonzero(total > 0.3 * total.max())[0]
    obs_nodes = np.repeat(nodes, 3)
    obs_dirs = np.tile([0, 1, 2], len(nodes))
    rng = np.random.default_rng(0)
    y = u_true[obs_nodes, obs_dirs] + sigma_obs * rng.normal(
        size=len(obs_nodes))
    return m, calibrate.make_problem(
        m, obs_nodes, obs_dirs, y, sigma_obs, dtype=dtype, device="cpu",
        mu_logE=np.log(210000.0), infer_load=infer_load)


def test_log_posterior_gradient_finite_difference():
    _, prob = _small_problem(infer_load=True)
    theta = torch.tensor([[np.log(200000.0), 0.0, 0.02]], requires_grad=True)
    prob.log_posterior(theta).sum().backward()
    g = theta.grad[0].numpy()
    h = 1e-4
    with torch.no_grad():
        for i in range(3):
            e = torch.zeros(1, 3, dtype=F64)
            e[0, i] = h
            fd = float(prob.log_posterior(theta + e)
                       - prob.log_posterior(theta - e)) / (2 * h)
            assert g[i] == pytest.approx(fd, rel=2e-3, abs=1e-3)


def test_log_posterior_matches_jax():
    """Value and gradient against stan_tpu's CalibrationProblem built on the
    same observations, for a batch of θ."""
    from stan_tpu.infer import calibrate as jcalibrate

    m, prob = _small_problem(sigma_obs=1e-4)
    jprob = jcalibrate.make_problem(
        m, prob.obs_idx[:, 0], prob.obs_idx[:, 1], prob.y.numpy(), 1e-4,
        mu_logE=np.log(210000.0))
    thetas = np.array([[np.log(200000.0), 0.1, 0.0],
                       [np.log(185000.0), -0.2, 0.0]])
    vg = jax.jit(jax.vmap(jax.value_and_grad(jprob.log_posterior)))
    v_ref, g_ref = (np.asarray(a) for a in vg(jnp.asarray(thetas)))
    th = torch.tensor(thetas, requires_grad=True)
    v = prob.log_posterior(th)
    v.sum().backward()
    np.testing.assert_allclose(v.detach().numpy(), v_ref, rtol=1e-9)
    np.testing.assert_allclose(th.grad.numpy(), g_ref, rtol=1e-6,
                               atol=1e-9 * np.abs(g_ref).max())
    cons = calibrate.CalibrationProblem.constrain(thetas)
    np.testing.assert_array_equal(
        cons, jcalibrate.CalibrationProblem.constrain(thetas))


def test_capped_solves_are_counted():
    """A solve that stops at the iteration cap is counted as unconverged
    (the reference drops the flag), and still scored."""
    m = meshgen.hex_beam(4, 3, 3)
    fwd = forward.build_forward(m, dtype=F64, device="cpu", cg_maxiter=3)
    th = torch.tensor(np.stack([THETA, THETA + 0.1]), requires_grad=True)
    u = forward.displacement_fn(fwd, m.nelem)(th)
    torch.sum(u ** 2).backward()
    st = fwd.stats.as_dict()
    assert st["forward_solves"] == st["adjoint_solves"] == 2
    assert st["forward_unconverged"] == st["adjoint_unconverged"] == 2
    assert st["forward_iters"] == st["forward_loop_iters"] * 2 == 6
    assert torch.isfinite(th.grad).all()
    assert forward._default_infer_maxiter(m.nnode) == min(3 * m.nnode, 4000)
    lam, mu = forward.lame_from_E_nu(190000.0, 0.28)
    assert (lam, mu) == jforward.lame_from_E_nu(190000.0, 0.28)


def test_build_forward_refusals():
    """The missing-material refusal stays; a heterogeneous material and a
    grid too thin for the stencil, refused until the field forward was
    ported, now build it, as in the reference."""
    hetero = meshgen.hex_beam(3, 2, 2)
    hetero.materials[2] = Material(id=2, name="soft", E=1000.0, poisson=0.4)
    hetero.elem_mat = hetero.elem_mat.copy()
    hetero.elem_mat[0] = 2
    thin = meshgen.hex_beam(4, 1, 3)
    for model in (hetero, thin):
        assert isinstance(jforward.build_forward(model),
                          jforward.StructuredFieldForwardProblem)
        assert isinstance(forward.build_forward(model, dtype=F64,
                                                device="cpu"),
                          forward.StructuredFieldForwardProblem)
    # An element whose material id is missing: the reference ignores it
    # and takes the stencil path; the port refuses.
    missing = meshgen.hex_beam(3, 2, 2)
    missing.elem_mat = missing.elem_mat.copy()
    missing.elem_mat[0] = 9
    assert isinstance(jforward.build_forward(missing),
                      jforward.StencilForwardProblem)
    with pytest.raises(ValueError, match=r"\[9\]"):
        forward.build_forward(missing, dtype=F64, device="cpu")


def test_sweeps_on_the_forward_path_meet_the_kernel_contract(monkeypatch):
    """Every sweep the forward and adjoint solves hand to the kernel
    wrappers passes the card's input checks (shape, dtype, contiguity),
    which the CPU path itself does not run."""
    from stan_tpu_torch.fem import stencil

    seen = []

    def checked(wrapper, batched):
        def call(up, tables2, coef, is_low, is_high):
            up_b, coef_b = (up, coef) if batched else (up[None], coef[None])
            stencil._check_theta("checked", up_b, tables2, coef_b)
            seen.append(batched)
            return wrapper(up, tables2, coef, is_low, is_high)
        return call

    monkeypatch.setattr(stencil, "theta_sweep",
                        checked(stencil.theta_sweep, False))
    monkeypatch.setattr(stencil, "theta_sweep_batched",
                        checked(stencil.theta_sweep_batched, True))
    m = meshgen.hex_beam(4, 3, 3)
    fwd = forward.build_forward(m, dtype=torch.float32, device="cpu",
                                cg_tol=1e-5)
    th = torch.tensor(np.stack([THETA, THETA + 0.1]), requires_grad=True)
    torch.sum(forward.displacement_fn(fwd, m.nelem)(th) ** 2).backward()
    forward.displacement_fn(fwd, m.nelem)(torch.tensor(THETA))
    assert True in seen and False in seen
