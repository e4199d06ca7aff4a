"""Port parity: the general (ForwardProblem) and per-element-field
(StructuredFieldForwardProblem) forward models of stan_tpu_torch against
stan_tpu.infer.forward, in float64 on the CPU.

build_forward routes each model to the counterpart of the reference's
class; u(θ) and the θ-gradient of Σu² match the reference's
displacement_fn to 1e-7 relative (problems built by the port and carried
across from the reference's arrays with convert.py); the field gradient
with respect to λ_e, μ_e matches central differences (rel 2e-4, as
tests/test_field_forward.py:62-90); a chain batch equals single solves;
the field solve equals the general operator's; and the calibration's log
posterior and its gradient agree across the three forwards and with the
reference's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.core.model import Material as JMaterial
from stan_tpu.infer import calibrate as jcalibrate
from stan_tpu.infer import forward as jforward
from stan_tpu_torch import convert
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.core.model import Material
from stan_tpu_torch.infer import calibrate, forward

F64 = torch.float64
THETA = np.array([np.log(190000.0), 0.28, 0.05])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_material(M, Mat, nx=3, ny=2, nz=2):
    """hex_beam with the x-upper half a second, softer material
    (tests/test_field_forward.py:27-34)."""
    m = M.hex_beam(nx, ny, nz, E=190000.0, poisson=0.3)
    m.materials[2] = Mat(id=2, name="soft", E=95000.0, poisson=0.3)
    elem_mat = np.asarray(m.elem_mat).reshape(nx, ny, nz).copy()
    elem_mat[nx // 2:] = 2
    m.elem_mat = elem_mat.reshape(-1)
    return m


def _graded(M, Mat):
    """hex_beam(3, 2, 2) with graded x-spacing: not a uniform grid."""
    m = M.hex_beam(3, 2, 2)
    x = m.coords[:, 0]
    m.coords = m.coords.copy()
    m.coords[:, 0] = x ** 1.5 / np.sqrt(x.max())
    return m


# name -> (model factory over (meshgen, Material), build_forward kwargs,
#          the class both packages must build)
CASES = {
    "homogeneous": (lambda M, Mat: M.hex_beam(3, 2, 2), {},
                    "StencilForwardProblem"),
    "two-material": (_two_material, {}, "StructuredFieldForwardProblem"),
    "hex_beam(4,1,3)": (lambda M, Mat: M.hex_beam(4, 1, 3), {},
                        "StructuredFieldForwardProblem"),
    "graded": (_graded, {}, "ForwardProblem"),
    "prefer_stencil=False": (lambda M, Mat: M.hex_beam(3, 2, 2),
                             {"prefer_stencil": False}, "ForwardProblem"),
}


def _models(name):
    make, kw, kind = CASES[name]
    return make(jmeshgen, JMaterial), make(meshgen, Material), kw, kind


@pytest.mark.parametrize("name", CASES)
def test_routing_matches_reference(name):
    m_ref, m, kw, kind = _models(name)
    assert type(jforward.build_forward(m_ref, **kw)).__name__ == kind
    fwd = forward.build_forward(m, dtype=F64, device="cpu", **kw)
    assert type(fwd).__name__ == kind


@functools.lru_cache(maxsize=None)
def _jax_reference(name):
    """The reference's forward problem for a case, u(THETA) and the
    gradient of Σu² at THETA (one compile)."""
    m_ref, _, kw, _ = _models(name)
    jf = jforward.build_forward(m_ref, **kw)

    def loss(th):
        u = jforward.displacement_fn(jf, m_ref.nelem)(th)
        return jnp.sum(u ** 2), u

    g, u = jax.jit(jax.grad(loss, has_aux=True))(jnp.asarray(THETA))
    return jf, np.asarray(u), np.asarray(g)


def _converted(jf):
    if isinstance(jf, jforward.ForwardProblem):
        op = jf.op0
        return convert.forward_problem_from_numpy(
            convert.stiffness_operator_from_numpy(
                np.asarray(op.conn), np.asarray(op.dN),
                np.asarray(op.detJw), np.asarray(op.D),
                np.asarray(op.free_mask), op.nnode, op.form,
                np.asarray(op.inc_idx), device="cpu"),
            np.asarray(jf.f0), jf.cg_tol, jf.cg_maxiter)
    op = jf.op0
    return convert.field_forward_from_numpy(
        convert.structured_operator_from_numpy(
            op.nelems, np.asarray(op.ke_lam), np.asarray(op.ke_mu),
            np.asarray(op.lam_e), np.asarray(op.mu_e),
            np.asarray(op.free_mask), op.form, device="cpu"),
        np.asarray(jf.f0), jf.cg_tol, jf.cg_maxiter)


@pytest.mark.parametrize("how", ["build_forward", "convert"])
@pytest.mark.parametrize("name", ["two-material", "graded"])
def test_displacement_and_gradient_match_reference(name, how):
    jf, u_ref, g_ref = _jax_reference(name)
    _, m, kw, _ = _models(name)
    fwd = (forward.build_forward(m, dtype=F64, device="cpu", **kw)
           if how == "build_forward" else _converted(jf))
    assert type(fwd).__name__ == type(jf).__name__
    assert (fwd.cg_tol, fwd.cg_maxiter) == (jf.cg_tol, jf.cg_maxiter)
    th = torch.tensor(THETA, requires_grad=True)
    u = forward.displacement_fn(fwd, m.nelem)(th)
    torch.sum(u ** 2).backward()
    np.testing.assert_allclose(u.detach().numpy(), u_ref, rtol=1e-7,
                               atol=1e-9 * np.abs(u_ref).max())
    np.testing.assert_allclose(th.grad.numpy(), g_ref, rtol=1e-7)
    st = fwd.stats
    assert st.forward_solves == st.adjoint_solves == 1
    assert st.forward_unconverged == st.adjoint_unconverged == 0


def test_field_solve_matches_general_operator():
    """The field forward at the model's own fields and the general forward
    at the model's own D_e solve the same system."""
    m = _two_material(meshgen, Material, 4, 3, 3)
    ffwd = forward.build_forward(m, dtype=F64, device="cpu")
    gfwd = forward.build_forward(m, dtype=F64, device="cpu",
                                 prefer_stencil=False)
    u_f = ffwd.to_flat(ffwd.solve(ffwd.op0.lam_e, ffwd.op0.mu_e))
    u_g = gfwd.solve(torch.as_tensor(m.elem_d_matrices()))
    np.testing.assert_allclose(u_f.numpy(), u_g.numpy(), rtol=1e-7,
                               atol=1e-9 * float(u_g.abs().max()))


def test_field_gradient_finite_difference():
    """d(Σu²)/d(λ_e, μ_e) through the adjoint solve against central
    differences along random per-element directions."""
    m = _two_material(meshgen, Material)
    fwd = forward.build_forward(m, dtype=F64, device="cpu")
    lam0, mu0 = fwd.op0.lam_e.clone(), fwd.op0.mu_e.clone()

    def loss(lam_e, mu_e):
        return torch.sum(fwd.solve(lam_e, mu_e) ** 2) * 1e6

    lam, mu = lam0.clone().requires_grad_(), mu0.clone().requires_grad_()
    loss(lam, mu).backward()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for g, first in ((lam.grad, True), (mu.grad, False)):
            v = torch.as_tensor(rng.normal(size=tuple(lam0.shape)))
            h = 1e-4 * float((lam0 if first else mu0).abs().max())
            if first:
                fd = (loss(lam0 + h * v, mu0) - loss(lam0 - h * v, mu0))
            else:
                fd = (loss(lam0, mu0 + h * v) - loss(lam0, mu0 - h * v))
            assert float((g * v).sum()) == pytest.approx(float(fd) / (2 * h),
                                                         rel=2e-4)


@pytest.mark.parametrize("name", ["two-material", "graded"])
def test_chain_batch_matches_single_solves(name):
    _, m, kw, _ = _models(name)
    fwd = forward.build_forward(m, dtype=F64, device="cpu", **kw)
    thetas = THETA + np.array([[0.0, 0.0, 0.0], [0.3, -0.05, 0.1],
                               [-0.2, 0.1, -0.3]])
    u_fn = forward.displacement_fn(fwd, m.nelem)
    batch = u_fn(torch.as_tensor(thetas))
    assert batch.shape == (3, m.nnode, 3)
    # The batched contractions may sum in another order than a single
    # system's, and CG carries that through its iterations.
    for c in range(3):
        one = u_fn(torch.as_tensor(thetas[c]))
        np.testing.assert_allclose(batch[c].numpy(), one.numpy(), rtol=0,
                                   atol=1e-10 * float(one.abs().max()))
    assert fwd.stats.forward_solves == 6


def _observations(m):
    fwd = forward.build_forward(m, dtype=F64, device="cpu")
    u = forward.displacement_fn(fwd, m.nelem)(
        torch.tensor([np.log(190000.0), 0.28, 0.0])).numpy()
    nodes = np.argsort(np.abs(u).max(axis=1))[-6:]
    obs_nodes, obs_dirs = np.repeat(nodes, 3), np.tile([0, 1, 2], 6)
    y = u[obs_nodes, obs_dirs] + 1e-4 * np.random.default_rng(0).normal(
        size=len(obs_nodes))
    return obs_nodes, obs_dirs, y


def test_log_posterior_across_forwards_and_reference():
    """On a homogeneous beam the stencil, field and general forwards give
    one log posterior and gradient (rtol 1e-9); the general one also
    equals the reference's make_problem(prefer_stencil=False)."""
    m = meshgen.hex_beam(3, 2, 2)
    obs_nodes, obs_dirs, y = _observations(m)
    kw = dict(dtype=F64, device="cpu", mu_logE=np.log(210000.0))
    probs = {
        "stencil": calibrate.make_problem(m, obs_nodes, obs_dirs, y, 1e-4,
                                          **kw),
        "general": calibrate.make_problem(m, obs_nodes, obs_dirs, y, 1e-4,
                                          prefer_stencil=False, **kw),
    }
    probs["field"] = calibrate.CalibrationProblem(
        fwd=forward.build_structured_field_forward(m, dtype=F64,
                                                   device="cpu"),
        obs_idx=probs["stencil"].obs_idx, y=probs["stencil"].y,
        sigma_obs=1e-4, mu_logE=np.log(210000.0))
    assert isinstance(probs["general"].fwd, forward.ForwardProblem)
    thetas = np.array([[np.log(200000.0), 0.1, 0.0],
                       [np.log(185000.0), -0.2, 0.0]])
    out = {}
    for name, prob in probs.items():
        th = torch.tensor(thetas, requires_grad=True)
        v = prob.log_posterior(th)
        v.sum().backward()
        out[name] = (v.detach().numpy(), th.grad.numpy())
    for name in ("field", "general"):
        for got, want in zip(out[name], out["stencil"]):
            np.testing.assert_allclose(got, want, rtol=1e-9,
                                       atol=1e-9 * np.abs(want).max())
    jprob = jcalibrate.make_problem(
        jmeshgen.hex_beam(3, 2, 2), obs_nodes, obs_dirs, y, 1e-4,
        mu_logE=np.log(210000.0), prefer_stencil=False)
    vg = jax.jit(jax.vmap(jax.value_and_grad(jprob.log_posterior)))
    v_ref, g_ref = (np.asarray(a) for a in vg(jnp.asarray(thetas)))
    np.testing.assert_allclose(out["general"][0], v_ref, rtol=1e-9)
    np.testing.assert_allclose(out["general"][1], g_ref, rtol=1e-7,
                               atol=1e-9 * np.abs(g_ref).max())


def _load_problem(name):
    """The homogeneous beam's calibration with infer_load on the stencil,
    field or general forward (CG to 1e-12)."""
    m = meshgen.hex_beam(3, 2, 2)
    obs_nodes, obs_dirs, y = _observations(m)
    kw = dict(dtype=F64, device="cpu", cg_tol=1e-12)
    fwd = (forward.build_structured_field_forward(m, **kw) if name == "field"
           else forward.build_forward(m, prefer_stencil=name == "stencil",
                                      **kw))
    return calibrate.CalibrationProblem(
        fwd=fwd, obs_idx=np.stack([obs_nodes, obs_dirs], axis=1),
        y=torch.as_tensor(y), sigma_obs=1e-4, mu_logE=np.log(210000.0),
        infer_load=True)


LOAD_THETAS = np.array([[np.log(200000.0), 0.1, 0.15],
                        [np.log(185000.0), -0.2, -0.1]])


def _posterior_grad(prob):
    th = torch.tensor(LOAD_THETAS, requires_grad=True)
    prob.log_posterior(th).sum().backward()
    return th.grad.numpy()


@pytest.mark.parametrize("name", ["stencil", "field", "general"])
def test_load_gradient_through_the_implicit_solve(name):
    """With infer_load, the log posterior's gradient in log s (the load's
    cotangent through the implicit solve) equals central differences and
    is the same for the three forwards (rtol 1e-9)."""
    prob = _load_problem(name)
    assert type(prob.fwd).__name__ == {
        "stencil": "StencilForwardProblem",
        "field": "StructuredFieldForwardProblem",
        "general": "ForwardProblem"}[name]
    g = _posterior_grad(prob)[:, 2]
    h = 1e-5
    for c in range(len(LOAD_THETAS)):
        up, down = LOAD_THETAS.copy(), LOAD_THETAS.copy()
        up[c, 2] += h
        down[c, 2] -= h
        with torch.no_grad():
            fd = (prob.log_posterior(torch.as_tensor(up))[c]
                  - prob.log_posterior(torch.as_tensor(down))[c]) / (2 * h)
        assert g[c] == pytest.approx(float(fd), rel=1e-6)
    want = _posterior_grad(_load_problem("stencil"))[:, 2]
    np.testing.assert_allclose(g, want, rtol=1e-9)
