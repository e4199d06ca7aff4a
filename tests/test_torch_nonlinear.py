"""Port parity: Total-Lagrangian nonlinear statics of stan_tpu_torch against
stan_tpu, in float64 on the CPU.

The element kernels (tangent action, also through the element tangent
matrices, internal force, recovery, strains and PK2 stress) against the
reference's to 1e-12 at a finite state; the
tangent against central differences of the internal force (the check of
tests/test_nonlinear.py:48-68); solve_nonlinear_statics against the
reference on hex_beam(2, 2, 2, load=(0, 0, -50)) over 3 increments at
newton_tol=1e-10 (u and stress per increment to 1e-8 of their largest
magnitude, the same Newton iterations); the analytic St. Venant-Kirchhoff
bar of tests/test_nonlinear.py:87-113; and checkpoint resume, from the
port's own checkpoint and from one the reference wrote.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from stan_tpu.analysis import nonlinear as jnonlinear
from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.fem import nonlinear_kernels as jnlk
from stan_tpu.fem import operator as joperator
from stan_tpu.utils import checkpoint as jckpt
from stan_tpu_torch.analysis import linear, nonlinear
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.fem import kernels
from stan_tpu_torch.fem import nonlinear_kernels as nlk
from stan_tpu_torch.fem.operator import build_operator
from stan_tpu_torch.utils import checkpoint as ckpt
from stan_tpu_torch.utils.timing import PhaseTimer

F64 = torch.float64
NINC = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _beam(M):
    m = M.hex_beam(2, 2, 2, load=(0.0, 0.0, -50.0))
    m.analysis.type = "Nonlinear_Statics"
    m.analysis.inc_numb = NINC
    return m


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's solve of the 2x2x2 beam, with its checkpoint."""
    path = str(tmp_path_factory.mktemp("nl") / "ref.npz")
    res = jnonlinear.solve_nonlinear_statics(
        _beam(jmeshgen), store=False, newton_tol=1e-10, checkpoint_path=path)
    return res, path


def _operator(m):
    return build_operator(m.coords, m.conn, m.elem_d_matrices(), m.fix_mask(),
                          m.formulation(), dtype=F64, device="cpu")


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("mesh", ["hex_beam(2,1,1)", "tet4 2x1x1"])
def test_kernels_match_reference(mesh):
    m = meshgen.hex_beam(2, 1, 1)
    if mesh.startswith("tet4"):
        m = chip_smoke.tet_split(m)
    op = _operator(m)
    jop = joperator.build_operator(m.coords, m.conn, m.elem_d_matrices(),
                                   m.fix_mask(), m.formulation())
    rng = np.random.default_rng(2)
    u = 0.05 * rng.normal(size=(m.nnode, 3))
    du = rng.normal(size=(m.nnode, 3))
    mine = (op.dN, op.detJw, op.D, op.gather(torch.as_tensor(u)))
    ref = (jop.dN, jop.detJw, jop.D, jop.gather(jnp.asarray(u)))
    du_e, jdu_e = op.gather(torch.as_tensor(du)), jop.gather(jnp.asarray(du))
    want = jnlk.tangent_apply(*ref, jdu_e)
    _close(nlk.tangent_apply(*mine, du_e), want, 1e-12)
    # the element tangent matrices the Newton loop multiplies by
    K = nlk.element_tangent(op.dN, op.detJw, op.D,
                            *nlk.tangent_state(op.dN, op.D, mine[3]))
    assert K.shape == (m.nelem, du_e[0].numel(), du_e[0].numel())
    _close(torch.bmm(K, du_e.reshape(m.nelem, -1, 1)).reshape(du_e.shape),
           want, 1e-12)
    _close(nlk.internal_force_tl(*mine), jnlk.internal_force_tl(*ref), 1e-12)
    _close(nlk.pk2_stress(*mine), jnlk.pk2_stress(*ref), 1e-12)
    _close(nlk.strain_variation(op.dN, mine[3], du_e),
           jnlk.strain_variation(jop.dN, ref[3], jdu_e), 1e-12)
    H = nlk.displacement_gradient(op.dN, mine[3])
    _close(H, jnlk.displacement_gradient(jop.dN, ref[3]), 1e-12)
    _close(nlk.green_lagrange(H), jnlk.green_lagrange(
        jnlk.displacement_gradient(jop.dN, ref[3])), 1e-12)
    for got, want in zip(nlk.recover_tl(*mine, op.form),
                         jnlk.recover_tl(*ref, jop.form)):
        _close(got, want, 1e-12)


def test_tangent_is_derivative_of_internal_force():
    """K_T(u) du against (R(u + h du) - R(u - h du)) / 2h; at u = 0 the
    tangent is the linear stiffness."""
    op = _operator(meshgen.hex_beam(2, 1, 1))
    rng = np.random.default_rng(2)
    u = torch.as_tensor(0.05 * rng.normal(size=(op.nnode, 3)))
    du = torch.as_tensor(rng.normal(size=(op.nnode, 3)))
    h = 1e-6

    def R(uu):
        return nlk.internal_force_tl(op.dN, op.detJw, op.D, op.gather(uu))

    fd = (R(u + h * du) - R(u - h * du)) / (2 * h)
    tan = nlk.tangent_apply(op.dN, op.detJw, op.D, op.gather(u),
                            op.gather(du))
    np.testing.assert_allclose(tan.numpy(), fd.numpy(), rtol=1e-5, atol=1e-4)
    at_zero = nlk.tangent_apply(op.dN, op.detJw, op.D,
                                op.gather(torch.zeros_like(u)), op.gather(du))
    lin = kernels.internal_force(op.dN, op.detJw, op.D, op.gather(du))
    np.testing.assert_allclose(at_zero.numpy(), lin.numpy(), atol=1e-10)


def test_solve_matches_reference(reference):
    ref, _ = reference
    m = _beam(meshgen)
    timer = PhaseTimer(verbose=False)
    res = nonlinear.solve_nonlinear_statics(m, device="cpu", dtype=F64,
                                            newton_tol=1e-10, timer=timer)
    assert res.converged and ref.converged
    np.testing.assert_array_equal(res.newton_iters, ref.newton_iters)
    assert (res.residuals <= 1e-10).all()
    assert res.disp.shape == ref.disp.shape == (NINC + 1, m.nnode, 3)
    for inc in range(1, NINC + 1):
        _close(res.disp[inc], ref.disp[inc], 1e-8)
        _close(res.stress[inc], ref.stress[inc], 1e-8)
        _close(res.strain[inc], ref.strain[inc], 1e-8)
    np.testing.assert_array_equal(m.disp, res.disp)
    assert m.analysis.result_step_no == NINC
    incs = [r for r in timer.records if r["phase"].startswith("Increment")]
    assert [r["newton_iters"] for r in incs] == list(ref.newton_iters)
    assert all(len(r["cg_iters"]) == r["newton_iters"] > 0 for r in incs)
    # Monotone load ramp: monotone tip deflection.
    tips = [np.abs(res.disp[i, :, 2]).max() for i in range(NINC + 1)]
    assert tips[0] == 0.0 and tips[1] < tips[2] < tips[3]


def test_tiny_load_matches_linear():
    m = meshgen.hex_beam(3, 2, 2, load=(0.0, 0.0, -1e-3))
    lin = linear.solve_linear_statics(m, device="cpu", dtype=F64,
                                      store=False)
    m.analysis.inc_numb = 1
    nl = nonlinear.solve_nonlinear_statics(m, device="cpu", dtype=F64,
                                           store=False, newton_tol=1e-8)
    assert nl.converged
    np.testing.assert_allclose(nl.u, lin.u, atol=1e-6 * np.abs(lin.u).max())


def test_uniaxial_stvk_analytic():
    """ν = 0 bar under a nominal load P: the stretch λ solves E λ (λ² - 1)/2
    = P (A = 1), and S11 = E (λ² - 1)/2 everywhere."""
    E_mod, force = 1000.0, 80.0
    m = meshgen.uniaxial_bar(2, E=E_mod, force=force)
    m.analysis.inc_numb = 4
    res = nonlinear.solve_nonlinear_statics(m, device="cpu", dtype=F64,
                                            newton_tol=1e-10)
    assert res.converged
    lam = np.roots([E_mod / 2, 0.0, -E_mod / 2, -force])
    lam = float(np.real([r for r in lam if np.isreal(r) and r > 0][0]))
    tip = res.u[:, 0].max()
    assert tip == pytest.approx((lam - 1.0) * 2.0, rel=1e-4)
    np.testing.assert_allclose(res.stress[-1][:, :, 0],
                               E_mod * (lam ** 2 - 1) / 2, rtol=1e-4)
    assert abs(tip - force * 2.0 / E_mod) > 0.01 * force * 2.0 / E_mod


def _truncate(path, save, load, done):
    """Rewrite a finished run's checkpoint as if only `done` increments had
    run."""
    state = load(path)
    assert int(state["next_inc"]) == NINC + 1
    state["next_inc"] = done + 1
    state["u"] = state["disp"][done]
    for key in ("disp", "strains", "stresses"):
        state[key] = state[key][:done + 1]
    for key in ("iters", "res"):
        state[key] = state[key][:done]
    save(path, state)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_resume(reference, tmp_path, writer):
    """A run resumed after 2 of 3 increments, from the port's checkpoint or
    from the reference's, gives the uninterrupted run's history."""
    ref, ref_path = reference
    if writer == "port":
        path = str(tmp_path / "nl.npz")
        full = nonlinear.solve_nonlinear_statics(
            _beam(meshgen), device="cpu", dtype=F64, newton_tol=1e-10,
            store=False, checkpoint_path=path)
        _truncate(path, ckpt.save, ckpt.load, 2)
    else:
        full = ref
        path = str(tmp_path / "ref.npz")
        jckpt.save(path, jckpt.load(ref_path))
        _truncate(path, jckpt.save, jckpt.load, 2)
    timer = PhaseTimer(verbose=False)
    res = nonlinear.solve_nonlinear_statics(
        _beam(meshgen), device="cpu", dtype=F64, newton_tol=1e-10,
        store=False, checkpoint_path=path, timer=timer)
    assert [r["phase"] for r in timer.records] == ["Operator setup",
                                                   "Increment 3"]
    assert res.converged
    np.testing.assert_array_equal(res.newton_iters, full.newton_iters)
    assert res.disp.shape == full.disp.shape
    _close(res.disp, full.disp, 1e-8)
    _close(res.stress, full.stress, 1e-8)
