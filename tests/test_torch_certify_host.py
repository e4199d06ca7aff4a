"""The certified float32 solve reads its float64 residual on the host.

solve_linear_statics certifies a float32 CG solve as stan_tpu does: the
true residual comes from the operator's float64 host twin
(fem/hostops.masked_f64_apply), with x and the residual in float64 on the
host and only the float32 corrections on the device. So a fault in the
stencil sweep that its float32 and float64 instantiations share cannot
certify itself: here the plain sweep, which a CPU tensor takes in both
dtypes, is broken, and the certificate must still be the truth about K.
Then each certified path (stencil, structured, general, the banded direct
solve and the sharded stencil solve's single-device twin) against
stan_tpu's on the same model, and pcg_refined with its float64 side on
the host.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stan_tpu.analysis import linear as jlinear
from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.core.model import Material as JMaterial
from stan_tpu.fem import hostops as jhostops
from stan_tpu.fem import stencil as jstencil
from stan_tpu_torch.analysis import linear
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.core.model import Material
from stan_tpu_torch.fem import hostops, stencil
from stan_tpu_torch.solvers import cg

F32, F64 = torch.float32, torch.float64


def _host_rel(m, u):
    """||b - K u|| / ||b|| by the reference's numpy general operator."""
    A = jhostops.general_apply_np(m.coords, m.conn, m.elem_d_matrices(),
                                  m.formulation(), m.fix_mask())
    b = (1.0 - m.fix_mask()) * m.load_vector()
    return float(np.linalg.norm(b - A(u)) / np.linalg.norm(b))


# -- a fault that both instantiations of the sweep share --------------------

FAULTS = {
    "output scaled by 1 + 1e-4":
        lambda sweep: lambda up, table, lo, hi: (
            sweep(up, table, lo, hi) * (1.0 + 1e-4)),
    "high-x face correction dropped":
        lambda sweep: lambda up, table, lo, hi: sweep(up, table, lo, 0),
}


@pytest.mark.parametrize("fault", FAULTS)
def test_shared_sweep_fault_is_not_certified(fault, monkeypatch):
    monkeypatch.setattr(stencil, "stencil_sweep_reference",
                        FAULTS[fault](stencil.stencil_sweep_reference))
    m = meshgen.hex_beam(5, 4, 4)
    res = linear.solve_linear_statics(m, device="cpu")
    assert res.operator == "stencil" and res.u_certified is not None
    # The base solve answered the faulty operator: the certificate had to
    # refine it against K.
    assert res.refine_cycles >= 1
    rel = _host_rel(m, res.u_certified)
    assert res.true_residual == pytest.approx(rel, rel=1e-6)
    assert res.converged == (rel <= m.analysis.lin_solver_tolerance)


# -- each certified path against the reference ------------------------------

@pytest.fixture
def reference_plain_sweeps(monkeypatch):
    """The reference's stencil sweeps through its plain jnp forms: its
    Pallas kernel runs in interpret mode on the CPU, ~40 s a solve. The
    whole-grid apply takes _stencil_apply_jnp; the sharded slab sweep
    (fused_sweep with face flags) takes slab_theta_apply with unit λ and
    zero μ, the same tables in both. The jit caches are cleared on both
    sides so no other test sees the patch."""
    jax.clear_caches()
    monkeypatch.setattr(
        jstencil.StencilOperator, "apply_raw",
        lambda self, u: jstencil._stencil_apply_jnp(self.tables, self.deltas,
                                                    u))

    def plain_slab(tables, up, is_low, is_high, BX=8):
        corr = jstencil.slab_correction_tables(tables)
        return jstencil.slab_theta_apply(tables, tables, corr, corr, 1.0,
                                         0.0, up[:, :, 1:-1, 1:-1], is_low,
                                         is_high)

    monkeypatch.setattr(jstencil, "fused_sweep", plain_slab)
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _two_material(M, Mat):
    m = M.hex_beam(5, 4, 4)
    m.materials[2] = Mat(id=2, name="soft", E=70000.0, poisson=0.33)
    m.elem_mat = m.elem_mat.copy()
    m.elem_mat[::2] = 2
    return m


def _perturbed(M, Mat):
    m = M.hex_beam(4, 3, 3)
    c = m.coords
    interior = ~np.logical_or.reduce([
        np.isclose(c[:, k], c[:, k].min()) | np.isclose(c[:, k], c[:, k].max())
        for k in range(3)])
    m.coords = c.copy()
    m.coords[interior] += np.random.default_rng(0).normal(
        0.0, 0.05, (interior.sum(), 3))
    return m


# name -> (model over (meshgen, Material), solve options, operator)
PATHS = {
    "stencil": (lambda M, Mat: M.hex_beam(5, 4, 4), {}, "stencil"),
    "structured": (_two_material, {}, "structured"),
    "general": (_perturbed, {}, "general"),
    "sharded-stencil twin": (lambda M, Mat: M.hex_beam(7, 3, 3),
                             {"n_domain": 2}, "sharded-stencilx2"),
}

# At the default 1e-6 the one correction solve stops at 3e-2 of a residual
# that is float32 rounding noise, and its count spreads 2x between two
# roundings of the same solve (8 against 18 iterations on the general
# path); at 1e-8 it has real work to do. The certified residuals of two
# float32 solves are two readings below tol, not one number: each side's
# is held to an independent host reading of its own answer.
PARITY_TOL = 1e-8
ITERS_RTOL = 0.3


@pytest.mark.parametrize("name", PATHS)
def test_certified_path_matches_reference(name, reference_plain_sweeps):
    make, kw, kind = PATHS[name]
    jm, m = make(jmeshgen, JMaterial), make(meshgen, Material)
    for model in (jm, m):
        model.analysis.lin_solver_tolerance = PARITY_TOL
    ref = jlinear.solve_linear_statics(jm, dtype=jnp.float32, store=False,
                                       **kw)
    res = linear.solve_linear_statics(m, device="cpu", store=False, **kw)
    assert res.operator == ref.operator == kind
    assert res.converged and ref.converged
    assert res.true_residual <= PARITY_TOL and ref.true_residual <= PARITY_TOL
    assert res.true_residual == pytest.approx(_host_rel(jm, res.u_certified),
                                              rel=1e-3)
    assert res.refine_cycles == ref.refine_cycles
    assert abs(res.refine_iters - ref.refine_iters) <= (
        ITERS_RTOL * ref.refine_iters)
    scale = np.abs(ref.u).max()
    np.testing.assert_allclose(res.u, ref.u, rtol=0, atol=1e-6 * scale)


def test_banded_residual_matches_reference(monkeypatch):
    """The banded direct solve's float64 residual, read by the general host
    twin on both sides (the limit lowered as in test_torch_direct.py)."""
    monkeypatch.setattr(linear, "_DENSE_DIRECT_MAX_DOF", 120)
    monkeypatch.setattr(jlinear, "_DENSE_DIRECT_MAX_DOF", 120)
    jm, m = jmeshgen.hex_beam(4, 2, 2), meshgen.hex_beam(4, 2, 2)
    for model in (jm, m):
        model.analysis.lin_solver = "Cholesky"
    ref = jlinear.solve_linear_statics(jm, dtype=jnp.float32, store=False)
    res = linear.solve_linear_statics(m, device="cpu", store=False)
    assert res.operator == ref.operator == "banded-cholesky"
    assert res.true_residual == pytest.approx(ref.true_residual, rel=1e-3,
                                              abs=1e-14)
    scale = np.abs(ref.u).max()
    np.testing.assert_allclose(res.u, ref.u, rtol=0, atol=1e-6 * scale)


def test_dense_residual_is_read_on_the_host():
    m = meshgen.hex_beam(3, 2, 2)
    m.analysis.lin_solver = "LU"
    res = linear.solve_linear_statics(m, device="cpu", store=False)
    assert res.operator == "dense-lu"
    assert res.true_residual == pytest.approx(
        _host_rel(m, res.u.astype(np.float64)), rel=1e-9)


# -- pcg_refined with its float64 side on the host --------------------------

def test_pcg_refined_with_a_host_twin():
    """tests/test_torch_cg.py's refinement with A_hi the numpy host twin
    (float64 arrays in and out): the same cycles, inner iterations and x
    as with the float64 StencilOperator, x float64 on b_hi's device."""
    m = meshgen.hex_beam(5, 4, 4)
    lo = stencil.build_stencil_operator(m, dtype=F32, device="cpu")
    hi = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    b64 = hi.free_mask * hi.to_grid(torch.as_tensor(m.load_vector()))
    base = cg.pcg(lo.apply, b64.to(F32), diag=lo.diagonal(), tol=1e-6)
    twin = hostops.masked_f64_apply(m, lo)
    calls = []

    def inner_solve(r, t):
        calls.append((r.dtype, r.device))
        return cg.pcg(lo.apply, r, diag=lo.diagonal(), tol=t)

    want = cg.pcg_refined(lo.apply, b64, hi.apply, diag=lo.diagonal(),
                          tol=1e-6, x0=base.u, lo_dtype=F32)
    got = cg.pcg_refined(None, b64, lambda x: torch.from_numpy(
        twin(x.numpy())), tol=1e-6, x0=base.u, lo_dtype=F32,
        inner_solve=inner_solve)
    assert got.converged and got.rel_residual <= 1e-6
    assert (got.cycles, got.inner_iters) == (want.cycles, want.inner_iters)
    assert calls == [(F32, b64.device)] * got.cycles
    assert got.u.dtype == F64 and got.u.device == b64.device
    np.testing.assert_allclose(got.u.numpy(), want.u.numpy(), rtol=0,
                               atol=1e-9 * float(want.u.abs().max()))
    assert got.rel_residual == pytest.approx(want.rel_residual, rel=1e-4)
    assert got.sweep_seconds > 0.0 and got.inner_seconds > 0.0
