"""Port parity: Jacobi PCG and float64 refinement of stan_tpu_torch against
stan_tpu.solvers.cg, in float64 on the CPU (iterations +-1, u to 1e-8)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stan_tpu.core import meshgen
from stan_tpu.fem import structured as jstructured
from stan_tpu.solvers import cg as jcg
from stan_tpu_torch import convert
from stan_tpu_torch.fem import stencil
from stan_tpu_torch.solvers import cg

F64 = torch.float64


def _operators(n=(4, 3, 3)):
    """The JAX structured operator and the port's twin built from its
    arrays, plus the masked load right-hand side of the beam."""
    m = meshgen.hex_beam(*n)
    jop = jstructured.build_structured_operator(m)
    op = convert.structured_operator_from_numpy(
        jop.nelems, np.asarray(jop.ke_lam), np.asarray(jop.ke_mu),
        np.asarray(jop.lam_e), np.asarray(jop.mu_e),
        np.asarray(jop.free_mask), jop.form, device="cpu")
    b = np.asarray(jop.free_mask) * np.asarray(
        jop.to_grid(jnp.asarray(m.load_vector())))
    return m, jop, op, b


@pytest.mark.parametrize("tol", [1e-6, 1e-10])
def test_pcg_matches_reference(tol):
    _, jop, op, b = _operators()
    ref = jax.jit(lambda b: jcg.pcg(jop.apply, b, diag=jop.diagonal(),
                                    tol=tol))(jnp.asarray(b))
    res = cg.pcg(op.apply, torch.as_tensor(b), diag=op.diagonal(), tol=tol)
    assert res.converged and bool(ref.converged)
    assert not res.diverged
    assert abs(res.iters - int(ref.iters)) <= 1
    want = np.asarray(ref.u)
    np.testing.assert_allclose(res.u.numpy(), want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())
    assert res.residual <= tol * np.linalg.norm(b)


def test_maxiter_zero_means_ndof():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((6, 6))
    A = M @ M.T + 6 * np.eye(6)
    b = rng.standard_normal(6)
    At = torch.as_tensor(A)
    # tol 0 never converges, so the cap decides the count.
    res = cg.pcg(lambda x: At @ x, torch.as_tensor(b), tol=0.0, maxiter=0,
                 ndof=4)
    ref = jcg.pcg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), tol=0.0,
                  maxiter=0, ndof=4)
    assert res.iters == int(ref.iters) == 4
    assert cg.pcg(lambda x: At @ x, torch.as_tensor(b), tol=0.0,
                  maxiter=0).iters == 6  # ndof defaults to b.numel()
    short = cg.pcg(lambda x: At @ x, torch.as_tensor(b), tol=1e-12, maxiter=2)
    assert short.iters == 2 and not short.converged and not short.diverged
    full = cg.pcg(lambda x: At @ x, torch.as_tensor(b), tol=1e-12,
                  diag=torch.as_tensor(np.diag(A).copy()))
    assert full.converged
    np.testing.assert_allclose(full.u.numpy(), np.linalg.solve(A, b),
                               rtol=1e-9)
    zero = cg.pcg(lambda x: At @ x, torch.zeros(6, dtype=F64))
    assert zero.converged and zero.iters == 0


def test_divergence_guard_on_indefinite_operator():
    d = np.array([1.0, -1.0, 1.0, -1.0])
    b = np.ones(4)
    res = cg.pcg(lambda x: torch.as_tensor(d) * x, torch.as_tensor(b))
    ref = jcg.pcg(lambda x: jnp.asarray(d) * x, jnp.asarray(b))
    assert res.diverged and bool(ref.diverged)
    assert not res.converged and not bool(ref.converged)
    assert res.iters == int(ref.iters)


def test_pcg_refined_reaches_f64_target():
    """float32 inner solves under the float64 true residual, on the CPU."""
    m = meshgen.hex_beam(5, 4, 4)
    lo = stencil.build_stencil_operator(m, dtype=torch.float32, device="cpu")
    hi = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    b64 = hi.free_mask * hi.to_grid(torch.as_tensor(m.load_vector()))
    base = cg.pcg(lo.apply, b64.to(torch.float32), diag=lo.diagonal(),
                  tol=1e-6)
    assert base.converged
    rr = cg.pcg_refined(lo.apply, b64, hi.apply, diag=lo.diagonal(), tol=1e-6,
                        x0=base.u, lo_dtype=torch.float32)
    assert rr.converged and rr.rel_residual <= 1e-6
    assert rr.u.dtype == F64
    true = float(torch.linalg.vector_norm(b64 - hi.apply(rr.u))
                 / torch.linalg.vector_norm(b64))
    assert true == pytest.approx(rr.rel_residual, rel=1e-9)
    # From a cold start the refinement needs at least one correction solve.
    cold = cg.pcg_refined(lo.apply, b64, hi.apply, diag=lo.diagonal(),
                          tol=1e-6, lo_dtype=torch.float32)
    assert cold.converged and cold.cycles >= 1 and cold.inner_iters > 0
    zero = cg.pcg_refined(lo.apply, torch.zeros_like(b64), hi.apply)
    assert zero.converged and zero.cycles == 0
