"""Linear static analysis driver.

Port of stan_tpu/analysis/linear.py for the CG solver on one device. The
operator is chosen fastest first: the assembled stencil (hand-written CUDA
sweep) on a uniform-material structured HEX8 grid, then the structured
slice-gather operator, then the general gather/scatter operator. All three
act on the same masked system. A solve below float64 is certified: the
true float64 residual is computed with the same operator family built in
float64 on the same device, and mixed-precision refinement runs until the
configured tolerance holds. Stress recovery runs on the general operator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stan_tpu_torch.core.model import FEModel
from stan_tpu_torch.fem import kernels
from stan_tpu_torch.fem import stencil as stencil_mod
from stan_tpu_torch.fem import structured as structured_mod
from stan_tpu_torch.fem.operator import (StiffnessOperator, build_operator,
                                         default_dtype, resolve_device)
from stan_tpu_torch.solvers import cg as cg_mod
from stan_tpu_torch.utils.timing import PhaseTimer


@dataclasses.dataclass
class LinearResult:
    u: np.ndarray  # [nnode, 3] displacements
    strain: np.ndarray  # [E, nn, 6] node-extrapolated strain
    stress: np.ndarray  # [E, nn, 6]
    reactions: np.ndarray  # [nnode, 3] internal force
    iters: int
    residual: float
    converged: bool
    operator: str = "general"  # stencil / structured / general
    n_domain: int = 1
    # True float64 relative residual of the certified solution (None when
    # the solve ran in float64 or certification was skipped).
    true_residual: float = None
    refine_cycles: int = 0
    refine_iters: int = 0
    # The float64 solution that true_residual certifies; `u` is the same
    # solution in the solve dtype.
    u_certified: Optional[np.ndarray] = None


def _pcg_flat(op: StiffnessOperator, rhs, tol, maxiter: int):
    return cg_mod.pcg(op.apply, rhs, diag=op.diagonal(), tol=tol,
                      maxiter=maxiter, ndof=3 * op.nnode)


def _solve_cg(op: StiffnessOperator, f, tol, maxiter: int):
    return _pcg_flat(op, op.free_mask * f, tol, maxiter)


def _pcg_grid(sop, rhs, tol, maxiter: int):
    """CG on a grid-layout operator (stencil/structured)."""
    return cg_mod.pcg(sop.apply, rhs, diag=sop.diagonal(), tol=tol,
                      maxiter=maxiter, ndof=rhs.numel())


def _solve_cg_structured(sop, f, tol, maxiter: int):
    rhs = (sop.free_mask * sop.to_grid(f)).contiguous()
    res = _pcg_grid(sop, rhs, tol, maxiter)
    return res._replace(u=sop.to_flat(res.u))


def _recover(op: StiffnessOperator, u):
    u_e = op.gather(u)
    eps, sig = kernels.recover_stress_strain(op.dN, op.detJw, op.D, u_e,
                                             op.form)
    R = op.scatter_add(kernels.internal_force(op.dN, op.detJw, op.D, u_e))
    return eps, sig, R


def _to_grid(node_shape, u_flat: torch.Tensor) -> torch.Tensor:
    """[nnode, 3] -> channel-first [3, nnx, nny, nnz] (meshgen node order)."""
    return u_flat.reshape(*node_shape, 3).permute(3, 0, 1, 2).contiguous()


def _from_grid(u_grid: torch.Tensor) -> torch.Tensor:
    """Channel-first [3, nnx, nny, nnz] -> [nnode, 3]."""
    return u_grid.permute(1, 2, 3, 0).reshape(-1, 3)


def _pick_cg_path(model, dtype, device, use_structured, n_domain):
    """Choose the fastest applicable single-device CG operator: stencil >
    structured > general. Returns (kind, grid operator or None)."""
    if n_domain not in (None, 1):
        raise NotImplementedError(
            "domain-sharded solves (n_domain > 1) are not ported yet: "
            "ROADMAP.md queue 1, item 10 (multi-GPU)")
    if use_structured:
        sop = stencil_mod.build_stencil_operator(model, dtype=dtype,
                                                 device=device)
        if sop is not None:
            return "stencil", sop
        sop = structured_mod.build_structured_operator(model, dtype=dtype,
                                                       device=device)
        if sop is not None:
            return "structured", sop
    return "general", None


def _f64_twin(model, kind, device):
    """The same operator family built in float64 on the same device: the
    true-residual operator of the certification."""
    if kind == "stencil":
        return stencil_mod.build_stencil_operator(
            model, dtype=torch.float64, device=device)
    if kind == "structured":
        return structured_mod.build_structured_operator(
            model, dtype=torch.float64, device=device)
    return build_operator(model.coords, model.conn, model.elem_d_matrices(),
                          model.fix_mask(), model.formulation(),
                          dtype=torch.float64, device=device)


def solve_linear_statics(
    model: FEModel,
    *,
    device="cuda",
    dtype=None,
    timer: Optional[PhaseTimer] = None,
    store: bool = True,
    use_structured: bool = True,
    n_domain: Optional[int] = None,
    certify: bool = True,
) -> LinearResult:
    """Run one linear static solve and (optionally) store results in `model`.

    device: where the solve runs ("cuda" by default; never changed behind
      the caller's back). dtype: float32 by default (fem/operator.py).
    n_domain: None or 1; domain-sharded solves are not ported yet.
    certify: when the solve runs below float64, certify the true float64
      residual and refine until the configured tolerance holds.
    """
    device = resolve_device(device)
    dtype = dtype or default_dtype()
    timer = timer or PhaseTimer(verbose=False)
    settings = model.analysis
    solver = settings.lin_solver
    if solver in ("Cholesky", "LU"):
        raise NotImplementedError(
            f"the {solver} direct solver is not ported yet: ROADMAP.md "
            f"queue 1, item 8 (the general path's direct solvers)")
    if solver != "CG":
        raise ValueError(f"Unknown linear solver {solver!r}")
    tol = float(settings.lin_solver_tolerance)
    maxiter = int(settings.lin_solver_maxiter)
    form = model.formulation()

    with timer.phase("Operator setup"):
        fix = model.fix_mask()
        loads = model.load_vector()
        op = build_operator(model.coords, model.conn, model.elem_d_matrices(),
                            fix, form, dtype=dtype, device=device)
        f = torch.as_tensor(loads, dtype=dtype, device=device)
        kind, sop = _pick_cg_path(model, dtype, device, use_structured,
                                  n_domain)

    with timer.phase(f"Linear solve (CG, {kind})"):
        if sop is not None:
            res = _solve_cg_structured(sop, f, tol, maxiter)
        else:
            res = _solve_cg(op, f, tol, maxiter)
        u64 = res.u.to(torch.float64)
        iters, residual, converged = res.iters, res.residual, res.converged
    timer.records[-1]["iters"] = iters

    true_residual = None
    refine_cycles = refine_iters = 0
    cert_op = sop if sop is not None else op
    needs_cert = (certify and dtype != torch.float64
                  and not (sop is None and model.nelem > 200_000))
    if needs_cert:
        with timer.phase("Certify (f64 refinement)"):
            hi = _f64_twin(model, kind, device)
            loads64 = torch.as_tensor(loads, dtype=torch.float64,
                                      device=device)
            if sop is not None:
                b64 = hi.free_mask * _to_grid(sop.node_shape, loads64)
                x0 = _to_grid(sop.node_shape, u64)

                def inner_solve(r, t):
                    return _pcg_grid(cert_op, r, t, maxiter)
            else:
                b64 = hi.free_mask * loads64
                x0 = u64

                def inner_solve(r, t):
                    return _pcg_flat(cert_op, r, t, maxiter)
            rr = cg_mod.pcg_refined(
                None, b64, hi.apply, tol=tol, maxiter=maxiter,
                ndof=3 * model.nnode, x0=x0, lo_dtype=dtype,
                inner_solve=inner_solve)
            true_residual = rr.rel_residual
            refine_cycles = rr.cycles
            refine_iters = rr.inner_iters
            converged = rr.converged
            u64 = _from_grid(rr.u) if sop is not None else rr.u
        timer.records[-1]["refine_iters"] = refine_iters
    u = u64.to(dtype)

    with timer.phase("Stress recovery"):
        eps, sig, R = _recover(op, u)
        u_np = u.cpu().numpy()
        eps_np, sig_np, R_np = (eps.cpu().numpy(), sig.cpu().numpy(),
                                R.cpu().numpy())

    if store:
        # Increment 0 = zeros, increment 1 = the solution.
        model.disp = np.stack([np.zeros_like(u_np), u_np], axis=0)
        model.strain = np.stack([np.zeros_like(eps_np), eps_np], axis=0)
        model.stress = np.stack([np.zeros_like(sig_np), sig_np], axis=0)
        model.analysis.result_step_no = 1

    return LinearResult(
        u=u_np, strain=eps_np, stress=sig_np, reactions=R_np,
        iters=iters, residual=residual, converged=converged,
        operator=kind, n_domain=1, true_residual=true_residual,
        refine_cycles=refine_cycles, refine_iters=refine_iters,
        u_certified=u64.cpu().numpy() if needs_cert else None,
    )
