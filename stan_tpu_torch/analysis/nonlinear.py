"""Nonlinear (Total-Lagrangian) static analysis: incremental Newton-Raphson.

Port of stan_tpu/analysis/nonlinear.py on one device. The load ramps as
inc/IncNumb over the increments; each increment runs Newton iterations
until ||M (f_ext - R(u))|| / ||M f_ext|| <= newton_tol, each a Jacobi PCG
solve with the tangent at the current state. R is the
internal force of the consistent total Green-Lagrange / PK2 state
(fem/nonlinear_kernels.py). The preconditioner is the Jacobi diagonal of
the linear operator, which does not depend on the state.

The reference runs the Newton loop on the device (lax.while_loop) and
recomputes F and S inside every tangent action. Here the Newton loop is
Python around cg.pcg, and the state's displacement gradient, PK2 stress
and element tangent matrices are computed once per Newton iteration,
outside the CG loop: the same function, and each CG iteration one batched
element matrix-vector product (K_T itself is never assembled).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stan_tpu_torch.core.model import FEModel
from stan_tpu_torch.fem import nonlinear_kernels as nlk
from stan_tpu_torch.fem.operator import (StiffnessOperator, build_operator,
                                         default_dtype, resolve_device)
from stan_tpu_torch.solvers import cg as cg_mod
from stan_tpu_torch.utils import checkpoint as ckpt
from stan_tpu_torch.utils.timing import PhaseTimer


@dataclasses.dataclass
class NonlinearResult:
    u: np.ndarray  # [nnode, 3] final displacements
    strain: np.ndarray  # [ninc+1, E, nn, 6] Green-Lagrange per increment
    stress: np.ndarray  # [ninc+1, E, nn, 6] PK2 per increment
    disp: np.ndarray  # [ninc+1, nnode, 3]
    newton_iters: np.ndarray  # [ninc]
    residuals: np.ndarray  # [ninc] final relative residual norms
    converged: bool


def internal_force(op: StiffnessOperator, u: torch.Tensor) -> torch.Tensor:
    """Global TL internal force R(u) [nnode, 3] (not masked)."""
    return op.scatter_add(nlk.internal_force_tl(op.dN, op.detJw, op.D,
                                                op.gather(u)))


def tangent_operator(op: StiffnessOperator, u: torch.Tensor):
    """Masked tangent action at state u: du -> M K_T(u) (M du) + (I - M)
    du, with the element tangents formed once (fem/nonlinear_kernels.
    element_tangent) and K_T never assembled."""
    m = op.free_mask
    H, S = nlk.tangent_state(op.dN, op.D, op.gather(u))
    K = nlk.element_tangent(op.dN, op.detJw, op.D, H, S)
    E, nn = op.conn.shape

    def apply(du):
        du_e = op.gather(m * du).reshape(E, 3 * nn, 1)
        f_e = torch.bmm(K, du_e).reshape(E, nn, 3)
        return m * op.scatter_add(f_e) + (1.0 - m) * du

    return apply


def _newton_increment(op, u, f_ext, tol, cg_tol, newton_maxiter,
                      cg_maxiter):
    """Newton iterations for one load increment. Returns (u, iterations,
    relative residual, CG iterations of each Newton step)."""
    m = op.free_mask
    norm_f = max(float(torch.linalg.vector_norm(m * f_ext)),
                 torch.finfo(u.dtype).tiny)
    diag = op.diagonal()
    res = m * (f_ext - internal_force(op, u))
    rel = float(torch.linalg.vector_norm(res)) / norm_f
    cg_iters = []
    while rel > tol and len(cg_iters) < newton_maxiter:
        sol = cg_mod.pcg(tangent_operator(op, u), res, diag=diag, tol=cg_tol,
                         maxiter=cg_maxiter, ndof=3 * op.nnode)
        cg_iters.append(sol.iters)
        u = u + m * sol.u
        res = m * (f_ext - internal_force(op, u))
        rel = float(torch.linalg.vector_norm(res)) / norm_f
    return u, len(cg_iters), rel, cg_iters


def solve_nonlinear_statics(
    model: FEModel,
    *,
    device="cuda",
    dtype=None,
    timer: Optional[PhaseTimer] = None,
    newton_tol: float = 1.0e-3,
    newton_maxiter: int = 20,
    store: bool = True,
    checkpoint_path: Optional[str] = None,
) -> NonlinearResult:
    """Incremental TL Newton solve; stores the per-increment displacement,
    strain and stress histories as the reference does.

    With ``checkpoint_path``, the per-increment history is saved after each
    increment, and a call with the same path and increment count resumes at
    the first increment not yet done. Each increment's timer record holds
    its Newton iterations, relative residual and the CG iterations of each
    Newton step.
    """
    device = resolve_device(device)
    dtype = dtype or default_dtype()
    timer = timer or PhaseTimer(verbose=False)
    ninc = max(1, model.analysis.inc_numb)

    with timer.phase("Operator setup"):
        op = build_operator(model.coords, model.conn,
                            model.elem_d_matrices(), model.fix_mask(),
                            model.formulation(), dtype=dtype, device=device)
        f_full = torch.as_tensor(model.load_vector(), dtype=dtype,
                                 device=device)

    nnode = model.nnode
    u = torch.zeros((nnode, 3), dtype=dtype, device=device)
    E, nn = model.nelem, model.conn.shape[1]
    zero66 = np.zeros((E, nn, 6))
    disp, strains, stresses = [np.zeros((nnode, 3))], [zero66], [zero66]
    iters_list, res_list = [], []
    cg_tol = float(model.analysis.lin_solver_tolerance)
    cg_maxiter = int(model.analysis.lin_solver_maxiter)

    ok = True
    start_inc = 1
    state_ck = ckpt.load_or_none(checkpoint_path)
    if state_ck is not None and int(state_ck.get("ninc", -1)) == ninc:
        start_inc = int(state_ck["next_inc"])
        u = torch.as_tensor(np.asarray(state_ck["u"]), dtype=dtype,
                            device=device)
        disp = [np.asarray(a) for a in state_ck["disp"]]
        strains = [np.asarray(a) for a in state_ck["strains"]]
        stresses = [np.asarray(a) for a in state_ck["stresses"]]
        iters_list = [int(v) for v in state_ck["iters"]]
        res_list = [float(v) for v in state_ck["res"]]
        ok = all(r <= newton_tol for r in res_list)

    for inc in range(start_inc, ninc + 1):
        f_ext = f_full * (inc / ninc)  # load ramp inc/ninc
        with timer.phase(f"Increment {inc}"):
            u, iters_i, rel_i, cg_iters = _newton_increment(
                op, u, f_ext, newton_tol, cg_tol, newton_maxiter, cg_maxiter)
        timer.records[-1].update(newton_iters=iters_i,
                                 residual=f"{rel_i:.2e}", cg_iters=cg_iters)
        iters_list.append(iters_i)
        res_list.append(rel_i)
        ok = ok and rel_i <= newton_tol

        eps, sig = nlk.recover_tl(op.dN, op.detJw, op.D, op.gather(u),
                                  op.form)
        disp.append(u.cpu().numpy())
        strains.append(eps.cpu().numpy())
        stresses.append(sig.cpu().numpy())
        if checkpoint_path:
            ckpt.save(checkpoint_path, {
                "ninc": ninc, "next_inc": inc + 1, "u": disp[-1],
                "disp": disp, "strains": strains, "stresses": stresses,
                "iters": iters_list, "res": res_list,
            })

    disp_arr = np.stack(disp, axis=0)
    strain_arr = np.stack(strains, axis=0)
    stress_arr = np.stack(stresses, axis=0)
    if store:
        model.disp = disp_arr
        model.strain = strain_arr
        model.stress = stress_arr
        model.analysis.result_step_no = ninc

    return NonlinearResult(
        u=u.cpu().numpy(), strain=strain_arr, stress=stress_arr,
        disp=disp_arr, newton_iters=np.asarray(iters_list),
        residuals=np.asarray(res_list), converged=ok)
