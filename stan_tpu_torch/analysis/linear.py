"""Linear static analysis driver.

Port of stan_tpu/analysis/linear.py. With the CG solver the operator is
chosen fastest first, as the reference chooses it: over more than one
device of the domain axis, the sharded stencil (x-slabs,
parallel/sharded_stencil.py) and then the sharded general operator
(parallel/sharded.py); on one device, the assembled stencil (hand-written
CUDA sweep) on a uniform-material structured HEX8 grid, then the
structured slice-gather operator, then the general gather/scatter
operator. All act on the same masked system. A solve below float64 is
certified as the reference certifies it: the true float64 residual is read
on the host by the operator's float64 twin (fem/hostops.masked_f64_apply:
exact tables and the native sweep for the stencil, numpy for the
structured and general operators), independent of the device code, and
mixed-precision refinement runs until the configured tolerance holds,
with x and the residual in float64 on the host and each correction solved
on the device (a sharded stencil solve on its single-device stencil twin,
a sharded general one on the general operator).

The domain width: on CUDA, n_domain is clamped to the visible cards, and
None means all of them for a model of AUTO_SHARD_MIN_NNODE nodes or more
(one card otherwise), as the reference clamps to its devices. On the CPU an
explicit n_domain is honoured with that many CPU slabs (one process drives
them all) and None means 1. After distributed.initialize() with several
processes the same rule counts the global devices, and the sharded solve's
mesh is device_mesh over them, as the reference's is over jax.devices():
every process runs the solve, each on its own slabs, and gets the whole u,
which it certifies on its own host and device (the same work on each, and
the same answer).

The direct solvers (Cholesky, LU) dispatch on size as the reference does:
up to 6000 DOF the masked K is assembled dense and factored on the device
(solvers/direct.py); above it the banded float64 factorisation runs on the
host (solvers/banded.py), as in the reference. Both report the true
float64 residual, read on the host by the general operator's twin
(hostops.general_apply_np). Stress recovery runs on the general operator.

Unlike the reference, which leaves the general operator uncertified above
200,000 elements (stan_tpu/analysis/linear.py:275-276, where its float64
host twin would cost minutes), the port certifies it at every size: its
twin is built and swept by the host runtime (hostops.general_twin_np), a
second or so at 1M DOF.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stan_tpu_torch.core.model import FEModel
from stan_tpu_torch.fem import assembly, hostops, kernels
from stan_tpu_torch.fem import stencil as stencil_mod
from stan_tpu_torch.fem import structured as structured_mod
from stan_tpu_torch.fem.operator import (StiffnessOperator, build_operator,
                                         default_dtype, resolve_device)
from stan_tpu_torch.parallel import distributed, sharded
from stan_tpu_torch.parallel import sharded_stencil as sstencil_mod
from stan_tpu_torch.solvers import banded, direct
from stan_tpu_torch.solvers import cg as cg_mod
from stan_tpu_torch.utils.timing import PhaseTimer

# Above this DOF count a dense [ndof, ndof] K stops being cheap (float64 at
# 6000 DOF is 0.29 GB) and the direct path takes the banded host solver.
_DENSE_DIRECT_MAX_DOF = 6000


@dataclasses.dataclass
class LinearResult:
    u: np.ndarray  # [nnode, 3] displacements
    strain: np.ndarray  # [E, nn, 6] node-extrapolated strain
    stress: np.ndarray  # [E, nn, 6]
    reactions: np.ndarray  # [nnode, 3] internal force
    iters: int
    residual: float
    converged: bool
    # stencil / structured / general, sharded-stencilxN /
    # sharded-generalxN (CG over N devices); dense-cholesky, dense-lu,
    # banded-cholesky, banded-lu (direct)
    operator: str = "general"
    n_domain: int = 1
    # True float64 relative residual of the certified solution (None when
    # a CG solve ran in float64 or certification was skipped); for the
    # direct solvers, of their solution.
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


# Auto domain decomposition threshold: below this node count a sharded
# solve costs more in exchanges and set-up than it saves.
AUTO_SHARD_MIN_NNODE = 20_000


def _domain_width(model, device, n_domain) -> int:
    """The domain axis's width (module docstring)."""
    several = distributed.process_count() > 1
    if device.type != "cuda" and not several:
        return max(1, n_domain or 1)
    ndev = (len(distributed.devices()) if several
            else torch.cuda.device_count())
    if n_domain is None:
        n_domain = ndev if (ndev > 1 and model.nnode >= AUTO_SHARD_MIN_NNODE
                            ) else 1
    return max(1, min(n_domain, ndev))


def _domain_mesh(device, n: int) -> distributed.DeviceMesh:
    """One row of n devices: the first n global devices over several
    processes, else the first n cards, or n CPU slabs."""
    if device.type == "cuda" or distributed.process_count() > 1:
        mesh = distributed.device_mesh(1, n)
        if mesh.home.type != device.type:
            raise ValueError(f"the processes' devices are "
                             f"{mesh.home.type}, the solve asks for "
                             f"{device}")
        return mesh
    return distributed.device_mesh(1, n, devices=[device] * n)


def _pick_cg_path(model, dtype, device, use_structured, n_domain):
    """Choose the fastest applicable CG operator, as the reference does:
    sharded stencil > sharded general over more than one device, then
    stencil > structured > general. Returns (kind, its operator: the
    sharded or single-device grid operator, None for the general ones; the
    domain width used)."""
    n = _domain_width(model, device, n_domain)
    if n > 1 and use_structured:
        ssop = sstencil_mod.build_sharded_stencil_operator(
            model, n, dtype=dtype, device=device)
        if ssop is not None:
            return "sharded-stencil", ssop, n
    if n > 1:
        return "sharded-general", None, n
    if use_structured:
        sop = stencil_mod.build_stencil_operator(model, dtype=dtype,
                                                 device=device)
        if sop is not None:
            return "stencil", sop, 1
        sop = structured_mod.build_structured_operator(model, dtype=dtype,
                                                       device=device)
        if sop is not None:
            return "structured", sop, 1
    return "general", None, 1


def _solve_sharded(kind, payload, model, op, f, n, tol, maxiter):
    """The sharded CG solve over a one-row mesh of n devices; returns (its
    CGResult, u [nnode, 3] in float64 on op's device)."""
    mesh = _domain_mesh(op.device, n)
    if kind == "sharded-stencil":
        node_shape = tuple(payload.free_mask.shape[1:])
        res = sstencil_mod.sharded_stencil_pcg(
            mesh, payload, _to_grid(node_shape, f), tol=tol, maxiter=maxiter)
        return res, _from_grid(res.u).to(torch.float64)
    shop, part = sharded.build_sharded_operator(
        model.coords, model.conn, model.elem_d_matrices(), model.fix_mask(),
        model.formulation(), n, dtype=op.dtype, device=op.device)
    fp = torch.as_tensor(sharded.shard_rhs(part, model.load_vector()),
                         dtype=op.dtype, device=op.device)
    res = sharded.sharded_pcg(mesh, shop, fp, tol=tol, maxiter=maxiter)
    u = sharded.unshard_u(part, res.u.cpu().numpy())
    return res, torch.as_tensor(u, dtype=torch.float64, device=op.device)


def _true_residual(model, u64) -> float:
    """||b - A u|| / ||b|| in float64, A the masked general operator's host
    twin (fem/hostops.general_apply_np), as the reference reads the banded
    solve's residual."""
    A_hi = hostops.general_apply_np(
        model.coords, model.conn,
        np.asarray(model.elem_d_matrices(), np.float64),
        model.formulation(), model.fix_mask())
    b64 = (1.0 - model.fix_mask()) * np.asarray(model.load_vector(),
                                                np.float64)
    r64 = b64 - A_hi(u64.detach().cpu().numpy())
    return float(np.linalg.norm(r64.ravel())) / max(
        float(np.linalg.norm(b64.ravel())), 1e-300)


def _certify(model, cert_op, grid, u64, loads, dtype, tol, maxiter, timer):
    """Mixed-precision refinement of the base solve u64 [nnode, 3] under
    the true float64 residual of cert_op's host twin
    (hostops.masked_f64_apply), as the reference certifies: x and the
    residual in float64 on the host, each correction solved in `dtype` on
    cert_op's device by the same CG as the base solve. Returns (its
    RefinedResult, u [nnode, 3] float64 on the host, the float64 sweeps
    run). The open phase of `timer` gets the parts of its seconds: twin
    set-up (twin_s), inner CG (inner_s), copies (copy_s); the host sweeps
    are the RefinedResult's sweep_seconds."""
    # The structured twin reads the operator's Lame fields, which a float32
    # operator holds rounded: it reads a float64 copy built on the host.
    with timer.part("certify.twin", "twin_s"):
        twin = hostops.masked_f64_apply(model, (
            structured_mod.build_structured_operator(
                model, dtype=torch.float64, device="cpu")
            if isinstance(cert_op, structured_mod.StructuredOperator)
            else cert_op))
    with timer.part("certify.copy", "copy_s"):
        x0 = u64.cpu()
    b64 = torch.as_tensor(loads, dtype=torch.float64)
    if grid:
        b64, x0 = (_to_grid(cert_op.node_shape, v) for v in (b64, x0))
    b64 = cert_op.free_mask.cpu().to(torch.float64) * b64

    sweeps = 0

    def A_hi(x):
        nonlocal sweeps
        sweeps += 1
        return torch.from_numpy(twin(x.numpy()))

    def inner_solve(r, t):
        with timer.part("certify.copy", "copy_s"):
            r = r.to(cert_op.free_mask.device)
        with timer.part("certify.inner_cg", "inner_s"):
            res = (_pcg_grid(cert_op, r, t, maxiter) if grid
                   else _pcg_flat(cert_op, r, t, maxiter))
        with timer.part("certify.copy", "copy_s"):
            return res._replace(u=res.u.cpu())

    rr = cg_mod.pcg_refined(
        None, b64, A_hi, tol=tol, maxiter=maxiter, ndof=3 * model.nnode,
        x0=x0, lo_dtype=dtype, inner_solve=inner_solve)
    return rr, _from_grid(rr.u) if grid else rr.u, sweeps


def _solve_direct(model, solver, op, f, timer, certify):
    """Dense factorisation on the device up to _DENSE_DIRECT_MAX_DOF, the
    banded float64 host factorisation above. Returns (u in the operator's
    dtype, operator name, true float64 residual or None)."""
    dtype, device = op.dtype, op.device
    if 3 * model.nnode > _DENSE_DIRECT_MAX_DOF:
        kind = f"banded-{solver.lower()}"
        with timer.phase(f"Linear solve (banded {solver})"):
            solve_b = (banded.solve_banded_cholesky if solver == "Cholesky"
                       else banded.solve_banded_lu)
            u64 = torch.as_tensor(solve_b(model, model.load_vector()),
                                  dtype=torch.float64, device=device)
            true_residual = _true_residual(model, u64) if certify else None
        return u64.to(dtype), kind, true_residual
    with timer.phase("Assembly (dense)"):
        K = assembly.assemble_dense(
            model.coords, model.conn, model.elem_d_matrices(),
            model.formulation(), fix_mask=model.fix_mask(), dtype=dtype,
            device=device)
    with timer.phase(f"Linear solve ({solver})"):
        solve = (direct.solve_cholesky if solver == "Cholesky"
                 else direct.solve_lu)
        u = solve(K, (op.free_mask * f).reshape(-1)).reshape(model.nnode, 3)
        true_residual = _true_residual(model, u) if certify else None
    return u, f"dense-{solver.lower()}", true_residual


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
    n_domain: the domain-decomposition width (module docstring); 1 forces
      one device.
    certify: when a CG solve runs below float64, certify the true float64
      residual and refine until the configured tolerance holds; for the
      direct solvers, report the true float64 residual of their solution.
    """
    device = resolve_device(device)
    dtype = dtype or default_dtype()
    timer = timer or PhaseTimer(verbose=False)
    settings = model.analysis
    solver = settings.lin_solver
    if solver not in ("CG", "Cholesky", "LU"):
        raise ValueError(f"Unknown linear solver {solver!r}")
    tol = float(settings.lin_solver_tolerance)
    maxiter = int(settings.lin_solver_maxiter)
    form = model.formulation()

    with timer.phase("Operator setup"):
        fix = model.fix_mask()
        loads = model.load_vector()
        with timer.part("setup.general_operator", "general_s"):
            op = build_operator(model.coords, model.conn,
                                model.elem_d_matrices(), fix, form,
                                dtype=dtype, device=device)
        f = torch.as_tensor(loads, dtype=dtype, device=device)
        n_used = 1
        if solver == "CG":
            with timer.part("setup.cg_operator", "grid_s"):
                path, sop, n_used = _pick_cg_path(model, dtype, device,
                                                  use_structured, n_domain)
            kind = path if n_used == 1 else f"{path}x{n_used}"

    refine_cycles = refine_iters = 0
    needs_cert = False
    if solver != "CG":
        u, kind, true_residual = _solve_direct(model, solver, op, f, timer,
                                               certify)
        iters, residual, converged = 1, 0.0, True
    else:
        with timer.phase(f"Linear solve (CG, {kind})"):
            if n_used > 1:
                res, u64 = _solve_sharded(path, sop, model, op, f, n_used,
                                          tol, maxiter)
            elif sop is not None:
                res = _solve_cg_structured(sop, f, tol, maxiter)
                u64 = res.u.to(torch.float64)
            else:
                res = _solve_cg(op, f, tol, maxiter)
                u64 = res.u.to(torch.float64)
            iters, residual, converged = res.iters, res.residual, \
                res.converged
        timer.records[-1].update(iters=iters, cg_s=res.wall_ns * 1e-9,
                                 wait_s=res.wait_ns * 1e-9, reads=res.reads,
                                 frozen=res.frozen)

        # Certification, as in the reference: a sharded stencil solve on
        # its single-device stencil twin, a sharded general one on the
        # general operator; the float64 residual on the host.
        if n_used > 1:
            sop = (stencil_mod.build_stencil_operator(model, dtype=dtype,
                                                      device=device)
                   if path == "sharded-stencil" and certify
                   and dtype != torch.float64 else None)
        true_residual = None
        cert_op = sop if sop is not None else op
        needs_cert = certify and dtype != torch.float64
        if needs_cert:
            with timer.phase("Certify (f64 refinement)"):
                rr, u64, sweeps = _certify(model, cert_op, sop is not None,
                                           u64, loads, dtype, tol, maxiter,
                                           timer)
                true_residual = rr.rel_residual
                refine_cycles = rr.cycles
                refine_iters = rr.inner_iters
                converged = rr.converged
            timer.records[-1].update(refine_iters=refine_iters,
                                     sweep_s=rr.sweep_seconds, sweeps=sweeps)
        u = u64.to(dtype).to(device)

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
        operator=kind, n_domain=n_used, true_residual=true_residual,
        refine_cycles=refine_cycles, refine_iters=refine_iters,
        u_certified=u64.cpu().numpy() if needs_cert else None,
    )
