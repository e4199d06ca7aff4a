"""Jacobi-preconditioned conjugate gradients, and float64 refinement.

Port of stan_tpu/solvers/cg.py (pcg, pcg_refined) with the same contract:

  * stop when ||r|| <= tol * ||b||;
  * maxiter == 0 means ndof (the exact-termination bound);
  * a NaN or a residual past 1e8 x ||b|| stops the loop and sets
    ``diverged``; ``converged`` says whether the threshold was met.

The JAX loop runs on the device (lax.while_loop). Here the loop is Python,
so the stopping test reads ||r|| on the host: one device sync per
iteration, which keeps the iteration count identical to the reference's.
Everything else in the iteration stays on the device.
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    u: torch.Tensor
    iters: int
    residual: float  # final ||r||
    converged: bool
    diverged: bool = False  # NaN / blow-up guard tripped


def pcg(
    A: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    *,
    diag: Optional[torch.Tensor] = None,
    tol: float = 1.0e-6,
    maxiter: int = 0,
    ndof: Optional[int] = None,
    x0: Optional[torch.Tensor] = None,
) -> CGResult:
    """Solve A u = b with Jacobi-preconditioned CG.

    A: SPD operator; b: right-hand side of any shape (reductions run over
    all elements); diag: diagonal of A for the preconditioner (None: none);
    maxiter 0 caps at ndof, which defaults to b.numel(); x0: initial guess
    (zeros by default).
    """
    if maxiter == 0:
        maxiter = int(ndof if ndof is not None else b.numel())
    inv_diag = None if diag is None else torch.where(
        diag != 0, 1.0 / diag, torch.zeros_like(diag))

    def precond(r):
        return r if inv_diag is None else inv_diag * r

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - A(x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    tiny = torch.finfo(b.dtype).tiny
    bnorm = max(float(torch.sqrt(torch.sum(b * b))), tiny)
    threshold = tol * bnorm
    blowup = 1.0e8 * bnorm

    def bad(rnorm):
        return not math.isfinite(rnorm) or rnorm > blowup

    rnorm = float(torch.sqrt(torch.sum(r * r)))
    k = 0
    while rnorm > threshold and k < maxiter and not bad(rnorm):
        Ap = A(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_n = torch.sum(r * z)
        beta = rz_n / rz
        p = z + beta * p
        rz = rz_n
        k += 1
        rnorm = float(torch.sqrt(torch.sum(r * r)))  # the per-iteration sync
    return CGResult(u=x, iters=k, residual=rnorm,
                    converged=rnorm <= threshold, diverged=bad(rnorm))


class RefinedResult(NamedTuple):
    u: torch.Tensor      # float64 solution
    cycles: int          # number of low-precision correction solves run
    rel_residual: float  # true ||b - A_hi u|| / ||b|| (float64)
    inner_iters: int     # total low-precision CG iterations
    converged: bool
    # Wall time of the float64 residual sweeps and of the inner solves.
    sweep_seconds: float = 0.0
    inner_seconds: float = 0.0


def pcg_refined(
    A,
    b_hi: torch.Tensor,
    A_hi: Callable[[torch.Tensor], torch.Tensor],
    *,
    diag=None,
    tol: float = 1.0e-6,
    inner_tol: Optional[float] = None,
    maxiter: int = 0,
    ndof: Optional[int] = None,
    max_cycles: int = 6,
    lo_dtype=torch.float32,
    x0: Optional[torch.Tensor] = None,
    inner_solve=None,
) -> RefinedResult:
    """Mixed-precision iterative refinement: low-precision CG corrections
    under a float64 true-residual outer loop.

    Each cycle computes r = b - A_hi(x) in float64, solves A d = r with the
    low-precision operator and adds d to x in float64; it stops at the
    target, or when a cycle no longer reduces the residual. The inner
    tolerance of a cycle is clip(0.3 * tol / rel, 8 eps_lo, 3e-2), as in
    the JAX package: each cycle retires about 1.5 decades and the product
    of cycles reaches tol.

    A: low-precision operator (used when inner_solve is None); A_hi: the
    float64 operator, here the port's own operator built in float64 on the
    same device; inner_solve: (r_lo, tol) -> CGResult for the corrections;
    x0: float64 warm start (e.g. the base solve's solution).
    """
    b64 = b_hi.to(torch.float64)
    bnorm = float(torch.linalg.vector_norm(b64))
    if bnorm == 0.0:
        return RefinedResult(torch.zeros_like(b64), 0, 0.0, 0, True)
    # Below ~8 eps the low-precision recurrence cannot reliably reach its
    # own threshold, so the schedule never asks for less.
    floor = 8.0 * torch.finfo(lo_dtype).eps
    inner = inner_solve if inner_solve is not None else (
        lambda r, t: pcg(A, r, diag=diag, tol=t, maxiter=maxiter, ndof=ndof))

    x = torch.zeros_like(b64) if x0 is None else x0.to(torch.float64)
    total_iters = 0
    rel = math.inf
    solves = 0
    sweep_s = 0.0
    inner_s = 0.0
    for _ in range(max_cycles + 1):
        t0 = time.perf_counter()
        r = b64 - A_hi(x)
        new_rel = float(torch.linalg.vector_norm(r)) / bnorm
        sweep_s += time.perf_counter() - t0
        if new_rel <= tol:
            return RefinedResult(x, solves, new_rel, total_iters, True,
                                 sweep_s, inner_s)
        if new_rel >= rel:  # stalled at the low-precision floor
            return RefinedResult(x, solves, new_rel, total_iters, False,
                                 sweep_s, inner_s)
        rel = new_rel
        if solves == max_cycles:
            break
        t = inner_tol if inner_tol is not None else min(
            max(0.3 * tol / new_rel, floor), 3.0e-2)
        t0 = time.perf_counter()
        res = inner(r.to(lo_dtype), t)
        total_iters += res.iters
        solves += 1
        x = x + res.u.to(torch.float64)
        inner_s += time.perf_counter() - t0
    return RefinedResult(x, solves, rel, total_iters, rel <= tol,
                         sweep_s, inner_s)
