"""Differentiable FEM forward model for calibration, on the stencil path.

Port of stan_tpu/infer/forward.py for its stencil branch. The calibration
treats the linear static solve as a forward model: θ = (log E, ν, log load
scale) -> displacement field u(θ). On a structured HEX8 grid with one
homogeneous material (the calibration setting: θ supplies the material),
the assembled stiffness is linear in the Lamé constants,

    K(θ)·u = λ·K_λu + μ·K_μu,

so the matvec is one pass of the theta sweep (fem/stencil.theta_apply) over
fixed unit-λ / unit-μ tables. Chains are an explicit leading axis: λ, μ are
[B] and grids [B, 3, X, Y, Z]; one θ is the case B = 1.

Gradients flow through the solve implicitly, as jax.lax.custom_linear_solve
(symmetric=True) gives them in the reference: the backward pass is one more
chain-batched PCG solve with the same SPD operator on the masked cotangent
(an adjoint solve), not CG unrolled.

Only the stencil forward is ported. build_forward raises
NotImplementedError where the reference would take the general
(ForwardProblem) or per-element-field (StructuredFieldForwardProblem) path:
ROADMAP.md queue 1, item 8.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from stan_tpu_torch.core.model import FEModel
from stan_tpu_torch.fem import stencil, structured
from stan_tpu_torch.fem.operator import default_dtype
from stan_tpu_torch.solvers import cg as cg_mod


def _default_infer_maxiter(nnode: int) -> int:
    """CG iteration cap of the inference forward and adjoint solves.

    Inside HMC the sampler probes arbitrary θ; a very small E makes K
    nearly singular and CG would grind toward ndof iterations. A θ whose
    solve needs more than this cap gets a displacement whose likelihood is
    astronomically low, so the Metropolis step rejects it either way;
    capping bounds the cost of visiting it. Unlike the reference, the port
    counts every solve that stops at the cap (SolveStats).
    """
    return min(3 * nnode, 4000)


def lame_from_E_nu(E, nu):
    """Lamé (λ, μ) from Young's modulus and Poisson's ratio."""
    lam = E * nu / ((1.0 - 2.0 * nu) * (1.0 + nu))
    mu = 0.5 * E / (1.0 + nu)
    return lam, mu


@dataclasses.dataclass
class SolveStats:
    """Counts over every solve a forward problem has run; each chain of a
    chain-batched solve counts as one solve. ``*_loop_iters`` counts the
    iterations of the batched CG loops themselves (the most any chain of
    that solve took), which is what the card runs."""

    forward_solves: int = 0
    forward_iters: int = 0
    forward_unconverged: int = 0
    forward_loop_iters: int = 0
    adjoint_solves: int = 0
    adjoint_iters: int = 0
    adjoint_unconverged: int = 0
    adjoint_loop_iters: int = 0

    def record(self, kind: str, res: cg_mod.CGResult) -> None:
        """Add one chain-batched pcg result under kind "forward" or
        "adjoint"."""
        add = {"solves": len(res.iters), "iters": int(res.iters.sum()),
               "unconverged": int((~res.converged).sum()),
               "loop_iters": int(res.iters.max())}
        for key, n in add.items():
            name = f"{kind}_{key}"
            setattr(self, name, getattr(self, name) + n)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def since(self, before: dict) -> dict:
        """The counts added since ``before`` (an earlier ``as_dict()``)."""
        return {k: v - before[k] for k, v in self.as_dict().items()}


@dataclasses.dataclass(frozen=True)
class StencilForwardProblem:
    """θ -> u forward model on the theta stencil sweep.

    The matvec M K(λ, μ) (M u) + (I - M) u runs K(λ, μ)·u as ONE pass of
    the coefficient-parameterised sweep (stencil.theta_apply: λ·K_λu +
    μ·K_μu, the unit tables fixed, (λ, μ) read from device memory per
    chain), the same FMA count as a single fixed-table sweep. A chain batch
    is one launch of theta_sweep_batched per matvec. solve() is implicitly
    differentiable in (λ, μ, f): its backward is an adjoint PCG solve with
    the same operator plus two unit-coefficient sweeps.
    """

    tables_lam: dict  # {sig: {offset: 3x3}} unit-λ signature tables
    tables_mu: dict   # unit-μ signature tables
    tables2: torch.Tensor  # pack_theta_tables(tables_lam, tables_mu)
    free_mask: torch.Tensor  # [3, nnx, nny, nnz]
    d_lam: torch.Tensor  # raw unit-λ diagonal grid [3, nnx, nny, nnz]
    d_mu: torch.Tensor   # raw unit-μ diagonal grid
    f0: torch.Tensor     # [3, nnx, nny, nnz] unit load grid
    node_shape: tuple
    cg_tol: float
    cg_maxiter: int
    stats: SolveStats = dataclasses.field(default_factory=SolveStats)

    @property
    def dtype(self):
        return self.f0.dtype

    @property
    def device(self):
        return self.f0.device

    def to_flat(self, u_grid: torch.Tensor) -> torch.Tensor:
        """[..., 3, nnx, nny, nnz] -> [..., nnode, 3]."""
        return u_grid.movedim(-4, -1).reshape(*u_grid.shape[:-4], -1, 3)

    def matvec_fn(self, lam: torch.Tensor, mu: torch.Tensor
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Masked SPD action on chain-batched grids [B, 3, X, Y, Z]."""
        m = self.free_mask

        def matvec(u):
            return m * stencil.theta_apply(self.tables2, lam, mu, m * u) \
                + (1.0 - m) * u

        return matvec

    def diagonal(self, lam: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
        """Masked Jacobi diagonal per chain, [B, 3, X, Y, Z]."""
        m = self.free_mask
        w = (lam.shape[0],) + (1,) * 4
        return m * (lam.view(w) * self.d_lam + mu.view(w) * self.d_mu) \
            + (1.0 - m)

    def _pcg(self, lam, mu, rhs) -> cg_mod.CGResult:
        return cg_mod.pcg(self.matvec_fn(lam, mu), rhs.contiguous(),
                          diag=self.diagonal(lam, mu), tol=self.cg_tol,
                          maxiter=self.cg_maxiter,
                          ndof=int(3 * np.prod(self.node_shape)),
                          batched=True)

    def solve(self, lam: torch.Tensor, mu: torch.Tensor,
              f: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Solve K(λ_b, μ_b) u_b = M f_b for every chain, implicitly
        differentiable in λ, μ ([B], the problem's dtype) and f ([B, 3, X,
        Y, Z]; None: the unit load for every chain). Returns u [B, 3, X, Y,
        Z]."""
        if f is None:
            f = self.f0.expand(lam.shape[0], *self.f0.shape)
        return _StencilSolve.apply(lam, mu, f, self)


class _StencilSolve(torch.autograd.Function):
    """u = A(λ, μ)⁻¹ (M f), A = M K(λ, μ) M + (I - M), chain-batched.

    Backward: w = A⁻¹ (M ū) (the adjoint solve; A is symmetric), then
    ∂/∂f = M w, ∂/∂λ = -⟨M w, K_λ(M u)⟩, ∂/∂μ = -⟨M w, K_μ(M u)⟩ per
    chain. u vanishes on the fixed DOFs whatever θ is, so masking the
    cotangent changes no gradient. Both solves record their iterations and
    convergence in the problem's SolveStats.
    """

    @staticmethod
    def forward(ctx, lam, mu, f, prob):
        res = prob._pcg(lam, mu, prob.free_mask * f)
        prob.stats.record("forward", res)
        ctx.save_for_backward(lam, mu, res.u)
        ctx.prob = prob
        return res.u

    @staticmethod
    def backward(ctx, ct):
        lam, mu, u = ctx.saved_tensors
        prob = ctx.prob
        m = prob.free_mask
        res = prob._pcg(lam, mu, m * ct)
        prob.stats.record("adjoint", res)
        w = m * res.u
        g_lam = g_mu = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            g_lam, g_mu = stencil.theta_coef_grads(prob.tables2, w, m * u)
            g_lam, g_mu = -g_lam, -g_mu
        return g_lam, g_mu, (w if ctx.needs_input_grad[2] else None), None


def _stencil_forward_pieces(model: FEModel, dtype, device):
    """The structured base operator, unit-coefficient signature tables, raw
    Jacobi diagonal grids and the unit load grid; None if the mesh does not
    qualify (structured HEX8 grid with at least 3 nodes per axis)."""
    base = structured.build_structured_operator(model, dtype=dtype,
                                                device=device)
    if base is None or min(base.node_shape) < 3:
        return None
    tables_lam = stencil.signature_tables(
        base.ke_lam.to(torch.float64).cpu().numpy())
    tables_mu = stencil.signature_tables(
        base.ke_mu.to(torch.float64).cpu().numpy())
    # Raw (unmasked, unit-coefficient) Jacobi diagonals, geometry only.
    shape = (24, *base.nelems)
    d_lam = base.scatter_elements(
        torch.diagonal(base.ke_lam)[:, None, None, None].expand(shape))
    d_mu = base.scatter_elements(
        torch.diagonal(base.ke_mu)[:, None, None, None].expand(shape))
    f0 = base.to_grid(torch.as_tensor(model.load_vector(), dtype=base.dtype,
                                      device=base.device)).contiguous()
    return base, tables_lam, tables_mu, d_lam, d_mu, f0


def build_stencil_forward(model: FEModel, *, dtype=None, device="cuda",
                          cg_tol: float = 1.0e-8, cg_maxiter: int = 0
                          ) -> Optional[StencilForwardProblem]:
    """Build the stencil forward model, or None if the mesh does not
    qualify. The material table is not read: θ supplies the material
    (build_forward checks that the model's own material is one)."""
    pieces = _stencil_forward_pieces(model, dtype or default_dtype(), device)
    if pieces is None:
        return None
    base, tables_lam, tables_mu, d_lam, d_mu, f0 = pieces
    if cg_maxiter == 0:
        cg_maxiter = _default_infer_maxiter(model.nnode)
    return StencilForwardProblem(
        tables_lam=tables_lam, tables_mu=tables_mu,
        tables2=stencil.pack_theta_tables(tables_lam, tables_mu, base.dtype,
                                          base.device),
        free_mask=base.free_mask.contiguous(), d_lam=d_lam.contiguous(),
        d_mu=d_mu.contiguous(), f0=f0,
        node_shape=base.node_shape, cg_tol=cg_tol, cg_maxiter=cg_maxiter)


def build_forward(model: FEModel, *, dtype=None, device="cuda",
                  cg_tol: float = 1.0e-8, cg_maxiter: int = 0
                  ) -> StencilForwardProblem:
    """Build the θ -> u forward model where the reference would take its
    stencil path: a structured HEX8 grid whose elements all use one
    (E, ν). Raises ValueError if an element's material id is missing from
    model.materials (the reference skips such ids and may then take the
    stencil path, which ignores the material table), and
    NotImplementedError where the reference would take a forward model the
    port does not have yet."""
    used = (set(np.asarray(model.elem_mat).tolist())
            if model.elem_mat is not None else set())
    missing = sorted(i for i in used if i not in model.materials)
    if missing:
        raise ValueError(
            f"elements use material ids {missing} that model.materials does "
            f"not define; refusing to build a forward model that would "
            f"ignore them")
    homog = len({(model.materials[i].E, model.materials[i].poisson)
                 for i in used}) <= 1
    later = ("is not ported yet: ROADMAP.md queue 1, item 8 (the general "
             "path and the other forward problems)")
    if not homog:
        raise NotImplementedError(
            f"a heterogeneous material needs the per-element-field forward "
            f"(StructuredFieldForwardProblem), which {later}")
    fwd = build_stencil_forward(model, dtype=dtype, device=device,
                                cg_tol=cg_tol, cg_maxiter=cg_maxiter)
    if fwd is None:
        raise NotImplementedError(
            f"the mesh is not a structured HEX8 grid with >= 3 nodes per "
            f"axis; the general forward (ForwardProblem) {later}")
    return fwd


def solve_theta(fwd: StencilForwardProblem, theta: torch.Tensor
                ) -> torch.Tensor:
    """θ [B, 3] = (log E, ν, log s) rows -> displacement grids [B, 3, X, Y,
    Z] (homogeneous material, load scaled by s), differentiable in θ."""
    lam, mu = lame_from_E_nu(torch.exp(theta[:, 0]), theta[:, 1])
    scale = torch.exp(theta[:, 2]).to(fwd.dtype).view(-1, 1, 1, 1, 1)
    return fwd.solve(lam.to(fwd.dtype), mu.to(fwd.dtype), fwd.f0 * scale)


def displacement_fn(fwd, nelem: int) -> Callable[[torch.Tensor],
                                                 torch.Tensor]:
    """θ = (log E, ν, log load scale) -> u [nnode, 3]; θ of shape [B, 3]
    gives u [B, nnode, 3]. nelem is kept for the reference's signature."""
    if not isinstance(fwd, StencilForwardProblem):
        raise NotImplementedError(
            f"{type(fwd).__name__} is not ported yet: ROADMAP.md queue 1, "
            f"item 8")

    def u_of(theta):
        if theta.dim() == 1:
            return fwd.to_flat(solve_theta(fwd, theta[None]))[0]
        return fwd.to_flat(solve_theta(fwd, theta))

    return u_of
