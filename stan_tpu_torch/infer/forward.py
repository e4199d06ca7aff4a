"""Differentiable FEM forward models for calibration.

Port of stan_tpu/infer/forward.py (its single-device forward problems).
The calibration treats the linear static solve as a forward model: θ =
(log E, ν, log load scale) -> displacement field u(θ). Chains are an
explicit leading axis: one θ is the case B = 1. Three forward problems,
chosen by build_forward as the reference chooses them:

- StencilForwardProblem: a structured HEX8 grid with one homogeneous
  material. The assembled stiffness is linear in the Lamé constants,
  K(θ)·u = λ·K_λu + μ·K_μu, so the matvec is one pass of the theta sweep
  (fem/stencil.theta_apply, a hand-written CUDA kernel) over fixed unit-λ /
  unit-μ tables; λ, μ are [B].
- StructuredFieldForwardProblem: a structured grid with per-element Lamé
  fields λ_e, μ_e ([B, nx, ny, nz]) on the structured operator (slice
  gather, one stacked matmul, shifted-read scatter; plain torch).
- ForwardProblem: any mesh, with a per-element D_e ([B, E, 6, 6]) on the
  general gather/scatter operator (plain torch).

ShardedStencilForwardProblem is the stencil forward on a chains x domain
device mesh (parallel/distributed.py): the grid cut into x-slabs over the
domain axis, the chains into blocks over the rows; it gives the
log-posterior's value and gradient for hmc.run_chains
(make_batched_logp_grad). build_row_forwards builds one of the three
forwards per row of a mesh, for a calibration whose chains alone are placed
(calibrate.make_problem(mesh=)).

Gradients flow through each solve implicitly, as jax.lax.custom_linear_solve
(symmetric=True) gives them in the reference: one torch.autograd.Function
(_ImplicitSolve) for the three forwards, whose backward is one more
chain-batched PCG solve with the same SPD operator on the masked cotangent
(an adjoint solve), not CG unrolled. The forwards differ only in what
_ImplicitForward asks of them: their operator for a batch of parameters,
the parameters' cotangents, and their layout. On the card the forward and
adjoint solves of a problem replay one captured CG loop (cg.pcg with
params).
Every solve records its iterations, convergence and host time in the
problem's SolveStats, and runs in the span "forward.solve" or
"forward.adjoint" (utils/timing.span: on the profiler's timeline while one
records).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from stan_tpu_torch.core.model import FEModel
from stan_tpu_torch.fem import kernels, stencil, structured
from stan_tpu_torch.fem.operator import (StiffnessOperator, build_operator,
                                         default_dtype)
from stan_tpu_torch.infer import hmc
from stan_tpu_torch.parallel import distributed
from stan_tpu_torch.parallel.distributed import DeviceMesh, Slabs
from stan_tpu_torch.parallel.sharded_stencil import halo_pad_rows
from stan_tpu_torch.solvers import cg as cg_mod
from stan_tpu_torch.utils.timing import span


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


def d_matrix_from_lame(lam: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Isotropic 6x6 D [..., 6, 6] from (λ, μ) of one shape [...]."""
    lam, mu = torch.broadcast_tensors(torch.as_tensor(lam),
                                      torch.as_tensor(mu))
    eye3 = torch.eye(3, dtype=lam.dtype, device=lam.device)
    top = lam[..., None, None] + 2.0 * mu[..., None, None] * eye3
    zero = torch.zeros_like(top)
    return torch.cat([torch.cat([top, zero], dim=-1),
                      torch.cat([zero, mu[..., None, None] * eye3], dim=-1)],
                     dim=-2)


@dataclasses.dataclass
class SolveStats:
    """Counts over every solve a forward problem has run; each chain of a
    chain-batched solve counts as one solve. ``*_loop_iters`` counts the
    iterations of the batched CG loops themselves (the most any chain of
    that solve took), which is what the card runs.

    The forwards of a problem placed on a mesh (build_row_forwards) share
    one SolveStats: each row solves its own block of chains, so the
    per-chain counts (solves, iterations, unconverged) are those of the
    same chains without a mesh, and ``*_loop_iters`` sums the rows'
    loops.

    ``*_calls`` counts the batched pcg calls, ``*_ns`` their host time and
    ``*_wait_ns`` the part of it blocked in the host reads of the norms
    (CGResult.wall_ns, wait_ns), ``*_reads`` those reads and ``*_frozen``
    the iterations a replayed block ran after the slowest chain's stop
    (CGResult.reads, frozen); on a mesh they sum the rows' calls too. All
    stay integers, so SummedSolveStats sums them exactly."""

    forward_solves: int = 0
    forward_iters: int = 0
    forward_unconverged: int = 0
    forward_loop_iters: int = 0
    adjoint_solves: int = 0
    adjoint_iters: int = 0
    adjoint_unconverged: int = 0
    adjoint_loop_iters: int = 0
    forward_calls: int = 0
    adjoint_calls: int = 0
    forward_ns: int = 0
    adjoint_ns: int = 0
    forward_wait_ns: int = 0
    adjoint_wait_ns: int = 0
    forward_reads: int = 0
    adjoint_reads: int = 0
    forward_frozen: int = 0
    adjoint_frozen: int = 0

    def record(self, kind: str, res: cg_mod.CGResult) -> None:
        """Add one chain-batched pcg result under kind "forward" or
        "adjoint"."""
        add = {"solves": len(res.iters), "iters": int(res.iters.sum()),
               "unconverged": int((~res.converged).sum()),
               "loop_iters": int(res.iters.max()), "calls": 1,
               "ns": res.wall_ns, "wait_ns": res.wait_ns,
               "reads": res.reads, "frozen": res.frozen}
        for key, n in add.items():
            name = f"{kind}_{key}"
            setattr(self, name, getattr(self, name) + n)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def since(self, before: dict) -> dict:
        """The counts added since ``before`` (an earlier ``as_dict()``)."""
        return {k: v - before[k] for k, v in self.as_dict().items()}


class SummedSolveStats(SolveStats):
    """The SolveStats of a problem placed on a mesh that spans several
    processes: each process counts the solves of its own rows, and
    ``as_dict`` reports the counts summed over the processes (a
    collective: every process reports at the same points), so the
    per-chain counts are those of one process."""

    def as_dict(self) -> dict:
        counts = super().as_dict()
        summed = distributed.all_sum(torch.tensor(list(counts.values()),
                                                  dtype=torch.int64))
        return dict(zip(counts, summed.tolist()))


@dataclasses.dataclass(frozen=True, kw_only=True)
class _ImplicitForward:
    """What the three single-device forwards share: the CG settings, the
    SolveStats, one chain-batched PCG and the implicitly differentiable
    solve (_ImplicitSolve). Each forward supplies its operator and layout:

    - system(*params) -> (matvec, diag): the masked SPD action M K(p) (M u)
      + (I - M) u and its Jacobi diagonal for one chain batch of
      parameters p. _pcg hands pcg the system and the parameters: on the
      card it builds the matvec once on static copies of p and replays it
      as a CUDA graph for every p of that layout (solvers/cg.py), so the
      matvec reads p from device memory and never on the host;
    - param_grads(params, w, Mu): the cotangents of p, -⟨w, ∂K/∂p Mu⟩ per
      chain, from the masked adjoint w and the masked solution Mu;
    - homogeneous(lam, mu, s): solve's arguments for one material (λ, μ
      [B]) over every element and the unit load scaled by s [B];
    - free_mask, f0, to_flat (the layout -> [..., nnode, 3]) and obs_index
      (the index of (node, dir) observations into the layout).
    """

    cg_tol: float
    cg_maxiter: int
    stats: SolveStats = dataclasses.field(default_factory=SolveStats)

    @property
    def dtype(self):
        return self.f0.dtype

    @property
    def device(self):
        return self.f0.device

    @property
    def ndof(self) -> int:
        return self.free_mask.numel()

    def _pcg(self, params, rhs) -> cg_mod.CGResult:
        return cg_mod.pcg(self.system, rhs, params=params, tol=self.cg_tol,
                          maxiter=self.cg_maxiter, ndof=self.ndof,
                          batched=True)

    def _solve(self, f, *params) -> torch.Tensor:
        if f is None:
            f = self.f0.expand(params[0].shape[0], *self.f0.shape)
        return _ImplicitSolve.apply(self, f, *params)


class _ImplicitSolve(torch.autograd.Function):
    """u = A(p)⁻¹ (M f), A = M K(p) M + (I - M), chain-batched, for the
    parameters p of any single-device forward (prob.system).

    Backward: w = A⁻¹ (M ū) (the adjoint solve; A is symmetric), then
    ∂/∂f = M w and ∂/∂p = -⟨M w, ∂K/∂p (M u)⟩ per chain (prob.param_grads).
    u vanishes on the fixed DOFs whatever p is, so masking the cotangent
    changes no gradient. Both solves record their iterations and
    convergence in the problem's SolveStats.
    """

    @staticmethod
    def forward(ctx, prob, f, *params):
        with span("forward.solve"):
            res = prob._pcg(params, (prob.free_mask * f).contiguous())
        prob.stats.record("forward", res)
        ctx.save_for_backward(res.u, *params)
        ctx.prob = prob
        return res.u

    @staticmethod
    def backward(ctx, ct):
        u, *params = ctx.saved_tensors
        prob = ctx.prob
        m = prob.free_mask
        with span("forward.adjoint"):
            res = prob._pcg(params, (m * ct).contiguous())
        prob.stats.record("adjoint", res)
        w = m * res.u
        grads = (None,) * len(params)
        if any(ctx.needs_input_grad[2:]):
            grads = prob.param_grads(params, w, m * u)
        return None, (w if ctx.needs_input_grad[1] else None), *grads


class _NodeGrid:
    """The layout of the structured forwards: [..., 3, nnx, nny, nnz]."""

    def to_flat(self, u_grid: torch.Tensor) -> torch.Tensor:
        """[..., 3, nnx, nny, nnz] -> [..., nnode, 3]."""
        return u_grid.movedim(-4, -1).reshape(*u_grid.shape[:-4], -1, 3)

    def obs_index(self, nodes: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        """(dir, i, j, k) of each observation (meshgen numbering: node =
        i*nny*nnz + j*nnz + k)."""
        _, nny, nnz = self.node_shape
        return np.stack([dirs, nodes // (nny * nnz), (nodes // nnz) % nny,
                         nodes % nnz])


@dataclasses.dataclass(frozen=True)
class StencilForwardProblem(_NodeGrid, _ImplicitForward):
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

    def system(self, lam: torch.Tensor, mu: torch.Tensor) -> tuple:
        """The masked action and diagonal on grids [B, 3, X, Y, Z]."""
        m = self.free_mask

        def matvec(u):
            return m * stencil.theta_apply(self.tables2, lam, mu, m * u) \
                + (1.0 - m) * u

        w = (lam.shape[0],) + (1,) * 4
        return matvec, m * (lam.view(w) * self.d_lam
                            + mu.view(w) * self.d_mu) + (1.0 - m)

    def param_grads(self, params, w, Mu) -> tuple:
        g_lam, g_mu = stencil.theta_coef_grads(self.tables2, w, Mu)
        return -g_lam, -g_mu

    def homogeneous(self, lam, mu, s) -> tuple:
        return lam, mu, self.f0 * s.view(-1, 1, 1, 1, 1)

    def solve(self, lam: torch.Tensor, mu: torch.Tensor,
              f: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Solve K(λ_b, μ_b) u_b = M f_b for every chain, implicitly
        differentiable in λ, μ ([B], the problem's dtype) and f ([B, 3, X,
        Y, Z]; None: the unit load for every chain). Returns u [B, 3, X, Y,
        Z]."""
        return self._solve(f, lam, mu)


@dataclasses.dataclass(frozen=True)
class ForwardProblem(_ImplicitForward):
    """θ -> u forward model on the general gather/scatter operator, for any
    mesh: the geometry (conn, dN, detJw, masks) of op0 is fixed and the
    per-element D_e varies. solve(D_e [B, E, 6, 6], f [B, nnode, 3]) is
    implicitly differentiable in D_e and f: per element ∂/∂D_e = -Σ_g detJ
    w_g ε(M w)_g ε(M u)_gᵀ, the derivative of -⟨M w, K(D)(M u)⟩."""

    op0: StiffnessOperator  # geometry carrier; its D is replaced per solve
    f0: torch.Tensor  # [nnode, 3] unit load vector

    @property
    def nelem(self) -> int:
        return self.op0.conn.shape[0]

    @property
    def free_mask(self) -> torch.Tensor:
        return self.op0.free_mask

    def to_flat(self, u: torch.Tensor) -> torch.Tensor:
        return u

    def obs_index(self, nodes: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        return np.stack([nodes, dirs])

    def system(self, D_e: torch.Tensor) -> tuple:
        """The masked action and diagonal of op0 with D_e [B, E, 6, 6] (it
        shares op0's int32 indices)."""
        op = self.op0.with_D(D_e)
        return op.apply, op.diagonal()

    def param_grads(self, params, w, Mu) -> tuple:
        op = self.op0
        eps_w = kernels.strain_at_gauss(op.dN, op.gather(w))
        eps_u = kernels.strain_at_gauss(op.dN, op.gather(Mu))
        return (-torch.einsum("...egi,...egj,eg->...eij", eps_w, eps_u,
                              op.detJw),)

    def homogeneous(self, lam, mu, s) -> tuple:
        D = d_matrix_from_lame(lam, mu)  # [B, 6, 6]
        return (D[:, None].expand(-1, self.nelem, 6, 6),
                self.f0 * s.view(-1, 1, 1))

    def solve(self, D_e: torch.Tensor, f: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
        """Solve K(D_e) u = M f: D_e [E, 6, 6] and f [nnode, 3] give u
        [nnode, 3]; D_e [B, E, 6, 6] and f [B, nnode, 3] give B solves, u
        [B, nnode, 3]. f None: the unit load."""
        if D_e.dim() == 3:
            return self.solve(D_e[None], None if f is None else f[None])[0]
        return self._solve(f, D_e)


@dataclasses.dataclass(frozen=True)
class StructuredFieldForwardProblem(_NodeGrid, _ImplicitForward):
    """θ -> u forward model with per-element Lamé fields on the structured
    operator (fem/structured.py): a heterogeneous material on a structured
    HEX8 grid, which the stencil forward cannot take. solve(λ_e, μ_e, f) is
    implicitly differentiable in the fields and f: per element ∂/∂λ_e =
    -⟨(M w)_e, ke_λ (M u)_e⟩ and ∂/∂μ_e the same with ke_μ."""

    op0: structured.StructuredOperator  # geometry; lam_e, mu_e replaced
    f0: torch.Tensor  # [3, nnx, nny, nnz] unit load grid

    @property
    def node_shape(self):
        return self.op0.node_shape

    @property
    def nelems(self):
        return self.op0.nelems

    @property
    def free_mask(self) -> torch.Tensor:
        return self.op0.free_mask

    def system(self, lam_e: torch.Tensor, mu_e: torch.Tensor) -> tuple:
        """The masked action and diagonal with the fields [B, nx, ny, nz]."""
        op = dataclasses.replace(self.op0, lam_e=lam_e, mu_e=mu_e)
        return op.apply, op.diagonal()

    def param_grads(self, params, w, Mu) -> tuple:
        f2 = self.op0.unit_products(Mu)  # [B, 2, 24, nx, ny, nz]
        w_e = self.op0.gather_elements(w)  # [B, 24, nx, ny, nz]
        return -(w_e * f2[:, 0]).sum(dim=1), -(w_e * f2[:, 1]).sum(dim=1)

    def homogeneous(self, lam, mu, s) -> tuple:
        shape = (lam.shape[0], *self.nelems)
        return (lam.view(-1, 1, 1, 1).expand(shape),
                mu.view(-1, 1, 1, 1).expand(shape),
                self.f0 * s.view(-1, 1, 1, 1, 1))

    def solve(self, lam_e: torch.Tensor, mu_e: torch.Tensor,
              f: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Solve K(λ_e, μ_e) u = M f on the grid: fields [nx, ny, nz] and f
        [3, nnx, nny, nnz] give u [3, nnx, nny, nnz]; fields [B, nx, ny,
        nz] and f [B, 3, nnx, nny, nnz] give B solves. f None: the unit
        load."""
        if lam_e.dim() == 3:
            return self.solve(lam_e[None], mu_e[None],
                              None if f is None else f[None])[0]
        return self._solve(f, lam_e, mu_e)


@dataclasses.dataclass(frozen=True)
class ShardedStencilForwardProblem:
    """The stencil forward on a chains x domain device mesh.

    Port of the reference's ShardedStencilForwardProblem. The grid is cut
    into x-slabs over the mesh's domain axis, the chains into one block per
    row of its chains axis, and one batched CG loop runs every row (a chain that has
    converged is frozen, so each keeps its own count, as the reference's
    sync_axes gives it):

      * the slab matvec is M K(λ, μ) (M u) + (I - M) u with the halo planes
        of sharded_stencil.halo_pad_rows and one theta sweep per slab
        (stencil.theta_apply_padded, flags (slab == first, slab == last)):
        what the reference's slab_theta_apply computes, on the kernel of
        csrc/theta_sweep.cu on the card;
      * the gradient comes from an adjoint solve with the same operator,
        as _ImplicitSolve's: with w the masked adjoint, ∂/∂s = ⟨w, f0⟩ and
        ∂/∂λ = -⟨w, K_λ(M u)⟩, ∂/∂μ = -⟨w, K_μ(M u)⟩, each slab's share
        over its own nodes with the haloed u, summed over the domain (the
        reference's psum); the prior is added once.

    The grids (free_mask, d_lam, d_mu, f0) are whole, on the mesh's home
    device; their slabs are placed on the mesh once. Over several processes
    each solves its own blocks, and every process gets the whole value and
    gradient (Slabs.dot), so SolveStats counts every chain on every
    process.
    """

    tables_lam: dict  # {sig: {offset: 3x3}} unit-λ signature tables
    tables_mu: dict
    tables2: torch.Tensor  # pack_theta_tables(tables_lam, tables_mu)
    free_mask: torch.Tensor  # [3, NNX, NNY, NNZ]
    d_lam: torch.Tensor
    d_mu: torch.Tensor
    f0: torch.Tensor
    node_shape: tuple
    cg_tol: float
    cg_maxiter: int
    mesh: DeviceMesh
    stats: SolveStats = dataclasses.field(default_factory=SolveStats)

    @property
    def dtype(self):
        return self.f0.dtype

    @property
    def device(self):
        return self.f0.device

    @property
    def ndev(self) -> int:
        return self.mesh.shape["domain"]

    def to_flat(self, u_grid: torch.Tensor) -> torch.Tensor:
        """[..., 3, nnx, nny, nnz] -> [..., nnode, 3]."""
        return u_grid.movedim(-4, -1).reshape(*u_grid.shape[:-4], -1, 3)

    @functools.cached_property
    def _slabs(self) -> dict:
        split = functools.partial(self.mesh.split, axis=1)
        return {"m": split(self.free_mask), "d_lam": split(self.d_lam),
                "d_mu": split(self.d_mu), "f0": split(self.f0),
                "tables2": self.mesh.replicate(self.tables2)}

    def _per_chain(self, v: torch.Tensor) -> Slabs:
        """v [C] as chain-batched blocks [B_r, 1, 1, 1, 1] on the mesh."""
        rows = self.mesh.shape["chains"]
        if v.shape[0] % rows:
            raise ValueError(f"{v.shape[0]} chains do not divide over {rows} "
                             f"mesh rows")
        return self.mesh.split(v.reshape(-1, 1, 1, 1, 1), None, chains=True)

    def _sweeps(self, coef: torch.Tensor, u: Slabs, masked: bool) -> Slabs:
        """Per chain coef[c, 0]·K_λ(M u) + coef[c, 1]·K_μ(M u) on every slab
        this process owns (coef [C, 2]); with `masked`, the masked SPD
        action M K (M u) + (I - M) u."""
        coefs = self.mesh.per_chain(coef.contiguous())
        masks_rows = self._slabs["m"].parts
        ups = halo_pad_rows(self.mesh, masks_rows, u.parts)
        out = []
        for masks, t2s, cs, uprow, us in zip(masks_rows,
                                             self._slabs["tables2"], coefs,
                                             ups, u.parts):
            n = len(us)
            row = []
            for s, (m, t2, c, up, u_s) in enumerate(zip(masks, t2s, cs,
                                                        uprow, us)):
                if up is None:
                    row.append(None)
                    continue
                ku = stencil.theta_apply_padded(t2, c, up, s == 0, s == n - 1)
                row.append(m * ku + (1.0 - m) * u_s if masked else ku)
            out.append(row)
        return u.like(out)

    def _pcg(self, lam, mu, rhs: Slabs) -> cg_mod.CGResult:
        coef = torch.stack([lam, mu], dim=-1)
        sl = self._slabs
        diag = sl["m"] * (self._per_chain(lam) * sl["d_lam"]
                          + self._per_chain(mu) * sl["d_mu"]) + (1.0 - sl["m"])
        return cg_mod.pcg(lambda u: self._sweeps(coef, u, True), rhs,
                          diag=diag, tol=self.cg_tol, maxiter=self.cg_maxiter,
                          ndof=int(3 * np.prod(self.node_shape)),
                          batched=True, dot=Slabs.dot)

    def _solve(self, lam, mu, s) -> Slabs:
        """u of every chain for (λ, μ, load scale) [C] each, recorded in
        stats."""
        sl = self._slabs
        with span("forward.solve"):
            res = self._pcg(lam, mu,
                            sl["m"] * (self._per_chain(s) * sl["f0"]))
        self.stats.record("forward", res)
        return res.u

    def _loglik_grads(self, lam, mu, u: Slabs, g_v, obs):
        """(∂/∂λ, ∂/∂μ, ∂/∂s) of Σ_c g_v[c]·loglik_c, [C] each, from one
        adjoint solve."""
        w_obs, y_obs, sig2 = obs
        m = self._slabs["m"]
        ct = self._per_chain(-g_v / sig2) * (w_obs * (u - y_obs))
        with span("forward.adjoint"):
            res = self._pcg(lam, mu, m * ct)
        self.stats.record("adjoint", res)
        w = m * res.u
        one, nil = torch.ones_like(lam), torch.zeros_like(lam)
        g_lam = -w.dot(self._sweeps(torch.stack([one, nil], -1), u, False))
        g_mu = -w.dot(self._sweeps(torch.stack([nil, one], -1), u, False))
        return g_lam, g_mu, w.dot(self._slabs["f0"])

    def make_batched_logp_grad(self, w_grid, y_grid, sigma_obs: float,
                               theta_to_material: Callable,
                               prior_logp: Callable) -> Callable:
        """logp_grad_b: θ [C, D] -> (log posterior [C], gradient [C, D]) for
        hmc.run_chains. theta_to_material: θ [C, D] -> (λ, μ, load scale),
        [C] each; prior_logp: θ [C, D] -> [C]. w_grid / y_grid: [3, NNX,
        NNY, NNZ] observation mask and values. A non-finite value becomes
        -inf with a zero gradient (hmc.guarded_logp_grad_b)."""
        grid = functools.partial(torch.as_tensor, dtype=self.dtype,
                                 device=self.device)
        obs = (self.mesh.split(grid(np.asarray(w_grid)), 1),
               self.mesh.split(grid(np.asarray(y_grid)), 1),
               float(sigma_obs) ** 2)

        def logp(theta):
            lam, mu, s = (t.to(self.dtype) for t in theta_to_material(theta))
            return (_ShardedLogLik.apply(lam, mu, s, self, obs)
                    + prior_logp(theta))

        return hmc.guarded_logp_grad_b(logp)

    def solve_batched(self, thetas: torch.Tensor,
                      theta_to_material: Callable) -> torch.Tensor:
        """Per-chain displacement grids u [C, 3, NNX, NNY, NNZ] on the
        problem's device, by the same sharded solve (forward only)."""
        with torch.no_grad():
            lam, mu, s = (t.to(self.dtype)
                          for t in theta_to_material(thetas))
            return self._solve(lam, mu, s).gather(self.device)


class _ShardedLogLik(torch.autograd.Function):
    """(λ, μ, s) [C] -> loglik [C] = -Σ w (u - y)² / (2 σ²) over every slab,
    u the sharded solve; backward: one adjoint solve
    (ShardedStencilForwardProblem._loglik_grads)."""

    @staticmethod
    def forward(ctx, lam, mu, s, prob, obs):
        w_obs, y_obs, sig2 = obs
        u = prob._solve(lam, mu, s)
        d = u - y_obs
        ctx.save_for_backward(lam, mu)
        ctx.u, ctx.prob, ctx.obs = u, prob, obs
        return -0.5 * (w_obs * d).dot(d) / sig2

    @staticmethod
    def backward(ctx, g_v):
        lam, mu = ctx.saved_tensors
        g_lam, g_mu, g_s = ctx.prob._loglik_grads(lam, mu, ctx.u, g_v,
                                                  ctx.obs)
        return g_lam, g_mu, g_s, None, None


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


def build_sharded_stencil_forward(
        model: FEModel, mesh: DeviceMesh, *, dtype=None,
        cg_tol: float = 1.0e-8, cg_maxiter: int = 0) -> Optional[ShardedStencilForwardProblem]:
    """The stencil forward on `mesh` (whole grids on its home device), or
    None if the model does not qualify: a structured HEX8 grid whose NNX the
    domain axis divides (the slab contract of parallel/sharded_stencil)."""
    pieces = _stencil_forward_pieces(model, dtype or default_dtype(),
                                     mesh.home)
    if pieces is None:
        return None
    base, tables_lam, tables_mu, d_lam, d_mu, f0 = pieces
    if base.node_shape[0] % mesh.shape["domain"]:
        return None
    if cg_maxiter == 0:
        cg_maxiter = _default_infer_maxiter(model.nnode)
    return ShardedStencilForwardProblem(
        tables_lam=tables_lam, tables_mu=tables_mu,
        tables2=stencil.pack_theta_tables(tables_lam, tables_mu, base.dtype,
                                          base.device),
        free_mask=base.free_mask.contiguous(), d_lam=d_lam.contiguous(),
        d_mu=d_mu.contiguous(), f0=f0, node_shape=base.node_shape,
        cg_tol=cg_tol, cg_maxiter=cg_maxiter, mesh=mesh)


def build_structured_field_forward(
        model: FEModel, *, dtype=None, device="cuda", cg_tol: float = 1.0e-8,
        cg_maxiter: int = 0) -> Optional[StructuredFieldForwardProblem]:
    """Build the per-element-field forward model, or None if the mesh is
    not a structured HEX8 grid in meshgen order. op0 holds the model's own
    Lamé fields."""
    base = structured.build_structured_operator(model, dtype=dtype,
                                                device=device)
    if base is None:
        return None
    f0 = base.to_grid(torch.as_tensor(model.load_vector(), dtype=base.dtype,
                                      device=base.device)).contiguous()
    if cg_maxiter == 0:
        cg_maxiter = _default_infer_maxiter(model.nnode)
    return StructuredFieldForwardProblem(op0=base, f0=f0, cg_tol=cg_tol,
                                         cg_maxiter=cg_maxiter)


def build_forward(model: FEModel, *, dtype=None, device="cuda",
                  cg_tol: float = 1.0e-8, cg_maxiter: int = 0,
                  prefer_stencil: bool = True):
    """Build the θ -> u forward model, routed as the reference routes it:
    with prefer_stencil, a homogeneous material (one (E, ν) over the
    elements) on a structured HEX8 grid takes the stencil forward, any
    other structured grid the per-element-field forward; everything else,
    and prefer_stencil=False, the general forward (ForwardProblem).

    Raises ValueError if an element's material id is missing from
    model.materials (the reference skips such ids in its homogeneity test
    and may then take the stencil path, which ignores the material
    table)."""
    dtype = dtype or default_dtype()
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
    kw = dict(dtype=dtype, device=device, cg_tol=cg_tol,
              cg_maxiter=cg_maxiter)
    if prefer_stencil:
        fwd = build_stencil_forward(model, **kw) if homog else None
        fwd = fwd or build_structured_field_forward(model, **kw)
        if fwd is not None:
            return fwd
    op = build_operator(model.coords, model.conn, model.elem_d_matrices(),
                        model.fix_mask(), model.formulation(), dtype=dtype,
                        device=device)
    if cg_maxiter == 0:
        cg_maxiter = _default_infer_maxiter(model.nnode)
    return ForwardProblem(
        op0=op, f0=torch.as_tensor(model.load_vector(), dtype=dtype,
                                   device=op.device),
        cg_tol=cg_tol, cg_maxiter=cg_maxiter)


def build_row_forwards(model: FEModel, mesh: DeviceMesh, **kw) -> list:
    """build_forward(model, **kw) on each distinct first device of the
    mesh's rows that this process owns (mesh.devices[r, 0], in row order:
    one forward for a mesh of ["cpu"] * n or [cuda:0] * n), each routed
    alike; they share one SolveStats, summed over the processes when the
    mesh spans several (SummedSolveStats)."""
    devices = list(dict.fromkeys(mesh.devices[r, 0]
                                 for r in mesh.local_rows()))
    fwds = [build_forward(model, device=d, **kw) for d in devices]
    stats = SummedSolveStats() if mesh.spmd else fwds[0].stats
    return [dataclasses.replace(f, stats=stats) for f in fwds]


def solve_theta(fwd, theta: torch.Tensor) -> torch.Tensor:
    """θ [B, 3] = (log E, ν, log s) rows -> displacements in the forward's
    layout, differentiable in θ: grids [B, 3, X, Y, Z] for the stencil and
    field forwards, [B, nnode, 3] for the general one. The material is
    homogeneous (broadcast over the elements) and the load is scaled by
    s."""
    lam, mu = lame_from_E_nu(torch.exp(theta[:, 0]), theta[:, 1])
    lam, mu = lam.to(fwd.dtype), mu.to(fwd.dtype)
    s = torch.exp(theta[:, 2]).to(fwd.dtype)
    return fwd.solve(*fwd.homogeneous(lam, mu, s))


def displacement_fn(fwd, nelem: int) -> Callable[[torch.Tensor],
                                                 torch.Tensor]:
    """θ = (log E, ν, log load scale) -> u [nnode, 3]; θ of shape [B, 3]
    gives u [B, nnode, 3]. Serves the three forward types; nelem is kept
    for the reference's signature (the general forward reads its own)."""

    def u_of(theta):
        if theta.dim() == 1:
            return fwd.to_flat(solve_theta(fwd, theta[None]))[0]
        return fwd.to_flat(solve_theta(fwd, theta))

    return u_of
