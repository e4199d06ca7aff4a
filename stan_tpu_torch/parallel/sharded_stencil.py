"""Sharded stencil operator: the assembled-stencil CG over a device mesh.

Port of stan_tpu/parallel/sharded_stencil.py. The node grid's flat
numbering is x-major (meshgen: id = i*nny*nnz + j*nnz + k), so cutting the
channel-first grid [3, NNX, NNY, NNZ] on axis 1 gives each device of the
mesh's domain axis a contiguous x-slab, and the halo a 27-point stencil
needs is one boundary plane from each x-neighbour:

  * halo_pad_rows writes each slab's masked u into a buffer that already
    has its ghost layer, then copies each neighbour's masked boundary plane
    into the x ghost planes (a copy to the slab's device, or a transfer
    from another process; the global edges keep zeros, the stencil's ghost
    convention, as the reference's non-wrapping ppermute gives them);
  * stencil_sweep (csrc/stencil_sweep.cu on the card) runs on each slab
    with flags (slab == first, slab == last): the global low / high x
    faces belong to the edge slabs, and the y/z faces to every slab.

CG's dot products reduce over the slabs (distributed.Slabs.dot). NNX must
divide evenly by the domain size; callers fall back to parallel/sharded.py's
general operator otherwise. Over several processes each sweeps only its own
slabs, and a boundary plane whose neighbour another process owns crosses
through the mesh's transport (DeviceMesh.exchange): one round per apply,
the reference's two ppermutes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stan_tpu_torch.core.model import FEModel
from stan_tpu_torch.fem import stencil
from stan_tpu_torch.parallel.distributed import DeviceMesh, Move, Slabs
from stan_tpu_torch.solvers import cg as cg_mod


@dataclasses.dataclass(frozen=True)
class ShardedStencilOperator:
    """Stencil operator in the global channel-first grid layout [3, NNX,
    NNY, NNZ], cut into x-slabs over the mesh's domain axis when applied.
    The packed table covers all 27 signatures, so the reference's delta
    tables are not kept."""

    free_mask: torch.Tensor  # [3, NNX, NNY, NNZ]
    diag: torch.Tensor       # [3, NNX, NNY, NNZ] masked Jacobi diagonal
    tables: dict             # {sig: {offset: 3x3 float64}} (fem/stencil)
    table: torch.Tensor      # stencil.pack_tables(tables) in the dtype
    ndev: int


def halo_pad_rows(mesh: DeviceMesh, masks: list, us: list) -> list:
    """Every row's slabs of a mesh ([r][s] blocks, None where another
    process owns one) with their ghost layers: for slab s of u (u[s]
    [..., 3, SX, NNY, NNZ]), a buffer [..., 3, SX+2, NNY+2, NNZ+2] holding
    masks[s]·u[s] inside zero y/z ghosts, and as x ghost planes the
    neighbours' masked boundary planes (zeros at the global edges), moved
    in one exchange round."""
    ups = []
    for mrow, urow in zip(masks, us):
        row = []
        for m, u in zip(mrow, urow):
            if u is None:
                row.append(None)
                continue
            *lead, sx, ny, nz = u.shape
            up = u.new_zeros((*lead, sx + 2, ny + 2, nz + 2))
            torch.mul(m, u, out=up[..., 1:-1, 1:-1, 1:-1])
            row.append(up)
        ups.append(row)

    def plane(up, x):
        return None if up is None else up[..., x, 1:-1, 1:-1]

    moves = [mv for r, row in enumerate(ups) for s in range(1, len(row))
             for mv in (Move((r, s - 1), (r, s), plane(row[s - 1], -2),
                             plane(row[s], 0)),
                        Move((r, s), (r, s - 1), plane(row[s], 1),
                             plane(row[s - 1], -1)))]
    mesh.exchange(moves)
    return ups


@dataclasses.dataclass
class _Placed:
    """An operator's slabs on a mesh: masks and Jacobi diagonal as Slabs
    (every row the same), the packed table on each device [r][s]."""

    free_mask: Slabs
    diag: Slabs
    table: list


def _place(mesh: DeviceMesh, op: ShardedStencilOperator) -> _Placed:
    if mesh.shape["domain"] != op.ndev:
        raise ValueError(f"the operator is cut for {op.ndev} slabs, the "
                         f"mesh's domain axis has {mesh.shape['domain']}")
    return _Placed(mesh.split(op.free_mask, 1), mesh.split(op.diag, 1),
                   mesh.replicate(op.table))


def _local_apply(pl: _Placed, u: Slabs) -> Slabs:
    """Masked K·u, M K (M u) + (I - M) u, on every slab this process owns:
    halo planes, then one stencil_sweep per slab (per chain of a
    chain-batched u)."""
    ups = halo_pad_rows(u.mesh, pl.free_mask.parts, u.parts)
    out = []
    for masks, tables, uprow, us in zip(pl.free_mask.parts, pl.table, ups,
                                        u.parts):
        n = len(us)
        row = []
        for s, (m, t, up, u_s) in enumerate(zip(masks, tables, uprow, us)):
            if up is None:
                row.append(None)
                continue
            lo, hi = s == 0, s == n - 1
            f = (stencil.stencil_sweep(up, t, lo, hi) if up.dim() == 4 else
                 torch.stack([stencil.stencil_sweep(c, t, lo, hi)
                              for c in up]))
            row.append(m * f + (1.0 - m) * u_s)
        out.append(row)
    return u.like(out)


def build_sharded_stencil_operator(
    model: FEModel, ndev: int, dtype=None, device="cuda"
) -> Optional[ShardedStencilOperator]:
    """The sharded fast path's operator (its arrays on `device`), or None if
    the model does not qualify (the stencil's requirements, and NNX
    divisible by ndev)."""
    sop = stencil.build_stencil_operator(model, dtype=dtype, device=device)
    if sop is None:
        return None
    nnx = sop.node_shape[0]
    if ndev < 1 or nnx % ndev != 0:
        return None
    return ShardedStencilOperator(
        free_mask=sop.free_mask.contiguous(),
        diag=sop.diagonal().contiguous(),
        tables=sop.tables,
        table=sop.table,
        ndev=ndev,
    )


def sharded_apply(mesh: DeviceMesh, op: ShardedStencilOperator,
                  u: torch.Tensor) -> torch.Tensor:
    """Masked K·u over the mesh's first row, for u [3, NNX, NNY, NNZ];
    returns the whole result on u's device (one apply, for tests and
    benches)."""
    return _local_apply(_place(mesh, op), mesh.split(u, 1)).gather(u.device)


def _one_row(mesh: DeviceMesh) -> None:
    if mesh.shape["chains"] != 1:
        raise ValueError(f"a single solve runs on a one-row mesh, got "
                         f"{mesh.shape}")


def sharded_stencil_pcg(mesh: DeviceMesh, op: ShardedStencilOperator,
                        f: torch.Tensor, *, tol: float = 1e-6,
                        maxiter: int = 0) -> cg_mod.CGResult:
    """Jacobi PCG on the sharded stencil operator over a one-row mesh.

    f: [3, NNX, NNY, NNZ] right-hand side in grid layout. Returns the
    CGResult with u in the same layout, on f's device (the whole of it on
    every process)."""
    _one_row(mesh)
    pl = _place(mesh, op)
    ndof = int(np.prod(op.free_mask.shape))
    rhs = pl.free_mask * mesh.split(f, 1)
    res = cg_mod.pcg(lambda u: _local_apply(pl, u), rhs, diag=pl.diag,
                     tol=tol, maxiter=maxiter, ndof=ndof,
                     dot=Slabs.dot)
    return res._replace(u=res.u.gather(f.device))


def chain_batched_pcg(mesh: DeviceMesh, op: ShardedStencilOperator,
                      f: torch.Tensor, *,
                      scales: Optional[torch.Tensor] = None,
                      tol: float = 1e-6, maxiter: int = 0
                      ) -> cg_mod.CGResult:
    """Independent per-chain PCG solves of K u = s_c f_c on the chains x
    domain mesh: the chains are cut into one block per mesh row, the grid
    into x-slabs over the domain axis.

    One batched loop runs every row (cg.pcg(batched=True)): a chain that
    has converged is frozen and its count stops, so each chain keeps its
    own iterations, as the reference's sync_axes gives them.

    f: shared [3, NNX, NNY, NNZ] (then `scales` [n_chains] is required) or
    per chain [n_chains, 3, NNX, NNY, NNZ]. Returns the CGResult with u
    [n_chains, 3, NNX, NNY, NNZ] on f's device and per-chain iters,
    residual, converged and diverged arrays.
    """
    per_chain = f.dim() == 5
    if not per_chain and scales is None:
        raise ValueError("shared-f mode needs per-chain `scales`")
    n_chains = f.shape[0] if per_chain else scales.shape[0]
    if n_chains % mesh.shape["chains"]:
        raise ValueError(f"{n_chains} chains do not divide over "
                         f"{mesh.shape['chains']} mesh rows")
    f_b = f if scales is None else scales.view(n_chains, 1, 1, 1, 1) * f
    pl = _place(mesh, op)
    ndof = int(np.prod(op.free_mask.shape))
    rhs = pl.free_mask * mesh.split(f_b, 2, chains=True)
    res = cg_mod.pcg(lambda u: _local_apply(pl, u), rhs, diag=pl.diag,
                     tol=tol, maxiter=maxiter, ndof=ndof,
                     batched=True, dot=Slabs.dot)
    return res._replace(u=res.u.gather(f.device))
