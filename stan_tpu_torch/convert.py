"""Build the port's operators from the JAX package's operator arrays.

Each function takes the fields of a stan_tpu operator as numpy arrays
(``np.asarray`` on the JAX arrays) and returns the port's operator holding
the same numbers, so both packages compute from identical inputs. Nothing
here imports jax. ``dtype=None`` keeps the arrays' own float dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from stan_tpu_torch.fem.operator import (StiffnessOperator, node_incidence,
                                         resolve_device)
from stan_tpu_torch.fem.stencil import (StencilOperator, pack_tables,
                                        pack_theta_tables)
from stan_tpu_torch.fem.structured import StructuredOperator
from stan_tpu_torch.infer.forward import (ForwardProblem,
                                          ShardedStencilForwardProblem,
                                          StencilForwardProblem,
                                          StructuredFieldForwardProblem)
from stan_tpu_torch.parallel.distributed import DeviceMesh
from stan_tpu_torch.parallel.sharded import ShardedOperator
from stan_tpu_torch.parallel.sharded_stencil import ShardedStencilOperator


def _float(a, dtype, device) -> torch.Tensor:
    # np.array copies: arrays from JAX are read-only views.
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def stiffness_operator_from_numpy(conn, dN, detJw, D, free_mask, nnode, form,
                                  inc_idx=None, *, device="cuda",
                                  dtype=None) -> StiffnessOperator:
    """StiffnessOperator from stan_tpu.fem.operator.StiffnessOperator's
    fields; inc_idx None builds the incidence map from conn."""
    dev = resolve_device(device)
    conn = np.array(conn)
    if inc_idx is None:
        inc_idx = node_incidence(conn, int(nnode))
    return StiffnessOperator(
        conn=torch.as_tensor(conn, dtype=torch.int64, device=dev),
        dN=_float(dN, dtype, dev),
        detJw=_float(detJw, dtype, dev),
        D=_float(D, dtype, dev),
        free_mask=_float(free_mask, dtype, dev),
        nnode=int(nnode),
        form=form,
        inc_idx=torch.as_tensor(np.array(inc_idx), dtype=torch.int64,
                                device=dev),
    )


def structured_operator_from_numpy(nelems, ke_lam, ke_mu, lam_e, mu_e,
                                   free_mask, form, *, device="cuda",
                                   dtype=None) -> StructuredOperator:
    """StructuredOperator from stan_tpu.fem.structured.StructuredOperator's
    fields."""
    dev = resolve_device(device)
    return StructuredOperator(
        nelems=tuple(int(n) for n in nelems),
        ke_lam=_float(ke_lam, dtype, dev),
        ke_mu=_float(ke_mu, dtype, dev),
        lam_e=_float(lam_e, dtype, dev),
        mu_e=_float(mu_e, dtype, dev),
        free_mask=_float(free_mask, dtype, dev),
        form=form,
    )


def stencil_operator_from_numpy(base: StructuredOperator, tables: dict
                                ) -> StencilOperator:
    """StencilOperator over a port StructuredOperator (e.g. from
    structured_operator_from_numpy) and stan_tpu.fem.stencil's
    {sig: {offset: 3x3 float64}} tables, in the base operator's dtype and
    device."""
    return StencilOperator(base=base, tables=tables,
                           table=pack_tables(tables, base.dtype, base.device))


def stencil_forward_from_numpy(free_mask, d_lam, d_mu, f0, tables_lam,
                               tables_mu, node_shape, cg_tol, cg_maxiter, *,
                               device="cuda", dtype=None
                               ) -> StencilForwardProblem:
    """StencilForwardProblem from stan_tpu.infer.forward.
    StencilForwardProblem's fields: the four grids as numpy arrays and the
    unit-λ / unit-μ tables as {sig: {offset: 3x3 float64}}
    (stan_tpu.fem.stencil._thaw_tables of ft_lam / ft_mu)."""
    dev = resolve_device(device)
    grids = [_float(a, dtype, dev).contiguous()
             for a in (free_mask, d_lam, d_mu, f0)]
    return StencilForwardProblem(
        tables_lam=tables_lam, tables_mu=tables_mu,
        tables2=pack_theta_tables(tables_lam, tables_mu, grids[3].dtype, dev),
        free_mask=grids[0], d_lam=grids[1], d_mu=grids[2], f0=grids[3],
        node_shape=tuple(int(n) for n in node_shape), cg_tol=float(cg_tol),
        cg_maxiter=int(cg_maxiter))


def forward_problem_from_numpy(op0: StiffnessOperator, f0, cg_tol, cg_maxiter
                               ) -> ForwardProblem:
    """ForwardProblem from stan_tpu.infer.forward.ForwardProblem's fields:
    op0 the port's operator holding the reference's op0 (e.g. from
    stiffness_operator_from_numpy), f0 [nnode, 3] as a numpy array."""
    return ForwardProblem(op0=op0, f0=_float(f0, op0.dtype, op0.device),
                          cg_tol=float(cg_tol), cg_maxiter=int(cg_maxiter))


def field_forward_from_numpy(op0: StructuredOperator, f0, cg_tol, cg_maxiter
                             ) -> StructuredFieldForwardProblem:
    """StructuredFieldForwardProblem from stan_tpu.infer.forward.
    StructuredFieldForwardProblem's fields: op0 the port's structured
    operator holding the reference's op0 (e.g. from
    structured_operator_from_numpy), f0 [3, nnx, nny, nnz] as a numpy
    array."""
    return StructuredFieldForwardProblem(
        op0=op0, f0=_float(f0, op0.dtype, op0.device).contiguous(),
        cg_tol=float(cg_tol), cg_maxiter=int(cg_maxiter))


def _index(a, device):
    if a is None:
        return None
    return torch.as_tensor(np.array(a), dtype=torch.int64, device=device)


def sharded_stencil_operator_from_numpy(free_mask, diag, tables, ndev, *,
                                        device="cuda", dtype=None
                                        ) -> ShardedStencilOperator:
    """ShardedStencilOperator from stan_tpu.parallel.sharded_stencil.
    ShardedStencilOperator's fields: the grids as numpy arrays, tables as
    {sig: {offset: 3x3 float64}}."""
    dev = resolve_device(device)
    mask = _float(free_mask, dtype, dev).contiguous()
    return ShardedStencilOperator(
        free_mask=mask, diag=_float(diag, dtype, dev).contiguous(),
        tables=tables, table=pack_tables(tables, mask.dtype, dev),
        ndev=int(ndev))


def sharded_operator_from_numpy(conn, dN, detJw, D, free_mask, diag,
                                nnode_pad, block, form, *, inc_idx=None,
                                ring=False, conn_ext=None, inc_ext=None,
                                device="cuda", dtype=None) -> ShardedOperator:
    """ShardedOperator from stan_tpu.parallel.sharded.ShardedOperator's
    fields (inc_idx for the all-gather mode; conn_ext, inc_ext for the
    ring)."""
    dev = resolve_device(device)
    return ShardedOperator(
        conn=_index(conn, dev), dN=_float(dN, dtype, dev),
        detJw=_float(detJw, dtype, dev), D=_float(D, dtype, dev),
        free_mask=_float(free_mask, dtype, dev), diag=_float(diag, dtype, dev),
        nnode_pad=int(nnode_pad), block=int(block), form=form,
        inc_idx=_index(inc_idx, dev), ring=bool(ring),
        conn_ext=_index(conn_ext, dev), inc_ext=_index(inc_ext, dev))


def sharded_stencil_forward_from_numpy(free_mask, d_lam, d_mu, f0, tables_lam,
                                       tables_mu, node_shape, cg_tol,
                                       cg_maxiter, mesh: DeviceMesh, *,
                                       dtype=None
                                       ) -> ShardedStencilForwardProblem:
    """ShardedStencilForwardProblem on `mesh` (whole grids on its home
    device) from stan_tpu.infer.forward.ShardedStencilForwardProblem's
    fields: the four grids as numpy arrays, the unit tables as {sig:
    {offset: 3x3 float64}} (stan_tpu.fem.stencil._thaw_tables of ft_lam /
    ft_mu)."""
    dev = mesh.home
    grids = [_float(a, dtype, dev).contiguous()
             for a in (free_mask, d_lam, d_mu, f0)]
    return ShardedStencilForwardProblem(
        tables_lam=tables_lam, tables_mu=tables_mu,
        tables2=pack_theta_tables(tables_lam, tables_mu, grids[3].dtype, dev),
        free_mask=grids[0], d_lam=grids[1], d_mu=grids[2], f0=grids[3],
        node_shape=tuple(int(n) for n in node_shape), cg_tol=float(cg_tol),
        cg_maxiter=int(cg_maxiter), mesh=mesh)
