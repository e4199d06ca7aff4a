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
from stan_tpu_torch.fem.stencil import StencilOperator, pack_tables
from stan_tpu_torch.fem.structured import StructuredOperator


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
