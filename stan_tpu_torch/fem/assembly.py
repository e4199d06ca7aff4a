"""Assembled global stiffness, dense and sparse, with deterministic sums.

Port of stan_tpu/fem/assembly.py. The element stiffness matrices are one
batched contraction on the device (fem/kernels.element_stiffness); their
entries are summed into K by a segment sum whose plan is computed on the
host: each distinct (row, col) gets the positions of its contributions,
in element order, padded to the largest count. The device gathers and
sums over that small axis, so every run gives the same bits (no
``index_add_``, whose atomics add in a varying order on CUDA); it is the
gather scatter of fem/operator.py applied to matrix entries.

Used by the dense direct solvers (solvers/direct.py); the CG path stays
matrix-free.
"""

from __future__ import annotations

import numpy as np
import torch

from stan_tpu_torch.fem import kernels
from stan_tpu_torch.fem.elements import ElementFormulation
from stan_tpu_torch.fem.operator import (default_dtype, node_incidence,
                                         resolve_device)


def coo_indices(conn: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Global (row, col) DOF indices for every ke entry.

    conn: i64[E, nn]. Returns (rows, cols) each i64[E, 3nn, 3nn], with DOF
    id = 3 * node_index + direction.
    """
    E, nn = conn.shape
    dof = (3 * conn[:, :, None] + np.arange(3)[None, None, :]).reshape(E, 3 * nn)
    rows = np.broadcast_to(dof[:, :, None], (E, 3 * nn, 3 * nn))
    cols = np.broadcast_to(dof[:, None, :], (E, 3 * nn, 3 * nn))
    return rows, cols


def _summed_entries(coords, conn, D_e, form, dtype, device):
    """(sorted distinct flat keys row * ndof + col on the host, their summed
    values on the device)."""
    conn_np = np.asarray(conn)
    ndof = 3 * int(np.asarray(coords).shape[0])
    kw = dict(dtype=dtype, device=device)
    conn_t = torch.as_tensor(conn_np, dtype=torch.int64, device=device)
    ke = kernels.element_stiffness(
        torch.as_tensor(np.asarray(coords), **kw)[conn_t],
        torch.as_tensor(np.asarray(D_e), **kw), form)  # [E, 3nn, 3nn]
    rows, cols = coo_indices(conn_np)
    keys, inv = np.unique((rows * ndof + cols).reshape(-1),
                          return_inverse=True)
    idx = torch.as_tensor(node_incidence(inv, len(keys)), device=device)
    flat = ke.reshape(-1)
    return keys, torch.cat([flat, flat.new_zeros(1)])[idx].sum(dim=1)


def assemble_dense(coords, conn, D_e, form: ElementFormulation, fix_mask=None,
                   dtype=None, device="cuda") -> torch.Tensor:
    """The full dense [ndof, ndof] stiffness matrix on ``device``.

    With fix_mask given, applies the masked-BC transform M K M + (I - M),
    so the result is SPD and solves the same system as the reference's
    reduced matrix (see fem/operator.py).
    """
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    ndof = 3 * int(np.asarray(coords).shape[0])
    keys, vals = _summed_entries(coords, conn, D_e, form, dtype, dev)
    K = torch.zeros(ndof * ndof, dtype=dtype, device=dev)
    K[torch.as_tensor(keys, device=dev)] = vals
    K = K.reshape(ndof, ndof)
    if fix_mask is not None:
        m = 1.0 - torch.as_tensor(np.asarray(fix_mask), dtype=dtype,
                                  device=dev).reshape(-1)
        K = K * m[:, None] * m[None, :] + torch.diag(1.0 - m)
    return K


def assemble_sparse(coords, conn, D_e, form: ElementFormulation,
                    fix_mask=None, dtype=None, device="cuda") -> torch.Tensor:
    """The stiffness matrix as a coalesced torch.sparse_coo_tensor (the
    port's counterpart of assemble_bcoo), masked as assemble_dense is when
    fix_mask is given: fixed rows and columns zeroed, 1 on their
    diagonal."""
    dev = resolve_device(device)
    dtype = dtype or default_dtype()
    ndof = 3 * int(np.asarray(coords).shape[0])
    keys, vals = _summed_entries(coords, conn, D_e, form, dtype, dev)
    idx = np.stack([keys // ndof, keys % ndof])
    if fix_mask is not None:
        m = 1.0 - np.asarray(fix_mask, dtype=np.float64).reshape(-1)
        vals = vals * torch.as_tensor(m[idx[0]] * m[idx[1]], dtype=dtype,
                                      device=dev)
        # fixed DOFs: their diagonal entry is 0 now; adding 1 there is the
        # reference's appended unit diagonal
        fixed = np.nonzero(m == 0.0)[0]
        idx = np.concatenate([idx, np.stack([fixed, fixed])], axis=1)
        vals = torch.cat([vals, vals.new_ones(len(fixed))])
    return torch.sparse_coo_tensor(torch.as_tensor(idx, device=dev), vals,
                                   (ndof, ndof),
                                   check_invariants=False).coalesce()
