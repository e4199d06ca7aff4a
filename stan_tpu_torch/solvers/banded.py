# Copied from stan_tpu/solvers/banded.py; imports the port's hostops and partition.
"""Banded (skyline-equivalent) direct solvers on the BFS-reduced ordering.

The reference solves medium problems with ALGLIB's SKS skyline Cholesky
(src/STAN_Solver/SolverFunctions.cs:332-444) and a sparse LU
(SolverFunctions.cs:446-516), both downstream of the bandwidth-reducing BFS
node numbering AssignDOF builds (src/STAN_Database/Database.cs:140-234).
The TPU-native rebuild keeps CG as the scalable device path (as the
reference keeps CG as its default, Analysis.cs:18) and provides this module
as the direct path for the sizes where the reference's skyline works but a
dense factorization cannot: O(ndof * hbw) banded storage and
O(ndof * hbw^2) factorization instead of O(ndof^2) / O(ndof^3).

Design (deliberately host-side):
  * the same BFS ordering that drives domain partitioning
    (parallel/partition.bfs_node_order — the rebuild's AssignDOF) doubles
    as the bandwidth reducer, exactly the role it plays in the reference;
  * assembly scatters element ke blocks straight into LAPACK
    diagonal-ordered lower-band storage, vectorized np.add.at over element
    chunks (no [ndof, ndof] intermediate ever exists);
  * factorization/solve are LAPACK banded routines (scipy cholesky_banded /
    cho_solve_banded, solve_banded for the LU variant) in float64 — the
    direct path is a small/medium-problem *latency* path and a float64
    reference, which is precisely where a host LAPACK beats shipping a
    sequential-dependency factorization onto a matmul-shaped accelerator;
  * Dirichlet DOFs stay in the system as identity rows/columns (masked
    convention of fem/operator.py — static shapes, no index shifting).

A memory assertion refuses problems whose band would not fit the
requested budget, with the reference-equivalent remedy (use CG) in the
message.

In the port too this path is float64 host LAPACK by design, as in the
reference: it is the reference's own choice for the sizes where a dense
factorization no longer fits, not a fallback from the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from stan_tpu_torch.core.model import FEModel
from stan_tpu_torch.fem import hostops
from stan_tpu_torch.parallel.partition import bfs_node_order


@dataclasses.dataclass(frozen=True)
class BandStructure:
    """BFS DOF permutation and half-bandwidth of the reordered K."""

    order: np.ndarray      # [nnode] new position -> old node id
    inv_order: np.ndarray  # [nnode] old node id -> new position
    hbw: int               # half-bandwidth in DOFs (excludes the diagonal)
    ndof: int

    def band_bytes(self, itemsize: int = 8) -> int:
        return (self.hbw + 1) * self.ndof * itemsize


def _node_bandwidth(conn: np.ndarray, inv: np.ndarray) -> int:
    pos = inv[conn]
    return int((pos.max(axis=1) - pos.min(axis=1)).max()) if len(pos) else 0


def band_structure(model: FEModel) -> BandStructure:
    """Bandwidth-reducing ordering + DOF half-bandwidth.

    Candidates: the BFS order (the rebuild's AssignDOF,
    Database.cs:140-234) and the mesh's natural order — meshgen/.bdf
    meshes often arrive already numbered cross-section-fastest, where the
    natural order beats a plain BFS; the narrower band wins. DOF numbering
    is 3*new_node + component (Node.SetDOF, Node.cs:218-223)."""
    conn = np.asarray(model.conn)
    nnode = model.nnode
    order = bfs_node_order(conn, nnode)
    inv = np.empty_like(order)
    inv[order] = np.arange(nnode)
    ident = np.arange(nnode)
    if _node_bandwidth(conn, ident) <= _node_bandwidth(conn, inv):
        order = inv = ident
    node_bw = _node_bandwidth(conn, inv)
    hbw = 3 * node_bw + 2
    return BandStructure(order=order, inv_order=inv, hbw=hbw,
                         ndof=3 * nnode)


def assemble_banded(
    model: FEModel,
    struct: Optional[BandStructure] = None,
    *,
    chunk: int = 2000,
) -> np.ndarray:
    """Assemble masked K into LAPACK lower diagonal-ordered band storage.

    Returns ab[hbw+1, ndof] float64 with ab[i, j] = K[j + i, j] (lower
    form). Fixed DOFs are identity rows/columns. Element stiffness is the
    float64 host kernel (hostops.element_stiffness_np), the same per-GP
    B^T D B quadrature as the device path (Element.cs:118-155).
    """
    if struct is None:
        struct = band_structure(model)
    ndof, hbw = struct.ndof, struct.hbw
    ab = np.zeros((hbw + 1, ndof), dtype=np.float64)

    conn = np.asarray(model.conn)
    coords = np.asarray(model.coords, np.float64)
    D_e = np.asarray(model.elem_d_matrices(), np.float64)
    form = model.formulation()
    free = (1.0 - np.asarray(model.fix_mask(), np.float64))  # [nnode, 3]

    nn = conn.shape[1]
    for e0 in range(0, len(conn), chunk):
        sl = slice(e0, e0 + chunk)
        ke = hostops.element_stiffness_np(coords[conn[sl]], D_e[sl], form)
        # DOF ids in the banded ordering and the free/fixed mask per column
        pos = struct.inv_order[conn[sl]]  # [e, nn]
        dofs = (3 * pos[:, :, None] + np.arange(3)).reshape(-1, 3 * nn)
        fr = free[conn[sl]].reshape(-1, 3 * nn)
        # Masked stiffness: fixed rows/cols dropped here, identity added at
        # the end (M K M + (I - M) of fem/operator.py, proven equivalent to
        # the reference's row/column removal in tests/test_solver.py).
        ke = ke * fr[:, :, None] * fr[:, None, :]
        I = np.broadcast_to(dofs[:, :, None], ke.shape)  # row
        J = np.broadcast_to(dofs[:, None, :], ke.shape)  # col
        low = I >= J  # lower triangle of the global K
        np.add.at(ab, (I[low] - J[low], J[low]), ke[low])

    # fix_mask is [nnode(old), 3]; map old node -> new position explicitly
    fm = np.asarray(model.fix_mask(), bool)
    old_nodes, comps = fm.nonzero()
    fixed_dofs = 3 * struct.inv_order[old_nodes] + comps
    ab[0, fixed_dofs] = 1.0
    return ab


def _check_memory(struct: BandStructure, max_band_bytes: int) -> None:
    need = struct.band_bytes()
    if need > max_band_bytes:
        raise MemoryError(
            f"banded factorization needs {need / 1e9:.2f} GB "
            f"(half-bandwidth {struct.hbw}, ndof {struct.ndof}) "
            f"> budget {max_band_bytes / 1e9:.2f} GB; "
            f"use the CG solver for this problem size "
            f"(Analysis.LinSolver='CG', the reference default)")


def solve_banded_cholesky(
    model: FEModel,
    f: Optional[np.ndarray] = None,
    *,
    max_band_bytes: int = 4 << 30,
) -> np.ndarray:
    """Direct LLT solve K u = f via banded Cholesky. Returns u[nnode, 3].

    Skyline-equivalent of LinearSolver_Cholesky
    (SolverFunctions.cs:332-444): factor once, one triangular solve pair.
    """
    from scipy.linalg import cho_solve_banded, cholesky_banded

    struct = band_structure(model)
    _check_memory(struct, max_band_bytes)
    ab = assemble_banded(model, struct)
    cb = cholesky_banded(ab, lower=True)
    u = _solve_rhs(model, struct,
                   lambda b: cho_solve_banded((cb, True), b), f)
    return u


def solve_banded_lu(
    model: FEModel,
    f: Optional[np.ndarray] = None,
    *,
    max_band_bytes: int = 4 << 30,
) -> np.ndarray:
    """Direct banded-LU solve (partial pivoting), the sparse-LU-equivalent
    path (SolverFunctions.cs:446-516). K is symmetric here, so this is a
    cross-check of the LLT path more than a necessity — kept for parity
    with the reference's programmatic LinSolver="LU" (Solver.cs:164)."""
    from scipy.linalg import solve_banded

    struct = band_structure(model)
    # gbsv needs kl+ku+1 rows plus kl fill rows: ~3x the LLT band
    need = (3 * struct.hbw + 1) * struct.ndof * 8
    if need > max_band_bytes:
        raise MemoryError(
            f"banded LU needs {need / 1e9:.2f} GB > budget "
            f"{max_band_bytes / 1e9:.2f} GB; use CG")
    ab_low = assemble_banded(model, struct)
    hbw, ndof = struct.hbw, struct.ndof
    # Expand the symmetric lower band to full general-band storage
    # ab_full[ku + i - j, j] = K[i, j] with kl = ku = hbw.
    ab_full = np.zeros((2 * hbw + 1, ndof), dtype=np.float64)
    ab_full[hbw:, :] = ab_low  # lower triangle incl. diagonal
    for k in range(1, hbw + 1):  # mirror to the upper triangle
        ab_full[hbw - k, k:] = ab_low[k, :-k]
    u = _solve_rhs(model, struct,
                   lambda b: solve_banded((hbw, hbw), ab_full, b), f)
    return u


def _solve_rhs(model: FEModel, struct: BandStructure, solve, f) -> np.ndarray:
    """Permute RHS into band order, solve, un-permute; fixed DOFs -> 0."""
    if f is None:
        f = model.load_vector()
    f = np.asarray(f, np.float64).reshape(model.nnode, 3)
    free = 1.0 - np.asarray(model.fix_mask(), np.float64)
    b = np.zeros(struct.ndof)
    dofs = (3 * struct.inv_order[:, None] + np.arange(3))
    b[dofs.reshape(-1)] = (free * f).reshape(-1)
    x = solve(b)
    u = x[dofs]  # [nnode, 3] back in model node order
    return u * free  # identity rows give exactly b=0 there; keep it exact
