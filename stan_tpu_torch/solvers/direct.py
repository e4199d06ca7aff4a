"""Direct dense solvers: Cholesky (LLT) and LU of the assembled masked K.

Port of stan_tpu/solvers/direct.py. The JAX package factors with
jax.scipy.linalg (cho_factor, lu_factor), library calls outside Pallas;
the port makes the matching torch.linalg calls on the matrix's device.
analysis/linear.py takes this path up to 6000 DOF and the banded host
path (solvers/banded.py) above.
"""

from __future__ import annotations

import torch


def solve_cholesky(K: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """LLT solve of the (masked, SPD) dense system; f [ndof] or [ndof,
    k]."""
    L = torch.linalg.cholesky(K)
    rhs = f if f.dim() == 2 else f[:, None]
    return torch.cholesky_solve(rhs, L).reshape(f.shape)


def solve_lu(K: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """LU solve with partial pivoting (the reference reaches it with
    LinSolver = "LU"); f [ndof] or [ndof, k]."""
    LU, pivots = torch.linalg.lu_factor(K)
    rhs = f if f.dim() == 2 else f[:, None]
    return torch.linalg.lu_solve(LU, pivots, rhs).reshape(f.shape)
