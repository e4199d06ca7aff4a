# Copied from stan_tpu/fem/hostops.py (_b_matrix_np, element_stiffness_np, d_np only).
"""Host-side float64 element stiffness and isotropic D (numpy).

The port builds the structured grid's unit-Lame element stiffness
matrices from these, in float64 on the host, before moving them to the
card.
"""

from __future__ import annotations

import numpy as np

from stan_tpu_torch.fem.elements import ElementFormulation


def _b_matrix_np(dN: np.ndarray) -> np.ndarray:
    """[..., 3, nn] gradients -> [..., 6, 3*nn] B, column 3*i+j = (node i,
    dir j) exactly as fem/kernels.b_matrix / BL0_Matrix (Element.cs:297-328)."""
    nn = dN.shape[-1]
    batch = dN.shape[:-2]
    B = np.zeros((*batch, 6, 3, nn), dtype=np.float64)
    dx, dy, dz = dN[..., 0, :], dN[..., 1, :], dN[..., 2, :]
    B[..., 0, 0, :] = dx
    B[..., 1, 1, :] = dy
    B[..., 2, 2, :] = dz
    B[..., 3, 0, :] = dy
    B[..., 3, 1, :] = dx
    B[..., 4, 1, :] = dz
    B[..., 4, 2, :] = dy
    B[..., 5, 0, :] = dz
    B[..., 5, 2, :] = dx
    return B.swapaxes(-1, -2).reshape(*batch, 6, 3 * nn)


def element_stiffness_np(
    coords_e: np.ndarray, D_e: np.ndarray, form: ElementFormulation
) -> np.ndarray:
    """float64 ke[E, 3nn, 3nn] = sum_g B^T D B detJ w on host.

    Twin of fem/kernels.element_stiffness (which runs at the device dtype);
    used where a float64 K is required on a TPU session with x64 disabled.
    """
    coords_e = np.asarray(coords_e, np.float64)
    D_e = np.asarray(D_e, np.float64)
    dN_local = np.asarray(form.gauss_dN, np.float64)  # [G, 3, nn]
    w = np.asarray(form.gauss_w, np.float64)  # [G]
    J = np.einsum("gkn,enj->egkj", dN_local, coords_e)
    detJ = np.linalg.det(J)
    Jinv = np.linalg.inv(J)
    dN = np.einsum("egkl,gln->egkn", Jinv, dN_local)
    B = _b_matrix_np(dN)  # [E, G, 6, 3nn]
    detJw = detJ * w[None, :]
    return np.einsum("egia,eij,egjb,eg->eab", B, D_e, B, detJw)


def d_np(lam: float, mu: float) -> np.ndarray:
    """float64 6x6 isotropic D from Lame constants (Material.cs:31-56),
    numpy twin of infer/forward.d_matrix_from_lame (which follows the jnp
    default dtype and is float32 on a TPU session)."""
    D = np.full((3, 3), lam, dtype=np.float64)
    D += 2.0 * mu * np.eye(3)
    out = np.zeros((6, 6), dtype=np.float64)
    out[:3, :3] = D
    out[3:, 3:] = mu * np.eye(3)
    return out
