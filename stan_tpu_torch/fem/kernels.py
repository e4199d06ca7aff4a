"""Batched element kernels: geometry, matrix-free action, stress recovery.

Port of stan_tpu/fem/kernels.py. Every quantity is one batched contraction
over all elements; the 6x(3*nn) B-matrix is never formed on the hot path.
With H = u_e . dN^T the displacement gradient,

    eps    = sym(H)                    (small strain, engineering shear)
    sigma  = D : eps
    f_e    = dN^T . T(sigma) * detJ*w  (B^T sigma without B)

Voigt order (xx, yy, zz, xy, yz, xz) with engineering shear, as in the
JAX package. Float32 contractions run in full float32: the entry points
switch TF32 off on the CUDA path (fem/operator.resolve_device).

The element action and the strains take leading batch axes on u_e [..., E,
nn, 3] and D_e [..., E, 6, 6] (a chain axis of the calibration forward
problems); the geometry dN, detJw is shared. The explicit B matrix and
the element stiffness (b_matrix, element_stiffness) serve the assembled
direct path only.
"""

from __future__ import annotations

import torch

from stan_tpu_torch.fem.elements import ElementFormulation


def det3(J: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of batched 3x3 matrices [..., 3, 3]."""
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3(J: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched 3x3 matrices (adjugate / det)."""
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    inv_det = 1.0 / (a * A + b * B + c * C)
    row0 = torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1)
    row1 = torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1)
    row2 = torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def element_geometry(coords_e: torch.Tensor, form: ElementFormulation):
    """Per-element, per-Gauss-point geometry from coords_e [E, nn, 3].

    Returns dN [E, G, 3, nn] (gradients in global coordinates) and
    detJw [E, G] (det J times the Gauss weight).
    """
    kw = dict(dtype=coords_e.dtype, device=coords_e.device)
    dN_local = torch.as_tensor(form.gauss_dN, **kw)  # [G, 3, nn]
    w = torch.as_tensor(form.gauss_w, **kw)  # [G]
    J = torch.einsum("gkn,enj->egkj", dN_local, coords_e)
    dN = torch.einsum("egkl,gln->egkn", inv3(J), dN_local)
    return dN, det3(J) * w[None, :]


def b_matrix(dN: torch.Tensor) -> torch.Tensor:
    """Explicit B [..., 6, 3*nn] from gradients dN [..., 3, nn]; column
    3*i + j is node i, direction j."""
    nn = dN.shape[-1]
    B = dN.new_zeros((*dN.shape[:-2], 6, 3, nn))
    dx, dy, dz = dN[..., 0, :], dN[..., 1, :], dN[..., 2, :]
    for row, col, d in ((0, 0, dx), (1, 1, dy), (2, 2, dz), (3, 0, dy),
                        (3, 1, dx), (4, 1, dz), (4, 2, dy), (5, 0, dz),
                        (5, 2, dx)):
        B[..., row, col, :] = d
    return B.transpose(-1, -2).reshape(*dN.shape[:-2], 6, 3 * nn)


def element_stiffness(coords_e: torch.Tensor, D_e: torch.Tensor,
                      form: ElementFormulation) -> torch.Tensor:
    """Element stiffness ke [E, 3nn, 3nn] = sum_g B^T D B detJ w."""
    dN, detJw = element_geometry(coords_e, form)
    B = b_matrix(dN)  # [E, G, 6, 3nn]
    DB = torch.einsum("eij,egjb->egib", D_e, B)
    return torch.einsum("egia,egib,eg->eab", B, DB, detJw)


def element_stiffness_diag(coords_e: torch.Tensor, D_e: torch.Tensor,
                           form: ElementFormulation) -> torch.Tensor:
    """diag(ke) [E, 3nn] without forming ke."""
    dN, detJw = element_geometry(coords_e, form)
    B = b_matrix(dN)
    DB = torch.einsum("eij,egja->egia", D_e, B)
    return torch.einsum("egia,egia,eg->ea", B, DB, detJw)


def strain_at_gauss(dN: torch.Tensor, u_e: torch.Tensor) -> torch.Tensor:
    """Small-strain Voigt vector eps [..., E, G, 6] from u_e [..., E, nn,
    3]."""
    H = torch.einsum("egkn,...enj->...egkj", dN, u_e)
    return torch.stack(
        [
            H[..., 0, 0],
            H[..., 1, 1],
            H[..., 2, 2],
            H[..., 0, 1] + H[..., 1, 0],
            H[..., 1, 2] + H[..., 2, 1],
            H[..., 0, 2] + H[..., 2, 0],
        ],
        dim=-1,
    )


def voigt_to_tensor(s: torch.Tensor) -> torch.Tensor:
    """[..., 6] Voigt (xx,yy,zz,xy,yz,xz) -> [..., 3, 3] symmetric tensor."""
    rows = [
        torch.stack([s[..., 0], s[..., 3], s[..., 5]], dim=-1),
        torch.stack([s[..., 3], s[..., 1], s[..., 4]], dim=-1),
        torch.stack([s[..., 5], s[..., 4], s[..., 2]], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def internal_force(dN, detJw, D_e, u_e) -> torch.Tensor:
    """Element internal force f_e [..., E, nn, 3] = B^T (D B u_e) detJ w."""
    sig = torch.einsum("...eij,...egj->...egi", D_e, strain_at_gauss(dN, u_e))
    T = voigt_to_tensor(sig)  # [..., E, G, 3, 3]
    return torch.einsum("egkn,...egjk,eg->...enj", dN, T, detJw)


def recover_stress_strain(dN, detJw, D_e, u_e, form: ElementFormulation):
    """Strain and stress at the Gauss points, extrapolated to the nodes with
    the formulation's weights. Returns (strain_n, stress_n), each [E, nn, 6].
    detJw is unused; the signature matches the JAX package's."""
    eps_g = strain_at_gauss(dN, u_e)
    sig_g = torch.einsum("eij,egj->egi", D_e, eps_g)
    W = torch.as_tensor(form.extrap, dtype=u_e.dtype, device=u_e.device)
    eps_n = torch.einsum("ng,egi->eni", W, eps_g)
    sig_n = torch.einsum("ng,egi->eni", W, sig_g)
    return eps_n, sig_n
