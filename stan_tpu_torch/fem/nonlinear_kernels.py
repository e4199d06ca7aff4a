"""Total-Lagrangian nonlinear element kernels (batched over elements).

Port of stan_tpu/fem/nonlinear_kernels.py. With F = I + H (H = dN . u_e,
the displacement gradient in material coordinates):

  strain variation     (BL du)      = voigt(sym(F^T dH)),   dH = dN . du_e
  internal force       (BL^T s)     -> f[n,j] = dN[k,n] (F S)[j,k] detJ w
  material tangent     BL^T D BL du -> with dS = D : voigt(sym(F^T dH))
  geometric tangent    BNL^T S BNL du -> f[n,j] = dN[k,n] S[k,l] dH[j,l] detJ w

St. Venant-Kirchhoff: the second Piola-Kirchhoff stress S = D : E_green
with the linear path's 6x6 D. Voigt order (xx, yy, zz, xy, yz, xz),
engineering shear.

F and S depend only on the Newton state u, not on the CG direction du:
tangent_state computes them, and element_tangent forms the tangent at
that state as element matrices [E, 3nn, 3nn], once per Newton iteration.
Each CG iteration is then one batched matrix-vector product per element
instead of a dozen 3x3 products per Gauss point, which CUDA's batched GEMM
runs at a few percent of its rate. tangent_apply is the reference's
matrix-free action, kept as the parity reference.
"""

from __future__ import annotations

import torch

from stan_tpu_torch.fem.kernels import voigt_to_tensor


def displacement_gradient(dN: torch.Tensor, u_e: torch.Tensor
                          ) -> torch.Tensor:
    """H[E, G, j, k] = du_j/dX_k at the Gauss points:
    H[j, k] = sum_n dN[k, n] u_e[n, j]."""
    return torch.einsum("egkn,enj->egjk", dN, u_e)


def _voigt_sym(M: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> Voigt [..., 6] of M + M^T off the diagonal
    (engineering shear) and M on it."""
    return torch.stack([M[..., 0, 0], M[..., 1, 1], M[..., 2, 2],
                        M[..., 0, 1] + M[..., 1, 0],
                        M[..., 1, 2] + M[..., 2, 1],
                        M[..., 0, 2] + M[..., 2, 0]], dim=-1)


def green_lagrange(H: torch.Tensor) -> torch.Tensor:
    """Green-Lagrange strain in Voigt form [E, G, 6] from H [E, G, 3, 3]:
    E = 1/2 (H + H^T + H^T H), engineering shear."""
    C = H + H.transpose(-1, -2) + torch.matmul(H.transpose(-1, -2), H)
    return 0.5 * torch.stack([C[..., 0, 0], C[..., 1, 1], C[..., 2, 2],
                              C[..., 0, 1] * 2.0, C[..., 1, 2] * 2.0,
                              C[..., 0, 2] * 2.0], dim=-1)


def strain_variation(dN, u_e, du_e) -> torch.Tensor:
    """(BL(u) du) in Voigt [E, G, 6]: sym(F^T dH), engineering shear."""
    H = displacement_gradient(dN, u_e)
    dH = displacement_gradient(dN, du_e)
    return _voigt_sym(dH + torch.matmul(H.transpose(-1, -2), dH))


def pk2_stress(dN, detJw, D_e, u_e) -> torch.Tensor:
    """Second Piola-Kirchhoff stress at the Gauss points [E, G, 6]. detJw
    is unused; the signature matches the JAX package's."""
    Eg = green_lagrange(displacement_gradient(dN, u_e))
    return torch.einsum("eij,egj->egi", D_e, Eg)


def _nodal(dN, P, detJw) -> torch.Tensor:
    """f[e, n, j] = sum_g sum_k dN[e,g,k,n] P[e,g,j,k] detJw[e,g]."""
    return torch.einsum("egkn,egjk,eg->enj", dN, P, detJw)


def internal_force_tl(dN, detJw, D_e, u_e) -> torch.Tensor:
    """Element internal force f_e [E, nn, 3] at the current total state:
    f[n, j] = sum_g dN[k, n] (F S)[j, k] detJ w."""
    H = displacement_gradient(dN, u_e)
    S = voigt_to_tensor(pk2_stress(dN, detJw, D_e, u_e))
    return _nodal(dN, torch.matmul(H, S) + S, detJw)


def tangent_state(dN, D_e, u_e) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, S): the displacement gradient and the PK2 stress tensor [E, G,
    3, 3] at state u_e, which every tangent action at that state reads."""
    H = displacement_gradient(dN, u_e)
    Eg = green_lagrange(H)
    return H, voigt_to_tensor(torch.einsum("eij,egj->egi", D_e, Eg))


def element_tangent(dN, detJw, D_e, H, S) -> torch.Tensor:
    """The element tangent stiffness [E, 3nn, 3nn] at the state (H, S) of
    tangent_state, DOF order 3 * node + direction: ke_T . du_e equals
    tangent_apply at the same state.

    Material part: sum_g detJ w BL^T D BL, where BL [6, 3nn] maps du_e to
    voigt(sym(F^T dH)): d(F^T dH)[a, b] / d du[n, j] = F[j, a] dN[b, n].
    Geometric part: sum_g detJ w (dN^T S dN)[n, m] on every direction j.
    """
    E, nn = dN.shape[0], dN.shape[-1]
    F = H + torch.eye(3, dtype=H.dtype, device=H.device)
    BL = _voigt_sym(torch.einsum("egja,egbn->egnjab", F, dN))  # [E,G,nn,3,6]
    BL = BL.reshape(*BL.shape[:2], 3 * nn, 6)
    DBL = torch.einsum("evw,egbw->egbv", D_e, BL) * detJw[..., None, None]
    K = torch.einsum("egav,egbv->eab", BL, DBL).reshape(E, nn, 3, nn, 3)
    G = torch.einsum("egkn,egkl,eglm,eg->enm", dN, S, dN, detJw)
    for j in range(3):
        K[:, :, j, :, j] += G
    return K.reshape(E, 3 * nn, 3 * nn)


def tangent_apply(dN, detJw, D_e, u_e, du_e) -> torch.Tensor:
    """Matrix-free tangent action f_e = ke_T . du_e at state u_e: material
    part F dS (BL^T D BL) plus geometric part dH S (BNL^T S BNL),
    contracted with dN^T in one pass."""
    H, S = tangent_state(dN, D_e, u_e)
    dH = displacement_gradient(dN, du_e)
    dE = _voigt_sym(dH + torch.matmul(H.transpose(-1, -2), dH))
    dS = voigt_to_tensor(torch.einsum("eij,egj->egi", D_e, dE))
    # F dS = dS + H dS; S symmetric, so S[k,l] dH[j,l] = (dH S)[j,k]
    return _nodal(dN, dS + torch.matmul(H, dS) + torch.matmul(dH, S), detJw)


def recover_tl(dN, detJw, D_e, u_e, form):
    """Green-Lagrange strain and PK2 stress extrapolated to the nodes, each
    [E, nn, 6], with the linear path's Gauss-to-node weights."""
    Eg = green_lagrange(displacement_gradient(dN, u_e))
    Sg = torch.einsum("eij,egj->egi", D_e, Eg)
    W = torch.as_tensor(form.extrap, dtype=u_e.dtype, device=u_e.device)
    return (torch.einsum("ng,egi->eni", W, Eg),
            torch.einsum("ng,egi->eni", W, Sg))
