"""Plain reference for the linear-elastic HEX8 beam: element stiffness,
matrix-free K, Jacobi-preconditioned CG and stress recovery.

Written from the textbook formulation (trilinear HEX8, 2 x 2 x 2 Gauss
points at +-1/sqrt(3), weight 1; small strain in Voigt order xx, yy, zz,
xy, yz, xz with engineering shear; isotropic D from the Lame constants;
Gauss-point values extrapolated to the nodes by the trilinear functions of
the Gauss points evaluated at the nodes, +-sqrt(3) in Gauss coordinates).
It imports nothing of the program and takes nothing the program made: the
benchmark hands both sides the same mesh arrays and loads, and this module
builds its own operator from them.

K acts element by element: gather the 24 nodal values of every element,
one matrix product with the element stiffness (the grid is uniform, so one
[24, 24] matrix serves every element, or one per system of a batch), and a
scatter-add back to the nodes. The masked system is M K M + (I - M), with M
the free DOFs, as the program solves it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Natural coordinates of the 8 nodes, in the node order of the mesh's conn.
SIGNS = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                  [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                 np.float64)
GAUSS = SIGNS / math.sqrt(3.0)  # Gauss point g sits at the sign of node g


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    to even), as a tensor core rounds a matrix product's operands."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def lame(E: float, nu: float) -> tuple:
    return E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu)), E / (2.0 * (1.0 + nu))


def d_matrix(lam: float, mu: float) -> np.ndarray:
    """Isotropic 6 x 6 D, Voigt order, engineering shear."""
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[[0, 1, 2], [0, 1, 2]] = lam + 2.0 * mu
    D[[3, 4, 5], [3, 4, 5]] = mu
    return D


def b_matrices(h) -> np.ndarray:
    """B [8 Gauss points, 6, 24] of a box element of edge lengths h, and
    det J (a constant for a box). Column 3 a + d: node a, direction d."""
    h = np.asarray(h, np.float64)
    B = np.zeros((8, 6, 24))
    for g, (xi, eta, zeta) in enumerate(GAUSS):
        s = SIGNS
        dxi = np.stack([s[:, 0] * (1 + s[:, 1] * eta) * (1 + s[:, 2] * zeta),
                        s[:, 1] * (1 + s[:, 0] * xi) * (1 + s[:, 2] * zeta),
                        s[:, 2] * (1 + s[:, 0] * xi) * (1 + s[:, 1] * eta)]
                       ) / 8.0  # [3, 8] dN/d(xi, eta, zeta)
        dx = dxi * (2.0 / h)[:, None]  # box: x = x0 + (1 + xi) h / 2
        for a in range(8):
            gx, gy, gz = dx[:, a]
            c = 3 * a
            B[g, 0, c] = gx
            B[g, 1, c + 1] = gy
            B[g, 2, c + 2] = gz
            B[g, 3, c], B[g, 3, c + 1] = gy, gx
            B[g, 4, c + 1], B[g, 4, c + 2] = gz, gy
            B[g, 5, c], B[g, 5, c + 2] = gz, gx
    return B, float(np.prod(h)) / 8.0


def element_stiffness(h, lam: float, mu: float) -> np.ndarray:
    """ke [24, 24] = sum_g B_g^T D B_g det J (Gauss weights 1)."""
    B, detj = b_matrices(h)
    D = d_matrix(lam, mu)
    return np.einsum("gia,ij,gjb->ab", B, D, B) * detj


def extrapolation() -> np.ndarray:
    """W [8 nodes, 8 Gauss points]: the trilinear function of Gauss point g
    (its own sign pattern, in coordinates where the Gauss points sit at
    +-1) at node i, which sits at +-sqrt(3) there."""
    at = SIGNS * math.sqrt(3.0)
    return np.prod(1.0 + at[:, None, :] * SIGNS[None, :, :], axis=2) / 8.0


def box_spacing(coords: np.ndarray, conn: np.ndarray) -> tuple:
    """The edge lengths of the grid's cells; raises unless every element is
    the same axis-aligned box (the reference's one-ke operator needs it)."""
    c = coords[conn]  # [E, 8, 3]
    h = c[:, 6] - c[:, 0]
    if not np.allclose(h, h[0], rtol=0, atol=1e-12 * np.abs(h).max()):
        raise ValueError("reference: the elements are not one uniform box")
    expect = c[:, :1] + (SIGNS[None] + 1.0) / 2.0 * h[:, None]
    if not np.allclose(c, expect, rtol=0, atol=1e-9 * np.abs(h).max()):
        raise ValueError("reference: an element is not an axis-aligned box")
    return tuple(float(v) for v in h[0])


class ElementOperator:
    """K(lam, mu) u for a batch of systems on one mesh, element by element.

    lam, mu: [S] per system (or floats: one system); the stiffness of system
    s is lam_s K_lam + mu_s K_mu, with K_lam, K_mu the unit-Lame element
    stiffnesses. Vectors are [S, nnode, 3] in `dtype` on `device`.
    tf32_products: round the element product's operands to TF32 (float32
    only).
    """

    def __init__(self, coords, conn, fixed_nodes, lam, mu, *,
                 dtype=torch.float64, device="cpu",
                 tf32_products: bool = False):
        h = box_spacing(coords, conn)
        kw = dict(dtype=dtype, device=device)
        self.kw = kw
        self.nnode = coords.shape[0]
        self.conn = torch.as_tensor(conn, device=device)
        self.flat = self.conn.reshape(-1)
        lam = torch.as_tensor(np.atleast_1d(lam), **kw)
        mu = torch.as_tensor(np.atleast_1d(mu), **kw)
        k_lam = torch.as_tensor(element_stiffness(h, 1.0, 0.0), **kw)
        k_mu = torch.as_tensor(element_stiffness(h, 0.0, 1.0), **kw)
        self.ke = (lam[:, None, None] * k_lam + mu[:, None, None] * k_mu)
        free = np.ones((self.nnode, 3))
        free[np.asarray(fixed_nodes)] = 0.0
        self.free = torch.as_tensor(free, **kw)
        self.h = h
        # TF32 products (the calibration's control): operands rounded here,
        # products summed in float32, whatever the library would pick.
        self.round = tf32 if tf32_products else (lambda x: x)

    @property
    def systems(self) -> int:
        return self.ke.shape[0]

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Unmasked K u; u [S, nnode, 3] -> [S, nnode, 3]."""
        S = u.shape[0]
        ue = self.round(u[:, self.conn].reshape(S, -1, 24))  # [S, E, 24]
        fe = torch.matmul(ue, self.round(self.ke).transpose(1, 2))
        out = torch.zeros_like(u)
        out.index_add_(1, self.flat, fe.reshape(S, -1, 3))
        return out

    def masked(self, u: torch.Tensor) -> torch.Tensor:
        """(M K M + I - M) u."""
        m = self.free
        return m * self.apply(m * u) + (1.0 - m) * u

    def diagonal(self) -> torch.Tensor:
        """The masked system's diagonal [S, nnode, 3]."""
        S = self.systems
        d = torch.diagonal(self.ke, dim1=1, dim2=2)  # [S, 24]
        out = torch.zeros((S, self.nnode, 3), **self.kw)
        E = self.conn.shape[0]
        out.index_add_(1, self.flat,
                       d[:, None, :].expand(S, E, 24).reshape(S, -1, 3))
        return self.free * out + (1.0 - self.free)


def cg(A, b: torch.Tensor, diag: torch.Tensor, *, tol: float,
       maxiter: int) -> tuple:
    """Jacobi-preconditioned CG on a batch of systems [S, ...] from zero;
    every system iterates until all meet ||r_s|| <= tol ||b_s|| or maxiter.
    The norm is read on the host every 25 iterations. Returns (x, the
    iterations run, the recurrence's relative residual per system)."""
    S = b.shape[0]

    def dot(u, v):
        return (u * v).reshape(S, -1).sum(1)

    def wide(v):
        return v.reshape((S,) + (1,) * (b.dim() - 1))

    inv = 1.0 / diag
    x = torch.zeros_like(b)
    r = b.clone()
    z = inv * r
    p = z
    rz = dot(r, z)
    bnorm = torch.sqrt(dot(b, b)).clamp_min(torch.finfo(b.dtype).tiny)
    k = 0
    rel = torch.ones_like(bnorm)
    while k < maxiter:
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + wide(alpha) * p
        r = r - wide(alpha) * Ap
        z = inv * r
        rz_new = dot(r, z)
        p = z + wide(rz_new / rz) * p
        rz = rz_new
        k += 1
        if k % 25 == 0 or k == maxiter:
            rel = torch.sqrt(dot(r, r)) / bnorm
            if bool((rel <= tol).all()):
                break
    return x, k, rel.cpu().numpy()


def relative_residual(op: ElementOperator, u: torch.Tensor,
                      b: torch.Tensor) -> np.ndarray:
    """||b_s - (M K M + I - M) u_s|| / ||b_s|| per system, in op's dtype."""
    S = u.shape[0]
    r = (b - op.masked(u)).reshape(S, -1)
    return (torch.linalg.vector_norm(r, dim=1)
            / torch.linalg.vector_norm(b.reshape(S, -1), dim=1)).cpu().numpy()


def recover(op: ElementOperator, u: torch.Tensor, lam: float, mu: float):
    """Node-extrapolated strain and stress [E, 8, 6] of one system's u
    [nnode, 3], and its internal force K u [nnode, 3] (the reactions on
    the clamped nodes)."""
    B, _ = b_matrices(op.h)
    kw = dict(dtype=u.dtype, device=u.device)
    B = torch.as_tensor(B, **kw)
    D = torch.as_tensor(d_matrix(lam, mu), **kw)
    W = torch.as_tensor(extrapolation(), **kw)
    ue = u[op.conn].reshape(-1, 24)  # [E, 24]
    eps_g = torch.einsum("gia,ea->egi", B, ue)
    sig_g = torch.einsum("ij,egj->egi", D, eps_g)
    eps = torch.einsum("ng,egi->eni", W, eps_g)
    sig = torch.einsum("ng,egi->eni", W, sig_g)
    return eps, sig, op.apply(u[None])[0]
