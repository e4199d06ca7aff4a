"""Plain reference for linear-elastic HEX8 on an arbitrary mesh: one
stiffness per element, a mask per DOF, matrix-free K, and recovery.

Written from the textbook isoparametric formulation (trilinear HEX8 in the
natural-sign node order of perfbench/reference/fem.py, 2 x 2 x 2 Gauss
points at +-1/sqrt(3), weight 1; J = dX/dxi, gradients J^-1 dN/dxi, B in
Voigt order xx, yy, zz, xy, yz, xz with engineering shear; ke = sum_g B^T
D B det J). The element stiffnesses are built on the device in blocks of
elements. It imports nothing of the program and takes nothing the program
made. Where the beam's reference (fem.py) has one box stiffness and whole
fixed nodes, this one takes any mesh whose elements have a positive
Jacobian and a mask per DOF; it reuses fem.py's CG, Gauss-to-node
extrapolation and Lame constants.

K acts element by element: gather the 24 nodal values of every element,
one product with that element's ke, and a scatter-add back to the nodes.
The masked system is M K M + (I - M), with M the free DOFs, as the program
solves it. Vectors are [S, nnode, 3] (S systems of one stiffness), as in
fem.py, so that fem.cg and fem.relative_residual take this operator too.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import fem

BLOCK = 32768  # elements per block of the stiffness build and recovery


def shape_gradients() -> np.ndarray:
    """dN/d(xi, eta, zeta) [8 Gauss points, 3, 8 nodes] of the trilinear
    functions (1 + s_a xi)(1 + t_a eta)(1 + u_a zeta) / 8."""
    s = fem.SIGNS  # [8 nodes, 3]
    g = fem.GAUSS[:, None, :]  # [8 points, 1, 3]
    f = 1.0 + s[None] * g  # [8, 8, 3]
    return np.stack([s[None, :, 0] * f[..., 1] * f[..., 2],
                     s[None, :, 1] * f[..., 0] * f[..., 2],
                     s[None, :, 2] * f[..., 0] * f[..., 1]], axis=1) / 8.0


def b_and_det(coords_e: torch.Tensor) -> tuple:
    """B [b, 8 Gauss points, 6, 24] and det J [b, 8] of elements whose
    corner coordinates are coords_e [b, 8, 3]. Column 3 a + d: node a,
    direction d."""
    kw = dict(dtype=coords_e.dtype, device=coords_e.device)
    dn = torch.as_tensor(shape_gradients(), **kw)  # [8, 3, 8]
    J = torch.einsum("gka,eaj->egkj", dn, coords_e)  # d x_j / d xi_k
    grad = torch.linalg.solve(J, dn.expand(J.shape[0], -1, -1, -1))
    gx, gy, gz = grad[:, :, 0], grad[:, :, 1], grad[:, :, 2]  # [b, 8, 8]
    B = coords_e.new_zeros(J.shape[0], 8, 6, 8, 3)
    B[:, :, 0, :, 0] = gx
    B[:, :, 1, :, 1] = gy
    B[:, :, 2, :, 2] = gz
    B[:, :, 3, :, 0], B[:, :, 3, :, 1] = gy, gx
    B[:, :, 4, :, 1], B[:, :, 4, :, 2] = gz, gy
    B[:, :, 5, :, 0], B[:, :, 5, :, 2] = gz, gx
    return B.reshape(J.shape[0], 8, 6, 24), torch.linalg.det(J)


class ElementOperator:
    """K u on one mesh, element by element, with one ke per element.

    coords [nnode, 3] and conn [E, 8] (float64 and integers, numpy); fixed
    bool [nnode, 3], the supported DOFs; lam, mu: the one material's Lame
    constants. Vectors are [S, nnode, 3] in `dtype` on `device`; the
    stiffnesses are built in float64 and then held in `dtype`.
    """

    def __init__(self, coords, conn, fixed, lam, mu, *,
                 dtype=torch.float64, device="cpu"):
        kw = dict(dtype=dtype, device=device)
        self.kw = kw
        self.nnode = coords.shape[0]
        self.conn = torch.as_tensor(conn, device=device)
        self.flat = self.conn.reshape(-1)
        self.coords = torch.as_tensor(coords, dtype=torch.float64,
                                      device=device)
        self.D = torch.as_tensor(fem.d_matrix(lam, mu), dtype=torch.float64,
                                 device=device)
        ke = []
        for lo in range(0, self.conn.shape[0], BLOCK):
            B, det = b_and_det(self.coords[self.conn[lo:lo + BLOCK]])
            if not bool((det > 0).all()):
                raise ValueError("reference: an element's Jacobian is not "
                                 "positive at a Gauss point")
            DB = torch.einsum("ij,egjb->egib", self.D, B)
            ke.append(torch.einsum("egia,egib->eab", B * det[..., None, None],
                                   DB).to(dtype))
        self.ke = torch.cat(ke)  # [E, 24, 24]
        self.free = torch.as_tensor(1.0 - np.asarray(fixed, np.float64),
                                    **kw)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Unmasked K u; u [S, nnode, 3] -> [S, nnode, 3]."""
        S = u.shape[0]
        ue = u[:, self.conn].reshape(S, -1, 24)  # [S, E, 24]
        fe = torch.einsum("eab,seb->sea", self.ke, ue)
        out = torch.zeros_like(u)
        out.index_add_(1, self.flat, fe.reshape(S, -1, 3))
        return out

    def masked(self, u: torch.Tensor) -> torch.Tensor:
        """(M K M + I - M) u."""
        m = self.free
        return m * self.apply(m * u) + (1.0 - m) * u

    def diagonal(self) -> torch.Tensor:
        """The masked system's diagonal [1, nnode, 3]."""
        d = torch.diagonal(self.ke, dim1=1, dim2=2)  # [E, 24]
        out = torch.zeros((self.nnode, 3), **self.kw)
        out.index_add_(0, self.flat, d.reshape(-1, 3))
        return (self.free * out + (1.0 - self.free))[None]

    def recover(self, u: torch.Tensor) -> tuple:
        """Node-extrapolated strain and stress [E, 8, 6] of one system's u
        [nnode, 3] (fem.extrapolation: the Gauss points' trilinear
        functions at the nodes), and the internal force K u [nnode, 3]
        (the reactions on the supported DOFs)."""
        kw = dict(dtype=u.dtype, device=u.device)
        W = torch.as_tensor(fem.extrapolation(), **kw)
        D = self.D.to(u.dtype)
        eps, sig = [], []
        for lo in range(0, self.conn.shape[0], BLOCK):
            conn = self.conn[lo:lo + BLOCK]
            B, _ = b_and_det(self.coords[conn])
            ue = u[conn].reshape(-1, 24)
            eps_g = torch.einsum("egia,ea->egi", B.to(u.dtype), ue)
            sig_g = torch.einsum("ij,egj->egi", D, eps_g)
            eps.append(torch.einsum("ng,egi->eni", W, eps_g))
            sig.append(torch.einsum("ng,egi->eni", W, sig_g))
        return torch.cat(eps), torch.cat(sig), self.apply(u[None])[0]
