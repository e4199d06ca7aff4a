"""The NAFEMS LE10 plate ("thick plate pressure") as plain arrays.

A quarter of an elliptic plate between the inner ellipse (x/a0)^2 +
(y/b0)^2 = 1 and the outer ellipse (x/a1)^2 + (y/b1)^2 = 1, of thickness t
centred on z = 0, meshed by a mapped grid of HEX8 cells: node (i, j, k)
sits at theta = (pi/2) i / n_theta, s = j / n_r, z = -t/2 + t k / n_z,
x = ((1 - s) a0 + s a1) cos(theta), y = ((1 - s) b0 + s b1) sin(theta).
Every element's node order is right-handed: (i, j, k), (i, j+1, k),
(i+1, j+1, k), (i+1, j, k), then the same at k + 1 (radial, then
circumferential, then up: the natural axes xi, eta, zeta).

The supports, per direction (LE10): u_y = 0 on the face y = 0 (i = 0),
u_x = 0 on the face x = 0 (i = n_theta), u_x = u_y = 0 on the outer curved
face (j = n_r), and u_z = 0 on that face's mid-line (j = n_r, z = 0, so
n_z is even). The load is a pressure on the upper face z = t/2, pointing
-z, given to the nodes as consistent nodal forces: the integral of each
node's bilinear face function times the pressure, by 2 x 2 Gauss points in
float64 (exact for a pressure linear in x and y on these planar quads).

The counterpart of perfbench/mesh.py: the arrays feed both the program and
the plain reference (perfbench/reference/general.py), so both sides solve
the same problem.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# The natural signs (radial, theta) of an upper quad's corners, in the
# order (i, j), (i, j+1), (i+1, j+1), (i+1, j); its 2 x 2 Gauss points.
_FACE = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)
_GAUSS2 = _FACE / math.sqrt(3.0)


@dataclasses.dataclass(frozen=True)
class Plate:
    n_theta: int
    n_r: int
    n_z: int
    coords: np.ndarray  # f64[nnode, 3]
    conn: np.ndarray  # i64[nelem, 8], right-handed HEX8 node order
    fixed: np.ndarray  # bool[nnode, 3]: the supported DOFs
    upper: np.ndarray  # i64[n_theta * n_r, 4]: the upper face's quads
    outer: tuple  # (a1, b1): the outer ellipse's semi-axes
    d_node: int  # the node at D = (a0, 0, t/2)
    d_elem: int  # the one element that holds D,
    d_corner: int  # and D's place among its nodes

    @property
    def nnode(self) -> int:
        return self.coords.shape[0]

    @property
    def nelem(self) -> int:
        return self.conn.shape[0]

    def load(self, a: float, b: float, pressure: float) -> np.ndarray:
        """f64[nnode, 3]: the consistent nodal forces of the pressure
        p(x, y) = pressure (1 + a x / a1 + b y / b1) on the upper face,
        pointing -z."""
        a1, b1 = self.outer
        quads = self.coords[self.upper][..., :2]  # [Q, 4, 2]
        f = np.zeros((self.nnode, 3))
        for g in _GAUSS2:
            n = 0.25 * (1 + _FACE[:, 0] * g[0]) * (1 + _FACE[:, 1] * g[1])
            dn = 0.25 * np.stack([_FACE[:, 0] * (1 + _FACE[:, 1] * g[1]),
                                  _FACE[:, 1] * (1 + _FACE[:, 0] * g[0])])
            xy = np.einsum("a,qak->qk", n, quads)
            jac = np.einsum("ra,qak->qrk", dn, quads)  # [Q, 2, 2]
            area = np.abs(jac[:, 0, 0] * jac[:, 1, 1]
                          - jac[:, 0, 1] * jac[:, 1, 0])
            p = pressure * (1 + a * xy[:, 0] / a1 + b * xy[:, 1] / b1)
            np.add.at(f[:, 2], self.upper, -(p * area)[:, None] * n[None])
        return f


def quarter_plate(n_theta: int, n_r: int, n_z: int, *, inner, outer,
                  thickness: float) -> Plate:
    """The mapped n_theta x n_r x n_z mesh; node (i, j, k) has id
    (i (n_r + 1) + j) (n_z + 1) + k, k fastest."""
    if n_z % 2:
        raise ValueError(f"n_z = {n_z}: the mid-line support needs an even "
                         "number of layers")
    (a0, b0), (a1, b1) = inner, outer
    i, j, k = np.meshgrid(np.arange(n_theta + 1), np.arange(n_r + 1),
                          np.arange(n_z + 1), indexing="ij")
    theta = (math.pi / 2) * i / n_theta
    s = j / n_r
    x = ((1 - s) * a0 + s * a1) * np.cos(theta)
    y = ((1 - s) * b0 + s * b1) * np.sin(theta)
    x[i == n_theta] = 0.0  # cos(pi/2) is 6e-17 in floating point
    z = -thickness / 2 + thickness * k / n_z
    coords = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (n_r + 1) + j) * (n_z + 1) + k

    I, J, K = (v.ravel() for v in np.meshgrid(
        np.arange(n_theta), np.arange(n_r), np.arange(n_z), indexing="ij"))
    corners = [(0, 0), (0, 1), (1, 1), (1, 0)]
    conn = np.stack([nid(I + di, J + dj, K + dk) for dk in (0, 1)
                     for di, dj in corners], axis=1).astype(np.int64)
    fixed = np.zeros((coords.shape[0], 3), bool)
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    fixed[i == 0, 1] = True
    fixed[i == n_theta, 0] = True
    fixed[j == n_r, :2] = True
    fixed[(j == n_r) & (k == n_z // 2), 2] = True
    Iq, Jq = (v.ravel() for v in np.meshgrid(np.arange(n_theta),
                                             np.arange(n_r), indexing="ij"))
    upper = np.stack([nid(Iq + di, Jq + dj, n_z) for di, dj in corners],
                     axis=1).astype(np.int64)
    return Plate(n_theta, n_r, n_z, coords, conn, fixed, upper,
                 (float(a1), float(b1)), d_node=int(nid(0, 0, n_z)),
                 d_elem=n_z - 1, d_corner=4)
