"""The benchmark's cantilever meshes, as plain arrays.

Frozen copy of the arithmetic of ``hex_beam`` in
``stan_tpu_torch/core/meshgen.py`` (itself a copy of the JAX package's
``core/meshgen.py``): a structured HEX8 grid of unit cells, clamped on the
x = 0 face, loaded on the x = L face. Kept here so that the benchmark's
inputs do not move when the program's generator does. The arrays feed both
the program (perfbench/program.py builds its model from them) and the plain
reference (perfbench/reference/), so both sides solve the same problem.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Beam:
    nx: int
    ny: int
    nz: int
    coords: np.ndarray  # f64[nnode, 3]
    conn: np.ndarray  # i64[nelem, 8], HEX8 natural-sign node order
    fixed_nodes: np.ndarray  # i64: the clamped x = 0 face
    tip_nodes: np.ndarray  # i64: the loaded x = L face

    @property
    def node_shape(self) -> tuple:
        return (self.nx + 1, self.ny + 1, self.nz + 1)

    @property
    def nnode(self) -> int:
        return self.coords.shape[0]

    @property
    def spacing(self) -> tuple:
        return (1.0, 1.0, 1.0)

    def load(self, direction, total: float) -> np.ndarray:
        """f64[nnode, 3]: `total` spread evenly over the tip face, along the
        unit vector `direction`."""
        f = np.zeros((self.nnode, 3))
        f[self.tip_nodes] = (np.asarray(direction, np.float64)
                             * (total / len(self.tip_nodes)))
        return f


def hex_beam(nx: int, ny: int, nz: int) -> Beam:
    """nx * ny * nz unit HEX8 cells; node (i, j, k) has id
    i * (ny+1)(nz+1) + j * (nz+1) + k, k fastest."""
    xs = np.linspace(0.0, float(nx), nx + 1)
    ys = np.linspace(0.0, float(ny), ny + 1)
    zs = np.linspace(0.0, float(nz), nz + 1)
    nyz = (ny + 1) * (nz + 1)

    def nid(i, j, k):
        return i * nyz + j * (nz + 1) + k

    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    conn = np.stack([nid(I, J, K), nid(I + 1, J, K), nid(I + 1, J + 1, K),
                     nid(I, J + 1, K), nid(I, J, K + 1),
                     nid(I + 1, J, K + 1), nid(I + 1, J + 1, K + 1),
                     nid(I, J + 1, K + 1)], axis=1).astype(np.int64)
    jj, kk = np.meshgrid(np.arange(ny + 1), np.arange(nz + 1), indexing="ij")
    face = (jj * (nz + 1) + kk).ravel().astype(np.int64)
    return Beam(nx, ny, nz, coords, conn, fixed_nodes=face,
                tip_nodes=nid(nx, 0, 0) + face)
