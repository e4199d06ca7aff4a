# Copied from stan_tpu/fem/elements.py; the port keeps its own copy.
"""Isoparametric element formulation registry.

TPU-native re-design of the reference ElementType registry
(reference: src/STAN_Database/FE_Library.cs:34-197). Instead of per-element
objects holding small matrices, each formulation is a set of constant numpy
tables that the batched kernels broadcast over every element on device:

  * ``gauss_dN``   f64[ngp, 3, nnode]  -- dN/d(xi,eta,zeta) at each Gauss point
                    (reference: FE_Library.cs:206-276, HEX8_Diff_ShapeFunctions)
  * ``gauss_w``    f64[ngp]            -- integration weight per Gauss point
  * ``extrap``     f64[nnode, ngp]     -- Gauss-point -> node extrapolation
                    weights used in stress recovery. The reference's unusual
                    construction (node natural coords divided by the Gauss
                    point location, FE_Library.cs:285-321) is reproduced
                    exactly so stress fields match.

Registry keys match the reference names: HEX8_G1, HEX8_G2, TET4_G1, TET4_G2
(FE_Library.cs:44-47). PENTA6 is declared "not implemented" in the reference
(FE_Library.cs:48-49) and is likewise absent here.

Note on the reference's G1 extrapolation table: FE_Library.cs:77-81 stores a
single row [1]*8 which Recovery_Stress (Element.cs:242) would index out of
range for node i>0; the *intent* (every node inherits the single Gauss-point
value with weight 1) is implemented here.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np

# Natural-coordinate sign pattern of the HEX8 nodes, in reference node order
# (FE_Library.cs:215-235 sign table): rows are nodes, columns (xi, eta, zeta).
_HEX8_SIGNS = np.array(
    [
        [-1, -1, -1],
        [+1, -1, -1],
        [+1, +1, -1],
        [-1, +1, -1],
        [-1, -1, +1],
        [+1, -1, +1],
        [+1, +1, +1],
        [-1, +1, +1],
    ],
    dtype=np.float64,
)

# TET4 node natural coordinates (FE_Library.cs:339-343: N1=1-xi-eta-zeta,
# N2=xi, N3=eta, N4=zeta).
_TET4_NODES = np.array(
    [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
    dtype=np.float64,
)


def _hex8_shape(points: np.ndarray) -> np.ndarray:
    """Trilinear shape functions N[p, node] at natural points [p, 3]."""
    xi = points[:, None, 0]
    eta = points[:, None, 1]
    zeta = points[:, None, 2]
    s = _HEX8_SIGNS[None, :, :]
    return (
        (1.0 + s[..., 0] * xi)
        * (1.0 + s[..., 1] * eta)
        * (1.0 + s[..., 2] * zeta)
        / 8.0
    )


def _hex8_dshape(points: np.ndarray) -> np.ndarray:
    """Trilinear shape-function derivatives dN[p, 3, node] at points [p, 3]."""
    xi = points[:, None, 0]
    eta = points[:, None, 1]
    zeta = points[:, None, 2]
    s = _HEX8_SIGNS[None, :, :]
    fx = 1.0 + s[..., 0] * xi
    fy = 1.0 + s[..., 1] * eta
    fz = 1.0 + s[..., 2] * zeta
    dN = np.stack(
        [
            s[..., 0] * fy * fz / 8.0,
            s[..., 1] * fx * fz / 8.0,
            s[..., 2] * fx * fy / 8.0,
        ],
        axis=1,
    )
    return dN


def _tet4_dshape() -> np.ndarray:
    """Constant TET4 derivatives dN[3, 4] (FE_Library.cs:330-367)."""
    return np.array(
        [
            [-1.0, 1.0, 0.0, 0.0],
            [-1.0, 0.0, 1.0, 0.0],
            [-1.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float64,
    )


@dataclasses.dataclass(frozen=True)
class ElementFormulation:
    """Constant tables fully describing one isoparametric formulation."""

    name: str
    nnode: int
    ngp: int
    gauss_dN: np.ndarray  # [ngp, 3, nnode]
    gauss_w: np.ndarray  # [ngp]
    extrap: np.ndarray  # [nnode, ngp] Gauss->node weights

    @property
    def ndof(self) -> int:
        return 3 * self.nnode


@lru_cache(maxsize=None)
def get(name: str) -> ElementFormulation:
    """Look up a formulation by its reference-compatible name."""
    if name == "HEX8_G1":
        # Reduced integration: single point at the centroid, weight 2^3
        # (FE_Library.cs:63-89).
        pts = np.zeros((1, 3))
        return ElementFormulation(
            name=name,
            nnode=8,
            ngp=1,
            gauss_dN=_hex8_dshape(pts),
            gauss_w=np.full(1, 8.0),
            extrap=np.ones((8, 1)),
        )
    if name == "HEX8_G2":
        # Full integration: 2x2x2 points at +-1/sqrt(3), weight 1, ordered
        # with the same sign pattern as the nodes (FE_Library.cs:91-131).
        g = np.sqrt(1.0 / 3.0)
        pts = _HEX8_SIGNS * g
        # extrap[i, g] = N_g(node_i / g): shape function of "GP g" evaluated
        # at node i's natural coords scaled by 1/gauss_location
        # (FE_Library.cs:285-321).
        extrap = _hex8_shape(_HEX8_SIGNS / g)  # [node, gp]
        return ElementFormulation(
            name=name,
            nnode=8,
            ngp=8,
            gauss_dN=_hex8_dshape(pts),
            gauss_w=np.ones(8),
            extrap=extrap,
        )
    if name == "TET4_G1":
        # Single point at the centroid, weight 1 (FE_Library.cs:133-159).
        # NOTE: the reference weight 1.0 omits the canonical 1/6 reference-
        # volume factor; with the constant-Jacobian TET4 this scales K by 6.
        # Reproduced as-is for parity.
        return ElementFormulation(
            name=name,
            nnode=4,
            ngp=1,
            gauss_dN=_tet4_dshape()[None],
            gauss_w=np.full(1, 1.0),
            extrap=np.ones((4, 1)),
        )
    if name == "TET4_G2":
        # 4-point rule at the standard (a,a,a) permutation points, weight
        # 0.25 each, GP order from FE_Library.cs:172-185.
        a = 0.138196601125010
        b = 0.585410196624968
        gps = np.array([[a, a, a], [a, a, b], [b, a, a], [a, b, a]])
        # extrap[i, g] = N_g(node_i / gp_i coords), FE_Library.cs:376-404:
        # node coords divided componentwise by *its own* GP location.
        node_over_gp = _TET4_NODES / gps  # [4 nodes, 3] / [4 gps, 3] rowwise
        xi, eta, zeta = node_over_gp[:, 0], node_over_gp[:, 1], node_over_gp[:, 2]
        extrap = np.stack([1 - xi - eta - zeta, xi, eta, zeta], axis=1)
        return ElementFormulation(
            name=name,
            nnode=4,
            ngp=4,
            gauss_dN=np.repeat(_tet4_dshape()[None], 4, axis=0),
            gauss_w=np.full(4, 0.25),
            extrap=extrap,
        )
    raise KeyError(f"Unknown element formulation: {name!r}")


ALL_FORMULATIONS = ("HEX8_G1", "HEX8_G2", "TET4_G1", "TET4_G2")
