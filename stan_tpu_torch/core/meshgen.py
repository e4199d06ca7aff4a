# Copied from stan_tpu/core/meshgen.py; the port keeps its own copy.
"""Synthetic structured hex meshes for tests and benchmarks.

The reference ships a single manual example mesh (Example1.zip, absent from
the mirror -- see SURVEY.md section 4); this generator produces equivalent
cantilever-beam setups of any size: a structured HEX8 grid, SPC-fixed at the
x=0 face, point loads on the x=L face.
"""

from __future__ import annotations

import numpy as np

from stan_tpu_torch.core.model import (
    AnalysisSettings,
    BoundaryCondition,
    FEModel,
    Material,
    PartInfo,
)


def hex_beam(
    nx: int,
    ny: int,
    nz: int,
    *,
    lx: float = None,
    ly: float = None,
    lz: float = None,
    E: float = 210000.0,
    poisson: float = 0.3,
    load: tuple[float, float, float] = (0.0, 0.0, -10.0),
    elem_type: str = "HEX8_G2",
    fix_all_directions: bool = True,
) -> FEModel:
    """Cantilever beam: nx*ny*nz HEX8 elements, unit cells by default.

    Node ordering of each element follows the HEX8 natural-coordinate sign
    table (reference: FE_Library.cs:215-235) with (xi,eta,zeta) -> (x,y,z).
    """
    lx = float(nx if lx is None else lx)
    ly = float(ny if ly is None else ly)
    lz = float(nz if lz is None else lz)
    xs = np.linspace(0.0, lx, nx + 1)
    ys = np.linspace(0.0, ly, ny + 1)
    zs = np.linspace(0.0, lz, nz + 1)
    # Node index (i, j, k) -> flat id, k fastest
    nyz = (ny + 1) * (nz + 1)

    def nid(i, j, k):
        return i * nyz + j * (nz + 1) + k

    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    I, J, K = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    conn = np.stack(
        [
            nid(I, J, K),
            nid(I + 1, J, K),
            nid(I + 1, J + 1, K),
            nid(I, J + 1, K),
            nid(I, J, K + 1),
            nid(I + 1, J, K + 1),
            nid(I + 1, J + 1, K + 1),
            nid(I, J + 1, K + 1),
        ],
        axis=1,
    ).astype(np.int64)

    nnode = coords.shape[0]
    nelem = conn.shape[0]
    model = FEModel(
        node_ids=np.arange(1, nnode + 1, dtype=np.int64),
        coords=coords,
        elem_ids=np.arange(1, nelem + 1, dtype=np.int64),
        conn=conn,
        elem_pid=np.ones(nelem, dtype=np.int64),
        elem_type=[elem_type] * nelem,
        analysis=AnalysisSettings(),
    )
    model.materials[1] = Material(id=1, name="steel", E=E, poisson=poisson)
    model.elem_mat = np.ones(nelem, dtype=np.int64)
    model.part_info[1] = PartInfo(mat_id=1, name="beam", hex_type=elem_type)

    # SPC: fix the x=0 face
    fixed_nodes = [nid(0, j, k) for j in range(ny + 1) for k in range(nz + 1)]
    spc = BoundaryCondition(id=1, type="SPC", name="clamp")
    flags = np.ones(3) if fix_all_directions else np.array([1.0, 0.0, 0.0])
    for n in fixed_nodes:
        spc.nodal_values[int(n) + 1] = flags.copy()  # +1: external IDs
    model.bcs[1] = spc

    # PointLoad: distribute over the x=L face
    tip_nodes = [nid(nx, j, k) for j in range(ny + 1) for k in range(nz + 1)]
    pl = BoundaryCondition(id=2, type="PointLoad", name="tip")
    per_node = np.asarray(load, dtype=np.float64) / len(tip_nodes)
    for n in tip_nodes:
        pl.nodal_values[int(n) + 1] = per_node.copy()
    model.bcs[2] = pl
    return model


def uniaxial_bar(n: int = 4, *, E: float = 1000.0, poisson: float = 0.0,
                 force: float = 100.0, elem_type: str = "HEX8_G2") -> FEModel:
    """1x1x(n) bar under uniaxial tension with nu=0: analytic solution
    u_x(x) = force * x / (E * A), stress_xx = force / A (A = 1)."""
    m = hex_beam(
        n, 1, 1, lx=float(n), ly=1.0, lz=1.0, E=E, poisson=poisson,
        load=(force, 0.0, 0.0), elem_type=elem_type, fix_all_directions=False,
    )
    # Fix lateral rigid-body motion minimally: clamp x at root (already),
    # plus y/z at root nodes to pin the section without Poisson constraint.
    spc = m.bcs[1]
    for nid_ext in list(spc.nodal_values):
        spc.nodal_values[nid_ext] = np.array([1.0, 1.0, 1.0])
    return m
