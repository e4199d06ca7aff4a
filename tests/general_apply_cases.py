"""Inputs for the general operator's apply tests (tests/test_torch_operator_
apply.py on the CPU, tests/test_torch_gpu.py on the card): a randomly
perturbed small beam in each formulation, and the LE10 plate at its
rehearsal grid. Imports no jax and nothing of stan_tpu."""

import dataclasses
import json
import pathlib

import numpy as np
import torch

from stan_tpu_torch.core import meshgen
from stan_tpu_torch.fem import elements
from stan_tpu_torch.fem.operator import build_operator
from stan_tpu_torch.infer.forward import d_matrix_from_lame

FORMS = ("HEX8_G1", "HEX8_G2", "TET4_G1", "TET4_G2")
# The six tetrahedra of a HEX8 around its corner-0 to corner-6 diagonal.
HEX_TO_TETS = np.array([[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
                        [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]])
LE10 = pathlib.Path(__file__).resolve().parents[1] / "perfbench" / "configs" \
    / "le10.json"


def mesh(kind: str, form: str, seed: int = 0):
    """(coords, conn, fixed [nnode, 3]) of a perturbed 4x3x2 beam ("beam")
    or the LE10 plate at 8x4x2 ("plate"), HEX8 or split into TET4 by the
    formulation's name."""
    rng = np.random.default_rng(seed)
    if kind == "beam":
        m = meshgen.hex_beam(4, 3, 2, lx=4.0, ly=3.0, lz=2.0)
        coords = np.asarray(m.coords) + rng.uniform(-0.2, 0.2,
                                                    np.shape(m.coords))
        conn, fixed = np.asarray(m.conn), m.fix_mask()
    else:
        from perfbench import plate

        c = json.loads(LE10.read_text())
        p = plate.quarter_plate(8, 4, 2, inner=c["inner_semi_axes"],
                                outer=c["outer_semi_axes"],
                                thickness=c["thickness"])
        coords, conn, fixed = p.coords, p.conn, p.fixed
    if form.startswith("TET4"):
        conn = conn[:, HEX_TO_TETS].reshape(-1, 4)
        q = coords[conn]
        vol = np.einsum("ij,ij->i", np.cross(q[:, 1] - q[:, 0],
                                             q[:, 2] - q[:, 0]),
                        q[:, 3] - q[:, 0])
        conn[vol < 0] = conn[vol < 0][:, [0, 2, 1, 3]]
    return coords, conn, np.asarray(fixed, bool)


def case(kind: str, form: str, dtype, device, B=None, seed: int = 0):
    """(operator, u): the operator of mesh(kind, form) with a D per element
    (E drawn around 210000, nu around 0.3), and a random u [nnode, 3]; with
    B, D [B, E, 6, 6] (one field per system) and u [B, nnode, 3]."""
    coords, conn, fixed = mesh(kind, form, seed)
    rng = np.random.default_rng(seed + 1)
    shape = (len(conn),) if B is None else (B, len(conn))
    E, nu = 210000.0 * rng.uniform(0.5, 1.5, shape), rng.uniform(0.2, 0.4,
                                                                 shape)
    D = d_matrix_from_lame(torch.as_tensor(E * nu / ((1 + nu) * (1 - 2 * nu))),
                           torch.as_tensor(E / (2 * (1 + nu)))).numpy()
    op = build_operator(coords, conn, D[0] if B else D, fixed,
                        elements.get(form), dtype=dtype, device=device)
    if B is not None:
        op = dataclasses.replace(op, D=torch.as_tensor(D, dtype=dtype,
                                                       device=device))
    u = rng.standard_normal(((B,) if B else ()) + (len(coords), 3))
    return op, torch.as_tensor(u, dtype=dtype, device=device)
