"""Post-processing: the 24 derived scalar result fields.

Port of stan_tpu/post/fields.py, the counterpart of Part.Load_Scalar
(src/STAN_Database/Part.cs:231-528). Every field is one batched torch
expression over all element-nodes at once, with the principal values from
the closed-form trigonometric solution for symmetric 3x3 matrices
(replacing MathNet Evd, Part.cs:324-337). There is no kernel here: the
pass is plain torch on the device.

Field catalogue (index -> name, Part.cs:272-297 / 403-428):
   0..2  Displacement X/Y/Z        3  Total Displacement
   4..9  Stress XX YY ZZ XY YZ XZ  10..12 Stress P1/P2/P3   13 von Mises
  14..19 Strain  (same comps)      20..22 Strain P1/P2/P3   23 Effective Strain

Parity notes:
  * the reference builds the *strain* tensor for its eigensolve with the
    engineering shear gamma placed directly in the off-diagonals — no 1/2
    factor (Part.cs:354-366). Reproduced as-is so Strain P1..P3 match.
  * von Mises = sqrt(((P1-P2)^2+(P2-P3)^2+(P3-P1)^2)/2)   (Part.cs:350)
  * effective strain = (2/3)*sqrt(same/2)                  (Part.cs:379)
  * cell fields take max/avg/min over the element's nodal values
    (Part.cs:383-390); point fields average a node's value over its adjacent
    elements (Part.cs:430-519).

Fields are computed in float64 by default: the closed form carries
O(sqrt(eps)·scale) error at repeated roots, about 2.4e-4 of the tensor's
scale in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from stan_tpu_torch.fem.operator import resolve_device

FIELD_NAMES: List[str] = [
    "Displacement X", "Displacement Y", "Displacement Z", "Total Displacement",
    "Stress XX", "Stress YY", "Stress ZZ", "Stress XY", "Stress YZ", "Stress XZ",
    "Stress P1", "Stress P2", "Stress P3", "von Mises Stress",
    "Strain XX", "Strain YY", "Strain ZZ", "Strain XY", "Strain YZ", "Strain XZ",
    "Strain P1", "Strain P2", "Strain P3", "Effective Strain",
]
NUM_FIELDS = len(FIELD_NAMES)  # 24 (Part.cs:233)


def principal_values_sym3(s: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric 3x3 tensors, descending: [..., 3].

    Input in Voigt order (xx, yy, zz, xy, yz, xz) — off-diagonals are used
    as given (see module docstring re engineering shear). Closed-form
    trigonometric method (stable for the repeated-eigenvalue case via
    clamping), replacing MathNet's Evd (Part.cs:324-337).
    """
    xx, yy, zz = s[..., 0], s[..., 1], s[..., 2]
    xy, yz, xz = s[..., 3], s[..., 4], s[..., 5]
    q = (xx + yy + zz) / 3.0
    dxx, dyy, dzz = xx - q, yy - q, zz - q
    p2 = (dxx**2 + dyy**2 + dzz**2) / 6.0 + (xy**2 + yz**2 + xz**2) / 3.0
    p = torch.sqrt(p2)
    # det(B) / 2 with B = (A - qI) / p
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    bxx, byy, bzz = dxx / safe_p, dyy / safe_p, dzz / safe_p
    bxy, byz, bxz = xy / safe_p, yz / safe_p, xz / safe_p
    r = (
        bxx * (byy * bzz - byz * byz)
        - bxy * (bxy * bzz - byz * bxz)
        + bxz * (bxy * byz - byy * bxz)
    ) / 2.0
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    vals = torch.stack([e1, e2, e3], dim=-1)
    return torch.where(p[..., None] > 0, vals, torch.stack([q, q, q], dim=-1))


def _tensor_fields(t: torch.Tensor) -> torch.Tensor:
    """[..., 6] Voigt -> [..., 10]: 6 components + P1..P3 + invariant slot.

    The invariant slot holds sqrt(((P1-P2)^2 + (P2-P3)^2 + (P3-P1)^2)/2)
    (von Mises for stress; multiply by 2/3 for effective strain).
    """
    P = principal_values_sym3(t)
    p1, p2, p3 = P[..., 0], P[..., 1], P[..., 2]
    inv = torch.sqrt(((p1 - p2) ** 2 + (p2 - p3) ** 2 + (p3 - p1) ** 2) / 2.0)
    return torch.cat([t, P, inv[..., None]], dim=-1)


def elemnode_fields(disp: torch.Tensor, conn: torch.Tensor,
                    stress: torch.Tensor, strain: torch.Tensor
                    ) -> torch.Tensor:
    """All 24 fields at every element-node: [E, nn, 24].

    disp [nnode, 3], conn i64[E, nn], stress / strain [E, nn, 6]."""
    u_e = disp[conn]  # [E, nn, 3]
    total = torch.linalg.vector_norm(u_e, dim=-1, keepdim=True)
    s_f = _tensor_fields(stress)  # [E, nn, 10] (slot 9 = von Mises)
    e_f = _tensor_fields(strain)
    e_f[..., 9] *= 2.0 / 3.0  # effective strain (Part.cs:379)
    return torch.cat([u_e, total, s_f, e_f], dim=-1)


def cell_fields(en: torch.Tensor):
    """Element (cell) max / average / min over the element's nodes.

    en: [E, nn, 24] -> three [E, 24] tensors (Part.cs:383-390).
    """
    return en.amax(dim=1), en.mean(dim=1), en.amin(dim=1)


def point_fields(en: torch.Tensor, conn: torch.Tensor, nnode: int
                 ) -> torch.Tensor:
    """Node (point) average over adjacent elements: [nnode, 24].

    The reference averages the per-element nodal values over every element
    touching the node (Part.cs:430-519); that is a segment-mean over the
    flattened (element, node) incidence, here index_add_.
    """
    flat = en.reshape(-1, en.shape[-1])
    seg = conn.reshape(-1)
    sums = torch.zeros((nnode, flat.shape[-1]), dtype=en.dtype,
                       device=en.device).index_add_(0, seg, flat)
    counts = torch.zeros(nnode, dtype=en.dtype, device=en.device).index_add_(
        0, seg, torch.ones_like(seg, dtype=en.dtype))
    return sums / counts.clamp_min(1.0)[:, None]


def compute_all(model, inc: int, *, device="cuda",
                dtype=torch.float64) -> Dict[str, np.ndarray]:
    """All cell + point fields for one increment, keyed by reference names,
    computed on `device` in `dtype` and returned as numpy arrays.

    Names match Part.cs:272-297/403-428 exactly, e.g.
    "Max Stress XX INC 1", "Average Strain P1 INC 0",
    "von Mises Stress INC 1" (point variant has no prefix).
    """
    if model.disp is None:
        raise ValueError("Model has no results")
    dev = resolve_device(device)

    def put(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    conn = torch.as_tensor(np.asarray(model.conn), dtype=torch.int64,
                           device=dev)
    en = elemnode_fields(put(model.disp[inc]), conn, put(model.stress[inc]),
                         put(model.strain[inc]))
    cells = torch.stack(cell_fields(en)).cpu().numpy()  # [3, E, 24]
    pavg = point_fields(en, conn, model.nnode).cpu().numpy()
    out: Dict[str, np.ndarray] = {}
    for s, name in enumerate(FIELD_NAMES):
        out[f"Max {name} INC {inc}"] = cells[0, :, s]
        out[f"Average {name} INC {inc}"] = cells[1, :, s]
        out[f"Min {name} INC {inc}"] = cells[2, :, s]
        out[f"{name} INC {inc}"] = pavg[:, s]
    return out


def export_vtu(
    model,
    prefix: str,
    *,
    increments=None,
    fields=None,
    binary: bool = True,
    deformed: bool = True,
    cell_variants: bool = True,
    device="cuda",
) -> List[str]:
    """Write one .vtu per increment: ``prefix_###.vtu``.

    Mirrors ExportWindow.Export_Click (ExportWindow.xaml.cs:43-108): chosen
    arrays on the (optionally deformed, ExportGrid -> UpdateNode) mesh, one
    file per increment. ``fields`` filters by base field name (default: all
    24 fields). Point variants go out as PointData; the reference's cell
    variants (Element Max / Average / Min, Part.cs:383-390 and the
    ExportWindow tri-state tree, ExportWindow.xaml.cs:61-67) go out as
    CellData unless ``cell_variants=False``. The fields are computed on
    `device` (compute_all).
    """
    from stan_tpu_torch.io import vtu as vtu_mod

    if model.disp is None:
        raise ValueError("Model has no results")
    ninc = model.disp.shape[0]
    incs = list(range(ninc)) if increments is None else list(increments)
    wanted = set(fields) if fields is not None else set(FIELD_NAMES)
    paths = []
    for inc in incs:
        all_fields = compute_all(model, inc, device=device)
        point_data, cell_data = {}, {}
        for name, arr in all_fields.items():
            is_cell = name.startswith(("Max ", "Average ", "Min "))
            base = name.rsplit(" INC ", 1)[0]
            if is_cell:
                base = base.split(" ", 1)[1]
            if base not in wanted:
                continue
            if is_cell:
                if cell_variants:
                    cell_data[name] = arr
            else:
                point_data[name] = arr
        pts = model.coords + (model.disp[inc] if deformed else 0.0)
        path = f"{prefix}_{inc:03d}.vtu"
        vtu_mod.write_vtu(
            path, pts, model.conn, point_data=point_data,
            cell_data=cell_data or None, binary=binary,
        )
        paths.append(path)
    return paths
