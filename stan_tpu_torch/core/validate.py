# Copied from stan_tpu/core/validate.py, with check_model also naming the
# elements whose Jacobian determinant is not positive (_inverted_elements).
"""Model validation: validate-and-refuse at ingest.

The reference collects mesh-parse failures into ``Database.Import_Error``
(src/STAN_Database/Database.cs:18,72-94) but never surfaces the list, lets
materials default to the sentinel E = nu = -999 (Material.cs:27-29) and only
blocks a GUI run on unassigned materials (MainWindow.xaml.cs:474-487); a
failed linear solve silently leaves zeros in U (SolverFunctions.cs:417-420).
Per SURVEY.md §5.3 the rebuild refuses bad input up front instead: this
module checks a loaded FEModel and raises ``ValidationError`` with the full
list of problems (not just the first).
"""

from __future__ import annotations

from typing import List

import numpy as np


class ValidationError(ValueError):
    """Raised on invalid model input; ``.problems`` lists every finding."""

    def __init__(self, problems: List[str]):
        self.problems = list(problems)
        super().__init__(
            "model validation failed:\n  - " + "\n  - ".join(self.problems))


def check_model(model, *, require_loads: bool = True) -> List[str]:
    """Return the list of problems (empty = valid)."""
    problems: List[str] = []
    coords = np.asarray(model.coords)
    conn = np.asarray(model.conn)

    if model.nnode == 0:
        problems.append("mesh has no nodes")
    if model.nelem == 0:
        problems.append("mesh has no elements")
    if coords.size and not np.isfinite(coords).all():
        bad = np.argwhere(~np.isfinite(coords).all(axis=1))[:5].ravel()
        problems.append(f"non-finite node coordinates (first: {bad.tolist()})")
    if conn.size:
        if conn.min() < 0 or conn.max() >= model.nnode:
            problems.append(
                f"connectivity references node index outside [0, {model.nnode})")
        else:
            # Degenerate elements: repeated nodes collapse the Jacobian.
            sorted_conn = np.sort(conn, axis=1)
            dup = (sorted_conn[:, 1:] == sorted_conn[:, :-1]).any(axis=1)
            if dup.any():
                problems.append(
                    f"{int(dup.sum())} element(s) with repeated nodes "
                    f"(first: element index {int(np.argmax(dup))})")

    # Mixed element families: the batched kernels require one formulation
    # per solve, and per-family block splitting is not implemented — refuse
    # at ingest with a named reason instead of failing deep inside the
    # solver (VERDICT r3 missing item 6). The reference sidesteps this by
    # whitelisting CHEXA only at import (Database.cs:44-48); our .bdf
    # reader accepts CHEXA + CTETRA, so the check lives here.
    kinds = sorted(set(model.elem_type))
    if len(kinds) > 1:
        families = sorted({k.split("_")[0] for k in kinds})
        problems.append(
            f"mixed element formulations {kinds}: a solve needs a single "
            f"formulation (families present: {families}); split the mesh "
            f"into per-family models or re-mesh with one element type "
            f"(reference imports HEX8 only, Database.cs:44-48)")

    # Materials: reference sentinel default is E = nu = -999 (Material.cs:27).
    for mid, mat in model.materials.items():
        if not (mat.E > 0) or not np.isfinite(mat.E):
            problems.append(f"material {mid}: E = {mat.E} (must be > 0)")
        if not (-1.0 < mat.poisson < 0.5):
            problems.append(
                f"material {mid}: poisson = {mat.poisson} "
                f"(must be in (-1, 0.5))")
    assigned = set(int(m) for m in np.asarray(model.elem_mat).ravel())
    missing = assigned - set(model.materials) - {0}
    if missing:
        problems.append(f"elements reference undefined material ids {sorted(missing)}")
    if 0 in assigned:
        problems.append(
            "elements with no material assigned (MatID 0) — the reference "
            "GUI refuses to run this too (MainWindow.xaml.cs:474-487)")

    # Boundary conditions.
    n_spc_dof = 0
    has_load = False
    known_ids = set(int(i) for i in np.asarray(model.node_ids).ravel())
    for bc in model.bcs.values():
        for nid in bc.nodal_values:
            if int(nid) not in known_ids:
                problems.append(
                    f"BC {bc.id} ({bc.type}) references unknown node {nid}")
                break
        if bc.type == "SPC":
            n_spc_dof += sum(
                int(np.count_nonzero(v)) for v in bc.nodal_values.values())
        elif bc.type == "PointLoad":
            has_load = has_load or any(
                np.any(np.asarray(v) != 0) for v in bc.nodal_values.values())
    if model.nelem and n_spc_dof < 6:
        problems.append(
            f"only {n_spc_dof} constrained DOF — rigid-body modes are not "
            f"suppressed (need >= 6); the solve would be singular")
    if require_loads and model.nelem and not has_load:
        problems.append("no nonzero PointLoad — the solution is trivially zero")

    problems.extend(_inverted_elements(model))
    return problems


def _inverted_elements(model, block: int = 65536) -> List[str]:
    """The elements whose Jacobian determinant is not positive at some Gauss
    point of the model's formulation, named by their ids. A mirrored node
    order makes every det J negative: K turns into -K, which Jacobi CG
    still solves, to the negated answer. Checked only where check_model's
    other findings leave the geometry defined (finite coordinates, indices
    in range, one formulation); elements with repeated nodes are named by
    their own finding."""
    coords = np.asarray(model.coords, np.float64)
    conn = np.asarray(model.conn)
    if (not conn.size or not np.isfinite(coords).all() or conn.min() < 0
            or conn.max() >= model.nnode or len(set(model.elem_type)) != 1):
        return []
    dN = np.asarray(model.formulation().gauss_dN, np.float64)  # [G, 3, nn]
    bad = []
    for lo in range(0, conn.shape[0], block):
        part = conn[lo:lo + block]
        J = np.einsum("gkn,enj->egkj", dN, coords[part])
        det = (J[..., 0, 0] * (J[..., 1, 1] * J[..., 2, 2]
                               - J[..., 1, 2] * J[..., 2, 1])
               - J[..., 0, 1] * (J[..., 1, 0] * J[..., 2, 2]
                                 - J[..., 1, 2] * J[..., 2, 0])
               + J[..., 0, 2] * (J[..., 1, 0] * J[..., 2, 1]
                                 - J[..., 1, 1] * J[..., 2, 0]))
        sorted_part = np.sort(part, axis=1)
        repeated = (sorted_part[:, 1:] == sorted_part[:, :-1]).any(axis=1)
        bad.append(lo + np.flatnonzero((det <= 0).any(axis=1) & ~repeated))
    bad = np.concatenate(bad)
    if not bad.size:
        return []
    ids = np.asarray(model.elem_ids)[bad[:10]].tolist()
    return [f"{bad.size} element(s) with a Jacobian determinant <= 0 at a "
            f"Gauss point: inverted or mirrored node order (element ids "
            f"{ids}{' ...' if bad.size > 10 else ''})"]


def validate(model, *, require_loads: bool = True) -> None:
    """Raise ValidationError listing every problem; no-op when valid."""
    problems = check_model(model, require_loads=require_loads)
    if problems:
        raise ValidationError(problems)
