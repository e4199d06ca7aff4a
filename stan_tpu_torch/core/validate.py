# Copied unchanged from stan_tpu/core/validate.py.
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

    return problems


def validate(model, *, require_loads: bool = True) -> None:
    """Raise ValidationError listing every problem; no-op when valid."""
    problems = check_model(model, require_loads=require_loads)
    if problems:
        raise ValidationError(problems)
