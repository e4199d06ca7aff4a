"""What the benchmark hands the program: its model object, built from the
benchmark's own mesh arrays (perfbench/mesh.py), as the program's
``core.meshgen.hex_beam`` builds one. The drivers import the program
through this module and the entries they time; nothing else of
``stan_tpu_torch`` is read."""

from __future__ import annotations

import numpy as np

from stan_tpu_torch.core.model import (AnalysisSettings, BoundaryCondition,
                                       FEModel, Material, PartInfo)


def fe_model(beam, *, E: float, nu: float, elem_type: str, load,
             tolerance: float) -> FEModel:
    """The clamped beam as an FEModel: one material (E, ν), SPC on the
    fixed face, the tip load `load` = (direction, total) as a PointLoad,
    CG to `tolerance`."""
    nnode, nelem = beam.nnode, beam.conn.shape[0]
    model = FEModel(
        node_ids=np.arange(1, nnode + 1, dtype=np.int64),
        coords=beam.coords, elem_ids=np.arange(1, nelem + 1, dtype=np.int64),
        conn=beam.conn, elem_pid=np.ones(nelem, dtype=np.int64),
        elem_type=[elem_type] * nelem,
        analysis=AnalysisSettings(lin_solver="CG",
                                  lin_solver_tolerance=tolerance))
    model.materials[1] = Material(id=1, name="steel", E=E, poisson=nu)
    model.elem_mat = np.ones(nelem, dtype=np.int64)
    model.part_info[1] = PartInfo(mat_id=1, name="beam", hex_type=elem_type)
    spc = BoundaryCondition(id=1, type="SPC", name="clamp")
    for n in beam.fixed_nodes:
        spc.nodal_values[int(n) + 1] = np.ones(3)
    model.bcs[1] = spc
    model.bcs[2] = BoundaryCondition(id=2, type="PointLoad", name="tip")
    set_tip_load(model, beam, *load)
    return model


def set_tip_load(model: FEModel, beam, direction, total: float) -> None:
    """Replace the model's tip load: `total` along `direction`, spread
    evenly over the tip face."""
    per_node = (np.asarray(direction, np.float64)
                * (total / len(beam.tip_nodes)))
    model.bcs[2].nodal_values = {int(n) + 1: per_node.copy()
                                 for n in beam.tip_nodes}
