# Copied from stan_tpu/core/model.py; the port keeps its own copy.
"""Struct-of-arrays FEM data model.

TPU-native replacement for the reference object graph
(src/STAN_Database/Database.cs:9-37: NodeLib/ElemLib/MatLib/BCLib as
``Dictionary<int, T>``). Dictionaries of objects do not map to XLA; here the
model is flat, statically-shaped arrays indexed by a dense 0-based node /
element index, with the original Nastran IDs kept as side tables for IO and
reporting only.

All device math uses the dense indices. Boundary conditions are arrays over
nodes (fix masks and load vectors) rather than per-BC dictionaries
(reference: src/STAN_Database/BoundaryCondition.cs:10-14), which makes
Dirichlet handling a static masking operation (see fem/operator.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from stan_tpu_torch.fem import elements as element_lib


@dataclasses.dataclass
class Material:
    """Linear elastic isotropic material (reference: Material.cs:7-61)."""

    id: int
    name: str = "blank"
    type: str = "Elastic"
    # Reference default sentinel is -999 for "not set" (Material.cs:27-29).
    E: float = -999.0
    poisson: float = -999.0
    color_id: int = 0

    def d_matrix(self) -> np.ndarray:
        """6x6 constitutive matrix from Lame lambda and shear modulus G.

        Strain ordering (xx, yy, zz, xy, yz, xz) with engineering shear,
        exactly as Material.cs:31-56.
        """
        lam = (self.E * self.poisson) / (
            (1 - 2 * self.poisson) * (1 + self.poisson)
        )
        G = 0.5 * self.E / (1 + self.poisson)
        D = np.zeros((6, 6), dtype=np.float64)
        D[:3, :3] = lam
        D[0, 0] = D[1, 1] = D[2, 2] = lam + 2 * G
        D[3, 3] = D[4, 4] = D[5, 5] = G
        return D


@dataclasses.dataclass
class BoundaryCondition:
    """One named BC set (reference: BoundaryCondition.cs:10-14).

    ``nodal_values`` maps node ID -> 3-vector; for SPC a 0/1 fix flag per
    direction, for PointLoad the force components.
    """

    id: int
    type: str  # "SPC" | "PointLoad"
    name: str = "blank"
    color_id: int = 0
    nodal_values: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AnalysisSettings:
    """Run configuration (reference: Analysis.cs:8-25, same defaults)."""

    type: str = "Linear_Statics"
    lin_solver: str = "CG"
    lin_solver_tolerance: float = 1.0e-6
    lin_solver_maxiter: int = 0  # 0 = automatic
    inc_numb: int = 0
    result_step_no: int = 0


@dataclasses.dataclass
class PartInfo:
    """Per-part metadata sidecar (reference: Information.cs:32-62)."""

    color_id: int = 0
    mat_id: int = 0
    name: str = "blank"
    hex_type: str = "blank"
    penta_type: str = "blank"
    tet_type: str = "blank"


@dataclasses.dataclass
class FEModel:
    """The full model: mesh + materials + BCs + analysis settings.

    Mesh arrays (struct-of-arrays):
      node_ids   i64[nnode]      original Nastran node IDs (sorted ascending)
      coords     f64[nnode, 3]
      elem_ids   i64[nelem]      original element IDs
      conn       i64[nelem, nn]  dense node indices per element
      elem_pid   i64[nelem]
      elem_type  list[str]       formulation name per element (HEX8_G2, ...)
    """

    node_ids: np.ndarray
    coords: np.ndarray
    elem_ids: np.ndarray
    conn: np.ndarray
    elem_pid: np.ndarray
    elem_type: List[str]
    materials: Dict[int, Material] = dataclasses.field(default_factory=dict)
    elem_mat: Optional[np.ndarray] = None  # i64[nelem] material ID per element
    bcs: Dict[int, BoundaryCondition] = dataclasses.field(default_factory=dict)
    analysis: AnalysisSettings = dataclasses.field(default_factory=AnalysisSettings)
    part_info: Dict[int, PartInfo] = dataclasses.field(default_factory=dict)
    # Results (populated by the solver): displacements per increment
    # [ninc+1, nnode, 3]; per-element nodal stress/strain [ninc+1, nelem, nn, 6].
    disp: Optional[np.ndarray] = None
    stress: Optional[np.ndarray] = None
    strain: Optional[np.ndarray] = None
    # Per-card import failures (analogue of Database.Import_Error,
    # reference: Database.cs:18,72-94 — collected, never fatal).
    import_errors: List[str] = dataclasses.field(default_factory=list)

    @property
    def nnode(self) -> int:
        return self.coords.shape[0]

    @property
    def nelem(self) -> int:
        return self.conn.shape[0]

    @property
    def ndof(self) -> int:
        # 3 DOF per node (reference: Database.cs:135-138).
        return 3 * self.nnode

    def strip_results(self) -> None:
        """Drop all solver results, shrinking the model for persistence.

        Counterpart of the reference's Remove Results action
        (MainWindow.xaml.cs:731-763 -> Element.ClearResults Element.cs:482-486
        and Node.ClearResults Node.cs:225-230, then Result_StepNo = 0)."""
        self.disp = None
        self.stress = None
        self.strain = None
        self.analysis.result_step_no = 0

    # ------------------------------------------------------------------
    # Index helpers
    # ------------------------------------------------------------------
    def node_index(self, node_id) -> np.ndarray:
        """Map original node ID(s) -> dense index via binary search."""
        idx = np.searchsorted(self.node_ids, node_id)
        if not np.all(self.node_ids[np.clip(idx, 0, self.nnode - 1)] == node_id):
            raise KeyError(f"Unknown node id(s) in {node_id}")
        return idx

    def formulation(self) -> element_lib.ElementFormulation:
        """Return the single formulation shared by all elements.

        The batched kernels require a uniform element block; mixed meshes
        are refused at ingest with a named reason (core/validate.check_model
        — per-family block splitting is not implemented). The reference is
        HEX8-only at import anyway (Database.cs:44-48); this raise is the
        last-resort guard for models built outside the validated ingest
        path.
        """
        kinds = set(self.elem_type)
        if len(kinds) != 1:
            raise ValueError(f"Mixed element formulations: {sorted(kinds)}")
        return element_lib.get(next(iter(kinds)))

    def set_formulation(self, name: str) -> None:
        """Switch integration rule for all elements (e.g. HEX8_G1 <-> G2),
        the equivalent of Part.Assign_FEtype (Part.cs:658-673)."""
        element_lib.get(name)  # validate
        self.elem_type = [name] * self.nelem

    # ------------------------------------------------------------------
    # BC assembly into dense arrays
    # ------------------------------------------------------------------
    def fix_mask(self) -> np.ndarray:
        """bool[nnode, 3]: True where the DOF is fixed by any SPC BC.

        Mirrors the Fix_DOF list construction (Solver.cs:104-117): a DOF is
        fixed when its per-direction flag equals 1.
        """
        mask = np.zeros((self.nnode, 3), dtype=bool)
        for bc in self.bcs.values():
            if bc.type != "SPC":
                continue
            for nid, vals in bc.nodal_values.items():
                idx = self.node_index(nid)
                mask[idx] |= np.asarray(vals, dtype=np.float64) == 1.0
        return mask

    def load_vector(self) -> np.ndarray:
        """f64[nnode, 3]: accumulated PointLoad forces (Solver.cs:136-152).

        Loads on fixed DOFs are zeroed by the solver's masking, matching the
        reference's skip of reduced-out rows (Solver.cs:144).
        """
        f = np.zeros((self.nnode, 3), dtype=np.float64)
        for bc in self.bcs.values():
            if bc.type != "PointLoad":
                continue
            for nid, vals in bc.nodal_values.items():
                idx = self.node_index(nid)
                f[idx] += np.asarray(vals, dtype=np.float64)
        return f

    def material_table(self) -> tuple[np.ndarray, np.ndarray]:
        """Return (mat_ids i64[nmat], D f64[nmat, 6, 6]) dense tables."""
        ids = np.array(sorted(self.materials), dtype=np.int64)
        D = np.stack([self.materials[i].d_matrix() for i in ids], axis=0)
        return ids, D

    def elem_d_matrices(self) -> np.ndarray:
        """f64[nelem, 6, 6]: constitutive matrix per element."""
        if self.elem_mat is None:
            raise ValueError("No material assignment (elem_mat is None)")
        ids, D = self.material_table()
        pos = np.searchsorted(ids, self.elem_mat)
        if not np.all(ids[np.clip(pos, 0, len(ids) - 1)] == self.elem_mat):
            missing = sorted(set(self.elem_mat) - set(ids))
            raise KeyError(f"Elements reference unknown material ids {missing}")
        return D[pos]

    def summary(self) -> str:
        """Human-readable summary matching Database_Summary (Database.cs:123)."""
        lines = [
            "  ==================   DATABASE SUMMARY   ==================",
            f"   Number of nodes:    {self.nnode:>35d}",
            f"   Number of elements: {self.nelem:>35d}",
            f"   Number of DoF:      {self.ndof:>35d}",
            "  ========================================================== ",
        ]
        return "\n".join(lines)
