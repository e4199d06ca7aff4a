"""Whole solves of the NAFEMS LE10 plate (perfbench/plate.py), one after
another: ``analysis.linear.solve_linear_statics(model, device=...,
store=False)`` of the program, on a curved mapped HEX8 mesh that only the
general operator takes, with operator set-up, CG, float64 certification on
the host and stress recovery in each.

Each request is one solve under the upper face's pressure p(x, y) =
pressure (1 + a x / a1 + b y / b1), (a, b) running over the traffic's
"cases" (the 9 pairs of {-0.5, 0, 0.5}^2; (0, 0) is the NAFEMS load) over
and over, each pass in an order drawn from the seed. The model is the same
object throughout, its PointLoad replaced before each solve by the
pressure's consistent nodal forces (STAN has only SPC and point loads, so
a pressure reaches it as a pre-processor's FORCE cards would). Every solve
keeps its PhaseTimer record. A seeded share of the solves keeps its
certified float64 displacement for the check: its relative residual under
the reference's own K. The window's first solve, whose load case the seed
draws, keeps its strain, stress and reactions: the reference solves that
case itself (float64 CG to "reference_tol") and recovers its own fields
from its own answer. Only the strain is held to a limit ("strain_gap"):
the stress and reaction gaps are read beside it, in the notes, since the
float32 control reads them only about twice the program's float32
recovery rounding (PERF.md, section 4). The window's first solve under
(0, 0), or one more solve under it after the window where the window held
none, gives the program's sigma_yy at D = (a0, 0, t/2), held to the
published target; at another grid than the configuration's (a rehearsal)
the target is the reference's own sigma_yy at D on that mesh.

A solve fails when it did not converge, or returned no certified
displacement, or one whose certified residual is above the tolerance.
A program that returns no certified displacement at all (one that skips
certification at this size) is refused at set-up, before the window.

variant (perfbench/tools/readings.py and the tests): "control" puts the
reference in float32 in the program's place (its float32 CG, uncertified,
and its recovery in float32); "altered" scales the program's strain by
1 + 1e-3 where it is produced; "unchanged" returns zero displacements.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from perfbench import plate as plate_mod
from perfbench import seeds
from perfbench.drivers import Base
from perfbench.reference import fem, general
from stan_tpu_torch.core.model import (AnalysisSettings, BoundaryCondition,
                                       FEModel, Material, PartInfo)


def fe_model(plate, *, E: float, nu: float, elem_type: str,
             tolerance: float) -> FEModel:
    """The plate as an FEModel: one material (E, nu), an SPC flag per
    supported direction, an empty PointLoad (set_load fills it), CG to
    `tolerance`."""
    nnode, nelem = plate.nnode, plate.nelem
    model = FEModel(
        node_ids=np.arange(1, nnode + 1, dtype=np.int64),
        coords=plate.coords, elem_ids=np.arange(1, nelem + 1, dtype=np.int64),
        conn=plate.conn, elem_pid=np.ones(nelem, dtype=np.int64),
        elem_type=[elem_type] * nelem,
        analysis=AnalysisSettings(lin_solver="CG",
                                  lin_solver_tolerance=tolerance))
    model.materials[1] = Material(id=1, name="steel", E=E, poisson=nu)
    model.elem_mat = np.ones(nelem, dtype=np.int64)
    model.part_info[1] = PartInfo(mat_id=1, name="plate", hex_type=elem_type)
    spc = BoundaryCondition(id=1, type="SPC", name="supports")
    for n in np.flatnonzero(plate.fixed.any(axis=1)):
        spc.nodal_values[int(n) + 1] = plate.fixed[n].astype(np.float64)
    model.bcs[1] = spc
    model.bcs[2] = BoundaryCondition(id=2, type="PointLoad", name="pressure")
    return model


def set_load(model: FEModel, f: np.ndarray) -> None:
    """Replace the model's point loads by the nodal forces f [nnode, 3]."""
    model.bcs[2].nodal_values = {int(n) + 1: f[n].copy()
                                 for n in np.flatnonzero(f.any(axis=1))}


class Driver(Base):
    TINY, SMALL = (8, 4, 2), (48, 32, 8)
    FAULTS = ("unchanged", "altered")

    def setup(self):
        from stan_tpu_torch.analysis import linear
        from stan_tpu_torch.utils.timing import PhaseTimer

        c = self.cfg
        self.plate = plate_mod.quarter_plate(
            *self.grid, inner=c["inner_semi_axes"],
            outer=c["outer_semi_axes"], thickness=c["thickness"])
        self.model = fe_model(self.plate, E=c["E"], nu=c["nu"],
                              elem_type=c["elem_type"],
                              tolerance=c["tolerance"])

        def solve(ab):
            set_load(self.model, self.load(ab))
            timer = PhaseTimer(verbose=False)
            res = linear.solve_linear_statics(self.model, device=self.device,
                                              store=False, timer=timer)
            return res, timer.records

        self.solve = solve
        if self.variant == "control":
            self.solve = self._control()
        elif self.variant == "altered":
            def altered(ab):
                res, rec = solve(ab)
                res.strain = res.strain * np.float32(1 + 1e-3)
                return res, rec
            self.solve = altered
        elif self.variant == "unchanged":
            def unchanged(ab):
                res, rec = solve(ab)
                res.u_certified = np.zeros_like(res.u_certified)
                return res, rec
            self.solve = unchanged
        self.cases = seeds.cycle(self.seed, "cases",
                                 np.asarray(self.t["cases"], np.float64))
        self.keeps = seeds.rng(self.seed, "keep")
        self.kept, self.full, self.sigma_d, self.phases = [], None, None, []
        self.notes = {"operators": [], "true_residuals": []}
        res, _ = self.solve((0.0, 0.0))  # warm every shape
        if res.u_certified is None:
            raise RuntimeError(
                "perfbench: the program returned no certified displacement "
                f"(operator {res.operator}, {self.plate.nelem} elements): "
                "it did not certify the solve")

    def load(self, ab) -> np.ndarray:
        return self.plate.load(float(ab[0]), float(ab[1]),
                               self.cfg["pressure"])

    def _control(self):
        """The reference in float32 in the program's place."""
        c, p = self.cfg, self.plate
        lam, mu = fem.lame(c["E"], c["nu"])
        ref = general.ElementOperator(p.coords, p.conn, p.fixed, lam, mu,
                                      dtype=torch.float32,
                                      device=self.device)
        diag = ref.diagonal()

        class Out:
            operator = "reference-float32"

        def solve(ab):
            b = ref.free * torch.as_tensor(self.load(ab), dtype=torch.float32,
                                           device=self.device)
            u, _, rel = fem.cg(ref.masked, b[None], diag, tol=c["tolerance"],
                               maxiter=3 * p.nnode)
            eps, sig, R = ref.recover(u[0])
            out = Out()
            out.u = u[0].cpu().numpy()
            out.u_certified = out.u.astype(np.float64)
            out.strain, out.stress = eps.cpu().numpy(), sig.cpu().numpy()
            out.reactions = R.cpu().numpy()
            out.converged = bool(rel[0] <= c["tolerance"])
            out.true_residual = float(rel[0])  # its own recurrence's
            return out, []

        return solve

    def request(self, i):
        ab = tuple(float(v) for v in next(self.cases))
        with self.spans.span("solve"):
            res, records = self.solve(ab)
        self.phases.append(records)
        self.notes["operators"].append(res.operator)
        self.notes["true_residuals"].append(res.true_residual)
        if res.u_certified is not None and (
                self.keeps.random() < self.t["keep_share"]):
            self.kept.append((ab, res.u_certified))
        if i >= 0 and res.u_certified is not None:
            self._keep(ab, res)
        ok = (res.converged and res.u_certified is not None
              and res.true_residual is not None
              and res.true_residual <= self.cfg["tolerance"])
        return {"ops": 1, "failed": int(not ok)}

    def counters(self):
        return {"phases": list(self.phases)}  # the window's, not profile()'s

    def profile(self):
        for _ in range(self.t["profile_solves"]):
            self.request(-1)

    def _keep(self, ab, res):
        """The first solve's fields, the first (0, 0) solve's sigma_yy(D)."""
        if self.full is None:
            self.full = (ab, res.u_certified, res.strain, res.stress,
                         res.reactions)
        if self.sigma_d is None and ab == (0.0, 0.0):
            p = self.plate
            self.sigma_d = float(res.stress[p.d_elem, p.d_corner, 1])

    def release(self):
        if self.sigma_d is None:  # the window held no solve under (0, 0)
            res, _ = self.solve((0.0, 0.0))
            self._keep((0.0, 0.0), res)
        self.solve = self.model = None
        self.empty_cache()

    def _reference(self, ref, ab):
        """The reference's own float64 CG to reference_tol under case ab,
        and its recovery: (strain, stress, reactions, iterations)."""
        b = ref.free * torch.as_tensor(self.load(ab), device=self.device)
        u_ref, iters, _ = fem.cg(ref.masked, b[None], ref.diagonal(),
                                 tol=self.t["reference_tol"],
                                 maxiter=20 * self.plate.nnode)
        return (*ref.recover(u_ref[0]), iters)

    def check(self):
        c, p, dev = self.cfg, self.plate, self.device
        lam, mu = fem.lame(c["E"], c["nu"])
        ref = general.ElementOperator(p.coords, p.conn, p.fixed, lam, mu,
                                      device=dev)
        ab, u_cert, strain, stress, reactions = self.full
        rel = []  # np.max of it keeps a NaN, where max() would drop it
        for abk, uk in self.kept + [(ab, u_cert)]:
            b = ref.free * torch.as_tensor(self.load(abk), device=dev)
            u = torch.as_tensor(np.asarray(uk, np.float64), device=dev)
            rel.append(fem.relative_residual(ref, u[None], b[None])[0])
        eps, sig, R, iters = self._reference(ref, ab)
        fixed = torch.as_tensor(p.fixed, device=dev)

        def gap(mine, theirs):
            mine = torch.as_tensor(np.asarray(mine, np.float64), device=dev)
            return float((mine - theirs).abs().max() / theirs.abs().max())

        if list(self.grid) == list(c["grid"]):
            target = c["target"]["value"]
        else:
            sig0 = sig if ab == (0.0, 0.0) else self._reference(
                ref, (0.0, 0.0))[1]
            target = float(sig0[p.d_elem, p.d_corner, 1])
        self.notes.update(
            full_case=list(ab), sigma_yy_D=self.sigma_d, target=target,
            reference_iters=iters, stress_gap=gap(stress, sig),
            reaction_gap=gap(np.asarray(reactions)[p.fixed], R[fixed]))
        certified = [r for r in self.notes["true_residuals"] if r is not None]
        print(f"plate_solve: operators {sorted(set(self.notes['operators']))}"
              f" over {len(self.notes['operators'])} solves, the largest "
              f"certified true_residual {max(certified, default=None)!r} "
              f"({len(certified)} certified); case {ab}: stress_gap "
              f"{self.notes['stress_gap']!r}, reaction_gap "
              f"{self.notes['reaction_gap']!r} (read, not limited); "
              f"sigma_yy(D) {self.sigma_d!r} (the target {target!r})",
              file=sys.stderr)
        return [("residual_max", float(np.max(rel)),
                 self.limits["residual_max"]),
                ("strain_gap", gap(strain, eps), self.limits["strain_gap"]),
                ("le10_target_gap",
                 abs(self.sigma_d - target) / abs(target),
                 self.limits["le10_target_gap"])]
