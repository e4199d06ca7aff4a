"""Whole solves, one after another: ``analysis.linear.solve_linear_statics
(model, device=..., store=False)`` of the program, operator set-up, CG,
float64 certification on the host and stress recovery in each.

Each request is one solve of the beam under its tip load (the
configuration's total over the x = L face) turned to each of the traffic's
"directions" directions spread evenly over the sphere, over and over, each
pass in an order drawn from the seed (every seed gets the same work); the
model is the same object throughout, its load replaced
before each solve. Every solve keeps its PhaseTimer record (the program's
own spans). A seeded share of the solves keeps its certified float64
displacement for the check: its relative residual under the reference's
own K. One solve, drawn from the seed among the first "full_within",
keeps its strain, stress and reactions too; the reference solves that
case itself (float64 CG to "reference_tol") and recovers its own fields
from its own answer, and the check compares the program's with them
(reactions on the clamped nodes, where they are the supports' forces).

variant (perfbench/tools/readings.py and the tests): "control" puts the
reference in float32 in the program's place (its float32 CG, uncertified,
and its recovery in float32); "altered" scales the program's stress by
1 + 1e-3 where it is produced; "unchanged" returns zero displacements.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import mesh, program, seeds
from perfbench.drivers import Base
from perfbench.reference import fem


class Driver(Base):
    TINY, SMALL = (6, 4, 4), (24, 24, 24)
    FAULTS = ("unchanged", "altered")

    def setup(self):
        from stan_tpu_torch.analysis import linear
        from stan_tpu_torch.utils.timing import PhaseTimer

        c = self.cfg
        self.beam = mesh.hex_beam(*self.grid)
        self.model = program.fe_model(
            self.beam, E=c["E"], nu=c["nu"], elem_type=c["elem_type"],
            load=((0.0, 0.0, -1.0), c["load_total"]),
            tolerance=c["tolerance"])

        def solve(d):
            program.set_tip_load(self.model, self.beam, d, c["load_total"])
            timer = PhaseTimer(verbose=False)
            res = linear.solve_linear_statics(self.model, device=self.device,
                                              store=False, timer=timer)
            return res, timer.records

        self.solve = solve
        if self.variant == "control":
            self.solve = self._control()
        elif self.variant == "altered":
            def altered(d):
                res, rec = solve(d)
                res.stress = res.stress * np.float32(1 + 1e-3)
                return res, rec
            self.solve = altered
        elif self.variant == "unchanged":
            def unchanged(d):
                res, rec = solve(d)
                res.u_certified = np.zeros_like(res.u_certified)
                return res, rec
            self.solve = unchanged
        self.directions = seeds.cycle(
            self.seed, "directions", seeds.sphere(self.t["directions"]))
        self.keeps = seeds.rng(self.seed, "keep")
        self.full_index = int(seeds.rng(self.seed, "full").integers(
            self.t["full_within"]))
        self.kept, self.full, self.phases = [], None, []
        self.solve((0.0, 0.0, -1.0))  # warm every shape

    def _control(self):
        """The reference in float32 in the program's place."""
        c = self.cfg
        lam, mu = fem.lame(c["E"], c["nu"])
        ref = fem.ElementOperator(self.beam.coords, self.beam.conn,
                                  self.beam.fixed_nodes, lam, mu,
                                  dtype=torch.float32, device=self.device)
        diag = ref.diagonal()

        class Out:
            pass

        def solve(d):
            b = ref.free * torch.as_tensor(self.beam.load(d, c["load_total"]),
                                           dtype=torch.float32,
                                           device=self.device)
            u, _, rel = fem.cg(ref.masked, b[None], diag, tol=c["tolerance"],
                               maxiter=3 * self.beam.nnode)
            eps, sig, R = fem.recover(ref, u[0], lam, mu)
            out = Out()
            out.u = u[0].cpu().numpy()
            out.u_certified = out.u.astype(np.float64)
            out.strain, out.stress = eps.cpu().numpy(), sig.cpu().numpy()
            out.reactions = R.cpu().numpy()
            out.converged = bool(rel[0] <= c["tolerance"])
            return out, []

        return solve

    def request(self, i):
        d = next(self.directions)
        with self.spans.span("solve"):
            res, records = self.solve(d)
        self.phases.append(records)
        if self.keeps.random() < self.t["keep_share"]:
            self.kept.append((d, res.u_certified))
        if i >= 0 and (self.full is None or self.full[0] != self.full_index):
            self.full = (i, d, res.u_certified, res.strain, res.stress,
                         res.reactions)
        return {"ops": 1, "failed": int(not res.converged)}

    def counters(self):
        return {"phases": list(self.phases)}  # the window's, not profile()'s

    def profile(self):
        for _ in range(self.t["profile_solves"]):
            self.request(-1)

    def release(self):
        self.solve = self.model = None
        self.empty_cache()

    def check(self):
        c, dev = self.cfg, self.device
        lam, mu = fem.lame(c["E"], c["nu"])
        ref = fem.ElementOperator(self.beam.coords, self.beam.conn,
                                  self.beam.fixed_nodes, lam, mu, device=dev)
        _, d, u_cert, strain, stress, reactions = self.full
        rel = []  # np.max of it keeps a NaN, where max() would drop it
        for dk, uk in self.kept + [(d, u_cert)]:
            b = ref.free * torch.as_tensor(self.beam.load(dk, c["load_total"]),
                                           device=dev)
            u = torch.as_tensor(np.asarray(uk, np.float64), device=dev)
            rel.append(fem.relative_residual(ref, u[None], b[None])[0])
        b = ref.free * torch.as_tensor(self.beam.load(d, c["load_total"]),
                                       device=dev)
        u_ref, _, _ = fem.cg(ref.masked, b[None], ref.diagonal(),
                             tol=self.t["reference_tol"],
                             maxiter=20 * self.beam.nnode)
        eps, sig, R = fem.recover(ref, u_ref[0], lam, mu)
        fixed = torch.as_tensor(self.beam.fixed_nodes, device=dev)

        def gap(mine, theirs):
            mine = torch.as_tensor(np.asarray(mine, np.float64), device=dev)
            return float((mine - theirs).abs().max() / theirs.abs().max())

        return [("residual_max", float(np.max(rel)),
                 self.limits["residual_max"]),
                ("strain_gap", gap(strain, eps), self.limits["strain_gap"]),
                ("stress_gap", gap(stress, sig), self.limits["stress_gap"]),
                ("reaction_gap",
                 gap(np.asarray(reactions)[self.beam.fixed_nodes], R[fixed]),
                 self.limits["reaction_gap"])]
