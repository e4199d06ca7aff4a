"""Load cases one after another on one built operator: the certified solve
of the program, ``solvers.cg.pcg_certified`` on the float32 and float64
``StencilOperator``s of ``fem.stencil.build_stencil_operator``.

Each request is one case: the tip load (the configuration's total over the
x = L face) turned to each of the traffic's "directions" directions spread
evenly over the sphere, over and over, each pass in an order drawn from
the seed: every seed gets the same work in another order. A seeded share
of the cases, and the slowest case of the window, keep their certified
displacement for the check: its float64 relative residual under the
reference's own K (perfbench/reference/fem.py), against the
configuration's certified tolerance.

variant (perfbench/tools/readings.py and the tests): "control" puts the
reference's float32 CG in the program's place; "unchanged" returns the
zero start of the solve as its answer; "altered" scales the program's
answer by 1 + 1e-3 where it is produced.
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
        from stan_tpu_torch.fem import stencil
        from stan_tpu_torch.solvers import cg

        c = self.cfg
        self.beam = mesh.hex_beam(*self.grid)
        model = program.fe_model(self.beam, E=c["E"], nu=c["nu"],
                                 elem_type=c["elem_type"],
                                 load=((0.0, 0.0, -1.0), c["load_total"]),
                                 tolerance=c["tolerance"])
        op = stencil.build_stencil_operator(model, dtype=torch.float32,
                                            device=self.device)
        ex = stencil.build_stencil_operator(model, dtype=torch.float64,
                                            device=self.device)
        if op is None or ex is None:
            raise RuntimeError("the stencil operator refused the beam")
        diag, ndof, tol = op.diagonal(), 3 * self.beam.nnode, c["tolerance"]
        # The tip load along x, y and z in the operator's grid layout; a
        # case's right-hand side is their combination.
        self.basis = [
            (ex.free_mask * ex.to_grid(torch.as_tensor(
                self.beam.load(e, c["load_total"]), dtype=torch.float64,
                device=self.device))).contiguous() for e in np.eye(3)]

        def solve(b64):
            res = cg.pcg_certified(op.apply, b64, ex.apply, diag=diag,
                                   tol=tol, ndof=ndof)
            return res.u, res.converged, res.inner_iters, res.cycles

        self.solve = solve
        if self.variant == "control":
            self.solve = self._control()
        elif self.variant == "unchanged":
            self.solve = lambda b64: (torch.zeros_like(b64), True, 0, 0)
        elif self.variant == "altered":
            self.solve = lambda b64: ((lambda r: (r[0] * (1 + 1e-3),) + r[1:])(
                solve(b64)))
        self.program = (op, ex)
        self.directions = seeds.cycle(
            self.seed, "directions", seeds.sphere(self.t["directions"]))
        self.keeps = seeds.rng(self.seed, "keep")
        self.kept, self.slowest = [], None
        self.solve(self._rhs((0.0, 0.0, -1.0)))  # warm every shape

    def _control(self):
        """The reference in float32 in the program's place: its own
        element operator and Jacobi CG to the same tolerance, from zero."""
        c = self.cfg
        ref = fem.ElementOperator(self.beam.coords, self.beam.conn,
                                  self.beam.fixed_nodes,
                                  *fem.lame(c["E"], c["nu"]),
                                  dtype=torch.float32, device=self.device)
        diag = ref.diagonal()
        nnx, nny, nnz = self.beam.node_shape

        def solve(b64):
            b = b64.permute(1, 2, 3, 0).reshape(1, -1, 3).to(torch.float32)
            u, k, rel = fem.cg(ref.masked, b, diag, tol=c["tolerance"],
                               maxiter=3 * self.beam.nnode)
            grid = u[0].reshape(nnx, nny, nnz, 3).permute(3, 0, 1, 2)
            return (grid.to(torch.float64).contiguous(),
                    bool(rel[0] <= c["tolerance"]), k, 1)

        return solve

    def _rhs(self, d):
        return sum(float(d[i]) * self.basis[i] for i in range(3))

    def request(self, i):
        d = next(self.directions)
        with self.spans.span("case"):
            u, ok, iters, cycles = self.solve(self._rhs(d))
        if self.keeps.random() < self.t["keep_share"]:
            self.kept.append((d, u))
        if self.slowest is None or iters > self.slowest[0]:
            self.slowest = (iters, d, u)
        return {"ops": 1, "failed": int(not ok), "inner_iters": int(iters),
                "cycles": int(cycles)}

    def profile(self):
        for _ in range(self.t["profile_cases"]):
            self.request(-1)

    def release(self):
        self.program = self.solve = self.basis = None
        self.empty_cache()

    def check(self):
        c = self.cfg
        ref = fem.ElementOperator(self.beam.coords, self.beam.conn,
                                  self.beam.fixed_nodes,
                                  *fem.lame(c["E"], c["nu"]),
                                  device=self.device)
        rel = []
        for d, u in self.kept + [self.slowest[1:]]:
            u_nodes = u.permute(1, 2, 3, 0).reshape(1, -1, 3)
            b = ref.free * torch.as_tensor(self.beam.load(d, c["load_total"]),
                                           device=self.device)
            rel.append(fem.relative_residual(ref, u_nodes, b[None])[0])
        # np.max keeps a NaN, where max() would drop it
        return [("residual_max", float(np.max(rel)),
                 self.limits["residual_max"])]
