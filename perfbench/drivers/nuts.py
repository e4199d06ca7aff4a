"""NUTS transitions of the calibration with the load held fixed: the CLI's
default calibration. Each request is ``infer.nuts.nuts_transition(
guarded_logp_grad_b(prob.log_posterior), gen, state, step, inv_mass,
max_depth)`` of every chain, the call ``run_nuts`` makes in its sampling
loop, on the problem of ``infer.calibrate.make_problem`` (float32, the
configuration's CG tolerance), with log s held (inverse mass 0).

Set-up: the beam, observations and problem as the HMC cells'
(perfbench/drivers/hmc.py); step and diagonal inverse mass fixed by the
traffic (adapted once, perfbench/tools/adapt_nuts.py), 0 on log s; the
chains start at the traffic's mean plus its scale times normal draws from
the seed, log s at 0. One warm transition from its own generator follows,
and the run is refused (an exception: exit 1) where that transition's
state or acceptance is not finite or where any of its leaves moved a held
coordinate: a program that does not hold log s fails there instead of
building every tree to max_depth. Each request is one transition of every
chain, its generator seeded from (seed, index): one draw per chain. Its
operations are the chains' forward and adjoint solves, and those that
stopped at the program's iteration cap failed (SolveStats). Counters: the
program's SolveStats and TreeStats over the window (a program without
TreeStats counts no trees, and its tree metrics are left out).

The check has two parts. Every transition of the window is replayed by
perfbench/reference/nuts.py from its start, the program's recorded batched
evaluations and the transition's own draws (decision_errors, a count of
chains, held to 0). One transition drawn from the seed is then held to the
float64 reference posterior (perfbench/reference/calib.py), following the
program from its own states: log p and ∇ at its start and at every leaf a
chain built (logp_gap; grad_gap over the free coordinates, as the HMC
cells'), and each leaf against the leapfrog step from its edge with the
reference's gradient and the replay's momenta (leapfrog_gap, in steps,
over the free coordinates: a held coordinate has no scale there).

variant (perfbench/tools/readings.py and the tests): "control" and "f32"
as the HMC cells'; "unchanged" makes every transition return its start;
"altered" adds 3 to the first chain's log posterior where it is produced;
"no_turn" makes the program's U-turn test never fire; "held_free" gives
log s the HMC cells' inverse mass back, as a program without the hold
runs. Set-up refuses only the program itself: a variant is there for the
check to find.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import torch

from perfbench import seeds
from perfbench.drivers import hmc
from perfbench.reference import nuts as reference

# The HMC cells' adapted inverse mass on log s (calib32-hmc16.json), which a
# sampler without the hold gives that coordinate.
HELD_FREE_INV_MASS = 0.0015395858041766864


class Driver(hmc.Driver):
    TINY, SMALL = (5, 3, 3), (16, 16, 16)
    FAULTS = ("unchanged", "altered", "no_turn", "held_free")

    def setup(self):
        from stan_tpu_torch.infer import hmc as program_hmc
        from stan_tpu_torch.infer import nuts

        t = self.t
        self.problem()
        self.stats = self.prob.fwd.stats
        tree_stats = getattr(nuts, "TreeStats", None)
        self.tree = tree_stats() if tree_stats is not None else None
        inner = program_hmc.guarded_logp_grad_b(self.prob.log_posterior)
        if self.variant in ("control", "f32"):
            inner = self._control(tf32=self.variant == "control")
        elif self.variant == "altered":
            def altered(theta, f=inner):
                logp, grad = f(theta)
                first = torch.arange(len(logp), device=logp.device) == 0
                return logp + 3.0 * first.to(logp.dtype), grad
            inner = altered

        def timed(theta):
            with self.spans.span("grad"):
                return inner(theta)

        self.evals = []

        def target(theta):
            logp, grad = timed(theta)
            self.evals.append((theta, logp, grad))
            return logp, grad

        C = t["chains"]
        self.step = torch.full((C,), float(t["step"]), dtype=torch.float64,
                               device=self.device)
        self.inv_mass = hmc._tensor(t["inv_mass"], self.device)[None].expand(
            C, 3).contiguous()
        inv_mass = self.inv_mass
        if self.variant == "held_free":
            inv_mass = torch.where(inv_mass == 0, HELD_FREE_INV_MASS,
                                   inv_mass)
        kw = {} if self.tree is None else {"stats": self.tree}
        no_turn = (mock.patch.object(
            nuts, "_turning", lambda p_left, p_right, sum_p, im: torch.zeros(
                len(p_left), dtype=torch.bool, device=p_left.device))
            if self.variant == "no_turn" else contextlib.nullcontext())

        def transition(gen, state):
            with no_turn:
                return nuts.nuts_transition(target, gen, state, self.step,
                                            inv_mass, t["max_depth"], **kw)

        self.transition = transition
        g = seeds.rng(self.seed, "start")
        theta0 = (np.asarray(t["start_mean"])[None]
                  + np.asarray(t["start_sd"])[None] * g.normal(size=(C, 3)))
        theta0 = hmc._tensor(theta0, self.device)
        self.state = program_hmc.HMCState(theta0, *target(theta0))
        self.transitions = []
        if self.variant not in ("control", "f32"):  # nothing to warm
            self.request(-1)  # warm every shape, from its own generator
            if self.variant == "program":
                self._refuse_unheld(*self.warm)

    def _refuse_unheld(self, key, pre, evals, accept, n_leaves, out):
        held = (self.inv_mass[0] == 0).cpu()
        finite = all(bool(torch.isfinite(x).all()) for x in (*out, accept))
        moved = [bool((e[0].cpu()[:, held] != pre[0].cpu()[:, held]).any())
                 for e in evals]
        if not finite or any(moved):
            raise RuntimeError(
                f"the warm NUTS transition is not sound: state and acceptance "
                f"finite {finite}, a held coordinate moved in {sum(moved)} of "
                f"{len(evals)} leaves; the program does not hold log s")

    def begin(self):
        self.stats0 = self.stats.as_dict()
        self.tree0 = self.tree.as_dict() if self.tree is not None else None

    def request(self, i):
        before = self.stats.as_dict()
        gen = torch.Generator(device=self.device)
        key = seeds.key(self.seed, "transition" if i >= 0 else "warm", abs(i))
        gen.manual_seed(key)
        pre, n0 = self.state, len(self.evals)
        new, accept, n_leaves = self.transition(gen, pre)
        self.state = pre if self.variant == "unchanged" else new
        record = (key, pre, self.evals[n0:], accept, n_leaves, self.state)
        if i >= 0:
            self.transitions.append(record)
        else:
            self.warm = record
        d = self.stats.since(before)
        return {"ops": d["forward_solves"] + d["adjoint_solves"],
                "failed": d["forward_unconverged"] + d["adjoint_unconverged"],
                "draws": self.t["chains"]}

    def counters(self):
        c = self.stats.since(self.stats0)
        if self.tree is not None:
            c.update(self.tree.since(self.tree0))
        return c

    def profile(self):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds.key(self.seed, "profile"))
        self.transition(gen, self.state)

    def release(self):
        def host(x):
            return x.detach().cpu().numpy() if torch.is_tensor(x) else x

        self.transitions = [
            (key, tuple(map(host, pre)), [tuple(map(host, e)) for e in ev],
             host(acc), host(n), tuple(map(host, out)))
            for key, pre, ev, acc, n, out in self.transitions]
        self.step_np, self.inv_mass_np = host(self.step), host(self.inv_mass)
        self.prob = self.transition = self.evals = self.state = None
        self.empty_cache()

    def check(self):
        L = self.limits
        self.notes = {}
        max_depth = self.t["max_depth"]
        errors = sum(reference.decision_errors(
            key, pre, evals, out, acc, n, self.step_np, self.inv_mass_np,
            max_depth, self.device)
            for key, pre, evals, acc, n, out in self.transitions)
        j = int(seeds.rng(self.seed, "check").integers(len(self.transitions)))
        key, pre, evals, _, _, _ = self.transitions[j]
        r = reference.replay(key, pre, evals, self.step_np, self.inv_mass_np,
                             max_depth, self.device)
        inv_mass = self.inv_mass_np
        free = inv_mass[0] > 0
        # The start of every chain, then every leaf a chain built.
        rows = [(c, -1) for c in range(len(r.built))] + [
            (c, k) for c in range(len(r.built)) for k, _, _ in r.built[c]]

        def point(c, k):
            return tuple(x[c] for x in (pre if k < 0 else evals[k]))

        theta, logp, grad = (np.stack(x) for x in zip(*(point(c, k)
                                                        for c, k in rows)))
        ref_logp, ref_grad = self.posterior_reference().logp_grad(theta)
        at = {row: i for i, row in enumerate(rows)}
        with np.errstate(invalid="ignore"):
            logp_gap = float(np.max(np.abs(logp - ref_logp)))
            diff = np.abs(grad - ref_grad)[:, free]
            row = np.abs(ref_grad[:, free]).max(axis=1)
            scale = np.maximum(row, np.median(row))
            grad_gap = float(np.max(diff.max(axis=1) / scale))
            self.notes["grad_gap_sd"] = float(np.max(
                diff * np.sqrt(inv_mass[0, free])))
            self.notes["leaves_checked"] = len(rows) - len(r.built)
            gaps = [0.0]
            for c, leaves in enumerate(r.built):
                p_ref = {-1: r.p0[c]}
                for k, edge, eps in leaves:
                    e = at[(c, edge)]
                    p_half = p_ref[edge] + 0.5 * eps * ref_grad[e]
                    want = theta[e] + eps * inv_mass[c] * p_half
                    i = at[(c, k)]
                    gaps.append(float(np.max(
                        np.abs(want - theta[i])[free]
                        / (abs(eps) * np.sqrt(inv_mass[c, free])))))
                    p_ref[k] = p_half + 0.5 * eps * ref_grad[i]
            worst = float(np.max(gaps))  # a NaN stays a NaN
        return [("logp_gap", logp_gap, L["logp_gap"]),
                ("grad_gap", grad_gap, L["grad_gap"]),
                ("leapfrog_gap", worst, L["leapfrog_gap"]),
                ("decision_errors", float(errors), L["decision_errors"])]
