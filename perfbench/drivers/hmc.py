"""HMC transitions of the calibration: ``infer.hmc.hmc_transition(
guarded_logp_grad_b(prob.log_posterior), gen, state, step, inv_mass,
n_leapfrog)``, the call ``run_chains`` makes in its sampling loop, on the
problem of ``infer.calibrate.make_problem`` (float32, the configuration's
CG tolerance).

Set-up: the observations come from the reference's float64 solve at the
true (E, ν), by the configuration's recipe, with the noise drawn from the
seed; the chains start at the traffic's adapted mean plus its scale times
normal draws from the seed; step and diagonal inverse mass are fixed by
the traffic (adapted once, perfbench/tools/adapt.py). One warm transition
from its own generator follows. Each request is one transition of every
chain, its generator seeded from (seed, index): it yields one draw per
chain. Its operations are the chains' forward and adjoint solves, and
those that stopped at the program's iteration cap failed (SolveStats).

The check has two parts. Every transition of the window: the Metropolis
step worked out again from the program's own recorded numbers, the
momenta, step jitter and acceptance draws drawn again from the
transition's generator in hmc_transition's documented order, the final
momenta by the leapfrog recurrence over the program's recorded gradients,
and the acceptance min(1, exp(-ΔH)) from the recorded log posteriors at
the start and the proposal. A chain's transition is a decision error
where the returned state is not the proposal where the draw fell below
that acceptance and the start elsewhere, or where the acceptance the
program returned differs from it; a draw within BAND of the acceptance
may go either way (decision_errors, a count held to 0). One transition
drawn from the seed is then replayed against the reference, following
the program step by step from its own state: the reference's float64 log
posterior and gradient at the transition's start and at each of the
program's leapfrog positions (logp_gap, grad_gap), and each leapfrog
position from the one before with the reference's gradient and the
transition's own momenta, jitter and step (leapfrog_gap, in steps).

variant (perfbench/tools/readings.py and the tests): "control" puts the
reference, in float32 with its element products' operands rounded to TF32
and the program's CG tolerance and cap, in place of the program's
posterior; "f32" the same in plain float32 (a witness of what float32
solves at the configuration's tolerance carry); "unchanged" makes
every transition return the state it started from; "half" evaluates the first
half of the chains and gives the others their mean; "altered" adds 3 to
the first chain's log posterior where it is produced.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import mesh, program, seeds
from perfbench.drivers import Base
from perfbench.reference import calib

# Where an acceptance draw lies this close to the acceptance, rounding may
# decide either way; the recomputed and the returned acceptance are taken
# to agree within it.
BAND = 1e-9


def _tensor(x, device, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


class Driver(Base):
    TINY, SMALL = (5, 3, 3), (16, 16, 16)
    FAULTS = ("unchanged", "half", "altered")

    def posterior_reference(self, **kw) -> calib.Posterior:
        c = self.cfg
        return calib.Posterior(
            self.beam, self.obs_nodes, self.obs_dirs, self.y, self.sigma,
            (c["load_direction"], c["load_total"]),
            mu_logE=math.log(c["posterior"]["E_prior_median"]),
            sigma_logE=c["posterior"]["sigma_logE"], device=self.device, **kw)

    def problem(self):
        """The beam, the observations and the program's CalibrationProblem
        (self.prob)."""
        from stan_tpu_torch.infer import calibrate

        c = self.cfg
        self.beam = mesh.hex_beam(*self.grid)
        obs = c["observations"]
        with self.reference_time():
            self.obs_nodes, self.obs_dirs, self.y, self.sigma = (
                calib.observations(
                    self.beam, c["truth"]["E"], c["truth"]["nu"],
                    (c["load_direction"], c["load_total"]), self.seed,
                    n_nodes=obs["nodes"], noise=obs["noise"],
                    threshold=obs["threshold"], device=self.device))
        model = program.fe_model(self.beam, E=c["E"], nu=c["nu"],
                                 elem_type=c["elem_type"],
                                 load=(c["load_direction"], c["load_total"]),
                                 tolerance=c["cg_tol"])
        self.prob = calibrate.make_problem(
            model, self.obs_nodes, self.obs_dirs, self.y, self.sigma,
            dtype=getattr(torch, c["dtype"]), device=self.device,
            cg_tol=c["cg_tol"],
            mu_logE=math.log(c["posterior"]["E_prior_median"]),
            sigma_logE=c["posterior"]["sigma_logE"])

    def setup(self):
        from stan_tpu_torch.infer import hmc

        t = self.t
        self.problem()
        self.stats = self.prob.fwd.stats
        inner = hmc.guarded_logp_grad_b(self.prob.log_posterior)
        if self.variant in ("control", "f32"):
            inner = self._control(tf32=self.variant == "control")
        elif self.variant == "half":
            inner = self._half(inner)
        elif self.variant == "altered":
            def altered(theta, f=inner):
                logp, grad = f(theta)
                first = torch.arange(len(logp), device=logp.device) == 0
                return logp + 3.0 * first.to(logp.dtype), grad
            inner = altered

        def timed(theta):
            with self.spans.span("grad"):
                return inner(theta)

        self.timed = timed
        self.evals = []

        def target(theta):
            logp, grad = timed(theta)
            self.evals.append((theta, logp, grad))
            return logp, grad

        def transition(gen, state):
            new, accept = hmc.hmc_transition(target, gen, state, self.step,
                                             self.inv_mass, t["n_leapfrog"])
            return (state if self.variant == "unchanged" else new), accept

        self.transition = transition
        C = t["chains"]
        g = seeds.rng(self.seed, "start")
        theta0 = (np.asarray(t["start_mean"])[None]
                  + np.asarray(t["start_sd"])[None] * g.normal(size=(C, 3)))
        theta0 = _tensor(theta0, self.device)
        self.step = torch.full((C,), float(t["step"]), dtype=torch.float64,
                               device=self.device)
        self.inv_mass = _tensor(t["inv_mass"], self.device)[None].expand(
            C, 3).contiguous()
        self.state = hmc.HMCState(theta0, *target(theta0))
        self.transitions = []
        if self.variant not in ("control", "f32"):  # nothing to warm
            self.request(-1)  # warm every shape, from its own generator

    def _control(self, tf32: bool):
        ref = self.posterior_reference(dtype=torch.float32,
                                       tol=self.cfg["cg_tol"],
                                       maxiter=min(3 * self.beam.nnode, 4000),
                                       tf32_products=tf32)

        def control(theta):
            logp, grad = (_tensor(v, theta.device) for v in
                          ref.logp_grad(theta.detach().cpu().numpy()))
            return (torch.where(torch.isfinite(logp), logp, -math.inf),
                    torch.where(torch.isfinite(grad), grad, 0.0))

        return control

    @staticmethod
    def _half(inner):
        def half(theta):
            n = max(theta.shape[0] // 2, 1)
            logp, grad = inner(theta[:n])
            C = theta.shape[0]
            return (torch.cat([logp, logp.mean().expand(C - n)]),
                    torch.cat([grad, grad.mean(0).expand(C - n, -1)]))
        return half

    def begin(self):
        self.stats0 = self.stats.as_dict()

    def request(self, i):
        before = self.stats.as_dict()
        gen = torch.Generator(device=self.device)
        key = seeds.key(self.seed, "transition" if i >= 0 else "warm", abs(i))
        gen.manual_seed(key)
        pre, n0 = self.state, len(self.evals)
        self.state, accept = self.transition(gen, pre)
        if i >= 0:
            self.transitions.append((key, pre, self.evals[n0:], accept,
                                     self.state))
        d = self.stats.since(before)
        return {"ops": d["forward_solves"] + d["adjoint_solves"],
                "failed": d["forward_unconverged"] + d["adjoint_unconverged"],
                "draws": self.t["chains"]}

    def counters(self):
        return self.stats.since(self.stats0)

    def profile(self):
        for _ in range(self.t["profile_grads"]):
            self.timed(self.state.theta)

    def release(self):
        def host(x):
            return x.detach().cpu().numpy() if torch.is_tensor(x) else x

        self.transitions = [
            (key, tuple(map(host, pre)), [tuple(map(host, e)) for e in ev],
             host(acc), tuple(map(host, out)))
            for key, pre, ev, acc, out in self.transitions]
        self.step_np, self.inv_mass_np = host(self.step), host(self.inv_mass)
        self.prob = self.transition = self.timed = self.evals = None
        self.state = None
        self.empty_cache()

    def _draws(self, key, C):
        """The momenta [C, 3], step jitter [C] and acceptance draws [C] of
        the transition seeded with `key`, drawn again as hmc_transition
        draws them."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(key)
        like = dict(dtype=torch.float64, device=self.device, generator=gen)
        inv_mass = _tensor(self.inv_mass_np, self.device)
        p0 = torch.randn((C, 3), **like) * torch.sqrt(1.0 / inv_mass)
        jitter = 0.8 + 0.4 * torch.rand(C, **like)
        draw = torch.rand(C, **like)
        return p0, jitter, draw

    def _decision_errors(self, key, pre, evals, accept, out) -> int:
        """Chains whose returned state or acceptance disagrees with the
        Metropolis step worked out again from the transition's own draws
        and the program's recorded log posteriors and gradients."""
        dev = self.device
        theta0, logp0, grad0 = (torch.as_tensor(x, device=dev) for x in pre)
        C = theta0.shape[0]
        if len(evals) != self.t["n_leapfrog"]:
            return C
        p0, jitter, draw = self._draws(key, C)
        inv_mass = _tensor(self.inv_mass_np, dev)
        s = (_tensor(self.step_np, dev) * jitter)[..., None]
        p, grad = p0, grad0
        for _, _, g in evals:  # the program's leapfrog recurrence
            p = p + 0.5 * s * grad
            grad = torch.as_tensor(g, device=dev)
            p = p + 0.5 * s * grad
        theta1, logp1, _ = (torch.as_tensor(x, device=dev) for x in evals[-1])
        ke0 = 0.5 * torch.sum(inv_mass * p0 ** 2, dim=-1)
        ke1 = 0.5 * torch.sum(inv_mass * p ** 2, dim=-1)
        la = (logp1 - ke1) - (logp0 - ke0)
        la = torch.where(torch.isfinite(la), la, -math.inf)
        want = torch.clamp(torch.exp(la), max=1.0).cpu().numpy()
        draw = draw.cpu().numpy()
        theta_out, logp_out = np.asarray(out[0]), np.asarray(out[1])
        proposal, start = ((np.asarray(theta1.cpu()), np.asarray(logp1.cpu())),
                           (np.asarray(pre[0]), np.asarray(pre[1])))
        gap = np.abs(np.asarray(accept, np.float64) - want)
        self.notes["accept_gap"] = max(self.notes.get("accept_gap", 0.0),
                                       float(np.max(gap)))
        errors = 0
        for c in range(C):
            took = [side for side in (proposal, start)
                    if np.array_equal(theta_out[c], side[0][c])
                    and np.array_equal(logp_out[c], side[1][c])]
            near = abs(draw[c] - want[c]) <= BAND
            due = [proposal] if draw[c] < want[c] else [start]
            ok = bool(took) and (near or any(t is due[0] for t in took))
            errors += int(not ok or not gap[c] <= BAND)
        return errors

    def check(self):
        L = self.limits
        self.notes = {}
        errors = sum(self._decision_errors(*tr) for tr in self.transitions)
        j = int(seeds.rng(self.seed, "check").integers(len(self.transitions)))
        key, pre, evals, accept, out = self.transitions[j]
        C = pre[0].shape[0]
        p0, jitter, _ = (x.cpu().numpy() for x in self._draws(key, C))
        inv_mass, step = self.inv_mass_np, self.step_np
        if len(evals) != self.t["n_leapfrog"]:
            return [("leapfrog_evals_missing", float(abs(
                self.t["n_leapfrog"] - len(evals))), 0.0)]
        ref = self.posterior_reference()
        points = [pre[0]] + [e[0] for e in evals]
        ref_logp, ref_grad = ref.logp_grad(np.concatenate(points))
        ref_logp = ref_logp.reshape(len(points), C)
        ref_grad = ref_grad.reshape(len(points), C, 3)
        mine_logp = np.stack([pre[1]] + [e[1] for e in evals])
        mine_grad = np.stack([pre[2]] + [e[2] for e in evals])
        with np.errstate(invalid="ignore"):
            logp_gap = float(np.max(np.abs(mine_logp - ref_logp)))
            row = np.abs(ref_grad).max(axis=2)
            scale = np.maximum(row, np.median(row))
            grad_gap = float(np.max(np.abs(mine_grad - ref_grad).max(axis=2)
                                    / scale))
            # The same gap in units of the gradient one posterior sd from
            # the mode (sd from the adapted inverse mass), for the readings.
            self.notes["grad_gap_sd"] = float(np.max(
                np.abs(mine_grad - ref_grad) * np.sqrt(inv_mass)))
            self.notes["grad_scale_min"] = float(np.min(scale))
            self.notes["grad_sd_max"] = float(np.max(
                np.abs(ref_grad) * np.sqrt(inv_mass)))
        s = (step * jitter)[:, None]
        p, gaps = p0.copy(), []
        for k in range(len(evals)):
            p_half = p + 0.5 * s * ref_grad[k]
            theta_ref = points[k] + s * inv_mass * p_half
            gaps.append(np.abs(theta_ref - points[k + 1])
                        / (s * np.sqrt(inv_mass)))
            p = p_half + 0.5 * s * ref_grad[k + 1]
        worst = float(np.max(gaps))  # a NaN stays a NaN
        return [("logp_gap", logp_gap, L["logp_gap"]),
                ("grad_gap", grad_gap, L["grad_gap"]),
                ("leapfrog_gap", worst, L["leapfrog_gap"]),
                ("decision_errors", float(errors), L["decision_errors"])]
