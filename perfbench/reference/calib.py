"""Plain reference for the calibration posterior: observations, and the log
posterior with its gradient by an adjoint solve.

The posterior (the configuration's, calib32.json "posterior"): θ = (log E,
t, log s) with ν = 0.5 sigmoid(t) and the load scale fixed at 1 (log s
takes no part);

    log p(θ) = -1/2 Σ_i ((y_i - u_i(θ)) / σ)^2
               - 1/2 ((log E - μ_E) / σ_E)^2 + log sigmoid(t) + log sigmoid(-t)

with u(θ) the masked linear solve K(λ, μ) u = M f of the beam, (λ, μ) the
Lame constants of (E, ν). The gradient: w = A^-1 (M ∂L/∂u) (A symmetric),
∂L/∂λ = -<w, K_λ u>, ∂L/∂μ = -<w, K_μ u>, carried to θ by autograd over
the closed-form map θ -> (λ, μ) and the prior. Every solve is
perfbench/reference/fem.py's CG; nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import fem


def lame_of(theta: torch.Tensor):
    """(λ, μ) [N] of θ [N, 3] (autograd-friendly)."""
    E = torch.exp(theta[:, 0])
    nu = 0.5 * torch.sigmoid(theta[:, 1])
    return E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu)), E / (2.0 * (1.0 + nu))


def prior(theta: torch.Tensor, mu_logE: float, sigma_logE: float):
    t = theta[:, 1]
    return (-0.5 * ((theta[:, 0] - mu_logE) / sigma_logE) ** 2
            + torch.nn.functional.logsigmoid(t)
            + torch.nn.functional.logsigmoid(-t))


def observations(beam, E: float, nu: float, load, seed: int, *,
                 n_nodes: int, noise: float, threshold: float, device,
                 tol: float = 1e-10):
    """The calibration's data, by the recipe of the port's bench.py
    (``_calibration_problem``, frozen here): the float64 reference solve at
    the true (E, ν); the first n_nodes nodes whose displacement exceeds
    `threshold` of the largest, each observed in x, y and z; σ = `noise` of
    the largest displacement component; y = u + σ N(0, 1), the noise drawn
    from `seed`. Returns (obs_nodes, obs_dirs, y, σ) as numpy."""
    lam, mu = fem.lame(E, nu)
    op = fem.ElementOperator(beam.coords, beam.conn, beam.fixed_nodes, lam,
                             mu, device=device)
    b = op.free * torch.as_tensor(beam.load(load[0], load[1]),
                                  dtype=torch.float64, device=device)[None]
    u, _, _ = fem.cg(op.masked, b, op.diagonal(), tol=tol, maxiter=50000)
    u = u[0].cpu().numpy()
    total = np.linalg.norm(u, axis=1)
    nodes = np.nonzero(total > threshold * total.max())[0][:n_nodes]
    obs_nodes = np.repeat(nodes, 3)
    obs_dirs = np.tile([0, 1, 2], len(nodes))
    sigma = noise * float(np.abs(u).max())
    rng = np.random.default_rng(seed)
    y = u[obs_nodes, obs_dirs] + sigma * rng.normal(size=len(obs_nodes))
    return obs_nodes, obs_dirs, y, sigma


class Posterior:
    """log p and ∇ log p of a batch of θ, in `dtype` on `device`; every
    forward and adjoint solve runs to `tol` (at most `maxiter`
    iterations); tf32_products: the solves' operator rounds its product's
    operands to TF32."""

    def __init__(self, beam, obs_nodes, obs_dirs, y, sigma, load, *,
                 mu_logE: float, sigma_logE: float, device,
                 dtype=torch.float64, tol: float = 1e-10,
                 maxiter: int = 50000, tf32_products: bool = False):
        self.beam = beam
        self.kw = dict(dtype=dtype, device=device)
        self.tf32 = tf32_products
        self.obs = (torch.as_tensor(np.asarray(obs_nodes), device=device),
                    torch.as_tensor(np.asarray(obs_dirs), device=device))
        self.y = torch.as_tensor(np.asarray(y), **self.kw)
        self.sigma = float(sigma)
        self.f = torch.as_tensor(beam.load(load[0], load[1]), **self.kw)
        self.mu_logE, self.sigma_logE = mu_logE, sigma_logE
        self.tol, self.maxiter = tol, maxiter
        self.unit = [fem.ElementOperator(beam.coords, beam.conn,
                                         beam.fixed_nodes, lam, mu, **self.kw)
                     for lam, mu in ((1.0, 0.0), (0.0, 1.0))]
        self.solves = 0
        self.iterations = 0

    def _solve(self, op, rhs):
        x, k, _ = fem.cg(op.masked, rhs, op.diagonal(), tol=self.tol,
                         maxiter=self.maxiter)
        self.solves += 1
        self.iterations += k
        return x

    def logp_grad(self, theta: np.ndarray):
        """(log p [N], ∇ log p [N, 3]) as float64 numpy, θ [N, 3]."""
        th = torch.as_tensor(np.asarray(theta), dtype=torch.float64,
                             device=self.kw["device"]).requires_grad_(True)
        with torch.enable_grad():
            lam, mu = lame_of(th)
        lam_w, mu_w = (v.detach().to(self.kw["dtype"]) for v in (lam, mu))
        op = fem.ElementOperator(self.beam.coords, self.beam.conn,
                                 self.beam.fixed_nodes, lam_w.cpu().numpy(),
                                 mu_w.cpu().numpy(), **self.kw,
                                 tf32_products=self.tf32)
        m = op.free
        N = th.shape[0]
        u = self._solve(op, (m * self.f).expand(N, -1, -1).contiguous())
        r = (self.y - u[(slice(None),) + self.obs]) / self.sigma
        loglike = -0.5 * (r ** 2).sum(1)
        dldu = torch.zeros_like(u)
        dldu.index_put_((torch.arange(N, device=u.device)[:, None],
                         *self.obs), r / self.sigma, accumulate=True)
        w = self._solve(op, m * dldu)
        g_lam = -((m * w) * self.unit[0].apply(m * u)).reshape(N, -1).sum(1)
        g_mu = -((m * w) * self.unit[1].apply(m * u)).reshape(N, -1).sum(1)
        with torch.enable_grad():
            lp = prior(th, self.mu_logE, self.sigma_logE)
            total = (lp.sum() + (lam * g_lam.to(torch.float64)).sum()
                     + (mu * g_mu.to(torch.float64)).sum())
            (grad,) = torch.autograd.grad(total, th)
        logp = loglike.to(torch.float64) + lp.detach()
        return logp.cpu().numpy(), grad.cpu().numpy()
