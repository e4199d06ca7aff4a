"""Automatic Differentiation Variational Inference (mean-field Gaussian).

Port of stan_tpu/infer/vi.py. Standard ADVI (Kucukelbir et al.):
q(θ) = N(μ, diag(exp(log σ)²)), reparameterised ELBO gradients, Adam with
optax.adam's update written out (b1 0.9, b2 0.999, eps 1e-8 added to the
bias-corrected root). Not torch.optim.Adam: constructing a torch.optim
optimiser imports torch._dynamo, about 8 s of host time once per process
on the card's host, which is longer than a short fit. Each step's
Monte-Carlo ELBO is one chain-batched call of the log density on the
[n_elbo_samples, D] draws; for FEM calibration its gradient runs through
the implicit-adjoint solve. The ε draws come from one generator on θ0's
device, seeded from `seed`, [n_elbo_samples, D] per step in step order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


@dataclasses.dataclass
class VIResult:
    mu: np.ndarray  # [D] posterior mean (Gaussian approx)
    sigma: np.ndarray  # [D] posterior stddev
    elbo_trace: np.ndarray  # [n_steps]

    def sample(self, seed: int, n: int) -> np.ndarray:
        """n draws [n, D] from q, with numpy's generator seeded by seed."""
        eps = np.random.default_rng(seed).standard_normal(
            (n, self.mu.shape[0]))
        return self.mu + eps * self.sigma


def run_advi(
    logp_fn: Callable[[torch.Tensor], torch.Tensor],
    theta0: torch.Tensor,  # [D] initial mean
    seed: int,
    *,
    n_steps: int = 2000,
    n_elbo_samples: int = 8,
    learning_rate: float = 2e-2,
) -> VIResult:
    """Fit q on theta0's device and in its dtype. `logp_fn` is a batched
    log density [S, D] -> [S]; a non-finite value scores -1e30."""
    theta0 = torch.as_tensor(theta0)
    dim = theta0.shape[0]
    mu = theta0.detach().clone().requires_grad_(True)
    log_sigma = torch.full_like(mu, -2.0).requires_grad_(True)
    params = (mu, log_sigma)
    m1 = [torch.zeros_like(p) for p in params]  # Adam's moments
    m2 = [torch.zeros_like(p) for p in params]
    gen = torch.Generator(device=theta0.device)
    gen.manual_seed(seed)
    # Gaussian entropy: 0.5*D*log(2*pi*e) + sum(log_sigma)
    entropy0 = 0.5 * dim * (1.0 + math.log(2.0 * math.pi))
    elbos = []
    for t in range(1, n_steps + 1):
        eps = torch.randn((n_elbo_samples, dim), generator=gen,
                          dtype=theta0.dtype, device=theta0.device)
        logps = logp_fn(mu + eps * torch.exp(log_sigma))
        logps = torch.where(torch.isfinite(logps), logps, -1e30)
        elbo = torch.mean(logps) + torch.sum(log_sigma) + entropy0
        grads = torch.autograd.grad(-elbo, params)
        with torch.no_grad():
            for p, g, a, b in zip(params, grads, m1, m2):
                a.copy_((1.0 - _B1) * g + _B1 * a)
                b.copy_((1.0 - _B2) * g ** 2 + _B2 * b)
                p.sub_(learning_rate * (a / (1.0 - _B1 ** t)) / (
                    torch.sqrt(b / (1.0 - _B2 ** t)) + _EPS))
        elbos.append(elbo.detach())
    return VIResult(
        mu=mu.detach().cpu().numpy(),
        sigma=torch.exp(log_sigma).detach().cpu().numpy(),
        elbo_trace=torch.stack(elbos).cpu().numpy() if elbos
        else np.zeros(0),
    )
