"""Sequential Monte Carlo: adaptive-tempering particle sampler.

Port of stan_tpu/infer/smc.py. Standard adaptive-tempering
SMC (Del Moral et al.):

  * particles start from the prior; the likelihood is annealed prior ->
    posterior with the inverse-temperature schedule chosen adaptively so
    each step's effective sample size stays near `ess_target`;
  * systematic resampling at every stage;
  * particles rejuvenated with a few random-walk Metropolis steps at the
    current temperature (scale from the particles' population std).

The particle axis is the batch axis of every call: `log_prior` and
`log_likelihood` take [N, D] and return [N] (for FEM calibration one
chain-batched solve per call, under torch.no_grad(), so no adjoint is
solved). The bisection for the next temperature runs on the host in numpy
against the device-computed log-likelihoods, as in the reference.

With ``mesh=`` the particles are placed over the mesh's chains axis as
hmc.run_chains places chains: `log_prior` and `log_likelihood` are
evaluated row by row (DeviceMesh.by_rows), row r's block of particles on
the row's first device, and the values come back to the mesh's home
device (over several processes, to every process's). The weights, the ESS bisection, the systematic resampling, the
walk scale and every draw stay global there, as the reference's psum and
gather make them, so placement changes no draw.

Randomness, from one generator on `device` seeded from
`seed`: sample_prior(gen, N) first; then per stage the resampling uniform
and, per Metropolis step, the proposal normals [N, D] and the acceptance
uniforms [N].
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from stan_tpu_torch.fem.operator import resolve_device
from stan_tpu_torch.parallel.distributed import canonical


@dataclasses.dataclass
class SMCResult:
    particles: np.ndarray  # [N, D] posterior particles (equal weights)
    log_evidence: float  # marginal-likelihood estimate
    temperatures: np.ndarray  # annealing schedule actually used
    acceptance: np.ndarray  # rejuvenation acceptance per stage


def _resample_index(cum: torch.Tensor, positions: torch.Tensor
                    ) -> torch.Tensor:
    """Indices of the positions in the cumulative weights. When cum[-1]
    rounds below 1 a position can land past it; the reference's gather
    clamps that index (JAX), torch's would raise, so it is clamped here."""
    idx = torch.searchsorted(cum, positions)
    return idx.clamp_max(cum.shape[0] - 1)


def _systematic_resample(gen, log_w: torch.Tensor, n: int) -> torch.Tensor:
    """Systematic resampling indices from unnormalised log-weights."""
    w = torch.exp(log_w - torch.logsumexp(log_w, dim=0))
    u = torch.rand((), generator=gen, dtype=log_w.dtype, device=log_w.device)
    positions = (u + torch.arange(n, dtype=log_w.dtype,
                                  device=log_w.device)) / n
    return _resample_index(torch.cumsum(w, dim=0), positions)


def _walk_scale(particles: torch.Tensor) -> torch.Tensor:
    """Random-walk scale per dimension: half the particles' population std
    (jnp.std's default; torch.std's default would be the unbiased one)."""
    return 0.5 * torch.std(particles, dim=0, correction=0) + 1e-8


def _mcmc_sweep(gen, log_prior, log_likelihood, particles, beta, scale,
                n_mcmc: int):
    """n_mcmc random-walk Metropolis steps at temperature beta; returns the
    particles and the mean acceptance."""

    def logp(theta):
        return log_prior(theta) + beta * log_likelihood(theta)

    lp = logp(particles)
    n_acc = 0.0
    for _ in range(n_mcmc):
        prop = particles + scale * torch.randn(
            particles.shape, generator=gen, dtype=particles.dtype,
            device=particles.device)
        lp_prop = logp(prop)
        lp_prop = torch.where(torch.isfinite(lp_prop), lp_prop, -torch.inf)
        u = torch.rand(particles.shape[0], generator=gen,
                       dtype=particles.dtype, device=particles.device)
        accept = torch.log(u) < lp_prop - lp
        particles = torch.where(accept[:, None], prop, particles)
        lp = torch.where(accept, lp_prop, lp)
        n_acc = n_acc + torch.mean(accept.to(particles.dtype))
    return particles, n_acc / max(n_mcmc, 1)


@torch.no_grad()
def run_smc(
    log_prior: Callable[[torch.Tensor], torch.Tensor],
    log_likelihood: Callable[[torch.Tensor], torch.Tensor],
    sample_prior: Callable[[torch.Generator, int], torch.Tensor],
    seed: int,
    *,
    n_particles: int = 512,
    ess_target: float = 0.5,
    n_mcmc: int = 5,
    max_stages: int = 50,
    device=None,
    mesh=None,
    particle_axis: str = "chains",
) -> SMCResult:
    """Adaptive-tempering SMC from prior to prior*likelihood, on `device`
    (default: the mesh's home device, else "cuda"; sample_prior(gen, n)
    draws there from the generator it is given). With `mesh`, the
    particles are placed over its `particle_axis` (module docstring); a
    particle count its rows do not divide is refused, and so is a
    `device` other than the mesh's home (ValueError)."""
    if mesh is not None:
        home = mesh.home
        if device is not None and canonical(resolve_device(device)) != home:
            raise ValueError(f"device {device!r} is not the mesh's home, "
                             f"this process's first device {home}, where "
                             f"the particles stay")
        device = home
        log_prior = mesh.by_rows(log_prior, particle_axis)
        log_likelihood = mesh.by_rows(log_likelihood, particle_axis)
    gen = torch.Generator(device=resolve_device(device or "cuda"))
    gen.manual_seed(seed)
    particles = sample_prior(gen, n_particles)  # [N, D]

    beta = 0.0
    temps = [0.0]
    accs = []
    log_Z = 0.0

    for _ in range(max_stages):
        ll = log_likelihood(particles)  # [N]
        ll_np = ll.cpu().numpy()
        ll_np = np.where(np.isfinite(ll_np), ll_np, -1e300)

        # Host bisection: largest delta_beta with ESS >= ess_target * N
        def ess_of(delta):
            w = delta * ll_np
            w = w - w.max()
            ew = np.exp(w)
            return (ew.sum() ** 2) / (ew**2).sum()

        target = ess_target * n_particles
        lo, hi = 0.0, 1.0 - beta
        if ess_of(hi) >= target:
            delta = hi
        else:
            for _ in range(50):
                mid = 0.5 * (lo + hi)
                if ess_of(mid) >= target:
                    lo = mid
                else:
                    hi = mid
            delta = lo
        delta = max(delta, 1e-6)
        beta = min(1.0, beta + delta)
        temps.append(beta)

        # Incremental evidence: log mean exp(delta * ll)
        w = delta * ll_np
        wmax = w.max()
        log_Z += wmax + np.log(np.mean(np.exp(w - wmax)))

        # Resample + rejuvenate
        idx = _systematic_resample(gen, delta * ll, n_particles)
        particles = particles[idx]
        particles, acc = _mcmc_sweep(gen, log_prior, log_likelihood,
                                     particles, beta,
                                     _walk_scale(particles), n_mcmc)
        accs.append(float(acc))

        if beta >= 1.0:
            break

    return SMCResult(
        particles=particles.cpu().numpy(),
        log_evidence=float(log_Z),
        temperatures=np.asarray(temps),
        acceptance=np.asarray(accs),
    )
