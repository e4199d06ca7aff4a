"""Hamiltonian Monte Carlo with Stan-style windowed warmup, batched chains.

Port of stan_tpu/infer/hmc.py:

  * the target is a chain-batched log density θ [C, D] -> [C] that torch
    can differentiate (for FEM calibration, infer/calibrate.py's
    log_posterior on the implicit-adjoint solve); its gradient is
    torch.autograd.grad of the sum over chains, which is each chain's own
    gradient because the chains are independent;
  * one transition is a static-length leapfrog for all chains at once, with
    per-chain [C] step sizes and acceptance;
  * warmup follows Stan's windowed scheme: a step-size-only init buffer,
    expanding diagonal-mass (Welford) windows, at whose close the mass
    matrix updates and dual averaging restarts at the current averaged
    step, and a step-size-only terminal buffer;
  * a coordinate whose inverse mass is 0 is held (_momenta): its momentum
    is 0, so θ never moves there and it adds nothing to the kinetic
    energy. run_chains(held=) holds the coordinates a posterior does not
    depend on (the calibration's log s with the load fixed), where a free
    momentum would only drift: HMC would random-walk there and NUTS's
    U-turn test would never fire.

Randomness: every transition draws from its own torch.Generator on the
state's device, seeded from (seed, stream, step index) alone. A run is
deterministic given its seed, and a run resumed from a checkpoint draws
exactly what a straight run draws. The streams differ from JAX's threefry
keys, so a checkpoint of the JAX sampler is never resumed here (its
kernel_id differs).
"""

from __future__ import annotations

import dataclasses
import math
import time
import zipfile
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from stan_tpu_torch.utils import checkpoint as ckpt

_WARMUP, _SAMPLE, _STEP_SEARCH = 0, 1, 2  # generator streams


class HMCState(NamedTuple):
    theta: torch.Tensor  # [C, D]
    logp: torch.Tensor  # [C]
    grad: torch.Tensor  # [C, D]


class DualAvgState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_avg: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor


def _generator(seed: int, stream: int, step: int, device) -> torch.Generator:
    """A generator on `device` seeded from (seed, stream, step) alone."""
    key = np.random.SeedSequence([seed, stream, step]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return gen


def _wide(flag, like):
    """Broadcast a [C]-shaped predicate against a [C, ...]-shaped tensor."""
    return flag.reshape(flag.shape + (1,) * (like.dim() - flag.dim()))


def _momenta(gen: torch.Generator, theta, inv_mass):
    """Momenta [C, D] ~ N(0, inv_mass^-1) from `gen`: one normal draw per
    coordinate, as many and in the order they always were, then 0 on the
    held coordinates (inverse mass 0), with no inf or NaN on the way."""
    z = torch.randn(theta.shape, dtype=theta.dtype, device=theta.device,
                    generator=gen)
    free = inv_mass > 0
    return torch.where(free, z * torch.sqrt(
        1.0 / torch.where(free, inv_mass, 1.0)), 0.0)


def _leapfrog(logp_grad_b, state: HMCState, p, step, inv_mass, n_steps):
    """Static-length leapfrog integrator, batched over chains.

    step: [C]; p / inv_mass: [C, D]. logp_grad_b: [C, D] -> ([C], [C, D]).
    """
    s = step[..., None]
    theta, logp, grad = state
    for _ in range(n_steps):
        p = p + 0.5 * s * grad
        theta = theta + s * inv_mass * p
        logp, grad = logp_grad_b(theta)
        p = p + 0.5 * s * grad
    return HMCState(theta, logp, grad), p


def _energy(logp, p, inv_mass):
    """The negative Hamiltonian [C]: log density less kinetic energy."""
    return logp - 0.5 * torch.sum(inv_mass * p ** 2, dim=-1)


def _log_accept(energy0, energy1):
    """ΔH's log Metropolis ratio energy1 - energy0 [C], -inf where it is not
    finite: HMC's acceptance, NUTS's leaf weight and divergence test."""
    la = energy1 - energy0
    return torch.where(torch.isfinite(la), la, torch.full_like(la, -math.inf))


def hmc_transition(logp_grad_b, gen: torch.Generator, state: HMCState, step,
                   inv_mass, n_steps):
    """One Metropolis-corrected HMC proposal for all chains at once.

    Draws, in this order from `gen`: the momenta [C, D], the step jitter
    [C] and the acceptance uniforms [C]. The step is jittered ±20% per
    transition and chain, the standard cure for fixed-length HMC's
    resonance (Neal 2011, §3.2). Returns (state, accept_prob [C]).
    """
    theta = state.theta
    like = dict(dtype=theta.dtype, device=theta.device, generator=gen)
    p0 = _momenta(gen, theta, inv_mass)
    jitter = 0.8 + 0.4 * torch.rand(state.logp.shape, **like)
    new, p1 = _leapfrog(logp_grad_b, state, p0, step * jitter, inv_mass,
                        n_steps)
    accept_prob = torch.clamp(torch.exp(_log_accept(
        _energy(state.logp, p0, inv_mass), _energy(new.logp, p1, inv_mass))),
        max=1.0)
    accept = torch.rand(state.logp.shape, **like) < accept_prob
    out = HMCState(*(torch.where(_wide(accept, a), a, b)
                     for a, b in zip(new, state)))
    return out, accept_prob


def _find_reasonable_step(logp_grad_b, gen: torch.Generator,
                          state: HMCState, inv_mass, step0,
                          max_doublings: int = 12):
    """Stan's init-stepsize search, per chain: from step0, double while a
    one-step leapfrog proposal accepts with probability > 1/2, or halve
    while it accepts with probability < 1/2, each chain on its own until all
    settle. One momentum draw serves every trial, as in the reference
    (whose key is the same at every doubling)."""
    log_half = math.log(0.5)
    p0 = _momenta(gen, state.theta, inv_mass)

    energy0 = _energy(state.logp, p0, inv_mass)

    def log_accept(step):
        new, p1 = _leapfrog(logp_grad_b, state, p0, step, inv_mass, 1)
        return _log_accept(energy0, _energy(new.logp, p1, inv_mass))

    la = log_accept(step0)
    up = la > log_half  # double while accepting; else halve
    factor = torch.where(up, 2.0, 0.5).to(step0.dtype)
    done = torch.where(up, la <= log_half, la >= log_half)
    step = step0
    k = 0
    while bool(torch.any(~done)) and k < max_doublings:
        step = torch.where(done, step, step * factor)
        la = torch.where(done, la, log_accept(step))
        done = done | torch.where(up, la <= log_half, la >= log_half)
        k += 1
    return step


def _dual_avg_init(step0):
    log_step = torch.log(step0)
    return DualAvgState(log_step=log_step, log_step_avg=log_step,
                        h_avg=torch.zeros_like(log_step),
                        t=torch.zeros_like(log_step),
                        mu=math.log(10.0) + log_step)


def _dual_avg_update(s: DualAvgState, accept_prob, target=0.8, gamma=0.05,
                     t0=10.0, kappa=0.75):
    t = s.t + 1.0
    h_avg = ((1.0 - 1.0 / (t + t0)) * s.h_avg
             + (target - accept_prob) / (t + t0))
    log_step = s.mu - torch.sqrt(t) / gamma * h_avg
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * s.log_step_avg
    return DualAvgState(log_step, log_step_avg, h_avg, t, s.mu)


def warmup_window_flags(n_warmup: int, init_buffer: int = 75,
                        term_buffer: int = 50, base_window: int = 25
                        ) -> np.ndarray:
    """Stan's expanding-window warmup schedule as a per-step boolean array.

    flags[t] is True on the last step of each diagonal-mass window: there
    the mass matrix updates from the window's Welford estimate, the Welford
    accumulator resets, and dual averaging restarts at the current averaged
    step. Layout: a step-size-only init buffer, doubling mass windows, and
    a step-size-only terminal buffer; a warmup too short for the defaults
    rescales the buffers, and one under 20 steps adapts the step only.
    """
    flags = np.zeros(max(n_warmup, 0), dtype=bool)
    if n_warmup < 20:
        return flags
    if init_buffer + base_window + term_buffer > n_warmup:
        init_buffer = int(round(0.15 * n_warmup))
        term_buffer = int(round(0.10 * n_warmup))
        base_window = n_warmup - init_buffer - term_buffer
    end_of_windows = n_warmup - term_buffer
    t, w = init_buffer, base_window
    while t < end_of_windows:
        end = t + w
        # If the next doubling would not fit, this window runs to the end
        # (Stan's anticipated-closing rule: no tiny last window).
        if end + 2 * w > end_of_windows:
            end = end_of_windows
        flags[end - 1] = True
        t = end
        w *= 2
    return flags


@dataclasses.dataclass
class HMCResult:
    samples: np.ndarray  # [chains, n_samples, D]
    accept_rate: np.ndarray  # [chains]
    step_size: np.ndarray  # [chains]
    inv_mass: np.ndarray  # [chains, D]
    rhat: np.ndarray  # [D]
    ess: np.ndarray  # [D]
    # Gradient evaluations per post-warmup draw per chain (n_leapfrog).
    evals_per_sample: Optional[np.ndarray] = None
    # Wall seconds of the warmup and of each sampling chunk, each ending in
    # a device sync.
    warmup_seconds: float = 0.0
    chunk_seconds: Optional[list] = None
    chunk_sizes: Optional[list] = None
    # Chain-batched evaluations of the target's value and gradient made by
    # this run (each covers every chain).
    grad_evals: int = 0
    # The forward model's SolveStats counts accrued during this run (None
    # when no stats object was passed): solves, iterations and solves that
    # stopped unconverged, forward and adjoint.
    solve_stats: Optional[dict] = None

    @property
    def unconverged_forward(self) -> Optional[int]:
        return None if self.solve_stats is None else \
            self.solve_stats["forward_unconverged"]

    @property
    def unconverged_adjoint(self) -> Optional[int]:
        return None if self.solve_stats is None else \
            self.solve_stats["adjoint_unconverged"]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_chains(
    logp_grad_b,
    transition,
    theta0: torch.Tensor,  # [chains, D]
    seed: int,
    *,
    n_samples: int,
    n_warmup: int,
    init_step: float,
    target_accept: float,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    kernel_id: str = "",
    solve_stats=None,
    mesh=None,
    chain_axis: str = "chains",
    held=None,
) -> HMCResult:
    """Shared chunked, checkpointed loop for batched MCMC chains.

    ``transition(logp_grad_b, gen, state, step, inv_mass) -> (state,
    accept_prob [C], n_grad_evals [C])`` is the chain-batched kernel;
    ``logp_grad_b: [C, D] -> ([C], [C, D])`` the batched target gradient,
    which run_chains hands to the kernel so that it counts every
    evaluation (grad_evals). The state stays on theta0's device and in its
    dtype.

    ``mesh``: a DeviceMesh whose home device (its first device of this
    process) holds theta0. Each call of the target is cut into one block
    of chains per row of ``chain_axis`` (DeviceMesh.by_rows; a chain count
    the rows do not divide is refused with ValueError), evaluated on the
    row's first device, and joined back in row order (over several
    processes each evaluates its own rows and every process gets the
    whole, so every process draws the same); the state, the generators and the draws stay on
    the home device, so a resumed run and a short final chunk keep the
    placement and the draws are those of the run without a mesh. The
    domain axis is not used: the reference replicates a row's chains over
    its domain devices, the port evaluates them once, on the row's first
    device. A target that places itself (such as
    calibrate.ShardedCalibrationProblem.logp_grad_b(), which cuts its
    chains over the rows and its grid over the domain axis) is passed
    without ``mesh``.

    Draws come in chunks of ``checkpoint_every`` samples (default: 10
    chunks with a checkpoint, else one); with ``checkpoint_path`` the chain
    state (positions, tuned step sizes, mass matrices, draws so far) is
    saved after the warmup and after every chunk, each chunk of draws once
    to its own sidecar, and a run with the same identity (kernel_id,
    n_warmup, chains, dim) resumes from it. ``solve_stats``: the forward
    model's SolveStats, whose counts over this run go into the result.

    ``held``: a [D] bool, the coordinates the target does not depend on.
    The warmup starts their inverse mass at 0 and keeps it there at every
    window close, so the kernels hold them (_momenta) at theta0's values;
    the inverse mass, checkpoints included, carries the zeros.
    """
    theta0 = torch.as_tensor(theta0)
    dev = theta0.device
    n_chains, dim = theta0.shape
    held = torch.as_tensor(np.zeros(dim, bool) if held is None else held,
                           dtype=torch.bool, device=dev)
    if mesh is not None:
        if dev != mesh.home:
            raise ValueError(f"theta0 lies on {dev}, the mesh's home (this "
                             f"process's first device of it) is "
                             f"{mesh.home}: the sampler's state stays there")
        logp_grad_b = mesh.by_rows(logp_grad_b, chain_axis)
    mass_flags = warmup_window_flags(n_warmup)
    stats0 = solve_stats.as_dict() if solve_stats is not None else None
    n_evals = 0

    def target(theta):
        nonlocal n_evals
        n_evals += 1
        return logp_grad_b(theta)

    def run_warmup():
        state = HMCState(theta0, *target(theta0))
        inv_mass = torch.where(held, 0.0, torch.ones_like(theta0))
        step0 = torch.full((n_chains,), init_step, dtype=theta0.dtype,
                           device=dev)
        step0 = _find_reasonable_step(
            target, _generator(seed, _STEP_SEARCH, 0, dev), state, inv_mass,
            step0)
        da = _dual_avg_init(step0)
        mean = torch.zeros_like(theta0)
        m2 = torch.zeros_like(theta0)
        cnt = 0.0
        for t in range(n_warmup):
            state, ap, _ = transition(
                target, _generator(seed, _WARMUP, t, dev), state,
                torch.exp(da.log_step), inv_mass)
            da = _dual_avg_update(da, ap, target=target_accept)
            # Welford accumulation for the diagonal mass matrix.
            cnt += 1.0
            delta = state.theta - mean
            mean = mean + delta / cnt
            m2 = m2 + delta * (state.theta - mean)
            if mass_flags[t]:
                # Window close: the regularised variance becomes the mass,
                # Welford resets, dual averaging restarts at the averaged
                # step so later adaptation tunes against the new mass.
                var = m2 / max(cnt - 1.0, 1.0)
                inv_mass = torch.where(
                    held, 0.0, (cnt / (cnt + 5.0)) * var
                    + 1.0e-3 * (5.0 / (cnt + 5.0)))
                da = _dual_avg_init(torch.exp(da.log_step_avg))
                mean = torch.zeros_like(mean)
                m2 = torch.zeros_like(m2)
                cnt = 0.0
        _sync(dev)
        return state.theta, torch.exp(da.log_step_avg), inv_mass

    chunk = checkpoint_every or (max(1, n_samples // 10)
                                 if checkpoint_path else n_samples)
    chunk = max(chunk, 1)
    identity = {"kernel": kernel_id, "n_warmup": n_warmup,
                "n_chains": n_chains, "dim": dim}
    state_ck = ckpt.load_or_none(checkpoint_path)

    def on_device(a):
        return torch.as_tensor(np.asarray(a), dtype=theta0.dtype, device=dev)

    resumed = False
    if state_ck is not None and all(state_ck.get(k) == v
                                    for k, v in identity.items()):
        try:
            draws = [np.asarray(c) for c in ckpt.load_chunks(
                checkpoint_path, int(state_ck["n_chunks"]))]
            theta = on_device(state_ck["theta"])
            step = on_device(state_ck["step"])
            inv_mass = on_device(state_ck["inv_mass"])
            done = int(state_ck["n_done"])
            acc_sum = np.asarray(state_ck["acc_sum"])
            eval_sum = np.asarray(state_ck["eval_sum"])
            resumed = True
        except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile):
            resumed = False  # missing or corrupt chunk sidecar: start fresh

    warmup_seconds = 0.0
    if not resumed:
        if checkpoint_path:
            # Fresh start over an old or foreign checkpoint: drop its chunk
            # sidecars so they cannot shadow this run's.
            ckpt.clean_chunks(checkpoint_path)
        t0 = time.perf_counter()
        theta, step, inv_mass = run_warmup()
        warmup_seconds = time.perf_counter() - t0
        draws, done = [], 0
        acc_sum = np.zeros(n_chains)
        eval_sum = np.zeros(n_chains)
        if checkpoint_path:
            ckpt.save(checkpoint_path, {
                **identity, "n_done": 0, "n_chunks": 0,
                "theta": theta.cpu().numpy(), "step": step.cpu().numpy(),
                "inv_mass": inv_mass.cpu().numpy(),
                "acc_sum": acc_sum, "eval_sum": eval_sum})

    chunk_seconds: list = []
    chunk_sizes: list = []
    while done < n_samples:
        take = min(chunk, n_samples - done)
        t0 = time.perf_counter()
        state = HMCState(theta, *target(theta))
        thetas, aps, nes = [], [], []
        for t in range(done, done + take):
            state, ap, ne = transition(
                target, _generator(seed, _SAMPLE, t, dev), state, step,
                inv_mass)
            thetas.append(state.theta)
            aps.append(ap)
            nes.append(ne)
        block = torch.stack(thetas, dim=1).cpu().numpy()  # [C, take, D]
        chunk_seconds.append(time.perf_counter() - t0)
        chunk_sizes.append(take)
        theta = state.theta
        draws.append(block)
        acc_sum = acc_sum + torch.stack(aps, 1).sum(1).cpu().numpy()
        eval_sum = eval_sum + torch.stack(nes, 1).sum(1).cpu().numpy()
        done += take
        if checkpoint_path:
            # Append-only: the chunk is written once to its own sidecar;
            # the small state file records how many chunks exist.
            ckpt.save_chunk(checkpoint_path, len(draws) - 1, draws[-1])
            ckpt.save(checkpoint_path, {
                **identity, "n_done": done, "n_chunks": len(draws),
                "theta": theta.cpu().numpy(), "step": step.cpu().numpy(),
                "inv_mass": inv_mass.cpu().numpy(),
                "acc_sum": acc_sum, "eval_sum": eval_sum})

    samples = np.concatenate(draws, axis=1)  # [chains, n_samples, D]
    rhat, ess = diagnostics(samples)
    return HMCResult(
        samples=samples,
        accept_rate=acc_sum / max(n_samples, 1),
        step_size=step.cpu().numpy(),
        inv_mass=inv_mass.cpu().numpy(),
        rhat=rhat,
        ess=ess,
        evals_per_sample=eval_sum / max(n_samples, 1),
        warmup_seconds=warmup_seconds,
        chunk_seconds=chunk_seconds,
        chunk_sizes=chunk_sizes,
        grad_evals=n_evals,
        solve_stats=None if solve_stats is None else solve_stats.since(
            stats0),
    )


def guarded_logp_grad_b(logp_fn) -> Callable:
    """Value and gradient of a chain-batched log density θ [C, D] -> [C],
    with the non-finite guards: a NaN forward solve becomes -inf logp and
    zero gradient, so the proposal is rejected instead of poisoning the
    chain. The gradient is autograd of the sum over chains."""

    def logp_grad_b(theta):
        th = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            v = logp_fn(th)
            (g,) = torch.autograd.grad(v.sum(), th)
        v = v.detach()
        return (torch.where(torch.isfinite(v), v, -math.inf),
                torch.where(torch.isfinite(g), g, 0.0))

    return logp_grad_b


def hmc_kernel(n_leapfrog: int) -> Callable:
    """run_chains' transition for static-length HMC of n_leapfrog steps,
    for a caller that brings its own logp_grad_b (such as
    calibrate.ShardedCalibrationProblem.logp_grad_b())."""

    def transition(target, gen, state, step, inv_mass):
        state, ap = hmc_transition(target, gen, state, step, inv_mass,
                                   n_leapfrog)
        return state, ap, torch.full_like(ap, float(n_leapfrog))

    return transition


def run_hmc(
    logp_fn: Callable[[torch.Tensor], torch.Tensor],
    theta0: torch.Tensor,  # [chains, D]
    seed: int,
    *,
    n_samples: int = 1000,
    n_warmup: int = 500,
    n_leapfrog: int = 16,
    init_step: float = 0.1,
    target_accept: float = 0.8,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    solve_stats=None,
    mesh=None,
    chain_axis: str = "chains",
    held=None,
) -> HMCResult:
    """Run batched HMC chains with windowed warmup on theta0's device.

    `logp_fn` is a chain-batched log density [C, D] -> [C]; `seed` fixes
    every draw. See ``run_chains`` for chunks, checkpoint/resume,
    `solve_stats`, the chains' placement over `mesh` and the `held`
    coordinates.
    """
    return run_chains(
        guarded_logp_grad_b(logp_fn), hmc_kernel(n_leapfrog), theta0, seed,
        n_samples=n_samples, n_warmup=n_warmup, init_step=init_step,
        target_accept=target_accept, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
        # Not the reference's "hmc:leapfrog{n}": the generators differ, so a
        # JAX checkpoint must not resume here, nor a torch one there.
        kernel_id=f"torch-hmc:leapfrog{n_leapfrog}",
        solve_stats=solve_stats, mesh=mesh, chain_axis=chain_axis, held=held,
    )


# ---------------------------------------------------------------------------
# Diagnostics (split R-hat + bulk ESS, host-side numpy)
# ---------------------------------------------------------------------------

def diagnostics(samples: np.ndarray):
    """Split R-hat and a crude bulk ESS per dimension.

    samples: [chains, n, D]. Split-chain potential scale reduction (Gelman
    et al.); ESS from FFT autocorrelations averaged over chains, summed in
    Geyer's initial positive pairs. Both are NaN for a coordinate with no
    variance (a held one): neither is defined there.
    """
    c, n, d = samples.shape
    half = n // 2
    x = samples[:, : 2 * half, :].reshape(c * 2, half, d)
    m = x.mean(axis=1)  # [2c, D]
    v = x.var(axis=1, ddof=1)  # [2c, D]
    W = v.mean(axis=0)
    B = half * m.var(axis=0, ddof=1)
    var_est = (half - 1) / half * W + B / half
    rhat = np.sqrt(var_est / np.where(W > 0, W, 1.0))

    xc = x - x.mean(axis=1, keepdims=True)
    nfft = 1 << (2 * half - 1).bit_length()
    f = np.fft.rfft(xc, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :half, :]
    acov = acov / np.arange(half, 0, -1)[None, :, None]
    rho = (acov / np.where(acov[:, :1, :] > 0, acov[:, :1, :], 1.0)).mean(
        axis=0)
    tau = np.ones(d)
    for k in range(d):
        s = 1.0
        for t in range(1, half - 1, 2):
            pair = rho[t, k] + rho[t + 1, k]
            if pair < 0:
                break
            s += 2 * pair
        tau[k] = s
    ess = (c * half) / tau
    still = np.all(x == x[:1, :1], axis=(0, 1))
    return np.where(still, np.nan, rhat), np.where(still, np.nan, ess)
