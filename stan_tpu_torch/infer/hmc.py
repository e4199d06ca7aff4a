"""Hamiltonian Monte Carlo with Stan-style windowed warmup, batched chains.

Port of stan_tpu/infer/hmc.py for one device:

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
    step, and a step-size-only terminal buffer.

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


def _log_accept(state, new, p0, p1, inv_mass):
    ke0 = 0.5 * torch.sum(inv_mass * p0 ** 2, dim=-1)
    ke1 = 0.5 * torch.sum(inv_mass * p1 ** 2, dim=-1)
    la = (new.logp - ke1) - (state.logp - ke0)
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
    p0 = torch.randn(theta.shape, **like) * torch.sqrt(1.0 / inv_mass)
    jitter = 0.8 + 0.4 * torch.rand(state.logp.shape, **like)
    new, p1 = _leapfrog(logp_grad_b, state, p0, step * jitter, inv_mass,
                        n_steps)
    accept_prob = torch.clamp(torch.exp(_log_accept(state, new, p0, p1,
                                                    inv_mass)), max=1.0)
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
    theta = state.theta
    p0 = torch.randn(theta.shape, dtype=theta.dtype, device=theta.device,
                     generator=gen) * torch.sqrt(1.0 / inv_mass)

    def log_accept(step):
        new, p1 = _leapfrog(logp_grad_b, state, p0, step, inv_mass, 1)
        return _log_accept(state, new, p0, p1, inv_mass)

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
    # Wall seconds of the warmup (and of each warmup segment) and of each
    # sampling chunk, each ending in a device sync.
    warmup_seconds: float = 0.0
    warmup_segment_seconds: Optional[list] = None
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


def _solve_delta(stats, before: Optional[dict]) -> Optional[dict]:
    if stats is None:
        return None
    return {k: v - before[k] for k, v in stats.as_dict().items()}


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
    warmup_chunk: int = 0,
    solve_stats=None,
) -> HMCResult:
    """Shared chunked, checkpointed loop for batched MCMC chains.

    ``transition(logp_grad_b, gen, state, step, inv_mass) -> (state,
    accept_prob [C], n_grad_evals [C])`` is the chain-batched kernel;
    ``logp_grad_b: [C, D] -> ([C], [C, D])`` the batched target gradient,
    which run_chains hands to the kernel so that it counts every
    evaluation (grad_evals). The state stays on
    theta0's device and in its dtype.

    ``warmup_chunk`` > 0 splits the warmup into segments of that many
    transitions, each timed to a device sync (warmup_segment_seconds); the
    draws do not depend on it. Draws come in chunks of
    ``checkpoint_every`` samples (default: 10 chunks with a checkpoint,
    else one); with ``checkpoint_path`` the chain state (positions, tuned
    step sizes, mass matrices, draws so far) is saved after the warmup and
    after every chunk, each chunk of draws once to its own sidecar, and a
    run with the same identity (kernel_id, n_warmup, chains, dim) resumes
    from it. ``solve_stats``: the forward model's SolveStats, whose counts
    over this run go into the result.
    """
    theta0 = torch.as_tensor(theta0)
    dev = theta0.device
    n_chains, dim = theta0.shape
    mass_flags = warmup_window_flags(n_warmup)
    stats0 = solve_stats.as_dict() if solve_stats is not None else None
    n_evals = 0

    def target(theta):
        nonlocal n_evals
        n_evals += 1
        return logp_grad_b(theta)

    def run_warmup():
        state = HMCState(theta0, *target(theta0))
        inv_mass = torch.ones_like(theta0)
        step0 = torch.full((n_chains,), init_step, dtype=theta0.dtype,
                           device=dev)
        step0 = _find_reasonable_step(
            target, _generator(seed, _STEP_SEARCH, 0, dev), state, inv_mass,
            step0)
        da = _dual_avg_init(step0)
        mean = torch.zeros_like(theta0)
        m2 = torch.zeros_like(theta0)
        cnt = 0.0
        seg = warmup_chunk if warmup_chunk > 0 else max(n_warmup, 1)
        seg_seconds = []
        t_seg = time.perf_counter()
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
                inv_mass = ((cnt / (cnt + 5.0)) * var
                            + 1.0e-3 * (5.0 / (cnt + 5.0)))
                da = _dual_avg_init(torch.exp(da.log_step_avg))
                mean = torch.zeros_like(mean)
                m2 = torch.zeros_like(m2)
                cnt = 0.0
            if (t + 1) % seg == 0 or t + 1 == n_warmup:
                _sync(dev)
                now = time.perf_counter()
                seg_seconds.append(now - t_seg)
                t_seg = now
        return state.theta, torch.exp(da.log_step_avg), inv_mass, seg_seconds

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

    warmup_seconds, seg_seconds = 0.0, []
    if not resumed:
        if checkpoint_path:
            # Fresh start over an old or foreign checkpoint: drop its chunk
            # sidecars so they cannot shadow this run's.
            ckpt.clean_chunks(checkpoint_path)
        t0 = time.perf_counter()
        theta, step, inv_mass, seg_seconds = run_warmup()
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
        warmup_segment_seconds=seg_seconds,
        chunk_seconds=chunk_seconds,
        chunk_sizes=chunk_sizes,
        grad_evals=n_evals,
        solve_stats=_solve_delta(solve_stats, stats0),
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
        return _guard(v.detach(), g)

    return logp_grad_b


def _guard(v, g):
    v = torch.where(torch.isfinite(v), v, torch.full_like(v, -math.inf))
    g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    return v, g


def run_hmc(
    logp_fn: Optional[Callable[[torch.Tensor], torch.Tensor]],
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
    logp_grad_b: Optional[Callable] = None,
    warmup_chunk: int = 0,
    solve_stats=None,
) -> HMCResult:
    """Run batched HMC chains with windowed warmup on theta0's device.

    Either `logp_fn` (chain-batched log density [C, D] -> [C]) or
    `logp_grad_b` ([C, D] -> ([C], [C, D]) value and gradient) must be
    given; `logp_grad_b` wins. `seed` fixes every draw. See ``run_chains``
    for chunks, checkpoint/resume and `solve_stats`.
    """
    if logp_grad_b is None:
        if logp_fn is None:
            raise ValueError("need logp_fn or logp_grad_b")
        logp_grad_b = guarded_logp_grad_b(logp_fn)
    else:
        raw = logp_grad_b

        def logp_grad_b(theta):  # noqa: F811 (guard the supplied target)
            return _guard(*raw(theta))

    def transition(target, gen, state, step, inv_mass):
        state, ap = hmc_transition(target, gen, state, step, inv_mass,
                                   n_leapfrog)
        return state, ap, torch.full_like(ap, float(n_leapfrog))

    return run_chains(
        logp_grad_b, transition, theta0, seed,
        n_samples=n_samples, n_warmup=n_warmup, init_step=init_step,
        target_accept=target_accept, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
        # Not the reference's "hmc:leapfrog{n}": the generators differ, so a
        # JAX checkpoint must not resume here, nor a torch one there.
        kernel_id=f"torch-hmc:leapfrog{n_leapfrog}",
        warmup_chunk=warmup_chunk, solve_stats=solve_stats,
    )


# ---------------------------------------------------------------------------
# Diagnostics (split R-hat + bulk ESS, host-side numpy)
# ---------------------------------------------------------------------------

def diagnostics(samples: np.ndarray):
    """Split R-hat and a crude bulk ESS per dimension.

    samples: [chains, n, D]. Split-chain potential scale reduction (Gelman
    et al.); ESS from FFT autocorrelations averaged over chains, summed in
    Geyer's initial positive pairs.
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
    return rhat, ess
