"""No-U-Turn Sampler (multinomial variant), iterative tree building, with
every chain of a batch in lockstep.

Port of stan_tpu/infer/nuts.py. The trajectory grows one leapfrog step at a
time, with an O(max_depth) checkpoint stack for the aligned power-of-two
U-turn checks (the iterative formulation of Phan & Pradhan,
arXiv:1912.11554, as adopted by Stan/NumPyro), so a trajectory that
U-turns after k steps costs k gradient evaluations, not 2^max_depth.
Multinomial sampling from the trajectory weighted by exp(logp - kinetic)
(Betancourt 2017), the generalised U-turn criterion checked for every
aligned power-of-two subtree, and Stan's semantics for rejected subtrees (a
doubling that turns or diverges contributes no proposal).

Lockstep. The reference vmaps a per-chain transition of nested while
loops; under vmap every chain still building sits at the same doubling
depth and the same leaf index n. So here depth, n, popcount(n >> 1) and
trailing_ones(n) are Python ints shared by the batch, the checkpoint
stacks are [max_depth, C, D] tensors indexed by them, and each chain
carries [C] masks: active (its trajectory still doubles), building (its
subtree still grows), turning and diverging. Every leaf is one
chain-batched call of the target for all C chains; a chain that is not
building passes its frozen θ and its result is masked away, as under the
reference's vmap. Each loop stops on one host read of a [C] mask.

Randomness, drawn from the transition's generator in this order: the
momenta [C, D] (hmc._momenta: a normal draw for every coordinate, 0 kept
on the held ones, whose inverse mass is 0); then per depth the direction
[C], per lockstep leaf of that depth the take-uniform [C], and the
combine-uniform [C]. A run resumed from a checkpoint draws what a straight
run draws (run_chains seeds each transition's generator from the seed and
the step index alone).

A held coordinate has no momentum, so it adds nothing to the U-turn test
(inv_mass * sum_p): a coordinate the posterior does not depend on keeps
its momentum along a free trajectory, its share of the test's dot product
grows with every step, and every tree would run to max_depth.

Spans (utils/timing.span): nuts.transition, and nuts.doubling around each
depth's subtree and its combine. Counters: TreeStats.

Warmup (step size dual averaging + diagonal mass) and chunked
checkpoint/resume reuse infer/hmc.run_chains.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from stan_tpu_torch.infer import hmc as hmc_mod
from stan_tpu_torch.utils.timing import span

_MAX_DELTA_ENERGY = 1000.0  # Stan's divergence threshold


@dataclasses.dataclass
class TreeStats:
    """Counts over the transitions that filled it (nuts_transition(stats=),
    run_nuts(stats=)), all integers, as SolveStats': ``lockstep_leaves``
    counts the chain-batched target calls, which is what the card runs;
    ``chain_leaves`` the leaves each chain itself needed (the gradient
    evaluations nuts_transition returns); ``depth_sum`` the doublings each
    chain built; ``at_max_depth`` the chain-transitions that stopped at
    max_depth, not at a U-turn or a divergence; ``divergent`` those that
    diverged."""

    transitions: int = 0
    chain_transitions: int = 0
    lockstep_leaves: int = 0
    chain_leaves: int = 0
    depth_sum: int = 0
    at_max_depth: int = 0
    divergent: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def since(self, before: dict) -> dict:
        """The counts added since ``before`` (an earlier ``as_dict()``)."""
        return {k: v - before[k] for k, v in self.as_dict().items()}


class _Z(NamedTuple):
    theta: torch.Tensor  # [C, D]
    p: torch.Tensor  # [C, D]
    logp: torch.Tensor  # [C]
    grad: torch.Tensor  # [C, D]


def _select(mask, a: _Z, b: _Z) -> _Z:
    """Per chain: a where mask [C] holds, else b."""
    return _Z(*(torch.where(hmc_mod._wide(mask, x), x, y)
                for x, y in zip(a, b)))


def _leapfrog_step(target, z: _Z, step, inv_mass, direction, moving) -> _Z:
    """One leapfrog step of every chain; a chain not `moving` evaluates the
    target at its own θ (the caller discards its result)."""
    eps = (direction * step)[:, None]
    p = z.p + 0.5 * eps * z.grad
    theta = torch.where(moving[:, None], z.theta + eps * inv_mass * p,
                        z.theta)
    logp, grad = target(theta)
    p = p + 0.5 * eps * grad
    return _Z(theta, p, logp, grad)


def _turning(p_left, p_right, sum_p, inv_mass):
    """Generalised U-turn per chain: momentum projected on the trajectory
    span. Symmetric in (left, right), so valid for spans built in either
    direction."""
    dr = inv_mass * sum_p
    return (torch.sum(dr * p_left, dim=-1) <= 0.0) | (
        torch.sum(dr * p_right, dim=-1) <= 0.0)


def _trailing_ones(n: int) -> int:
    return ((~n & (n + 1)) - 1).bit_count()


class _Subtree(NamedTuple):
    z_end: _Z  # outermost leaf (the new trajectory edge if accepted)
    z_prop: _Z  # multinomial proposal from this subtree
    log_weight: torch.Tensor  # [C]
    sum_p: torch.Tensor  # [C, D] momentum sum over built leaves
    turning: torch.Tensor  # [C]
    diverging: torch.Tensor  # [C]
    sum_accept: torch.Tensor  # [C]
    n_leaves: torch.Tensor  # [C] leaves actually built (= gradient evals)
    n_steps: int  # chain-batched target calls (lockstep leaves)


def _build_subtree(target, gen: torch.Generator, z_edge: _Z, depth: int,
                   step, inv_mass, direction, energy0, max_depth: int,
                   active) -> _Subtree:
    """Grow up to 2^depth leaves from z_edge for every `active` chain, one
    leapfrog per iteration, all chains at the same leaf index n.

    U-turn checks cover every aligned power-of-two sub-span via a
    checkpoint stack: leaf n (0-based, build order) stores its momentum and
    the inclusive momentum prefix-sum at stack slot popcount(n >> 1) when n
    is even; when n is odd it checks the spans ending at n against slots
    [popcount(n>>1) - trailing_ones(n) + 1 .. popcount(n>>1)], which hold
    exactly the first leaves of those spans. A chain stops at its first
    U-turn or divergence; the loop stops when no chain builds.
    """
    C, D = z_edge.theta.shape
    like = dict(dtype=z_edge.theta.dtype, device=z_edge.theta.device)
    z = z_prop = z_edge
    lw = torch.full((C,), -math.inf, **like)
    cps = torch.zeros((C, D), **like)
    p_ck = torch.zeros((max_depth, C, D), **like)
    ps_ck = torch.zeros((max_depth, C, D), **like)
    false = torch.zeros(C, dtype=torch.bool, device=like["device"])
    turning, diverging = false, false
    sacc = torch.zeros(C, **like)
    n_leaves = torch.zeros(C, **like)
    building = active
    n_steps = 0
    for n in range(1 << depth):
        if not bool(building.any()):
            break
        n_steps += 1
        u = torch.rand(C, generator=gen, **like)
        z_new = _leapfrog_step(target, z, step, inv_mass, direction, building)
        # ΔH as HMC's acceptance takes it: -inf where it is not finite (a
        # failed solve's -inf log density diverges).
        w = hmc_mod._log_accept(energy0,
                                hmc_mod._energy(z_new.logp, z_new.p, inv_mass))
        # Progressive multinomial sampling: take the new leaf with
        # probability exp(w - logaddexp(lw, w)) — equivalent in
        # distribution to the recursive pairwise combine.
        lw_new = torch.logaddexp(lw, w)
        take = building & (torch.log(u) < w - lw_new)
        z_prop = _select(take, z_new, z_prop)
        sacc = sacc + torch.where(building,
                                  torch.clamp(torch.exp(w), max=1.0), 0.0)
        cps_new = cps + z_new.p
        idx_max = (n >> 1).bit_count()
        if n % 2 == 0:
            # Even leaf: start of future aligned spans -> store checkpoint.
            p_ck[idx_max] = torch.where(building[:, None], z_new.p,
                                        p_ck[idx_max])
            ps_ck[idx_max] = torch.where(building[:, None], cps_new,
                                         ps_ck[idx_max])
        # Odd leaf: spans of size 2^k end here for k = 1..trailing_ones(n);
        # their first leaves sit at slots idx_min..idx_max (an empty range
        # on even leaves).
        turn = false
        for i in range(idx_max - _trailing_ones(n) + 1, idx_max + 1):
            span_sum = cps_new - ps_ck[i] + p_ck[i]
            turn = turn | _turning(p_ck[i], z_new.p, span_sum, inv_mass)
        z = _select(building, z_new, z)
        lw = torch.where(building, lw_new, lw)
        cps = torch.where(building[:, None], cps_new, cps)
        turning = torch.where(building, turn, turning)
        diverging = torch.where(building, w < -_MAX_DELTA_ENERGY,
                                diverging)
        n_leaves = n_leaves + building.to(n_leaves.dtype)
        building = building & ~turning & ~diverging
    return _Subtree(z, z_prop, lw, cps, turning, diverging, sacc, n_leaves,
                    n_steps)


def nuts_transition(target, gen: torch.Generator, state: hmc_mod.HMCState,
                    step, inv_mass, max_depth: int,
                    stats: Optional[TreeStats] = None):
    """One NUTS transition of every chain. step [C], inv_mass [C, D] (0 on
    a held coordinate). Returns (state, accept_stat [C], n_grad_evals [C]).
    `stats`: a TreeStats this transition adds to, with one host read of
    four device sums."""
    with span("nuts.transition"):
        return _transition(target, gen, state, step, inv_mass, max_depth,
                           stats)


def _transition(target, gen, state, step, inv_mass, max_depth, stats):
    theta = state.theta
    C = theta.shape[0]
    like = dict(dtype=theta.dtype, device=theta.device)
    p0 = hmc_mod._momenta(gen, theta, inv_mass)
    z0 = _Z(theta, p0, state.logp, state.grad)
    energy0 = hmc_mod._energy(z0.logp, z0.p, inv_mass)

    z_left = z_right = z_prop = z0
    lw = torch.zeros(C, **like)  # trajectory log weight (initial leaf = 1)
    sum_p = p0
    turning = diverging = torch.zeros(C, dtype=torch.bool,
                                      device=like["device"])
    sacc = torch.zeros(C, **like)  # the seed point is NOT a proposal
    n_leaves = torch.ones(C, **like)
    depths = torch.zeros(C, dtype=torch.int64, device=like["device"])
    n_steps = 0
    for depth in range(max_depth):
        active = ~turning & ~diverging
        if not bool(active.any()):
            break
        with span("nuts.doubling"):
            direction = torch.where(
                torch.rand(C, generator=gen, **like) < 0.5, 1.0, -1.0).to(
                    theta.dtype)
            forward = direction > 0
            edge = _select(forward, z_right, z_left)
            sub = _build_subtree(target, gen, edge, depth, step, inv_mass,
                                 direction, energy0, max_depth, active)
            u = torch.rand(C, generator=gen, **like)
            # Stan semantics: a subtree that turned or diverged is rejected
            # whole — no proposal, no weight, the trajectory ends here.
            valid = active & ~sub.turning & ~sub.diverging
            lw_new = torch.logaddexp(lw, sub.log_weight)
            take = valid & (torch.log(u) < sub.log_weight - lw_new)
            z_prop = _select(take, sub.z_prop, z_prop)
            lw = torch.where(valid, lw_new, lw)
            z_left_new = _select(forward, z_left, sub.z_end)
            z_right_new = _select(forward, sub.z_end, z_right)
            sum_p_new = sum_p + sub.sum_p
            turn_comb = _turning(z_left_new.p, z_right_new.p, sum_p_new,
                                 inv_mass)
            z_left = _select(valid, z_left_new, z_left)
            z_right = _select(valid, z_right_new, z_right)
            sum_p = torch.where(valid[:, None], sum_p_new, sum_p)
            turning = torch.where(active, sub.turning | (valid & turn_comb),
                                  turning)
            diverging = torch.where(active, sub.diverging, diverging)
            sacc = sacc + sub.sum_accept
            n_leaves = n_leaves + sub.n_leaves
            depths = depths + active.to(depths.dtype)
            n_steps += sub.n_steps
    if stats is not None:
        # A chain neither turned nor diverged only where all max_depth
        # doublings ran: the loop breaks early once every chain stopped.
        sums = torch.stack([(n_leaves - 1.0).sum().to(torch.int64),
                            depths.sum(), (~turning & ~diverging).sum(),
                            diverging.sum()]).tolist()
        stats.transitions += 1
        stats.chain_transitions += C
        stats.lockstep_leaves += n_steps
        for key, n in zip(("chain_leaves", "depth_sum", "at_max_depth",
                           "divergent"), sums):
            setattr(stats, key, getattr(stats, key) + int(n))
    new_state = hmc_mod.HMCState(z_prop.theta, z_prop.logp, z_prop.grad)
    # Stan's accept statistic: mean Metropolis ratio over *proposed* leaves
    # (the seed point excluded). An immediately-diverging trajectory has no
    # proposed leaves: accept 0.
    accept = sacc / torch.clamp(n_leaves - 1.0, min=1.0)
    return new_state, accept, n_leaves - 1.0  # gradient evals (minus seed)


def run_nuts(
    logp_fn: Callable[[torch.Tensor], torch.Tensor],
    theta0: torch.Tensor,  # [chains, D]
    seed: int,
    *,
    n_samples: int = 1000,
    n_warmup: int = 500,
    max_depth: int = 6,
    init_step: float = 0.1,
    target_accept: float = 0.8,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    solve_stats=None,
    mesh=None,
    chain_axis: str = "chains",
    held=None,
    stats: Optional[TreeStats] = None,
) -> hmc_mod.HMCResult:
    """NUTS with HMC's windowed warmup on theta0's device; the same chunked
    checkpoint/resume, placement over `mesh` and `held` coordinates as
    run_hmc (shared loop: hmc.run_chains; each lockstep leaf evaluates the
    target row by row). `logp_fn` is a chain-batched log density [C, D] ->
    [C]; `seed` fixes every draw. evals_per_sample counts each chain's own
    leapfrog steps; grad_evals counts the chain-batched evaluations the
    lockstep batch made. `stats`: a TreeStats that every transition of the
    run, warmup included, adds to."""
    if not 0 < max_depth <= 14:
        raise ValueError("max_depth must be in 1..14")

    def transition(target, gen, state, step, inv_mass):
        return nuts_transition(target, gen, state, step, inv_mass, max_depth,
                               stats)

    return hmc_mod.run_chains(
        hmc_mod.guarded_logp_grad_b(logp_fn), transition, theta0, seed,
        n_samples=n_samples, n_warmup=n_warmup, init_step=init_step,
        target_accept=target_accept, checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
        # Not the reference's "nuts:maxdepth{n}": the generators differ, so
        # neither side resumes the other's checkpoint.
        kernel_id=f"torch-nuts:maxdepth{max_depth}",
        solve_stats=solve_stats, mesh=mesh, chain_axis=chain_axis, held=held,
    )
