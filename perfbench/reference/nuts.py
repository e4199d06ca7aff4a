"""Plain reference for one transition of multinomial NUTS with every chain
of a batch in lockstep: a replay of each chain's tree, leaf by leaf, from
the program's own recorded evaluations, which says whether the program
took the decisions its numbers call for.

The sampler (Hoffman & Gelman, JMLR 15 (2014) 1593-1623; Betancourt,
arXiv:1701.02434): the trajectory doubles, each doubling a subtree of
2^depth leapfrog steps from the trajectory's end in a random direction; a
subtree stops at its first U-turn over an aligned power-of-two span of its
leaves or at a divergence (ΔH < -1000), and then adds no proposal and ends
the trajectory (Stan's rule); within a subtree each leaf is taken as its
proposal with probability exp(w - log Σ exp(w)) over the leaves so far
(progressive multinomial sampling, w = ΔH, the log density less the
kinetic energy against the start's); a whole subtree's proposal replaces
the trajectory's with probability W_sub / (W_traj + W_sub); after each
accepted doubling the whole trajectory is tested for a U-turn. A
coordinate whose inverse mass is 0 is held: its momentum is 0. The U-turn
test of a span: (inv_mass Σp) · p_first <= 0 or (inv_mass Σp) · p_last
<= 0, Σp over the span's leaves, summed here leaf by leaf (no checkpoint
stack). The acceptance statistic is the mean of min(1, exp(w)) over the
leaves a chain built.

Lockstep: every leaf is one batched evaluation of all chains, and the
batch builds a depth's leaves until its last chain stops, so a depth's
evaluations are as many as its longest subtree. The draws come from one
generator seeded with the transition's key, in this order: the momenta
[C, D] (normal; 0 on held coordinates, N(0, 1 / inv_mass) elsewhere);
then for each depth the direction [C] (forward where a uniform < 1/2), a
take-uniform [C] for each of the depth's evaluations, and the
combine-uniform [C]. Everything else is float64 numpy on the host; the
draws are made on the program's device so that they are its numbers.

A chain's decision error (replay's ``bad`` and decision_errors): a
recorded leaf θ that is not the leapfrog step from its edge with the
recorded gradient to 1e-12 of the step (a held coordinate must not move
at all); the batch's evaluations not the count the replayed trees need
(marks every chain); a returned state that is not the chosen leaf's
recorded (θ, log p, ∇); an acceptance statistic or a leaf count off the
replay's (1e-9; exact). Where a uniform lies within BAND of its threshold,
or a U-turn dot within TURN_BAND of 0 relative to its terms, rounding may
decide either way: where a wrong chain met such decisions, the replay is
tried again with them flipped, and a transition counts the fewest errors
of those replays.

Nothing of the program is imported.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

BAND = 1e-9
TURN_BAND = 1e-12
STEP_TOL = 1e-12  # of the step, for a recorded leaf's θ
MAX_DELTA_H = 1000.0
MAX_FLIPS = 3
MAX_REPLAYS = 64


class _Draws:
    """The transition's draws, made as the program makes them."""

    def __init__(self, key: int, device, C: int):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(key))
        self.C = C
        self.kw = dict(dtype=torch.float64, device=device, generator=gen)

    def normal(self, shape) -> np.ndarray:
        return torch.randn(shape, **self.kw).cpu().numpy()

    def uniform(self) -> np.ndarray:
        return torch.rand(self.C, **self.kw).cpu().numpy()


@dataclasses.dataclass
class _Leaf:
    theta: np.ndarray
    p: np.ndarray
    logp: float
    grad: np.ndarray
    index: int  # the batched evaluation it came from; -1 for the start
    w: float = 0.0


@dataclasses.dataclass
class Replay:
    """One replay of a transition. p0 [C, D]: the momenta drawn; bad [C]:
    leaf, count or schedule errors; chosen [C]: the proposal's evaluation
    (-1: the start); accept [C]; leaves [C]: the leaves each chain built;
    used: the evaluations the replayed trees need; built: per chain, each
    leaf built as (its evaluation, its edge's evaluation or -1, the signed
    step), in the order built; ties: the near-tied decisions met."""

    p0: np.ndarray
    bad: np.ndarray
    chosen: np.ndarray
    accept: np.ndarray
    leaves: np.ndarray
    used: int
    built: list
    ties: list


def _turned(p_first, p_last, sum_p, inv_mass, key, ties, flip) -> bool:
    dr = inv_mass * sum_p
    dots = [float(dr @ p_first), float(dr @ p_last)]
    scales = [float(np.abs(dr) @ np.abs(p_first)),
              float(np.abs(dr) @ np.abs(p_last))]
    turned = any(d <= 0.0 for d in dots)
    if not any(d < -TURN_BAND * s for d, s in zip(dots, scales)) and any(
            abs(d) <= TURN_BAND * s for d, s in zip(dots, scales)):
        ties.append(key)
        turned ^= key in flip
    return turned


def _take(u: float, threshold: float, key, ties, flip) -> bool:
    """log(u) < threshold, the program's test (False where it is NaN)."""
    take = bool(np.log(u) < threshold)
    if abs(u - np.exp(threshold)) <= BAND:
        ties.append(key)
        take ^= key in flip
    return take


def replay(key: int, start, evals, step, inv_mass, max_depth: int, device,
           flip=frozenset()) -> Replay:
    """Replay the transition seeded with `key` from start = (θ [C, D],
    log p [C], ∇ [C, D]) over the program's batched evaluations `evals`, a
    list of (θ [C, D], log p [C], ∇ [C, D]), with step [C], inv_mass
    [C, D] and max_depth; `flip`: keys of near-tied decisions to take the
    other way."""
    with np.errstate(divide="ignore", invalid="ignore"):  # log 0, -inf - -inf
        return _replay(key, start, evals, step, inv_mass, max_depth, device,
                       flip)


def _replay(key, start, evals, step, inv_mass, max_depth, device, flip):
    theta0, logp0, grad0 = (np.asarray(x, np.float64) for x in start)
    step = np.asarray(step, np.float64)
    inv_mass = np.asarray(inv_mass, np.float64)
    C, D = theta0.shape
    held = inv_mass == 0.0
    draws = _Draws(key, device, C)
    z = draws.normal((C, D))
    p0 = np.where(held, 0.0, z * np.sqrt(1.0 / np.where(held, 1.0, inv_mass)))
    e0 = logp0 - 0.5 * np.sum(inv_mass * p0 ** 2, axis=1)

    traj = [[_Leaf(theta0[c], p0[c], logp0[c], grad0[c], -1)]
            for c in range(C)]
    lw = np.zeros(C)
    chosen = np.full(C, -1)
    sacc = np.zeros(C)
    n_built = np.zeros(C, int)
    stopped = np.zeros(C, bool)
    bad = np.zeros(C, bool)
    built = [[] for _ in range(C)]
    ties = []
    used = 0
    for depth in range(max_depth):
        if stopped.all():
            break
        forward = draws.uniform() < 0.5
        subs = {}
        for c in np.flatnonzero(~stopped):
            subs[c] = _subtree(c, depth, traj[c], forward[c], step[c],
                               inv_mass[c], held[c], e0[c], theta0[c],
                               evals, used, built[c], ties, flip)
            bad[c] |= subs[c][3]
        n_evals = max(len(s[0]) for s in subs.values())
        takes = [draws.uniform() for _ in range(n_evals)]
        u = draws.uniform()
        for c, (leaves, turned, diverged, _, edge) in subs.items():
            lw_sub, prop = -np.inf, edge  # the program's subtree starts there
            for n, leaf in enumerate(leaves):
                lw_new = np.logaddexp(lw_sub, leaf.w)
                if _take(takes[n][c], leaf.w - lw_new,
                         ("take", c, depth, n), ties, flip):
                    prop = leaf.index
                lw_sub = lw_new
                sacc[c] += min(1.0, np.exp(leaf.w))
            n_built[c] += len(leaves)
            if turned or diverged or not leaves:
                stopped[c] = True
                continue
            lw_new = np.logaddexp(lw[c], lw_sub)
            if _take(u[c], lw_sub - lw_new, ("combine", c, depth), ties,
                     flip):
                chosen[c] = prop
            lw[c] = lw_new
            traj[c] = (traj[c] + leaves if forward[c]
                       else leaves[::-1] + traj[c])
            sum_p = np.sum([leaf.p for leaf in traj[c]], axis=0)
            stopped[c] = _turned(traj[c][0].p, traj[c][-1].p, sum_p,
                                 inv_mass[c], ("whole", c, depth), ties, flip)
        used += n_evals
    if used != len(evals):
        bad[:] = True
    accept = sacc / np.maximum(n_built, 1)
    return Replay(p0, bad, chosen, accept, n_built, used, built, ties)


def _subtree(c, depth, traj, forward, step, inv_mass, held, e0, theta0,
             evals, offset, built, ties, flip):
    """Chain c's subtree of this depth from its trajectory's end: (leaves,
    turned, diverged, bad, the end's evaluation)."""
    eps = step if forward else -step
    edge = traj[-1] if forward else traj[0]
    first, leaves, bad = edge.index, [], False
    for n in range(1 << depth):
        k = offset + n
        if k >= len(evals):
            return leaves, False, False, True, first
        th, logp, grad = (np.asarray(x[c], np.float64) for x in evals[k])
        p_half = edge.p + 0.5 * eps * edge.grad
        want = edge.theta + eps * inv_mass * p_half
        bad |= bool(np.any(th[held] != theta0[held]))
        bad |= not bool(np.all(np.abs(th - want)[~held]
                               <= STEP_TOL * abs(step)))
        p = p_half + 0.5 * eps * grad
        w = float((logp - 0.5 * np.sum(inv_mass * p ** 2)) - e0)
        leaf = _Leaf(th, p, float(logp), grad, k, w if np.isfinite(w)
                     else -np.inf)
        built.append((k, edge.index, eps))
        leaves.append(leaf)
        turned = False
        for j in range(1, n.bit_length() + 1):
            size = 1 << j
            if (n + 1) % size:
                break
            span = leaves[n + 1 - size:]
            turned |= _turned(span[0].p, span[-1].p,
                              np.sum([s.p for s in span], axis=0), inv_mass,
                              ("span", c, depth, n, j), ties, flip)
        diverged = leaf.w < -MAX_DELTA_H
        if turned or diverged:
            return leaves, turned, diverged, bad, first
        edge = leaf
    return leaves, False, False, bad, first


def _wrong(r: Replay, start, evals, out, accept, n_leaves) -> np.ndarray:
    """[C]: the chains whose replay, returned state, acceptance or leaf
    count disagrees."""
    wrong = r.bad.copy()
    for c in range(len(wrong)):
        src = start if r.chosen[c] < 0 else evals[r.chosen[c]]
        wrong[c] |= not all(np.array_equal(np.asarray(o)[c], np.asarray(s)[c])
                            for o, s in zip(out, src))
        wrong[c] |= not abs(float(accept[c]) - r.accept[c]) <= BAND
        wrong[c] |= int(round(float(n_leaves[c]))) != r.leaves[c]
    return wrong


def decision_errors(key, start, evals, out, accept, n_leaves, step,
                    inv_mass, max_depth, device) -> int:
    """The chains of one transition whose decisions disagree with the
    replay: out = the returned (θ, log p, ∇), accept [C] and n_leaves [C]
    (gradient evaluations) as the program returned them. Where a wrong
    chain met near-tied decisions, the fewest errors over the replays with
    up to MAX_FLIPS of them flipped (at most MAX_REPLAYS replays)."""
    args = (key, start, evals, step, inv_mass, max_depth, device)
    r = replay(*args)
    wrong = _wrong(r, start, evals, out, accept, n_leaves)
    best = int(wrong.sum())
    ties = [t for t in r.ties if wrong[t[1]]]
    flips = itertools.chain.from_iterable(
        itertools.combinations(ties, k) for k in range(1, MAX_FLIPS + 1))
    for flip in itertools.islice(flips, MAX_REPLAYS):
        if best == 0:
            break
        best = min(best, int(_wrong(replay(*args, flip=frozenset(flip)),
                                    start, evals, out, accept,
                                    n_leaves).sum()))
    return best
