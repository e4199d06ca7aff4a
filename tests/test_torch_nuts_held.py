"""Held coordinates in the port's samplers, and NUTS against the plain
replay of perfbench/reference/nuts.py, on the CPU.

A coordinate whose inverse mass is 0 is held: its momentum is 0, so θ
never moves there. The calibration with the load fixed does not depend on
log s; without the hold a free momentum there never turns, and every NUTS
tree runs to max_depth. Where no inverse mass is 0, every draw is the bits
it was before the hold existed (the digests below were recorded from the
samplers without it, on this CPU generator).
"""

import hashlib

import numpy as np
import pytest
import torch

from perfbench.reference import nuts as reference
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.infer import calibrate, forward, hmc, nuts

F64 = torch.float64
# The inverse mass the HMC cells adapted on log s, which a sampler without
# the hold gives the flat coordinate.
FREE_FLAT = 1.54e-3


@pytest.fixture(autouse=True)
def _one_thread():
    """The FEM solves here have about a hundred unknowns: one thread runs
    them as fast as eight alone, and faster beside other test workers on
    the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_target(th):
    """A standard normal in coordinates 0 and 1, flat in coordinate 2."""
    g = -th.clone()
    g[:, 2] = 0.0
    return -0.5 * torch.sum(th[:, :2] ** 2, dim=1), g


def _gauss_target(D, held, seed=7):
    """A correlated Gaussian in D coordinates, or in the first D - 1 and
    flat in the last where `held`."""
    rng = np.random.default_rng(seed)
    n = D - 1 if held else D
    a = rng.normal(size=(n, n))
    prec = np.zeros((D, D))
    prec[:n, :n] = a @ a.T / n + np.eye(n)
    prec = torch.as_tensor(prec)

    def target(th):
        g = -th @ prec
        return 0.5 * torch.sum(th * g, dim=1), g

    return target, np.diag(np.linalg.pinv(prec.numpy()))


def _fem_problem():
    """hex_beam(3, 2, 2)'s float64 posterior with the load fixed."""
    m = meshgen.hex_beam(3, 2, 2)
    fwd = forward.build_forward(m, dtype=F64, device="cpu")
    u = forward.displacement_fn(fwd, m.nelem)(
        torch.tensor([np.log(190000.0), 0.28, 0.0])).numpy()
    total = np.linalg.norm(u, axis=1)
    nodes = np.nonzero(total > 0.3 * total.max())[0]
    obs_nodes, obs_dirs = np.repeat(nodes, 3), np.tile([0, 1, 2], len(nodes))
    y = u[obs_nodes, obs_dirs] + 1e-4 * np.random.default_rng(0).normal(
        size=len(obs_nodes))
    return calibrate.make_problem(m, obs_nodes, obs_dirs, y, 1e-4, dtype=F64,
                                  device="cpu", cg_tol=1e-10)


FEM_THETA0 = [[np.log(200000.0), 0.1, 0.0], [np.log(185000.0), -0.1, 0.0],
              [np.log(190000.0), 0.3, 0.0], [np.log(195000.0), 0.2, 0.0]]


class _Recorded:
    """A chain-batched target that keeps every call's (θ, log p, ∇)."""

    def __init__(self, target):
        self.target, self.evals = target, []

    def __call__(self, theta):
        logp, grad = self.target(theta)
        self.evals.append((theta.clone(), logp.clone(), grad.clone()))
        return logp, grad


@pytest.mark.parametrize("flat_inv_mass,held", [(0.0, True),
                                                (FREE_FLAT, False)])
def test_a_zero_inverse_mass_holds_the_flat_coordinate(flat_inv_mass, held):
    """40 seeded transitions of 4 chains at max_depth 6, step 0.9 in
    whitened units: held, the flat coordinate never moves, in any leaf,
    and the trees stop at U-turns (under 16 lockstep leaves a transition on
    average, under a tenth of the trees at the cap); given the HMC cells'
    inverse mass there instead, the batch builds nearly every tree of the
    cap's 63 leaves, and about half the chains' own trees reach it."""
    C = 4
    rng = np.random.default_rng(1)
    theta = torch.as_tensor(np.c_[rng.normal(size=(C, 2)), np.full(C, 0.3)])
    inv_mass = torch.tensor([[1.0, 1.0, flat_inv_mass]] * C, dtype=F64)
    step = torch.full((C,), 0.9, dtype=F64)
    target = _Recorded(_flat_target)
    state = hmc.HMCState(theta, *target(theta))
    stats = nuts.TreeStats()
    for k in range(40):
        state, acc, _ = nuts.nuts_transition(
            target, torch.Generator().manual_seed(1000 + k), state, step,
            inv_mass, 6, stats)
        assert torch.isfinite(acc).all()
    leaves = stats.lockstep_leaves / stats.transitions
    assert stats.transitions == 40 and stats.chain_transitions == 160
    if held:
        assert all(bool((th[:, 2] == 0.3).all()) for th, _, _ in target.evals)
        assert leaves < 16, leaves
        assert stats.at_max_depth < 16
    else:
        assert leaves >= 55, leaves
        assert stats.at_max_depth >= 64


def test_momenta_are_zero_and_finite_on_a_held_coordinate():
    """hmc_transition and the initial step search with a held coordinate:
    no NaN or inf anywhere, θ held, the momenta 0 there."""
    C = 4
    theta = torch.as_tensor(np.random.default_rng(2).normal(size=(C, 3)))
    inv_mass = torch.tensor([[1.0, 0.5, 0.0]] * C, dtype=F64)
    p = hmc._momenta(torch.Generator().manual_seed(3), theta, inv_mass)
    assert torch.isfinite(p).all() and (p[:, 2] == 0).all()
    assert (p[:, :2] != 0).all()
    state = hmc.HMCState(theta, *_flat_target(theta))
    for k in range(5):
        state, acc = hmc.hmc_transition(
            _flat_target, torch.Generator().manual_seed(k), state,
            torch.full((C,), 0.5, dtype=F64), inv_mass, 8)
        assert all(bool(torch.isfinite(x).all()) for x in (*state, acc))
        assert torch.equal(state.theta[:, 2], theta[:, 2])
    step = hmc._find_reasonable_step(
        _flat_target, torch.Generator().manual_seed(9), state, inv_mass,
        torch.full((C,), 0.1, dtype=F64))
    assert torch.isfinite(step).all() and (step > 0).all()


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = a.numpy() if torch.is_tensor(a) else a
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _free_case():
    rng = np.random.default_rng(25)
    C, D = 4, 3
    a = rng.normal(size=(D, D))
    prec = torch.as_tensor(a @ a.T / D + np.eye(D))
    theta = torch.as_tensor(rng.normal(size=(C, D)))
    inv_mass = torch.as_tensor(rng.uniform(0.5, 1.5, (C, D)))
    return prec, theta, inv_mass, rng


def test_transitions_keep_their_bits_without_a_held_coordinate():
    """NUTS and HMC transitions and the step search with no zero inverse
    mass: the bits recorded from the samplers before the hold."""
    prec, theta, inv_mass, _ = _free_case()
    step = torch.full((4,), 0.4, dtype=F64)

    def target(th):
        g = -th @ prec
        return 0.5 * torch.sum(th * g, dim=1), g

    state = hmc.HMCState(theta, *target(theta))
    out = []
    for k in range(3):
        new, acc, n = nuts.nuts_transition(
            target, torch.Generator().manual_seed(100 + k), state, step,
            inv_mass, 5)
        out += [new.theta, new.logp, new.grad, acc, n]
        new2, acc2 = hmc.hmc_transition(
            target, torch.Generator().manual_seed(200 + k), state, step,
            inv_mass, 6)
        out += [new2.theta, new2.logp, new2.grad, acc2]
        out.append(hmc._find_reasonable_step(
            target, torch.Generator().manual_seed(300 + k), state, inv_mass,
            step))
        state = new
    assert _digest(out) == (
        "fc2775baa25dfbc5c33d70b226c08518aff260c9ef6a549a8edb20f48dea50dc")


def test_runs_keep_their_bits_without_a_held_coordinate():
    """run_nuts and run_hmc with their warmup, held=None: the draws, steps,
    inverse masses, acceptance and evaluations recorded before the hold."""
    prec, theta0, _, _ = _free_case()

    def logp(th):
        return -0.5 * torch.sum((th @ prec) * th, dim=1)

    out = []
    for res in (nuts.run_nuts(logp, theta0, 3, n_samples=4, n_warmup=25,
                              max_depth=4),
                hmc.run_hmc(logp, theta0, 3, n_samples=4, n_warmup=25,
                            n_leapfrog=5)):
        out += [res.samples, res.step_size, res.inv_mass, res.accept_rate,
                res.evals_per_sample]
    assert _digest(out) == (
        "fdb7a97058a039d14c8e1c674bafe7ff3a3fa6df251cc23b4ffca0805ed6b33a")


@pytest.mark.parametrize("sampler", ["nuts", "hmc"])
def test_warmup_keeps_the_load_held(sampler):
    """run_nuts(held=) and run_hmc(held=) on the FEM posterior with the
    load fixed: a mass window closes (the free inverse masses leave 1),
    log s's stays 0, every draw's log s is its start while (E, ν) move,
    R-hat and ESS are NaN there and finite on (E, ν)."""
    prob = _fem_problem()
    assert prob.held == (False, False, True)
    run = {"nuts": lambda **kw: nuts.run_nuts(max_depth=2, **kw),
           "hmc": lambda **kw: hmc.run_hmc(n_leapfrog=2, **kw)}[sampler]
    res = run(logp_fn=prob.log_posterior,
              theta0=torch.tensor(FEM_THETA0, dtype=F64), seed=5,
              n_warmup=20, n_samples=6, init_step=0.02, held=prob.held)
    assert (res.inv_mass[:, 2] == 0).all()
    assert (res.inv_mass[:, :2] != 1).all()
    assert (res.samples[..., 2] == 0).all()
    assert (np.ptp(res.samples[..., :2], axis=1) > 0).all()  # chains move
    assert np.isnan(res.rhat[2]) and np.isnan(res.ess[2])
    assert np.isfinite(res.rhat[:2]).all() and np.isfinite(res.ess[:2]).all()


def test_a_resumed_run_keeps_the_hold(tmp_path):
    """The checkpoint carries the held coordinate's zero inverse mass: a
    run resumed from it draws what the straight run draws, and holds."""
    theta0 = torch.as_tensor(np.c_[np.random.default_rng(6).normal(
        size=(4, 2)), np.full(4, 0.3)])

    def logp(th):
        return _flat_target(th)[0]

    kw = dict(n_warmup=25, max_depth=4, held=[False, False, True])
    straight = nuts.run_nuts(logp, theta0, 8, n_samples=8, **kw)
    path = str(tmp_path / "nuts.ckpt")
    nuts.run_nuts(logp, theta0, 8, n_samples=4, checkpoint_path=path,
                  checkpoint_every=4, **kw)
    resumed = nuts.run_nuts(logp, theta0, 8, n_samples=8,
                            checkpoint_path=path, checkpoint_every=4, **kw)
    np.testing.assert_array_equal(resumed.samples, straight.samples)
    assert (resumed.inv_mass[:, 2] == 0).all()
    assert (resumed.samples[..., 2] == 0.3).all()


def test_diagnostics_are_nan_on_a_constant_coordinate():
    x = np.random.default_rng(4).normal(size=(4, 20, 3))
    x[..., 1] = 0.25
    rhat, ess = hmc.diagnostics(x)
    assert np.isnan(rhat[1]) and np.isnan(ess[1])
    assert np.isfinite(rhat[[0, 2]]).all() and np.isfinite(ess[[0, 2]]).all()


def _case(kind, held):
    """(target, θ0 [4, 3], step [4], inv_mass [4, 3], max_depth)."""
    if kind == "gauss":
        target, var = _gauss_target(3, held)
        theta0 = np.random.default_rng(11).normal(size=(4, 3))
        inv_mass = np.where(var > 0, var, 0.0) if held else var
        return target, theta0, np.array([0.3, 0.5, 0.7, 0.9]), np.tile(
            inv_mass, (4, 1)), 6
    prob = _fem_problem()
    return (hmc.guarded_logp_grad_b(prob.log_posterior),
            np.asarray(FEM_THETA0), np.full(4, 0.25),
            np.tile([0.007, 1.0, 0.0 if held else 0.5], (4, 1)), 3)


def _errors(kind, held, fault=None, monkeypatch=None, n=10):
    """The replay's decision errors over n transitions of 4 chains, with
    the program broken by `fault` underneath: "unchanged" returns every
    transition's start; "altered" hands the sampler 3 nats more on chain 0
    than it records; "no_turn" never lets the U-turn test fire;
    "held_free" gives the program the HMC cells' inverse mass on the held
    coordinate while the replay has 0."""
    target, theta0, step, inv_mass, max_depth = _case(kind, held)
    rec = _Recorded(target)
    sampler_target = rec
    if fault == "altered":
        def sampler_target(th):
            logp, grad = rec(th)
            return logp + 3.0 * (torch.arange(len(logp)) == 0), grad
    if fault == "no_turn":
        monkeypatch.setattr(nuts, "_turning", lambda a, b, s, im:
                            torch.zeros(len(a), dtype=torch.bool))
    program_inv_mass = inv_mass.copy()
    if fault == "held_free":
        program_inv_mass[:, 2] = FREE_FLAT
    th = torch.as_tensor(theta0)
    state = hmc.HMCState(th, *target(th))
    errors = 0
    for k in range(n):
        key = 500 + k
        n0 = len(rec.evals)
        new, acc, n_leaves = nuts.nuts_transition(
            sampler_target, torch.Generator().manual_seed(key), state,
            torch.as_tensor(step), torch.as_tensor(program_inv_mass),
            max_depth)
        out = state if fault == "unchanged" else new
        errors += reference.decision_errors(
            key, tuple(x.numpy() for x in state),
            [tuple(x.numpy() for x in e) for e in rec.evals[n0:]],
            tuple(x.numpy() for x in out), acc.numpy(), n_leaves.numpy(),
            step, inv_mass, max_depth, "cpu")
        state = out
    return errors


@pytest.mark.parametrize("held", [True, False], ids=["held", "free"])
@pytest.mark.parametrize("kind", ["gauss", "fem"])
def test_nuts_transition_agrees_with_the_reference_replay(kind, held):
    assert _errors(kind, held) == 0


@pytest.mark.parametrize("fault", ["unchanged", "altered", "no_turn",
                                   "held_free"])
def test_the_replay_finds_a_broken_sampler(fault, monkeypatch):
    assert _errors("gauss", True, fault, monkeypatch) >= 1


def test_a_near_tie_may_go_either_way(monkeypatch):
    """Where a uniform lies within BAND of its threshold, rounding may
    decide either way: a returned state that the replay with that decision
    flipped chooses counts no error; one that no replay chooses does (BAND
    widened so that every uniform is near its threshold)."""
    monkeypatch.setattr(reference, "BAND", 2.0)
    target, theta0, step, inv_mass, _ = _case("gauss", True)
    th = torch.as_tensor(theta0)
    state = hmc.HMCState(th, *target(th))
    rec = _Recorded(target)
    new, acc, n_leaves = nuts.nuts_transition(
        rec, torch.Generator().manual_seed(77), state, torch.as_tensor(step),
        torch.as_tensor(inv_mass), 3)
    start = tuple(x.numpy() for x in state)
    evals = [tuple(x.numpy() for x in e) for e in rec.evals]
    args = (77, start, evals)
    rest = (acc.numpy(), n_leaves.numpy(), step, inv_mass, 3, "cpu")
    r = reference.replay(*args, step, inv_mass, 3, "cpu")
    last = [t for t in r.ties if t[:2] == ("combine", 0)][-1]
    flipped = reference.replay(*args, step, inv_mass, 3, "cpu",
                               flip=frozenset({last}))
    assert flipped.chosen[0] != r.chosen[0]
    assert (flipped.chosen[1:] == r.chosen[1:]).all()
    other = tuple(np.stack([(start if k < 0 else evals[k])[i][c]
                            for c, k in enumerate(flipped.chosen)])
                  for i in range(3))
    assert reference.decision_errors(*args, other, *rest) == 0
    moved = (other[0] + 1.0, other[1], other[2])
    assert reference.decision_errors(*args, moved, *rest) == 4
