"""The port's spans and counters (utils/timing.span, PhaseTimer parts,
CGResult.wall_ns / wait_ns, SolveStats' host times), on the CPU.

With no profiler recording, a span is a shared null context and the solves
call no record_function; under torch.profiler each span is an annotation
nested where the program opens it. The counters are filled by the solves
themselves and the phase records keep their shape.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stan_tpu_torch.analysis.linear import solve_linear_statics
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.fem import stencil
from stan_tpu_torch.infer import forward
from stan_tpu_torch.solvers import cg
from stan_tpu_torch.utils import timing
from stan_tpu_torch.utils.timing import PhaseTimer

F32, F64 = torch.float32, torch.float64


def _certified_case():
    m = meshgen.hex_beam(6, 3, 3)
    op = stencil.build_stencil_operator(m, dtype=F32, device="cpu")
    ex = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    b64 = ex.free_mask * ex.to_grid(torch.as_tensor(m.load_vector(),
                                                    dtype=F64))
    return m, op, ex, b64


def _pcg(batched=False):
    m, op, _, b64 = _certified_case()
    b = b64.to(F32)
    if batched:
        return cg.pcg(lambda u: torch.stack([op.apply(v) for v in u]),
                      torch.stack([b, 2 * b]), diag=op.diagonal(), tol=1e-5,
                      ndof=3 * m.nnode, batched=True)
    return cg.pcg(op.apply, b, diag=op.diagonal(), tol=1e-5,
                  ndof=3 * m.nnode)


def _certified():
    m, op, ex, b64 = _certified_case()
    return cg.pcg_certified(op.apply, b64, ex.apply, diag=op.diagonal(),
                            tol=1e-6, ndof=3 * m.nnode)


def _solve(timer=None):
    return solve_linear_statics(meshgen.hex_beam(5, 4, 4), device="cpu",
                                timer=timer or PhaseTimer(verbose=False))


PROGRAM = ("cg.", "setup.", "certified.", "certify.", "forward.",
           "Operator setup", "Linear solve", "Certify")


def _spans(prof) -> list:
    """(name, innermost enclosing program span or None) of every program
    span in the trace, by the spans' intervals on their thread."""
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
              e.start_thread_id())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(PROGRAM)]
    out = []
    for name, s, e, th in spans:
        outer = [(s2, n2) for n2, s2, e2, th2 in spans
                 if th2 == th and s2 <= s and e <= e2
                 and (s2, e2) != (s, e)]
        out.append((name, max(outer)[1] if outer else None))
    return out


def test_span_is_a_shared_null_context_without_a_profiler():
    assert timing.span("a") is timing.span("b")
    with timing.span("a"):
        pass


@pytest.mark.parametrize("call", [_pcg, lambda: _pcg(batched=True),
                                  _certified, _solve],
                         ids=["pcg", "pcg-batched", "pcg_certified",
                              "solve_linear_statics"])
def test_no_record_function_without_a_profiler(call, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    call()


def test_spans_nest_under_the_profiler():
    timer = PhaseTimer(verbose=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _solve(timer)
    spans = _spans(prof)
    assert ("cg.pcg", "Linear solve (CG, stencil)") in spans
    assert ("setup.general_operator", "Operator setup") in spans
    assert ("setup.cg_operator", "Operator setup") in spans
    for part in ("certify.twin", "certify.copy", "certify.sweep",
                 "certify.inner"):
        assert any(n == part for n, _ in spans), part
    # Each correction's CG is a cg.pcg in a certify.inner_cg part of its
    # certify.inner.
    assert (sum(n == "cg.pcg" and p == "certify.inner_cg" for n, p in spans)
            == sum(n == "certify.inner_cg" and p == "certify.inner"
                   for n, p in spans) == res.refine_cycles)
    # The phases' records are those of an untraced solve.
    assert [r["phase"] for r in timer.records][:2] == [
        "Operator setup", "Linear solve (CG, stencil)"]


def test_certified_residual_once_per_cycle():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _certified()
    spans = _spans(prof)
    assert res.converged and res.cycles >= 2
    assert sum(n == "certify.sweep" for n, _ in spans) == res.cycles
    assert sum(n == "cg.pcg" for n, _ in spans) == res.cycles


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batched"])
def test_cg_host_time_and_wait(batched):
    res = _pcg(batched)
    assert np.all(res.converged)
    assert isinstance(res.wall_ns, int) and isinstance(res.wait_ns, int)
    assert 0 < res.wait_ns <= res.wall_ns
    assert res.reads == np.max(res.iters) + (1 if batched else 2)
    assert res.frozen == 0


def test_stencil_forward_fills_the_solve_stats():
    m = meshgen.hex_beam(4, 3, 3)
    fwd = forward.build_stencil_forward(m, dtype=F64, device="cpu",
                                        cg_tol=1e-8)
    before = fwd.stats.as_dict()
    lam = torch.tensor([1.2e5, 1.0e5], dtype=F64, requires_grad=True)
    mu = torch.tensor([8.0e4, 7.0e4], dtype=F64, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        u = fwd.solve(lam, mu)
        u.square().sum().backward()
    d = fwd.stats.since(before)
    assert d["forward_calls"] == d["adjoint_calls"] == 1
    assert d["forward_solves"] == d["adjoint_solves"] == 2
    for kind in ("forward", "adjoint"):
        assert 0 < d[f"{kind}_wait_ns"] <= d[f"{kind}_ns"]
        assert all(isinstance(d[k], int) for k in d)
    spans = _spans(prof)
    assert ("cg.pcg", "forward.solve") in spans
    assert ("cg.pcg", "forward.adjoint") in spans


def test_phase_records_carry_the_parts_and_counters():
    timer = PhaseTimer(verbose=False)
    res = _solve(timer)
    recs = timer.records
    assert [r["phase"] for r in recs] == [
        "Operator setup", "Linear solve (CG, stencil)",
        "Certify (f64 refinement)", "Stress recovery"]
    setup, base, cert = recs[:3]
    assert 0 < setup["general_s"] + setup["grid_s"] <= setup["seconds"]
    assert base["iters"] == res.iters
    assert 0 < base["wait_s"] <= base["cg_s"] <= base["seconds"]
    # On the CPU the loop reads ||b||, the first ||r|| and one a step.
    assert (base["reads"], base["frozen"]) == (res.iters + 2, 0)
    for key in ("twin_s", "sweep_s", "inner_s", "copy_s"):
        assert math.isfinite(cert[key]) and cert[key] >= 0, key
    assert cert["refine_iters"] == res.refine_iters
    assert (cert["twin_s"] + cert["sweep_s"] + cert["inner_s"]
            + cert["copy_s"] <= cert["seconds"])


def test_a_part_adds_to_the_open_phase_and_appends_no_record():
    timer = PhaseTimer(verbose=False)
    with timer.part("outside", "x_s"):  # no phase open: a span alone
        pass
    with timer.phase("P", n=3):
        for _ in range(2):
            with timer.part("p.a", "a_s"):
                pass
    assert len(timer.records) == 1
    rec = timer.records[0]
    assert rec["n"] == 3 and 0 <= rec["a_s"] <= rec["seconds"]
    assert "x_s" not in rec
    assert "a_s=" in timer.summary()


def _nuts_run(n, C, stats):
    """n NUTS transitions of C chains on a correlated Gaussian with a flat,
    held third coordinate; returns (target calls, summed gradient
    evaluations the transitions returned)."""
    from stan_tpu_torch.infer import hmc, nuts

    prec = torch.tensor([[1.0, 0.6, 0.0], [0.6, 1.0, 0.0], [0.0, 0.0, 0.0]],
                        dtype=torch.float64)
    calls = 0

    def target(th):
        nonlocal calls
        calls += 1
        g = -th @ prec
        return 0.5 * torch.sum(th * g, dim=1), g

    th = torch.as_tensor(np.random.default_rng(8).normal(size=(C, 3)))
    state = hmc.HMCState(th, *target(th))
    calls = 0
    inv_mass = torch.tensor([[1.0, 1.0, 0.0]] * C, dtype=torch.float64)
    step = torch.linspace(0.3, 1.1, C, dtype=torch.float64)
    evals = 0.0
    for k in range(n):
        state, _, n_evals = nuts.nuts_transition(
            target, torch.Generator().manual_seed(k), state, step, inv_mass,
            5, stats)
        evals += float(n_evals.sum())
    return calls, evals


def test_tree_stats_count_the_calls_and_the_leaves():
    """TreeStats over 12 transitions of 4 chains: lockstep_leaves is the
    target's calls, chain_leaves the gradient evaluations the transitions
    returned, and every chain-transition stopped at a U-turn, a divergence
    or max_depth, having built at least one doubling."""
    from stan_tpu_torch.infer import nuts

    stats = nuts.TreeStats()
    calls, evals = _nuts_run(12, 4, stats)
    d = stats.as_dict()
    assert d["transitions"] == 12 and d["chain_transitions"] == 48
    assert d["lockstep_leaves"] == calls
    assert d["chain_leaves"] == evals
    assert d["chain_leaves"] <= 4 * d["lockstep_leaves"]
    assert 48 <= d["depth_sum"] <= 48 * 5
    assert 0 <= d["at_max_depth"] + d["divergent"] <= 48
    assert all(isinstance(v, int) for v in d.values())
    assert stats.since(d) == dict.fromkeys(d, 0)


def test_nuts_spans_open_once_a_transition_and_once_a_depth():
    """Under the profiler: one nuts.transition per transition, and one
    nuts.doubling per depth the batch built, inside it (one chain: its
    doublings are its depth_sum)."""
    from stan_tpu_torch.infer import nuts

    stats = nuts.TreeStats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _nuts_run(6, 1, stats)
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("nuts.")]
    outer = [(s, e) for n, s, e in spans if n == "nuts.transition"]
    inner = [(s, e) for n, s, e in spans if n == "nuts.doubling"]
    assert len(outer) == stats.transitions == 6
    assert len(inner) == stats.depth_sum
    assert all(any(s0 <= s and e <= e0 for s0, e0 in outer)
               for s, e in inner)
