"""The readers of the program's own spans and counters, on synthetic runs:
a value where the program's keys are there, None (the metric left out)
where they are not, as in a run of a program without them."""

import pytest

from perfbench import harness


def _run(counters):
    return harness.Run(cell=None, setup_s=0.0, window_s=1.0, requests=[],
                       counters=counters, spans={}, grid=(1, 1, 1))


def _solves(with_keys: bool):
    """Two solves' PhaseTimer records."""
    def solve(general, grid, cg, wait, iters):
        setup = {"phase": "Operator setup", "seconds": 0.6}
        base = {"phase": "Linear solve (CG, stencil)", "seconds": 0.2,
                "iters": iters}
        if with_keys:
            setup.update(general_s=general, grid_s=grid)
            base.update(cg_s=cg, wait_s=wait)
        return [setup, base, {"phase": "Certify (f64 refinement)",
                              "seconds": 0.3}]
    return {"phases": [solve(0.3, 0.2, 0.19, 0.04, 500),
                       solve(0.5, 0.1, 0.21, 0.06, 500)]}


def _stats(with_keys: bool):
    c = {"forward_solves": 32, "forward_iters": 9000,
         "forward_unconverged": 0, "forward_loop_iters": 600,
         "adjoint_solves": 32, "adjoint_iters": 9400,
         "adjoint_unconverged": 0, "adjoint_loop_iters": 600}
    if with_keys:
        c.update(forward_calls=2, adjoint_calls=2, forward_ns=400_000_000,
                 adjoint_ns=600_000_000, forward_wait_ns=100_000_000,
                 adjoint_wait_ns=140_000_000)
    return c


WANT = {
    "setup_general_s": (_solves, 0.4),
    "setup_grid_s": (_solves, 0.15),
    "cg_host_ms_per_iter.solve": (_solves, 1e3 * (0.40 - 0.10) / 1000),
    "cg_wait_ms_per_iter.solve": (_solves, 1e3 * 0.10 / 1000),
    "forward_solve_s": (_stats, 0.2),
    "adjoint_solve_s": (_stats, 0.3),
    "cg_host_ms_per_iter.calib": (_stats, 1e-6 * 760_000_000 / 1200),
    "cg_wait_ms_per_iter.calib": (_stats, 1e-6 * 240_000_000 / 1200),
}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reads_the_program_keys(metric):
    make, want = WANT[metric]
    assert harness.reader(metric)(_run(make(True))) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_none_without_the_program_keys(metric):
    make, _ = WANT[metric]
    assert harness.reader(metric)(_run(make(False))) is None
    if make is _solves:  # nor without a solve
        assert harness.reader(metric)(_run({"phases": []})) is None


def test_host_and_wait_sum_to_the_cg_wall_per_iteration():
    run = _run(_stats(True))
    per_iter = 1e-6 * (1_000_000_000) / 1200
    assert (harness.reader("cg_host_ms_per_iter.calib")(run)
            + harness.reader("cg_wait_ms_per_iter.calib")(run)
            == pytest.approx(per_iter))
