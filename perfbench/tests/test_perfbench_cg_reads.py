"""The readers of the base CG's host reads and frozen iterations, on
synthetic runs: a value where the program's "Linear solve (CG, ...)"
records hold reads and frozen, None (the metric left out) where they do
not, as in a run of a program without them."""

import pytest

from perfbench import harness


def _run(phases):
    return harness.Run(cell=None, setup_s=0.0, window_s=1.0, requests=[],
                       counters={"phases": phases}, spans={},
                       grid=(1, 1, 1))


def _solves(with_keys: bool):
    """Two solves' PhaseTimer records: 500 and 300 iterations, read in 33
    and 20 blocks of 16 (one read more each before the loop)."""
    def solve(iters, reads, frozen):
        base = {"phase": "Linear solve (CG, stencil)", "seconds": 0.2,
                "iters": iters, "cg_s": 0.19, "wait_s": 0.04}
        if with_keys:
            base.update(reads=reads, frozen=frozen)
        return [{"phase": "Operator setup", "seconds": 0.6}, base,
                {"phase": "Certify (f64 refinement)", "seconds": 0.3}]
    return [solve(500, 33, 12), solve(300, 20, 4)]


WANT = {
    "cg_iters_per_read.solve": 800 / 53,
    "cg_frozen_share.solve": 100.0 * 16 / 816,
}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reads_the_program_keys(metric):
    assert harness.reader(metric)(_run(_solves(True))) == pytest.approx(
        WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_none_without_the_program_keys(metric):
    assert harness.reader(metric)(_run(_solves(False))) is None
    assert harness.reader(metric)(_run([])) is None


def test_a_loop_that_reads_every_iteration():
    """The per-iteration loop: iters + 2 reads a solve, nothing frozen."""
    run = _run([[{"phase": "Linear solve (CG, stencil)", "iters": 98,
                  "reads": 100, "frozen": 0}]])
    assert harness.reader("cg_iters_per_read.solve")(run) == 0.98
    assert harness.reader("cg_frozen_share.solve")(run) == 0.0
