"""The reader of the calibration's batched CG iterations per host read, on
synthetic runs: a value where the program's SolveStats hold the reads,
None (the metric left out) where they do not, as in a run of a program
without them."""

import pytest

from perfbench import harness

METRIC = "cg_iters_per_read.calib"


def _run(counters):
    return harness.Run(cell=None, setup_s=0.0, window_s=1.0, requests=[],
                       counters=counters, spans={}, grid=(1, 1, 1))


def _stats(with_reads: bool, blocks: bool = True):
    """Ten forward and ten adjoint solves of 300 and 310 loop iterations,
    read once before each loop and then once a block of 16 (or once an
    iteration)."""
    c = {"forward_loop_iters": 3000, "adjoint_loop_iters": 3100,
         "forward_calls": 10, "adjoint_calls": 10}
    if with_reads:
        if blocks:
            c.update(forward_reads=10 * (19 + 1), adjoint_reads=10 * (20 + 1))
        else:
            c.update(forward_reads=3000 + 10, adjoint_reads=3100 + 10)
    return c


def test_reads_the_program_counters():
    assert harness.reader(METRIC)(_run(_stats(True))) == pytest.approx(
        6100 / 410)


def test_a_loop_that_reads_every_iteration():
    assert harness.reader(METRIC)(_run(_stats(True, False))) == (
        pytest.approx(6100 / 6120))


def test_none_without_the_program_counters():
    assert harness.reader(METRIC)(_run(_stats(False))) is None
    assert harness.reader(METRIC)(_run({})) is None
    assert harness.reader(METRIC)(_run(
        {**_stats(False), "forward_reads": 0, "adjoint_reads": 0})) is None
