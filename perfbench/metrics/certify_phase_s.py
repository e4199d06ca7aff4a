"""Mean seconds of the program's "Certify (f64 refinement)" phase per
solve: the float64 host twin's refinement (PhaseTimer)."""

from perfbench import readers


def read(run):
    return readers.phase_mean(run, "Certify (f64 refinement)")
