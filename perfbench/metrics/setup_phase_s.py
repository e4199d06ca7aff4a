"""Mean seconds of the program's "Operator setup" phase per solve
(PhaseTimer, synchronised at its edges)."""

from perfbench import readers


def read(run):
    return readers.phase_mean(run, "Operator setup")
