"""Mean seconds of the program's base CG phase, "Linear solve (CG, ...)",
per solve (PhaseTimer)."""

from perfbench import readers


def read(run):
    return readers.phase_mean(run, "Linear solve (CG")
