"""Mean seconds per solve of the CG operator's build
(analysis/linear._pick_cg_path: the stencil operator on this beam) inside
the program's "Operator setup" phase: its part "grid_s" (span
setup.cg_operator). A part is host time only: it does not synchronise, so
device work it queued may be charged to a later part or to the phase's
closing sync, where the phase settles it."""

from perfbench import readers


def read(run):
    return readers.phase_mean(run, "Operator setup", "grid_s")
