"""Mean seconds per solve of the general operator's build
(fem/operator.build_operator) inside the program's "Operator setup" phase:
its part "general_s" (span setup.general_operator). A part is host time
only: it does not synchronise, so device work it queued may be charged to
a later part or to the phase's closing sync, where the phase settles it."""

from perfbench import readers


def read(run):
    return readers.phase_mean(run, "Operator setup", "general_s")
