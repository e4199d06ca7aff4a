"""The device's idle share of the traced slice of gradient evaluations,
in %."""

from perfbench import readers


def read(run):
    return readers.idle_percent(run)
