"""The device's idle share of the traced slice, one whole NUTS transition,
in %."""

from perfbench import readers


def read(run):
    return readers.idle_percent(run)
