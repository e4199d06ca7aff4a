"""The device's idle share of the traced slice of load cases, in %."""

from perfbench import readers


def read(run):
    return readers.idle_percent(run)
