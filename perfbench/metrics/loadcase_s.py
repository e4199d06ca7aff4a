"""Seconds per certified load case: the window's seconds over its cases."""


def read(run):
    return run.window_s / len(run.requests)
