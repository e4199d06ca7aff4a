"""Seconds per full certified solve: the window's seconds over its solves."""


def read(run):
    return run.window_s / len(run.requests)
