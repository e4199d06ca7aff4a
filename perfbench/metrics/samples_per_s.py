"""Posterior draws of all chains per second: the window's draws over its
seconds."""


def read(run):
    return sum(r["draws"] for r in run.requests) / run.window_s
