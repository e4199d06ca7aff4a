"""The 90th percentile of the window's case times (every case, each from
its start to its synchronised end)."""

from perfbench import readers


def read(run):
    return readers.percentile([r["seconds"] for r in run.requests], 90)
