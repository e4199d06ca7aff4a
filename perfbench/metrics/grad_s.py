"""Mean seconds of one chain-batched log-posterior-and-gradient call in
the window (the benchmark's span, synchronised at its edges)."""

from perfbench import readers


def read(run):
    return readers.mean(run.spans.get("grad"))
