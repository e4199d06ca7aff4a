"""Mean seconds of one chain-batched log-posterior-and-gradient call of
the NUTS cell's window, a lockstep leaf (the benchmark's span, synchronised
at its edges in the traced run)."""

from perfbench import readers


def read(run):
    return readers.mean(run.spans.get("grad"))
