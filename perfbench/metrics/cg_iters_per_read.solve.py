"""Base CG iterations per host read of the norms: iters / reads summed
over the program's "Linear solve (CG, ...)" records (CGResult.reads). Just under 1
on a loop that reads every iteration (and twice before it); about the
block length on one that reads once per replayed block."""

from perfbench import readers


def read(run):
    sums = readers.totals(run, "Linear solve (CG", "iters", "reads")
    if sums is None or not sums[1]:
        return None
    return sums[0] / sums[1]
