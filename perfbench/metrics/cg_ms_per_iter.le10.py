"""Milliseconds per iteration of the solves' base CG on the general
operator: 1e3 cg_s / iters summed over the program's "Linear solve
(CG, ...)" records (CGResult.wall_ns)."""

from perfbench import readers


def read(run):
    sums = readers.totals(run, "Linear solve (CG", "cg_s", "iters")
    if sums is None or not sums[1]:
        return None
    return 1e3 * sums[0] / sums[1]
