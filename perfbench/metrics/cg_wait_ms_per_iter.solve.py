"""Host milliseconds per iteration of the solves' base CG blocked in its
host reads of the norms: 1e3 wait_s / iters summed over the program's
"Linear solve (CG, ...)" records (CGResult.wait_ns): the host waiting for
the device in solvers/cg.pcg."""

from perfbench import readers


def read(run):
    sums = readers.totals(run, "Linear solve (CG", "wait_s", "iters")
    if sums is None or not sums[1]:
        return None
    return 1e3 * sums[0] / sums[1]
