"""Host milliseconds per iteration of the solves' base CG outside its norm
reads: 1e3 (cg_s - wait_s) / iters summed over the program's "Linear solve
(CG, ...)" records (CGResult.wall_ns and wait_ns): dispatch and the host's
own work in solvers/cg.pcg."""

from perfbench import readers


def read(run):
    sums = readers.totals(run, "Linear solve (CG", "cg_s", "wait_s", "iters")
    if sums is None or not sums[2]:
        return None
    cg_s, wait_s, iters = sums
    return 1e3 * (cg_s - wait_s) / iters
