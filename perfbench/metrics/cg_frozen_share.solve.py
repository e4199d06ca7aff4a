"""Share of the base CG's device iterations run after the stop, in %:
100 frozen / (iters + frozen) summed over the program's "Linear solve
(CG, ...)" records (CGResult.frozen): the waste of reading the stopping
test once per block of iterations."""

from perfbench import readers


def read(run):
    sums = readers.totals(run, "Linear solve (CG", "iters", "frozen")
    if sums is None or not sum(sums):
        return None
    iters, frozen = sums
    return 100.0 * frozen / (iters + frozen)
