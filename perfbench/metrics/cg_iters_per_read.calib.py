"""Batched CG loop iterations per host read of the calibration's forward
and adjoint solves, over the window (the program's SolveStats):
(forward_loop_iters + adjoint_loop_iters) / (forward_reads +
adjoint_reads). Just under 1 on a loop that reads every iteration (and
once before it); about the block length on one that reads once per
replayed block. None where the program counts no reads."""


def read(run):
    c = run.counters
    if "forward_reads" not in c:
        return None
    reads = c["forward_reads"] + c["adjoint_reads"]
    if not reads:
        return None
    return (c["forward_loop_iters"] + c["adjoint_loop_iters"]) / reads
