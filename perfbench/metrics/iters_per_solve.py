"""CG iterations per chain solve, forward and adjoint, over the window
(the program's SolveStats)."""


def read(run):
    c = run.counters
    n = c["forward_solves"] + c["adjoint_solves"]
    return (c["forward_iters"] + c["adjoint_iters"]) / n if n else None
