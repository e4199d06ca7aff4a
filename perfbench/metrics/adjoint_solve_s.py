"""Mean host seconds of one chain-batched adjoint CG solve of the
calibration's gradient, over the window: the program's SolveStats counters
adjoint_ns over adjoint_calls (sums of CGResult.wall_ns, which ends on a norm
read and so holds the device work the call queued). The span forward.adjoint
names the same solve in a trace and is not read here."""


def read(run):
    c = run.counters
    if not c.get("adjoint_calls"):
        return None
    return 1e-9 * c["adjoint_ns"] / c["adjoint_calls"]
