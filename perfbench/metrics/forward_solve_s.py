"""Mean host seconds of one chain-batched forward CG solve of the
calibration, over the window: the program's SolveStats counters
forward_ns over forward_calls (sums of CGResult.wall_ns, which ends on a norm
read and so holds the device work the call queued). The span forward.solve
names the same solve in a trace and is not read here."""


def read(run):
    c = run.counters
    if not c.get("forward_calls"):
        return None
    return 1e-9 * c["forward_ns"] / c["forward_calls"]
