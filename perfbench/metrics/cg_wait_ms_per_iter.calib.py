"""Host milliseconds per batched CG loop iteration of the calibration's
forward and adjoint solves blocked in their host reads of the norms, over
the window (the program's SolveStats): 1e-6 (forward_wait_ns +
adjoint_wait_ns) / (forward_loop_iters + adjoint_loop_iters)."""


def read(run):
    c = run.counters
    loops = c["forward_loop_iters"] + c["adjoint_loop_iters"]
    if "forward_wait_ns" not in c or not loops:
        return None
    return 1e-6 * (c["forward_wait_ns"] + c["adjoint_wait_ns"]) / loops
