"""Host milliseconds per batched CG loop iteration of the calibration's
forward and adjoint solves outside their norm reads, over the window (the
program's SolveStats): 1e-6 (forward_ns + adjoint_ns - forward_wait_ns -
adjoint_wait_ns) / (forward_loop_iters + adjoint_loop_iters)."""


def read(run):
    c = run.counters
    loops = c["forward_loop_iters"] + c["adjoint_loop_iters"]
    if "forward_ns" not in c or not loops:
        return None
    host = (c["forward_ns"] + c["adjoint_ns"] - c["forward_wait_ns"]
            - c["adjoint_wait_ns"])
    return 1e-6 * host / loops
