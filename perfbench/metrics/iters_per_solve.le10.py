"""CG iterations per LE10 solve, the window's mean: the base solve's
iterations plus the certification's inner iterations (refine_iters)."""

from perfbench import readers


def read(run):
    base = readers.phase_mean(run, "Linear solve (CG", "iters")
    refine = readers.phase_mean(run, "Certify (f64 refinement)",
                                "refine_iters")
    if base is None or refine is None:
        return None
    return base + refine
