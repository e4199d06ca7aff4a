"""Milliseconds of case wall time per inner CG iteration of pcg_certified,
over the window's cases."""


def read(run):
    return 1e3 * sum(r["seconds"] for r in run.requests) / max(
        sum(r["inner_iters"] for r in run.requests), 1)
