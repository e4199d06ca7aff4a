"""Inner CG iterations per certified case (CertifiedResult.inner_iters),
the window's mean."""


def read(run):
    return sum(r["inner_iters"] for r in run.requests) / len(run.requests)
