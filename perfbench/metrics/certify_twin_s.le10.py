"""Mean seconds per LE10 solve of building the float64 host twin (the
"Certify" record's twin_s part)."""

from perfbench import readers


def read(run):
    return readers.phase_mean(run, "Certify (f64 refinement)", "twin_s")
