"""Milliseconds per float64 host sweep of the certification: 1e3 sweep_s /
sweeps summed over the window's "Certify" records (sweeps: the sweeps
run, a counter of the record)."""

from perfbench import readers


def read(run):
    sums = readers.totals(run, "Certify (f64 refinement)", "sweep_s",
                          "sweeps")
    if sums is None or not sums[1]:
        return None
    return 1e3 * sums[0] / sums[1]
