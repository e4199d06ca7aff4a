"""The float32 theta sweep's share, in %, of its bound for one chain
(perfbench/rooflines/theta_sweep.py), in a cell of one chain."""

from perfbench import readers


def read(run):
    from perfbench.rooflines import theta_sweep

    if run.cell.workload["traffic"]["chains"] != 1:
        return None
    shape = [n + 1 for n in run.grid]
    return readers.roofline_percent(run, theta_sweep.KERNEL,
                                    theta_sweep.bound_s(1, shape, 4))
