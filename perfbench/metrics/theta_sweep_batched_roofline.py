"""The float32 theta sweep's share, in %, of its bound at the cell's batch
of chains (perfbench/rooflines/theta_sweep.py), in a cell of more than
one chain."""

from perfbench import readers


def read(run):
    from perfbench.rooflines import theta_sweep

    chains = run.cell.workload["traffic"]["chains"]
    if chains < 2:
        return None
    shape = [n + 1 for n in run.grid]
    return readers.roofline_percent(run, theta_sweep.KERNEL,
                                    theta_sweep.bound_s(chains, shape, 4))
