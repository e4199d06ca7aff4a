"""The float32 theta sweep's share, in %, of its bound at the NUTS cell's
batch of chains (perfbench/rooflines/theta_sweep.py), over the traced
transition's launches."""

from perfbench import readers


def read(run):
    from perfbench.rooflines import theta_sweep

    chains = run.cell.workload["traffic"]["chains"]
    shape = [n + 1 for n in run.grid]
    return readers.roofline_percent(run, theta_sweep.KERNEL,
                                    theta_sweep.bound_s(chains, shape, 4))
