"""The float32 stencil_sweep's share, in %, of its bound (perfbench/
rooflines/stencil_sweep.py) from the device time per launch in the
traced slice."""

from perfbench import readers


def read(run):
    from perfbench.rooflines import stencil_sweep

    shape = [n + 1 for n in run.grid]
    return readers.roofline_percent(run, stencil_sweep.KERNEL,
                                    stencil_sweep.bound_s(shape, 4))
