"""The float32 general apply's share, in %, of its bound (perfbench/
rooflines/general_apply.py) on the cell's mapped HEX8 mesh: the device
seconds of both of its kernels' launches in the traced slice over the
element kernel's launches (one an apply), against the bound of one
apply. None where the trace holds no element kernel (a program without
them)."""

import math


def read(run):
    from perfbench.rooflines import general_apply as ga

    if run.trace is None:
        return None
    kernels = run.trace["kernels"]
    applies = sum(v[0] for n, v in kernels.items() if ga.ELEMENT_KERNEL in n)
    if not applies:
        return None
    seconds = sum(v[1] for n, v in kernels.items()
                  if ga.ELEMENT_KERNEL in n or ga.NODE_KERNEL in n)
    nn = 8 if run.cell.config["elem_type"].startswith("HEX8") else 4
    nelem = math.prod(run.grid)
    nnode = math.prod(n + 1 for n in run.grid)
    return 100.0 * ga.bound_s(nelem, nnode, nn, 4) / (seconds / applies)
