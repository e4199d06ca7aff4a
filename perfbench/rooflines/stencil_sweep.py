"""The least time of one stencil_sweep (csrc/stencil_sweep.cu) from its
shapes. Frozen copy of ``sweep_bound_ms`` in stan_tpu_torch/bench.py: the
ghost-padded input, the output and the packed [27, 27, 3, 3] table each
moved once at the HBM rate, against 243 multiply-adds per node (27
neighbours x a 3 x 3 block) at the peak rate of the type."""

from __future__ import annotations

import math

from perfbench import peaks

# The kernel's name in a device trace: the sweep template instantiated with
# the fixed-table coefficients, in float32.
KERNEL = "TableCoef<float>"


def counts(node_shape, size: int) -> tuple:
    """(bytes, floating-point operations) of one sweep over a whole grid
    of `node_shape` nodes, `size` bytes per element."""
    nodes = math.prod(node_shape)
    padded = math.prod(n + 2 for n in node_shape)
    return (3 * padded + 3 * nodes + 27 * 27 * 9) * size, 2 * 243 * nodes


def bound_s(node_shape, size: int) -> float:
    nbytes, flops = counts(node_shape, size)
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.PEAK_FLOPS[size])
