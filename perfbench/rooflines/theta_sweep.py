"""The least time of one theta sweep (csrc/theta_sweep.cu: theta_sweep for
one chain, theta_sweep_batched for B) from its shapes: the counterpart of
stencil_sweep's count. K(θ)·u = λ K_λu + μ K_μu for every chain needs
each chain's ghost-padded u read once and its output written once, both
unit-Lame tables ([2, 27, 27, 3, 3]) and the [B, 2] coefficients read
once, and 243 multiply-adds per node per chain (the coefficients fold
into one table per chain). It does not depend on how a kernel does it."""

from __future__ import annotations

import math

from perfbench import peaks

KERNEL = "ThetaCoef<float>"


def counts(batch: int, node_shape, size: int) -> tuple:
    nodes = math.prod(node_shape)
    padded = math.prod(n + 2 for n in node_shape)
    nbytes = (batch * (3 * padded + 3 * nodes) + 2 * 27 * 27 * 9
              + 2 * batch) * size
    return nbytes, 2 * 243 * nodes * batch


def bound_s(batch: int, node_shape, size: int) -> float:
    nbytes, flops = counts(batch, node_shape, size)
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.PEAK_FLOPS[size])
