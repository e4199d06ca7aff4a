"""The kernels' operations and bytes from their shapes."""

import pytest

from perfbench import peaks
from perfbench.rooflines import stencil_sweep, theta_sweep


def test_stencil_sweep_counts_at_70_cubed():
    nbytes, flops = stencil_sweep.counts((71, 71, 71), 4)
    assert nbytes == (3 * 73 ** 3 + 3 * 71 ** 3 + 27 * 27 * 9) * 4
    assert flops == 2 * 27 * 9 * 71 ** 3
    # bytes bind it: 2.68 us at 3.35 TB/s, the bound the port's tables give
    assert stencil_sweep.bound_s((71, 71, 71), 4) == pytest.approx(
        nbytes / peaks.HBM_BYTES_PER_S)
    assert stencil_sweep.bound_s((71, 71, 71), 4) == pytest.approx(2.683e-6, rel=1e-3)
    assert stencil_sweep.bound_s((71, 71, 71), 8) == pytest.approx(5.366e-6, rel=1e-3)


def test_theta_sweep_counts():
    one = theta_sweep.counts(1, (33, 33, 33), 4)
    many = theta_sweep.counts(16, (33, 33, 33), 4)
    tables = 2 * 27 * 27 * 9 * 4
    per_chain = (3 * 35 ** 3 + 3 * 33 ** 3 + 2) * 4
    assert one[0] == per_chain + tables
    assert many[0] == 16 * per_chain + tables
    assert many[1] == 16 * one[1] == 16 * 2 * 243 * 33 ** 3
    assert theta_sweep.bound_s(16, (33, 33, 33), 4) == pytest.approx(4.53e-6, rel=2e-3)
    assert theta_sweep.bound_s(1, (33, 33, 33), 4) == pytest.approx(0.30e-6, rel=2e-2)


def test_a_bound_never_exceeds_the_slower_resource():
    for size in (4, 8):
        nbytes, flops = stencil_sweep.counts((10, 20, 30), size)
        assert stencil_sweep.bound_s((10, 20, 30), size) == max(
            nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.PEAK_FLOPS[size])
