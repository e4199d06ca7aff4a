"""The general apply's bound from the LE10 mesh, and its roofline reader on
a trace of the two kernels (and on one without them)."""

import types

import pytest

from perfbench import harness, peaks
from perfbench.rooflines import general_apply


def test_bound_at_le10():
    nbytes, flops = general_apply.counts(331776, 351625, 8, 4)
    # conn, coordinates, u, result, the mask at 3 bits a node, one D
    assert nbytes == 23407336 == (4 * 8 * 331776 + 9 * 4 * 351625
                                  + 131860 + 36 * 4)
    assert flops == 2 * 24 ** 2 * 331776
    bound = general_apply.bound_s(331776, 351625, 8, 4)
    assert bound == pytest.approx(6.987e-6, rel=1e-3)  # bytes bind it
    assert bound == max(nbytes / peaks.HBM_BYTES_PER_S,
                        flops / peaks.PEAK_FLOPS[4])
    assert flops / peaks.PEAK_FLOPS[4] == pytest.approx(5.70e-6, rel=1e-3)


def _run(kernels):
    return types.SimpleNamespace(
        cell=harness.find_cell("le10-solve"), grid=(144, 96, 24),
        trace={"kernels": kernels, "busy_s": 1.0, "window_s": 2.0})


def test_reader_divides_both_kernels_time_by_the_applies():
    read = harness.reader("general_apply_roofline")
    bound = general_apply.bound_s(331776, 351625, 8, 4)
    element = ("void (anonymous namespace)::general_element_kernel<float, 8, "
               "8>(float const*, ...)")
    node = "void (anonymous namespace)::general_node_kernel<float>(...)"
    # 100 applies of 0.1 ms element and 0.05 ms node time
    value = read(_run({element: [100, 0.010], node: [100, 0.005],
                       "general_element_kernel<double, 8, 8>": [5, 1.0],
                       "gemmSN_NN_kernel": [300, 2.0]}))
    assert value == pytest.approx(100.0 * bound / 1.5e-4)
    assert read(_run({"gemmSN_NN_kernel": [300, 2.0]})) is None
    assert read(types.SimpleNamespace(trace=None)) is None
