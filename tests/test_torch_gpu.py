"""Tests of the port's CUDA kernel and CUDA path; they need a card.

They skip where torch sees no CUDA device. This file imports no jax, so it
also runs where jax is not installed, without the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from stan_tpu.core import meshgen
from stan_tpu_torch.analysis.linear import solve_linear_statics
from stan_tpu_torch.fem import stencil

pytestmark = pytest.mark.gpu

# The kernel and the plain version sum the same products in other orders.
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stencil sweep kernel runs only "
                    "on the card")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("flags", [(1, 1), (0, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("n,kw", [((4, 4, 3), {}),
                                  ((5, 4, 3), {"lx": 6.0, "ly": 1.5,
                                               "lz": 3.0})])
def test_kernel_matches_plain_version(n, kw, flags, dtype):
    _need_cuda()
    op = stencil.build_stencil_operator(meshgen.hex_beam(*n, **kw),
                                        dtype=dtype, device="cuda")
    rng = np.random.default_rng(sum(n))
    up = torch.as_tensor(rng.standard_normal(
        (3, *(k + 2 for k in op.node_shape))), dtype=dtype, device="cuda")
    before = stencil.launches
    f = stencil.stencil_sweep(up, op.table, *flags)
    assert stencil.launches == before + 1
    f_ref = stencil.stencil_sweep_reference(up, op.table, *flags)
    torch.cuda.synchronize()
    err = float((f - f_ref).abs().max())
    assert err <= RTOL[dtype] * float(f_ref.abs().max())


def test_kernel_refuses_bad_input():
    _need_cuda()
    op = stencil.build_stencil_operator(meshgen.hex_beam(3, 3, 3),
                                        dtype=torch.float32, device="cuda")
    up = torch.zeros((3, 6, 6, 6), device="cuda")
    with pytest.raises(TypeError):
        stencil.stencil_sweep(up.half(), op.table.half(), 1, 1)
    with pytest.raises(ValueError):
        stencil.stencil_sweep(up.transpose(1, 2), op.table, 1, 1)
    with pytest.raises(ValueError):
        stencil.stencil_sweep(up, op.table[:26], 1, 1)


def test_cuda_solve_matches_cpu_float64():
    _need_cuda()
    m_gpu, m_cpu = meshgen.hex_beam(8, 5, 4), meshgen.hex_beam(8, 5, 4)
    before = stencil.launches
    res = solve_linear_statics(m_gpu, device="cuda")
    ref = solve_linear_statics(m_cpu, device="cpu", dtype=torch.float64)
    assert res.operator == ref.operator == "stencil"
    assert res.converged and res.true_residual <= 1e-6
    assert stencil.launches - before >= res.iters
    scale = np.abs(ref.u).max()
    np.testing.assert_allclose(res.u_certified, ref.u, atol=1e-5 * scale)
    assert np.isfinite(res.stress).all() and np.isfinite(res.reactions).all()
