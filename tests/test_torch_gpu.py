"""Tests of the port's CUDA kernels and CUDA paths; they need a card.

They skip where torch sees no CUDA device. This file imports no jax and
nothing of stan_tpu, so it also runs where jax is not installed, without
the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from stan_tpu_torch.core import meshgen
from stan_tpu_torch.analysis.linear import solve_linear_statics
from stan_tpu_torch.fem import stencil

pytestmark = pytest.mark.gpu

# The kernel and the plain version sum the same products in other orders.
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")


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


def _theta_case(n, kw, dtype, B, seed, sx=None):
    """Unit tables of hex_beam(*n, **kw), random slabs of B chains (of sx
    x-planes if given) with random ghosts, and random coefficients."""
    from stan_tpu_torch.fem import structured

    base = structured.build_structured_operator(
        meshgen.hex_beam(*n, **kw), dtype=torch.float64, device="cuda")
    t2 = stencil.pack_theta_tables(
        stencil.signature_tables(base.ke_lam.cpu().numpy()),
        stencil.signature_tables(base.ke_mu.cpu().numpy()), dtype, "cuda")
    shape = base.node_shape if sx is None else (sx, *base.node_shape[1:])
    rng = np.random.default_rng(seed)
    up = torch.as_tensor(rng.standard_normal(
        (B, 3, *(k + 2 for k in shape))), dtype=dtype, device="cuda")
    coef = torch.as_tensor(np.stack([rng.uniform(5e4, 2e5, B),
                                     rng.uniform(3e4, 1e5, B)], axis=1),
                           dtype=dtype, device="cuda")
    return up, t2, coef


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("flags", [(1, 1), (0, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("n,kw", [((4, 4, 3), {}),
                                  ((5, 4, 3), {"lx": 6.0, "ly": 1.5,
                                               "lz": 3.0})])
def test_theta_kernels_match_plain_version(n, kw, flags, dtype):
    _need_cuda()
    up, t2, coef = _theta_case(n, kw, dtype, 3, sum(n))
    before = (stencil.theta_launches, stencil.theta_batched_launches)
    f_b = stencil.theta_sweep_batched(up, t2, coef, *flags)
    f_1 = stencil.theta_sweep(up[1], t2, coef[1], *flags)
    assert (stencil.theta_launches, stencil.theta_batched_launches) == (
        before[0] + 1, before[1] + 1)
    ref = stencil.theta_sweep_reference(up, t2, coef, *flags)
    torch.cuda.synchronize()
    for b in range(3):
        assert float((f_b[b] - ref[b]).abs().max()) <= RTOL[dtype] * float(
            ref[b].abs().max())
    assert float((f_1 - ref[1]).abs().max()) <= RTOL[dtype] * float(
        ref[1].abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("flags", [(1, 1), (0, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("n,sx", [((32, 32, 32), None), ((32, 32, 32), 1),
                                  ((6, 9, 140), None), ((13, 5, 37), 1)])
def test_theta_kernel_tiling(n, sx, B, flags, dtype):
    """Shapes that stress the kernel's tiles: the calibration grid (35 y and
    z nodes, which no tile width divides), one x-plane (every plane a face),
    z over two tiles (141 nodes), one chain and sixteen."""
    _need_cuda()
    up, t2, coef = _theta_case(n, {}, dtype, B, sum(n) + B, sx)
    f = (stencil.theta_sweep(up[0], t2, coef[0], *flags)[None] if B == 1
         else stencil.theta_sweep_batched(up, t2, coef, *flags))
    ref = stencil.theta_sweep_reference(up, t2, coef, *flags)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(f).all())
    assert float((f - ref).abs().max()) <= RTOL[dtype] * float(
        ref.abs().max())


def test_theta_kernels_refuse_bad_input():
    _need_cuda()
    up, t2, coef = _theta_case((3, 3, 3), {}, torch.float32, 2, 0)
    with pytest.raises(TypeError):
        stencil.theta_sweep_batched(up, t2, coef.double(), 1, 1)
    with pytest.raises(ValueError):
        stencil.theta_sweep_batched(up.transpose(3, 4), t2, coef, 1, 1)
    with pytest.raises(ValueError):
        stencil.theta_sweep_batched(up, t2[:1], coef, 1, 1)
    with pytest.raises(ValueError):
        stencil.theta_sweep_batched(up, t2, coef[:1], 1, 1)
    with pytest.raises(ValueError):
        stencil.theta_sweep(up[0], t2, coef[0].cpu(), 1, 1)


def test_chain_batched_solve_matches_cpu_float64():
    """16 chains solved at once on the card (float32, tol 1e-6) against the
    CPU float64 solve of the same θ (tol 1e-10), to 1e-4 of max|u|: the
    float32 solve stops at a relative residual of 1e-6, which the grid's
    conditioning turns into an error of about 1e-5 of max|u|."""
    _need_cuda()
    from stan_tpu_torch.infer import forward

    m = meshgen.hex_beam(8, 5, 4)
    rng = np.random.default_rng(3)
    thetas = np.stack([np.log(190000.0) + 0.2 * rng.standard_normal(16),
                       0.28 + 0.05 * rng.standard_normal(16),
                       0.1 * rng.standard_normal(16)], axis=1)
    gpu = forward.build_forward(m, device="cuda", cg_tol=1e-6)
    cpu = forward.build_forward(m, dtype=torch.float64, device="cpu",
                                cg_tol=1e-10)
    before = stencil.theta_batched_launches
    u = forward.displacement_fn(gpu, m.nelem)(
        torch.as_tensor(thetas, device="cuda")).cpu().numpy()
    ref = forward.displacement_fn(cpu, m.nelem)(
        torch.as_tensor(thetas)).numpy()
    st = gpu.stats
    assert st.forward_solves == 16 and st.forward_unconverged == 0
    assert stencil.theta_batched_launches - before >= st.forward_loop_iters
    for c in range(16):
        assert np.abs(u[c] - ref[c]).max() <= 1e-4 * np.abs(ref[c]).max()
