"""Port parity: the theta sweeps (λ·K_λu + μ·K_μu) of stan_tpu_torch against
stan_tpu, in float64 on the CPU.

theta_sweep_reference (the plain version every CPU tensor takes) is held
against the Pallas kernels fused_sweep_theta and fused_sweep_theta_batched
themselves, run in interpret mode on the CPU (jitted with the flags traced,
so each kernel compiles once per module). The sweep's cotangents, as the
stencil forward's backward forms them (theta_apply, theta_coef_grads), are
held against jax.vjp of stan_tpu.fem.stencil.theta_sweep, and that
solve's gradient against torch.autograd.gradcheck. Tolerance of the
sweeps: 1e-12·max|f| (the two sides sum the same products in other
orders).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from stan_tpu.core import meshgen
from stan_tpu.fem import stencil as jstencil
from stan_tpu.fem import structured as jstructured
from stan_tpu_torch.fem import launches, stencil
from stan_tpu_torch.infer import forward

F64 = torch.float64
FLAGS = [(1, 1), (0, 1), (1, 0), (0, 0)]
LAMS = np.array([1.1e5, 2.3e5, 0.7e5])
MUS = np.array([7.9e4, 0.4e5, 1.6e5])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: intra-op threads only add contention with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _odd_grid():
    """hex_beam(5,4,3, lx=6, ly=1.5, lz=3): the JAX unit tables, the port's
    packed pair, and the padded node shape."""
    m = meshgen.hex_beam(5, 4, 3, lx=6.0, ly=1.5, lz=3.0)
    base = jstructured.build_structured_operator(m)
    tl = jstencil.signature_tables(np.asarray(base.ke_lam))
    tm = jstencil.signature_tables(np.asarray(base.ke_mu))
    t2 = stencil.pack_theta_tables(tl, tm, F64, "cpu")
    return tl, tm, t2, tuple(n + 2 for n in base.node_shape)


@functools.lru_cache(maxsize=None)
def _pallas(batched: bool):
    """The Pallas kernel (interpret mode on the CPU) with BX=2, so the
    5-node x axis spans three x-blocks; jitted with the flags traced."""
    tl, tm, _, _ = _odd_grid()
    fn = (jstencil.fused_sweep_theta_batched if batched
          else jstencil.fused_sweep_theta)
    return jax.jit(lambda lam, mu, up, lo, hi: fn(tl, tm, lam, mu, up, lo,
                                                  hi, BX=2))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("flags", FLAGS)
def test_theta_sweep_matches_pallas_kernel(flags):
    _, _, t2, padded = _odd_grid()
    up = _rand((3,) + padded, seed=1)
    want = np.asarray(_pallas(False)(LAMS[0], MUS[0], jnp.asarray(up),
                                     *flags))
    coef = torch.tensor([LAMS[0], MUS[0]], dtype=F64)
    got = stencil.theta_sweep(torch.as_tensor(up), t2, coef, *flags)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("flags", FLAGS)
def test_theta_sweep_batched_matches_pallas_kernel(flags):
    _, _, t2, padded = _odd_grid()
    up = _rand((3, 3) + padded, seed=2)
    want = np.asarray(_pallas(True)(jnp.asarray(LAMS), jnp.asarray(MUS),
                                    jnp.asarray(up), *flags))
    coef = torch.as_tensor(np.stack([LAMS, MUS], axis=1))
    got = stencil.theta_sweep_batched(torch.as_tensor(up), t2, coef, *flags)
    for b in range(3):  # distinct coefficients per chain, each to its own max
        np.testing.assert_allclose(got[b].numpy(), want[b], rtol=0,
                                   atol=1e-12 * np.abs(want[b]).max())


def test_theta_sweep_equals_combined_table_sweep():
    """One pass with coefficients (λ, μ) is the fixed-table sweep with
    the tables of ke = λ·ke_λ + μ·ke_μ."""
    tl, tm, t2, padded = _odd_grid()
    up = torch.as_tensor(_rand((3,) + padded, seed=3))
    for lam, mu in zip(LAMS, MUS):
        tables = {sig: {off: lam * tl[sig].get(off, 0.0)
                        + mu * tm[sig].get(off, 0.0)
                        for off in set(tl[sig]) | set(tm[sig])}
                  for sig in tl}
        table = stencil.pack_tables(tables, F64, "cpu")
        for flags in FLAGS:
            want = stencil.stencil_sweep_reference(up, table, *flags)
            got = stencil.theta_sweep(up, t2, torch.tensor([lam, mu],
                                                           dtype=F64), *flags)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-12 * float(want.abs().max()))


def test_cpu_tensors_take_plain_version_uncounted():
    _, _, t2, padded = _odd_grid()
    up = torch.as_tensor(_rand((3, 3) + padded, seed=4))
    coef = torch.as_tensor(np.stack([LAMS, MUS], axis=1))
    before = launches.snapshot()
    assert torch.equal(stencil.theta_sweep_batched(up, t2, coef, 1, 1),
                       stencil.theta_sweep_reference(up, t2, coef, 1, 1))
    assert torch.equal(
        stencil.theta_sweep(up[1], t2, coef[1], 0, 1),
        stencil.theta_sweep_reference(up[1:2], t2, coef[1:2], 0, 1)[0])
    assert launches.snapshot() == before


def test_pack_theta_tables_layout_and_shape_refusals():
    tl, tm, t2, padded = _odd_grid()
    assert t2.shape == (2, 27, 27, 3, 3) and t2.dtype == F64
    assert torch.equal(t2[0], stencil.pack_tables(tl, F64, "cpu"))
    assert torch.equal(t2[1], stencil.pack_tables(tm, F64, "cpu"))
    up = torch.zeros((3,) + padded, dtype=F64)
    with pytest.raises(ValueError):
        stencil.theta_sweep(up[None], t2, torch.ones(2, dtype=F64), 1, 1)
    with pytest.raises(ValueError):
        stencil.theta_sweep_batched(up, t2, torch.ones(1, 2, dtype=F64), 1, 1)


@functools.lru_cache(maxsize=None)
def _grid_tables(n=(4, 3, 3)):
    m = meshgen.hex_beam(*n)
    base = jstructured.build_structured_operator(m)
    tl = jstencil.signature_tables(np.asarray(base.ke_lam))
    tm = jstencil.signature_tables(np.asarray(base.ke_mu))
    return (jstencil._freeze_tables(tl), jstencil._freeze_tables(tm),
            stencil.pack_theta_tables(tl, tm, F64, "cpu"), base.node_shape)


@pytest.mark.parametrize("batched", [False, True], ids=["one", "chains"])
def test_theta_grads_match_jax_vjp(batched):
    """The sweep's (λ, μ, u) cotangents as the solve's backward forms them,
    against jax.vjp of the reference primitive (its transpose rules), on a
    random cotangent: the cotangent of u is the same sweep of ct (the
    operator is self-adjoint), those of λ and μ are theta_coef_grads."""
    fl, fm, t2, shape = _grid_tables()
    B = 3 if batched else 1
    u = _rand((B, 3) + shape, seed=5)
    ct = _rand((B, 3) + shape, seed=6)
    lam, mu = LAMS[:B] / 1e5, MUS[:B] / 1e5

    @jax.jit
    def sweep_vjp(a, b, x, c):
        out, vjp = jax.vjp(
            lambda a, b, x: jstencil.theta_sweep(a, b, x, fl, fm), a, b, x)
        return (out,) + vjp(c)

    if batched:
        out, gl, gm, gu = sweep_vjp(lam, mu, u, ct)
    else:
        out, gl, gm, gu = (g[None] for g in sweep_vjp(lam[0], mu[0], u[0],
                                                       ct[0]))
    tl_, tm_, tu, tct = (torch.as_tensor(a) for a in (lam, mu, u, ct))
    f = stencil.theta_apply(t2, tl_, tm_, tu)
    g_u = stencil.theta_apply(t2, tl_, tm_, tct)
    g_lam, g_mu = stencil.theta_coef_grads(t2, tct, tu)
    scale = np.abs(np.asarray(out)).max()
    np.testing.assert_allclose(f.numpy(), np.asarray(out), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(g_u.numpy(), np.asarray(gu), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(gu)).max())
    np.testing.assert_allclose(g_lam.numpy(), np.asarray(gl), rtol=1e-12)
    np.testing.assert_allclose(g_mu.numpy(), np.asarray(gm), rtol=1e-12)


def test_theta_sweep_gradcheck():
    """Finite differences of the stencil forward's solve in float64
    (torch.autograd.gradcheck defaults: eps 1e-6, atol 1e-5, rtol 1e-3),
    whose backward takes the gradients in λ and μ from theta_coef_grads:
    two chains (theta_sweep_batched) and one (theta_sweep). The Jacobian in
    (λ, μ), with f fixed, is checked entry by entry; the one in f (a CG
    solve for each of its entries) along random directions (fast mode)."""
    fwd = forward.build_forward(meshgen.hex_beam(3, 2, 2), dtype=F64,
                                device="cpu", cg_tol=1e-14, cg_maxiter=500)
    assert isinstance(fwd, forward.StencilForwardProblem)
    f = torch.as_tensor(_rand((2, 3) + fwd.node_shape, seed=7), dtype=F64)
    lam = torch.tensor([1.2, 0.8], dtype=F64, requires_grad=True)
    mu = torch.tensor([0.6, 1.1], dtype=F64, requires_grad=True)
    for b in (2, 1):
        lm = (lam[:b].detach().requires_grad_(),
              mu[:b].detach().requires_grad_())
        assert torch.autograd.gradcheck(
            lambda a, m: fwd.solve(a, m, f[:b]), lm)
    assert torch.autograd.gradcheck(
        lambda g: fwd.solve(lam.detach(), mu.detach(), g),
        (f.clone().requires_grad_(),), fast_mode=True)


def test_theta_sweep_slabs_compose():
    """Three x-slabs with flags (1,0), (0,0), (0,1), each with its
    neighbours' planes in its x ghosts, give the whole-grid batched sweep
    (the contract of a later multi-GPU slab path)."""
    _, _, t2, padded = _odd_grid()
    up = torch.as_tensor(_rand((3, 3) + padded, seed=8))
    up = F.pad(up[:, :, 1:-1, 1:-1, 1:-1], (1, 1, 1, 1, 1, 1))
    coef = torch.as_tensor(np.stack([LAMS, MUS], axis=1))
    whole = stencil.theta_sweep_batched(up, t2, coef, 1, 1)
    nnx = padded[0] - 2
    cuts = [0, 2, nnx - 2, nnx]
    parts = [stencil.theta_sweep_batched(up[:, :, a:b + 2].contiguous(), t2,
                                         coef, int(s == 0), int(s == 2))
             for s, (a, b) in enumerate(zip(cuts[:-1], cuts[1:]))]
    np.testing.assert_allclose(torch.cat(parts, dim=2).numpy(), whole.numpy(),
                               rtol=0, atol=1e-12 * float(whole.abs().max()))
