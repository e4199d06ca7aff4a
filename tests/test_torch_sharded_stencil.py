"""Port parity: the x-slab sharded stencil (parallel/sharded_stencil.py)
against stan_tpu, in float64 on the CPU, on meshes of ["cpu"] * n.

The JAX shard_map stencil path reaches the Pallas kernel in interpret mode
(its own tests are slow), so the JAX side here is the reference's plain
forms: _stencil_apply_jnp for the masked apply of the whole grid, and
slab_theta_apply for one slab with ghost planes and face flags. The
sharded CG and the chains x domain CG are held to the port's
single-device solves (the reference's own tests hold them to its
single-device solves the same way).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.fem import stencil as jstencil
from stan_tpu.fem import structured as jstructured
from stan_tpu_torch import convert
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.fem import stencil
from stan_tpu_torch.parallel import distributed
from stan_tpu_torch.parallel import sharded_stencil as ss
from stan_tpu_torch.solvers import cg

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n_domain, n_chains=1):
    return distributed.device_mesh(n_chains, n_domain,
                                   devices=["cpu"] * (n_chains * n_domain))


@functools.lru_cache(maxsize=None)
def _reference_apply():
    """hex_beam(7, 4, 3) (NNX = 8, which 1, 2, 4 and 8 divide): the JAX
    stencil operator, a random u and the masked apply by the plain form."""
    jop = jstencil.build_stencil_operator(jmeshgen.hex_beam(7, 4, 3))
    u = np.random.default_rng(0).standard_normal((3,) + jop.node_shape)
    m = np.asarray(jop.free_mask)
    k = jstencil._stencil_apply_jnp(jop.tables, jop.deltas,
                                    jnp.asarray(m * u))
    return jop, u, m * np.asarray(k) + (1.0 - m) * u


@pytest.mark.parametrize("how", ["build", "convert"])
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_sharded_apply_matches_plain_reference(ndev, how):
    jop, u, f_ref = _reference_apply()
    if how == "build":
        op = ss.build_sharded_stencil_operator(meshgen.hex_beam(7, 4, 3),
                                               ndev, dtype=F64, device="cpu")
    else:
        op = convert.sharded_stencil_operator_from_numpy(
            np.asarray(jop.free_mask), np.asarray(jop.diagonal()),
            jop.tables, ndev, device="cpu")
    assert op is not None and op.ndev == ndev
    f = ss.sharded_apply(_mesh(ndev), op, torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(f, f_ref, atol=1e-12 * np.abs(f_ref).max())


@functools.lru_cache(maxsize=None)
def _unit_tables():
    """JAX's unit-λ and unit-μ tables of hex_beam(7, 4, 3), with their slab
    corrections."""
    base = jstructured.build_structured_operator(jmeshgen.hex_beam(7, 4, 3))
    tl = jstencil.signature_tables(np.asarray(base.ke_lam, np.float64))
    tm = jstencil.signature_tables(np.asarray(base.ke_mu, np.float64))
    return (tl, tm, jstencil.slab_correction_tables(tl),
            jstencil.slab_correction_tables(tm), base.node_shape)


COEF = np.array([[1.234, 0.789], [2.5e5, 8.1e4]])


@functools.lru_cache(maxsize=None)
def _slab_references(ndev):
    """For the slabs of n that differ in their flags (the first, the second
    and the last): (s, flags, two chains' u_ext with random ghost planes,
    also on the global faces where the flags must ignore them, and the
    reference's slab_theta_apply of each chain with its COEF row)."""
    tl, tm, cl, cm, node_shape = _unit_tables()
    rng = np.random.default_rng(ndev)
    sx = node_shape[0] // ndev
    out = []
    for s in sorted({0, min(1, ndev - 1), ndev - 1}):
        lo, hi = int(s == 0), int(s == ndev - 1)
        u_ext = rng.standard_normal((2, 3, sx + 2) + node_shape[1:])
        refs = [np.asarray(jstencil.slab_theta_apply(
            tl, tm, cl, cm, COEF[c, 0], COEF[c, 1], jnp.asarray(u_ext[c]),
            lo, hi)) for c in range(2)]
        out.append((lo, hi, u_ext, refs))
    return out


@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_slab_theta_sweep_matches_slab_theta_apply(ndev, chains):
    """The theta sweep with each slab's flags (B = 1 and B = 2 chains)
    against the reference's slab_theta_apply, per chain."""
    tl, tm = _unit_tables()[:2]
    t2 = stencil.pack_theta_tables(tl, tm, F64, "cpu")
    for lo, hi, u_ext, refs in _slab_references(ndev):
        up = F.pad(torch.as_tensor(u_ext[:chains]), (1, 1, 1, 1)).contiguous()
        got = stencil.theta_apply_padded(t2, torch.as_tensor(COEF[:chains]),
                                         up, lo, hi).numpy()
        for c in range(chains):
            np.testing.assert_allclose(got[c], refs[c],
                                       atol=1e-12 * np.abs(refs[c]).max())


def test_halo_pad_exchanges_masked_planes():
    """Each slab's buffer: its masked nodes, zero y/z ghosts, its
    neighbours' masked boundary planes as x ghosts, zeros at the ends."""
    rng = np.random.default_rng(3)
    u = torch.as_tensor(rng.standard_normal((2, 3, 6, 4, 5)))
    m = torch.as_tensor((rng.random((3, 6, 4, 5)) > 0.3).astype(float))
    masks, us = list(m.tensor_split(3, dim=1)), list(u.tensor_split(3, dim=2))
    mesh = distributed.device_mesh(1, 3, devices=["cpu"] * 3)
    ups = ss.halo_pad_rows(mesh, [masks], [us])[0]
    whole = F.pad(m * u, (1, 1, 1, 1, 1, 1))
    for s, up in enumerate(ups):
        assert up.shape == (2, 3, 4, 6, 7)
        torch.testing.assert_close(up, whole[:, :, 2 * s:2 * s + 4],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_stencil_cg_matches_single(ndev):
    m = meshgen.hex_beam(7, 3, 3)
    sop = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    op = ss.build_sharded_stencil_operator(m, ndev, dtype=F64, device="cpu")
    f = sop.to_grid(torch.as_tensor(m.load_vector()))
    ref = cg.pcg(sop.apply, sop.free_mask * f, diag=sop.diagonal(),
                 tol=1e-12, ndof=3 * m.nnode)
    res = ss.sharded_stencil_pcg(_mesh(ndev), op, f, tol=1e-12)
    assert res.converged and not res.diverged
    assert abs(res.iters - ref.iters) <= 2
    scale = float(ref.u.abs().max())
    torch.testing.assert_close(res.u, ref.u, rtol=1e-8, atol=1e-10 * scale)


def test_sharded_stencil_cg_deterministic():
    m = meshgen.hex_beam(7, 3, 3)
    op = ss.build_sharded_stencil_operator(m, 4, dtype=F64, device="cpu")
    f = torch.as_tensor(m.load_vector()).reshape(8, 4, 4, 3).permute(
        3, 0, 1, 2).contiguous()
    u1 = ss.sharded_stencil_pcg(_mesh(4), op, f, tol=1e-10).u
    u2 = ss.sharded_stencil_pcg(_mesh(4), op, f, tol=1e-10).u
    assert torch.equal(u1, u2)


def test_indivisible_nnx_returns_none():
    m = meshgen.hex_beam(6, 3, 3)  # NNX = 7, not divisible by 2
    assert ss.build_sharded_stencil_operator(m, 2, device="cpu") is None
    assert ss.build_sharded_stencil_operator(m, 7, device="cpu") is not None


def test_nonqualifying_mesh_returns_none():
    m = meshgen.hex_beam(1, 1, 1)  # too small for the stencil itself
    assert ss.build_sharded_stencil_operator(m, 1, device="cpu") is None


def test_chain_batched_pcg_unequal_iters_2x4():
    """On a 2 x 4 (chains x domain) mesh, the two chain rows converge in
    different iteration counts: every chain's count and solution are its
    own solve's (the frozen chains of the one batched loop stay frozen)."""
    m = meshgen.hex_beam(7, 2, 2)
    sop = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    op = ss.build_sharded_stencil_operator(m, 4, dtype=F64, device="cpu")
    f0 = sop.to_grid(torch.as_tensor(m.load_vector()))
    rough = torch.as_tensor(np.random.default_rng(7).standard_normal(
        f0.shape))
    f_chains = torch.stack([f0, 1.3 * f0, f0 + rough, f0 - 0.7 * rough])
    res = ss.chain_batched_pcg(_mesh(4, 2), op, f_chains, tol=1e-8,
                               maxiter=400)
    assert res.converged.all() and res.u.shape == (4, 3) + sop.node_shape
    assert res.iters[:2].max() != res.iters[2:].max(), res.iters
    for c in range(4):
        ref = cg.pcg(sop.apply, sop.free_mask * f_chains[c],
                     diag=sop.diagonal(), tol=1e-8, maxiter=400)
        scale = float(ref.u.abs().max())
        torch.testing.assert_close(res.u[c], ref.u, rtol=1e-8,
                                   atol=1e-10 * scale)
        assert abs(int(res.iters[c]) - ref.iters) <= 2, (c, res.iters)


def test_chain_batched_pcg_shared_f_scales():
    """Shared f with per-chain scales on a 4 x 2 mesh: u_c = s_c u_1."""
    m = meshgen.hex_beam(3, 3, 3)
    sop = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    op = ss.build_sharded_stencil_operator(m, 2, dtype=F64, device="cpu")
    f0 = sop.to_grid(torch.as_tensor(m.load_vector()))
    scales = torch.tensor([0.5, 1.0, 2.0, -1.0], dtype=F64)
    res = ss.chain_batched_pcg(_mesh(2, 4), op, f0, scales=scales,
                               tol=1e-11)
    assert res.converged.all()
    base = res.u[1]
    for c, s in enumerate(scales.tolist()):
        torch.testing.assert_close(res.u[c], s * base, rtol=1e-6,
                                   atol=1e-9 * float(base.abs().max()))


def test_chain_batched_pcg_refusals():
    m = meshgen.hex_beam(3, 3, 3)
    op = ss.build_sharded_stencil_operator(m, 2, dtype=F64, device="cpu")
    f0 = op.free_mask.clone()
    with pytest.raises(ValueError, match="scales"):
        ss.chain_batched_pcg(_mesh(2), op, f0)
    with pytest.raises(ValueError, match="divide"):
        ss.chain_batched_pcg(_mesh(2, 2), op, f0, scales=torch.ones(3))
    with pytest.raises(ValueError, match="slabs"):
        ss.sharded_apply(_mesh(4), op, f0)
