"""Port parity: the stencil tables, the sweep's plain version and the masked
stencil operator of stan_tpu_torch against stan_tpu, in float64 on the CPU.

The JAX stencil operator's apply_raw runs Pallas in interpret mode on the
CPU (minutes), so the JAX side here is its plain twins
(_stencil_apply_jnp, apply_numpy) and the structured operator; the one
comparison against the Pallas kernel itself is marked slow.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from stan_tpu.core import meshgen
from stan_tpu.core.model import Material
from stan_tpu.fem import stencil as jstencil
from stan_tpu.fem import structured as jstructured
from stan_tpu_torch.fem import stencil

# (nelems, hex_beam keywords): G2 and G1, unit and non-uniform spacing.
MESHES = [
    ((4, 4, 3), {}),
    ((3, 3, 4), {"elem_type": "HEX8_G1"}),
    ((4, 2, 2), {"lx": 6.0, "ly": 1.5, "lz": 3.0}),
    ((5, 4, 3), {"lx": 6.0, "ly": 1.5, "lz": 3.0}),
]
IDS = ["4x4x3-G2", "3x3x4-G1", "4x2x2-nonuniform", "5x4x3-nonuniform"]
F64 = torch.float64


def _pair(n, kw):
    m = meshgen.hex_beam(*n, **kw)
    jop = jstencil.build_stencil_operator(m)
    op = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    assert jop is not None and op is not None
    return m, jop, op


def _rand_grid(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("n,kw", MESHES, ids=IDS)
def test_tables_equal_reference(n, kw):
    m, jop, op = _pair(n, kw)
    lam = float(np.asarray(jop.base.lam_e).flat[0])
    mu = float(np.asarray(jop.base.mu_e).flat[0])
    ke = (np.asarray(jop.base.ke_lam) * lam + np.asarray(jop.base.ke_mu) * mu)
    mine, ref = stencil.signature_tables(ke), jstencil.signature_tables(ke)
    assert mine.keys() == ref.keys()
    for sig in ref:
        assert mine[sig].keys() == ref[sig].keys()
        for off in ref[sig]:
            np.testing.assert_array_equal(mine[sig][off], ref[sig][off])
    deltas, jdeltas = stencil.delta_tables(mine), jstencil.delta_tables(ref)
    assert deltas.keys() == jdeltas.keys()
    for sig in jdeltas:
        assert deltas[sig].keys() == jdeltas[sig].keys()
        for off in jdeltas[sig]:
            np.testing.assert_array_equal(deltas[sig][off], jdeltas[sig][off])
    # The port's own build (float64 ke from fem.hostops) agrees to roundoff.
    scale = np.abs(ke).max()
    for sig in ref:
        for off in set(ref[sig]) | set(op.tables[sig]):
            np.testing.assert_allclose(
                op.tables[sig].get(off, 0.0), ref[sig].get(off, 0.0),
                rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("n,kw", MESHES, ids=IDS)
def test_sweep_reference_matches_jax(n, kw):
    m, jop, op = _pair(n, kw)
    u = _rand_grid((3,) + op.node_shape, seed=sum(n))
    table = stencil.pack_tables(jop.tables, F64, "cpu")
    up = F.pad(torch.as_tensor(u), (1, 1, 1, 1, 1, 1))
    f = stencil.stencil_sweep_reference(up, table, 1, 1).numpy()
    f_jnp = np.asarray(jstencil._stencil_apply_jnp(jop.tables, jop.deltas,
                                                   jnp.asarray(u)))
    f_np = jstencil.apply_numpy(jop.tables, jop.deltas, u)
    scale = np.abs(f_np).max()
    np.testing.assert_allclose(f, f_jnp, rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(f, f_np, rtol=0, atol=1e-12 * scale)


def test_sweep_on_cpu_takes_plain_version():
    _, _, op = _pair(*MESHES[0])
    up = F.pad(torch.as_tensor(_rand_grid((3,) + op.node_shape, 7)),
               (1, 1, 1, 1, 1, 1))
    before = stencil.launches
    for lo, hi in ((1, 1), (0, 1), (1, 0), (0, 0)):
        assert torch.equal(stencil.stencil_sweep(up, op.table, lo, hi),
                           stencil.stencil_sweep_reference(up, op.table, lo, hi))
    assert stencil.launches == before


@pytest.mark.parametrize("n,kw", MESHES[2:], ids=IDS[2:])
def test_sweep_flags_compose_slabs(n, kw):
    """Three x-slabs with flags (1,0), (0,0), (0,1), each with its
    neighbours' boundary planes in its x ghosts, give the whole-grid sweep
    (the contract the later multi-GPU slab path relies on)."""
    _, _, op = _pair(n, kw)
    u = torch.as_tensor(_rand_grid((3,) + op.node_shape, 11))
    up = F.pad(u, (1, 1, 1, 1, 1, 1))
    whole = stencil.stencil_sweep_reference(up, op.table, 1, 1)
    nnx = op.node_shape[0]
    cuts = [0, 2, nnx - 2, nnx]
    parts = []
    for s, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        slab = up[:, a:b + 2]  # nodes [a, b) plus one ghost plane each side
        parts.append(stencil.stencil_sweep_reference(
            slab.contiguous(), op.table, int(s == 0), int(s == 2)))
    got = torch.cat(parts, dim=1)
    scale = float(whole.abs().max())
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                               atol=1e-12 * scale)


@pytest.mark.parametrize("n,kw", MESHES, ids=IDS)
def test_masked_operator_matches_structured(n, kw):
    m, jop, op = _pair(n, kw)
    jbase = jop.base
    u = _rand_grid((3,) + op.node_shape, seed=3)
    want = np.asarray(jbase.apply(jnp.asarray(u)))
    got = op.apply(torch.as_tensor(u)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)
    want_raw = np.asarray(jbase.apply_raw(jnp.asarray(u)))
    got_raw = op.apply_raw(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got_raw, want_raw, rtol=0,
                               atol=1e-12 * np.abs(want_raw).max())
    dwant = np.asarray(jbase.diagonal())
    np.testing.assert_allclose(op.diagonal().numpy(), dwant, rtol=1e-12,
                               atol=1e-12 * np.abs(dwant).max())
    flat = _rand_grid((m.nnode, 3), seed=4)
    np.testing.assert_array_equal(
        op.to_flat(op.to_grid(torch.as_tensor(flat))).numpy(), flat)
    np.testing.assert_array_equal(
        op.to_grid(torch.as_tensor(flat)).numpy(),
        np.asarray(jbase.to_grid(jnp.asarray(flat))))


def test_build_refuses_what_the_reference_refuses():
    hetero = meshgen.hex_beam(3, 2, 2)
    hetero.materials[2] = Material(id=2, name="soft", E=1000.0, poisson=0.4)
    hetero.elem_mat = hetero.elem_mat.copy()
    hetero.elem_mat[0] = 2
    perturbed = meshgen.hex_beam(3, 3, 3)
    perturbed.coords = perturbed.coords.copy()
    perturbed.coords[5, 0] += 0.01
    for m in (hetero, meshgen.hex_beam(1, 1, 1), meshgen.hex_beam(4, 1, 3),
              perturbed):
        assert jstencil.build_stencil_operator(m) is None
        assert stencil.build_stencil_operator(m, dtype=F64,
                                              device="cpu") is None
    assert jstructured.build_structured_operator(hetero) is not None


def test_pack_tables_layout_and_empty_refusal():
    _, jop, op = _pair(*MESHES[0])
    packed = stencil.pack_tables(jop.tables, F64, "cpu")
    assert packed.shape == (27, 27, 3, 3) and packed.dtype == F64
    for s, sig in enumerate(stencil._SIGS):
        for o, off in enumerate(stencil._OFFSETS):
            want = jop.tables[sig].get(off, np.zeros((3, 3)))
            np.testing.assert_array_equal(packed[s, o].numpy(), want)
    broken = dict(jop.tables)
    broken[("L", "F", "H")] = {}
    with pytest.raises(ValueError, match="empty"):
        stencil.pack_tables(broken, F64, "cpu")


@pytest.mark.slow
def test_sweep_flags_match_pallas_kernel():
    """The plain version against the Pallas kernel itself (interpret mode)
    for the flags the single-device path never passes."""
    _, jop, op = _pair((3, 3, 3), {})
    up = F.pad(torch.as_tensor(_rand_grid((3,) + op.node_shape, 5)),
               (1, 1, 1, 1, 1, 1))
    for lo, hi in ((0, 0), (0, 1), (1, 0)):
        want = np.asarray(jstencil.fused_sweep(jop.tables,
                                               jnp.asarray(up.numpy()), lo, hi))
        got = stencil.stencil_sweep_reference(up, op.table, lo, hi).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
