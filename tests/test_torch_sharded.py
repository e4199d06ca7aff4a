"""Port parity: the device mesh (parallel/distributed.py), the domain
partition and the general sharded operator (parallel/sharded.py), and
solve_linear_statics' sharded routes, against stan_tpu in float64 on the
CPU. The port's meshes are ["cpu"] * n; the JAX side runs on the
8-device virtual CPU mesh of tests/conftest.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from stan_tpu.analysis import linear as jlinear
from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.parallel import partition as jpartition
from stan_tpu.parallel import sharded as jsharded
from stan_tpu_torch import convert
from stan_tpu_torch.analysis.linear import solve_linear_statics
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.parallel import distributed, partition, sharded

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n_domain, n_chains=1):
    return distributed.device_mesh(n_chains, n_domain,
                                   devices=["cpu"] * (n_chains * n_domain))


# ------------------------------------------------------------------ mesh

def test_device_mesh_layout_and_refusals():
    mesh = distributed.device_mesh(2, 3, devices=["cpu"] * 8)
    assert mesh.shape == {"chains": 2, "domain": 3}
    assert mesh.axis_names == ("chains", "domain")
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert distributed.device_mesh(2, devices=["cpu"] * 8).shape == {
        "chains": 2, "domain": 4}
    assert "chains=2 x domain=3 on 6 cpu device(s) (1 distinct)" in \
        distributed.describe(mesh)
    with pytest.raises(ValueError, match="needs 8 devices"):
        distributed.device_mesh(2, 4, devices=["cpu"] * 6)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.device_mesh(4, devices=["cpu"] * 6)


def test_mixed_type_mesh_raises():
    """A mesh whose devices are not of one type is refused (no card is
    needed to name one)."""
    with pytest.raises(ValueError, match="one type"):
        distributed.device_mesh(1, 2, devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="one type"):
        distributed.DeviceMesh([["cpu"], ["cuda:0"]])


def test_initialize_is_single_process(monkeypatch):
    """One process is a no-op (so callers may call it unconditionally);
    several need an init method, and are refused without one before
    anything is joined."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "STAN_TPU_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize()  # one process: nothing to do
    assert distributed.process_count() == 1
    with pytest.raises(ValueError, match="init method"):
        distributed.initialize(num_processes=4)
    assert distributed.process_count() == 1 and distributed.backend() is None


def test_slabs_split_gather_and_dot():
    """A vector cut over a 2 x 3 mesh: chains over the rows, x over the
    slabs; elementwise torch functions act block by block; dot reduces per
    chain in slab order."""
    mesh = _cpu_mesh(3, 2)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((4, 3, 6, 2, 2)))
    b = torch.as_tensor(rng.standard_normal((4, 3, 6, 2, 2)))
    sa, sb = mesh.split(a, 2, chains=True), mesh.split(b, 2, chains=True)
    assert sa.shape == a.shape and sa.parts[1][2].shape == (2, 3, 2, 2, 2)
    torch.testing.assert_close(sa.gather(), a, rtol=0, atol=0)
    s = torch.tensor([1.0, -2.0, 0.5, 3.0], dtype=F64)
    got = torch.where(s.view(4, 1, 1, 1, 1) > 0, s.view(4, 1, 1, 1, 1) * sa
                      + sb, torch.zeros_like(sb))
    want = torch.where(s.view(4, 1, 1, 1, 1) > 0, s.view(4, 1, 1, 1, 1) * a
                       + b, torch.zeros_like(b))
    torch.testing.assert_close(got.gather(), want, rtol=0, atol=0)
    torch.testing.assert_close(sa.dot(sb), (a * b).reshape(4, -1).sum(1),
                               rtol=1e-14, atol=0)
    one = _cpu_mesh(3)
    torch.testing.assert_close(one.split(a[0], 1).dot(one.split(b[0], 1)),
                               torch.sum(a[0] * b[0]), rtol=1e-14, atol=0)


# ---------------------------------------------------- partition, operator

@pytest.mark.parametrize("ndev", [2, 3, 4, 8])
def test_partition_equals_reference(ndev):
    m = meshgen.hex_beam(5, 3, 2)
    p = partition.partition(m.conn, m.nnode, ndev)
    j = jpartition.partition(m.conn, m.nnode, ndev)
    for name in ("perm", "inv_perm", "conn", "elem_owner", "elem_pos",
                 "pad_elem"):
        np.testing.assert_array_equal(getattr(p, name), getattr(j, name))
    assert (p.nnode_pad, p.block, p.epb) == (j.nnode_pad, j.block, j.epb)


@functools.lru_cache(maxsize=None)
def _pair(ndev, prefer_ring):
    """The port's and JAX's sharded operators of hex_beam(8, 2, 2)."""
    m = meshgen.hex_beam(8, 2, 2)
    args = (m.coords, m.conn, m.elem_d_matrices(), m.fix_mask(),
            m.formulation(), ndev)
    op, part = sharded.build_sharded_operator(
        *args, dtype=F64, prefer_ring=prefer_ring, device="cpu")
    jop, jpart = jsharded.build_sharded_operator(*args,
                                                 prefer_ring=prefer_ring)
    return m, op, part, jop, jpart


MODES = [(8, True), (8, False), (3, False)]
MODE_IDS = ["ring-8", "all-gather-8", "all-gather-3"]


@pytest.mark.parametrize("ndev,prefer_ring", MODES, ids=MODE_IDS)
def test_sharded_operator_arrays_equal_reference(ndev, prefer_ring):
    """The integer layout exactly; the float arrays to the last bits (the
    element geometry's contractions run in other orders)."""
    _, op, part, jop, _ = _pair(ndev, prefer_ring)
    assert op.ring == jop.ring == prefer_ring
    assert (op.nnode_pad, op.block) == (jop.nnode_pad, jop.block)
    for name in ("conn", "conn_ext", "inc_ext", "inc_idx"):
        mine, ref = getattr(op, name), getattr(jop, name)
        assert (mine is None) == (ref is None), name
        if ref is not None:
            np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(op.free_mask.numpy(),
                                  np.asarray(jop.free_mask))
    for name in ("dN", "detJw", "D", "diag"):
        ref = np.asarray(getattr(jop, name))
        np.testing.assert_allclose(getattr(op, name).numpy(), ref, rtol=0,
                                   atol=1e-14 * np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def _jax_solve(ndev, prefer_ring):
    m, _, part, jop, _ = _pair(ndev, prefer_ring)
    f = sharded.shard_rhs(part, m.load_vector())
    mesh = Mesh(np.array(jax.devices()[:ndev]), axis_names=("domain",))
    res = jsharded.sharded_pcg(mesh, jop, jnp.asarray(f), tol=1e-12)
    return f, np.asarray(res.u), int(res.iters)


@pytest.mark.parametrize("how", ["build", "convert"])
@pytest.mark.parametrize("ndev,prefer_ring", MODES, ids=MODE_IDS)
def test_sharded_pcg_matches_reference(ndev, prefer_ring, how):
    m, op, part, jop, _ = _pair(ndev, prefer_ring)
    if how == "convert":
        op = convert.sharded_operator_from_numpy(
            *(np.asarray(getattr(jop, k)) for k in
              ("conn", "dN", "detJw", "D", "free_mask", "diag")),
            jop.nnode_pad, jop.block, jop.form,
            inc_idx=jop.inc_idx, ring=jop.ring, conn_ext=jop.conn_ext,
            inc_ext=jop.inc_ext, device="cpu")
    f, u_ref, iters = _jax_solve(ndev, prefer_ring)
    res = sharded.sharded_pcg(_cpu_mesh(ndev), op, torch.as_tensor(f),
                              tol=1e-12)
    assert res.converged and abs(res.iters - iters) <= 2
    np.testing.assert_allclose(res.u.numpy(), u_ref,
                               atol=1e-10 * np.abs(u_ref).max())
    u = sharded.unshard_u(part, res.u.numpy())
    assert u.shape == (m.nnode, 3)


@pytest.mark.parametrize("ndev,prefer_ring", MODES, ids=MODE_IDS)
def test_sharded_apply_equals_single_device(ndev, prefer_ring):
    """The masked SpMV of either exchange mode is the general operator's in
    the new numbering, padding rows identity."""
    from stan_tpu_torch.fem.operator import build_operator

    m, op, part, _, _ = _pair(ndev, prefer_ring)
    u = torch.as_tensor(np.random.default_rng(ndev).standard_normal(
        (op.nnode_pad, 3)))
    got = sharded.sharded_apply(_cpu_mesh(ndev), op, u)
    gop = build_operator(m.coords, m.conn, m.elem_d_matrices(),
                         m.fix_mask(), m.formulation(), dtype=F64,
                         device="cpu")
    perm = torch.as_tensor(part.perm)
    want = gop.apply(u[perm])
    torch.testing.assert_close(got[perm], want, rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))
    pad = torch.ones(op.nnode_pad, dtype=torch.bool)
    pad[perm] = False
    torch.testing.assert_close(got[pad], u[pad], rtol=0, atol=0)


def test_sharded_solve_deterministic():
    _, op, part, _, _ = _pair(8, True)
    f = torch.as_tensor(sharded.shard_rhs(part, meshgen.hex_beam(
        8, 2, 2).load_vector()))
    u1 = sharded.sharded_pcg(_cpu_mesh(8), op, f, tol=1e-10).u
    u2 = sharded.sharded_pcg(_cpu_mesh(8), op, f, tol=1e-10).u
    assert torch.equal(u1, u2)


# --------------------------------------------------------------- routing

@functools.lru_cache(maxsize=None)
def _jax_linear():
    """JAX's single-device answer on hex_beam(7, 3, 3), from its general
    operator (its stencil path runs Pallas in interpret mode on the CPU,
    about a minute; the answer is the same system's)."""
    m = jmeshgen.hex_beam(7, 3, 3)
    m.analysis.lin_solver_tolerance = 1e-12
    return jlinear.solve_linear_statics(m, store=False, n_domain=1,
                                        use_structured=False)


@pytest.mark.parametrize("n_domain,want", [
    (2, "sharded-stencilx2"),
    (3, "sharded-generalx3"),  # NNX = 8: no cut into 3 slabs
], ids=["stencil", "general"])
def test_linear_statics_routes_sharded(n_domain, want):
    ref = _jax_linear()
    m = meshgen.hex_beam(7, 3, 3)
    m.analysis.lin_solver_tolerance = 1e-12
    res = solve_linear_statics(m, device="cpu", dtype=F64, n_domain=n_domain)
    assert res.operator == want and res.n_domain == n_domain
    assert res.converged and res.true_residual is None
    scale = np.abs(ref.u).max()
    np.testing.assert_allclose(res.u, ref.u, atol=1e-8 * scale)
    np.testing.assert_allclose(res.stress, ref.stress,
                               atol=1e-8 * np.abs(ref.stress).max())
    np.testing.assert_allclose(m.disp[1], res.u)


@pytest.mark.parametrize("n,n_domain,want", [
    ((7, 3, 3), 4, "sharded-stencilx4"),
    ((6, 3, 3), 2, "sharded-generalx2"),
], ids=["stencil", "general"])
def test_float32_sharded_solve_is_certified(n, n_domain, want):
    """Below float64 the sharded solve is certified on one device (the
    stencil twin, the general operator) to the configured tolerance."""
    m = meshgen.hex_beam(*n)
    res = solve_linear_statics(m, device="cpu", n_domain=n_domain,
                               store=False)
    assert res.operator == want and res.converged
    assert res.true_residual <= m.analysis.lin_solver_tolerance
    ref = solve_linear_statics(meshgen.hex_beam(*n), device="cpu", dtype=F64,
                               n_domain=1, store=False)
    np.testing.assert_allclose(res.u_certified, ref.u,
                               atol=1e-5 * np.abs(ref.u).max())


def test_domain_width_on_cpu():
    """On the CPU an explicit n_domain is honoured and None means one
    device; a solve through a one-wide domain is the single-device path."""
    m = meshgen.hex_beam(3, 2, 2)
    assert solve_linear_statics(m, device="cpu", dtype=F64,
                                store=False).operator == "stencil"
    res = solve_linear_statics(m, device="cpu", dtype=F64, n_domain=1,
                               store=False)
    assert (res.operator, res.n_domain) == ("stencil", 1)
    sharded_res = solve_linear_statics(m, device="cpu", dtype=F64,
                                       n_domain=2, use_structured=False,
                                       store=False)
    assert sharded_res.operator == "sharded-generalx2"
    np.testing.assert_allclose(sharded_res.u, res.u,
                               atol=1e-8 * np.abs(res.u).max())
