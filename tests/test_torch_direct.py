"""Port parity: assembly, the direct solvers and the banded host solver of
stan_tpu_torch against stan_tpu, in float64 on the CPU.

Assembled K (dense, masked and not, and sparse) and the element stiffness
to 1e-12 relative;
direct solves, through the solver functions and through
solve_linear_statics, to 1e-10 of max|u| with the same operator name and
the same size dispatch; the banded host solver and its bandwidth-reducing
order against the reference's (its pure-Python BFS, which the port
copies), and the memory refusal of tests/test_banded.py:64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from stan_tpu.analysis import linear as jlinear
from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.fem import assembly as jassembly
from stan_tpu.solvers import banded as jbanded
from stan_tpu.solvers import direct as jdirect
from stan_tpu_torch.analysis import linear
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.fem import assembly
from stan_tpu_torch.parallel import partition
from stan_tpu_torch.solvers import banded, direct

F64 = torch.float64

# name -> model factory over a meshgen module (the reference's or the port's)
MESHES = {
    "hex_beam(3,2,2)": lambda M: M.hex_beam(3, 2, 2),
    "hex_beam(4,3,3)": lambda M: M.hex_beam(4, 3, 3),
    "uniaxial_bar(2)": lambda M: M.uniaxial_bar(2),
    "tet4 2x2x2": lambda M: chip_smoke.tet_split(M.hex_beam(2, 2, 2)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(m):
    return m.coords, m.conn, m.elem_d_matrices(), m.formulation()


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("name", MESHES)
def test_assembly_matches_reference(name):
    m = MESHES[name](meshgen)
    fix = m.fix_mask()
    for mask in (None, fix):
        want = np.asarray(jassembly.assemble_dense(
            *_args(m), fix_mask=mask, dtype=jnp.float64))
        got = assembly.assemble_dense(*_args(m), fix_mask=mask, dtype=F64,
                                      device="cpu")
        _close(got.numpy(), want, 1e-12)
        bcoo = jassembly.assemble_bcoo(*_args(m), fix_mask=mask,
                                       dtype=jnp.float64)
        sp = assembly.assemble_sparse(*_args(m), fix_mask=mask, dtype=F64,
                                      device="cpu")
        assert sp.is_coalesced() and sp.shape == tuple(bcoo.shape)
        _close(sp.to_dense().numpy(), np.asarray(bcoo.todense()), 1e-12)
    rows, cols = assembly.coo_indices(m.conn)
    want_rows, want_cols = jassembly.coo_indices(m.conn)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(cols, want_cols)


@pytest.mark.parametrize("name", ["hex_beam(3,2,2)", "tet4 2x2x2"])
def test_element_stiffness_matches_reference(name):
    """b_matrix, element_stiffness and element_stiffness_diag of the port's
    fem/kernels.py against the reference's, to 1e-12."""
    from stan_tpu.fem import kernels as jkernels
    from stan_tpu_torch.fem import kernels

    m = MESHES[name](meshgen)
    coords_e = np.asarray(m.coords)[np.asarray(m.conn)]
    D, form = m.elem_d_matrices(), m.formulation()
    ke = kernels.element_stiffness(torch.as_tensor(coords_e),
                                   torch.as_tensor(D), form)
    _close(ke.numpy(), jkernels.element_stiffness(
        jnp.asarray(coords_e), jnp.asarray(D), form), 1e-12)
    diag = kernels.element_stiffness_diag(torch.as_tensor(coords_e),
                                          torch.as_tensor(D), form)
    _close(diag.numpy(), jkernels.element_stiffness_diag(
        jnp.asarray(coords_e), jnp.asarray(D), form), 1e-12)
    _close(diag.numpy(), torch.diagonal(ke, dim1=1, dim2=2).numpy(), 1e-12)
    dN, _ = kernels.element_geometry(torch.as_tensor(coords_e), form)
    np.testing.assert_array_equal(kernels.b_matrix(dN).numpy(),
                                  jkernels.b_matrix(jnp.asarray(dN.numpy())))


@pytest.mark.parametrize("name", MESHES)
def test_direct_solvers_match_reference(name):
    m = MESHES[name](meshgen)
    K = assembly.assemble_dense(*_args(m), fix_mask=m.fix_mask(), dtype=F64,
                                device="cpu")
    f = torch.as_tensor(((1.0 - m.fix_mask()) * m.load_vector()).reshape(-1))
    for mine, ref in ((direct.solve_cholesky, jdirect.solve_cholesky),
                      (direct.solve_lu, jdirect.solve_lu)):
        want = np.asarray(ref(jnp.asarray(K.numpy()), jnp.asarray(f.numpy())))
        _close(mine(K, f).numpy(), want, 1e-10)
        two = mine(K, torch.stack([f, 2.0 * f], dim=1))
        _close(two[:, 1].numpy(), 2.0 * want, 1e-10)


@pytest.mark.parametrize("solver", ["Cholesky", "LU"])
@pytest.mark.parametrize("name", ["hex_beam(4,3,3)", "tet4 2x2x2"])
def test_solve_linear_statics_direct(name, solver):
    m_ref, m = MESHES[name](jmeshgen), MESHES[name](meshgen)
    for model in (m_ref, m):
        model.analysis.lin_solver = solver
    ref = jlinear.solve_linear_statics(m_ref)
    res = linear.solve_linear_statics(m, device="cpu", dtype=F64)
    assert res.operator == ref.operator == f"dense-{solver.lower()}"
    assert res.converged and res.iters == ref.iters == 1
    assert res.true_residual < 1e-12 and res.u_certified is None
    for got, want in ((res.u, ref.u), (res.stress, ref.stress),
                      (res.reactions, ref.reactions)):
        _close(got, want, 1e-10)
    _close(m.disp[1], m_ref.disp[1], 1e-10)


def test_size_dispatch_matches_reference(monkeypatch):
    """Both packages switch from dense to banded above 6000 DOF; with the
    limit lowered in both, a model on each side of it takes the same
    path in each, and the banded path reports its float64 residual."""
    assert linear._DENSE_DIRECT_MAX_DOF == jlinear._DENSE_DIRECT_MAX_DOF \
        == 6000
    monkeypatch.setattr(linear, "_DENSE_DIRECT_MAX_DOF", 120)
    monkeypatch.setattr(jlinear, "_DENSE_DIRECT_MAX_DOF", 120)
    for n, kind in ((3, "dense"), (4, "banded")):  # 108 and 135 DOF
        m_ref, m = jmeshgen.hex_beam(n, 2, 2), meshgen.hex_beam(n, 2, 2)
        for model in (m_ref, m):
            model.analysis.lin_solver = "LU"
        ref = jlinear.solve_linear_statics(m_ref, store=False)
        res = linear.solve_linear_statics(m, device="cpu", dtype=F64,
                                          store=False)
        assert res.operator == ref.operator == f"{kind}-lu"
        _close(res.u, ref.u, 1e-10)
        if kind == "banded":
            assert res.true_residual == pytest.approx(ref.true_residual,
                                                      rel=1e-3, abs=1e-14)


@pytest.mark.parametrize("name", ["hex_beam(4,3,3)", "tet4 2x2x2"])
def test_banded_matches_reference(name, monkeypatch):
    monkeypatch.setattr("stan_tpu.native.bfs_order", lambda conn, n: None)
    m = MESHES[name](meshgen)
    np.testing.assert_array_equal(
        partition.bfs_node_order(m.conn, m.nnode),
        jbanded.bfs_node_order(m.conn, m.nnode))
    assert banded.band_structure(m).hbw == jbanded.band_structure(m).hbw
    np.testing.assert_array_equal(banded.assemble_banded(m),
                                  jbanded.assemble_banded(m))
    for mine, ref in ((banded.solve_banded_cholesky,
                       jbanded.solve_banded_cholesky),
                      (banded.solve_banded_lu, jbanded.solve_banded_lu)):
        _close(mine(m), ref(m), 1e-10)


def test_banded_order_on_scrambled_numbering(monkeypatch):
    """tests/test_banded.py:72-98 on the port: with node ids scrambled, the
    BFS order recovers a band near the cross-section's, the same order and
    half-bandwidth as the reference's: the native walk of each package,
    then the numpy body of each. (The two walks break ties between seeds
    of equal degree differently here: the numpy argsort is not stable.)"""
    import copy

    m = meshgen.hex_beam(40, 3, 3)
    perm = np.random.default_rng(0).permutation(m.nnode)
    m2 = copy.copy(m)
    m2.coords = np.asarray(m.coords)[np.argsort(perm)]
    m2.conn = perm[np.asarray(m.conn)]
    for walk in ("native", "numpy"):
        if walk == "numpy":
            for mod in ("stan_tpu.native", "stan_tpu_torch.native"):
                monkeypatch.setattr(f"{mod}.bfs_order", lambda conn, n: None)
        got, want = banded.band_structure(m2), jbanded.band_structure(m2)
        np.testing.assert_array_equal(got.order, want.order)
        assert got.hbw == want.hbw <= 4 * banded.band_structure(m).hbw


def test_banded_memory_refusal():
    m = meshgen.hex_beam(8, 8, 8)
    with pytest.raises(MemoryError, match="CG"):
        banded.solve_banded_cholesky(m, max_band_bytes=1000)
    with pytest.raises(MemoryError, match="CG"):
        banded.solve_banded_lu(m, max_band_bytes=1000)
