"""The port's certified solve and float64 host operators, against stan_tpu.

exact_tables, apply_numpy, the hostops twins (general, stencil, structured,
and masked_f64_apply's dispatch) and the exact-table float64 device apply
(the float64 StencilOperator) of stan_tpu_torch against the JAX package's
and against the port's own operators built in float64 on the CPU; then
pcg_certified on both sides, each certified by the JAX package's host
float64 operator. Also validate and the STdb protobuf writer.

The JAX side's certified solve runs its masked plain stencil form
(_stencil_apply_jnp) as the float32 operator and, as its high-precision
operator, the float64 plain form over exact_tables returned as float32
(hi, lo) pairs, built here: its df32 operator costs about 220 s of XLA
compilation per model on the CPU, and tests/test_df32.py (slow) holds
that operator to the host one. No Pallas interpret run is needed. The
port's runs its float32 StencilOperator on the CPU (the sweep's plain
version) with the float64 StencilOperator's apply.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.core import validate as jvalidate
from stan_tpu.core.model import Material as JMaterial
from stan_tpu.fem import hostops as jhostops
from stan_tpu.fem import operator as joperator
from stan_tpu.fem import stencil as jstencil
from stan_tpu.fem import structured as jstructured
from stan_tpu.io import stdb as jstdb
from stan_tpu.solvers import cg as jcg
from stan_tpu_torch.core import meshgen, validate
from stan_tpu_torch.core.model import Material
from stan_tpu_torch.fem import hostops, stencil, structured
from stan_tpu_torch.fem.operator import build_operator
from stan_tpu_torch.io import stdb, stdb_pb2
from stan_tpu_torch.solvers import cg

F32, F64 = torch.float32, torch.float64
# tests/test_df32.py's model, and a beam with unequal spacings.
MODELS = {"6x5x4": ((6, 5, 4), {}),
          "4x2x2": ((4, 2, 2), {"lx": 6.0, "ly": 1.5, "lz": 3.0})}
# tests/test_stencil.py:45-52: the operator to 1e-12 of max|f|.
OP_RTOL = 1e-12
TOL = 1e-6
# tests/test_df32.py:112: the host cross-check of a certified solve.
HOST_TOL = 1.2e-6


def _pair(name):
    n, kw = MODELS[name]
    return meshgen.hex_beam(*n, **kw), jmeshgen.hex_beam(*n, **kw)


def _two_material(mod, material):
    m = mod.hex_beam(4, 3, 2)
    m.materials[2] = material(id=2, name="soft", E=70000.0, poisson=0.33)
    m.elem_mat = m.elem_mat.copy()
    m.elem_mat[m.nelem // 2:] = 2
    return m


def _close(got, want, rtol=OP_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{err:.3e} > {rtol:.0e} * {scale:.3e}"


def _grid_input(shape, seed):
    return np.random.default_rng(seed).standard_normal((3, *shape))


def _torch(x):
    return torch.as_tensor(x, dtype=F64)


# -- exact tables and the host sweep ----------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_exact_tables_equal_reference(name):
    m, jm = _pair(name)
    (t, d), (jt, jd) = stencil.exact_tables(m), jstencil.exact_tables(jm)
    for mine, ref in ((t, jt), (d, jd)):
        assert mine.keys() == ref.keys()
        scale = max(np.abs(b).max() for s in ref.values() for b in s.values())
        for sig in ref:
            assert mine[sig].keys() == ref[sig].keys(), sig
            for off in ref[sig]:
                gap = np.abs(mine[sig][off] - ref[sig][off]).max()
                assert gap <= 1e-14 * scale, (sig, off, gap)


def _near_twin_materials(mod, material):
    """Two materials whose moduli differ below float32's resolution: equal
    in a float32 operator's tensors, not in float64."""
    m = mod.hex_beam(4, 3, 2)
    first = m.materials[1]
    m.materials[2] = material(id=2, name="twin", E=first.E * (1 + 1e-12),
                              poisson=first.poisson)
    m.elem_mat = m.elem_mat.copy()
    m.elem_mat[m.nelem // 2:] = 2
    return m


def test_exact_tables_refuse_what_the_reference_refuses():
    """No stencil operator, no exact tables: several materials (also ones
    that a float32 operator cannot tell apart), a grid with fewer than 3
    nodes along an axis, a mesh that is not a brick grid. One host test
    decides for both dtypes, so the float32 operator refuses what
    exact_tables refuses."""
    cases = [
        (_two_material(meshgen, Material), _two_material(jmeshgen, JMaterial)),
        (_near_twin_materials(meshgen, Material),
         _near_twin_materials(jmeshgen, JMaterial)),
        (meshgen.hex_beam(4, 1, 2), jmeshgen.hex_beam(4, 1, 2)),
    ]
    irregular = meshgen.hex_beam(3, 2, 2)
    irregular.coords = irregular.coords.copy()
    irregular.coords[5, 1] += 0.1
    cases.append((irregular, copy.deepcopy(irregular)))
    for m, jm in cases:
        assert jstencil.exact_tables(jm) is None
        assert stencil.exact_tables(m) is None
        for dtype in (F32, F64):
            assert stencil.build_stencil_operator(m, dtype=dtype,
                                                  device="cpu") is None


def test_exact_tables_ignore_the_operator_dtype():
    """The tables come from the float64 ke, not from a float32 operator's
    rounded one, whose tables are 1e-8 (relative) away."""
    m = meshgen.hex_beam(6, 5, 4)
    exact, _ = stencil.exact_tables(m)
    op32 = stencil.build_stencil_operator(m, dtype=F32, device="cpu")
    op64 = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    interior = ("F", "F", "F")
    scale = max(np.abs(b).max() for b in exact[interior].values())

    def gap(tables):
        return max(np.abs(tables[interior][o] - exact[interior][o]).max()
                   for o in exact[interior]) / scale

    assert gap(op64.tables) <= 1e-14
    assert gap(op32.tables) > 1e-9


@pytest.mark.parametrize("name", MODELS)
def test_apply_numpy_matches_reference_and_sweep(name):
    m, jm = _pair(name)
    t, d = stencil.exact_tables(m)
    jt, jd = jstencil.exact_tables(jm)
    op = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    u = _grid_input(op.node_shape, 3)
    f = stencil.apply_numpy(t, d, u)
    _close(f, jstencil.apply_numpy(jt, jd, u))
    _close(f, op.apply_raw(_torch(u)).numpy())


# -- the hostops twins -------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_stencil_apply_np_matches_reference_and_operator(name):
    m, jm = _pair(name)
    op = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    jop = jstencil.build_stencil_operator(jm)
    u = _grid_input(op.node_shape, 4)
    f = hostops.stencil_apply_np(m, op)(u)
    _close(f, jhostops.stencil_apply_np(jm, jop)(u))
    _close(f, op.apply(_torch(u)).numpy())


@pytest.mark.parametrize("dtype", [F32, F64])
def test_structured_apply_np_matches_reference_and_operator(dtype):
    """Two materials, so the structured operator (not the stencil) is the
    model's grid operator. lam_e and mu_e are read from the operator, as in
    the reference: in float32 they are the rounded ones."""
    m = _two_material(meshgen, Material)
    jm = _two_material(jmeshgen, JMaterial)
    sop = structured.build_structured_operator(m, dtype=dtype, device="cpu")
    jsop = jstructured.build_structured_operator(
        jm, dtype=jnp.float32 if dtype == F32 else jnp.float64)
    u = _grid_input(sop.node_shape, 5)
    f = hostops.structured_apply_np(m, sop)(u)
    _close(f, jhostops.structured_apply_np(jm, jsop)(u))
    if dtype == F64:
        _close(f, sop.apply(_torch(u)).numpy())


@pytest.mark.parametrize("name", MODELS)
def test_general_apply_np_matches_reference_and_operator(name):
    m, jm = _pair(name)
    args = (m.coords, m.conn, np.asarray(m.elem_d_matrices(), np.float64),
            m.formulation(), m.fix_mask())
    u = np.random.default_rng(6).standard_normal((m.nnode, 3))
    f = hostops.general_apply_np(*args)(u)
    _close(f, jhostops.general_apply_np(
        jm.coords, jm.conn, np.asarray(jm.elem_d_matrices(), np.float64),
        jm.formulation(), jm.fix_mask())(u))
    op = build_operator(m.coords, m.conn, m.elem_d_matrices(), m.fix_mask(),
                        m.formulation(), dtype=F64, device="cpu")
    _close(f, op.apply(_torch(u)).numpy())


def _port_and_reference_ops(family):
    if family == "structured":
        m = _two_material(meshgen, Material)
        jm = _two_material(jmeshgen, JMaterial)
        return (m, jm,
                structured.build_structured_operator(m, dtype=F64,
                                                     device="cpu"),
                jstructured.build_structured_operator(jm))
    m, jm = _pair("4x2x2")
    if family == "stencil":
        return (m, jm,
                stencil.build_stencil_operator(m, dtype=F64, device="cpu"),
                jstencil.build_stencil_operator(jm))
    return (m, jm,
            build_operator(m.coords, m.conn, m.elem_d_matrices(),
                           m.fix_mask(), m.formulation(), dtype=F64,
                           device="cpu"),
            joperator.build_operator(jm.coords, jm.conn,
                                     jm.elem_d_matrices(), jm.fix_mask(),
                                     jm.formulation()))


@pytest.mark.parametrize("family", ["stencil", "structured", "general"])
def test_masked_f64_apply_dispatches_like_reference(family):
    m, jm, op, jop = _port_and_reference_ops(family)
    shape = ((m.nnode, 3) if family == "general"
             else (3, *op.node_shape))
    u = np.random.default_rng(7).standard_normal(shape)
    f = hostops.masked_f64_apply(m, op)(u)
    _close(f, jhostops.masked_f64_apply(jm, jop)(u))
    _close(f, op.apply(_torch(u)).numpy())


def test_masked_f64_apply_refuses_an_unknown_operator():
    with pytest.raises(TypeError, match="unknown operator family"):
        hostops.masked_f64_apply(meshgen.hex_beam(2, 2, 2), object())


# -- the exact-table float64 device apply -----------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_exact_operator_matches_apply_numpy(name):
    m, _ = _pair(name)
    ex = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    assert ex.dtype == F64 and ex.table.dtype == F64
    t, d = stencil.exact_tables(m)
    free = ex.free_mask.numpy()
    u = _grid_input(ex.node_shape, 8)
    want = free * stencil.apply_numpy(t, d, free * u) + (1.0 - free) * u
    _close(ex.apply(_torch(u)).numpy(), want)


# -- the certified solve -----------------------------------------------------

def _host_rel(jm, b, u):
    """||b - A u|| / ||b|| with the JAX package's host float64 operator."""
    jt, jd = jstencil.exact_tables(jm)
    free = np.asarray(jstencil.build_stencil_operator(jm).free_mask,
                      np.float64)
    u = np.asarray(u, np.float64)
    f = free * jstencil.apply_numpy(jt, jd, free * u) + (1.0 - free) * u
    return float(np.linalg.norm((b - f).ravel()) / np.linalg.norm(b.ravel()))


def _reference_certified(jm, order=1):
    """The JAX package's pcg_certified with its masked plain stencil form as
    the float32 operator (offsets summed in `order`) and, as its
    high-precision operator, the float64 plain form over the exact tables
    returned as float32 (hi, lo) pairs. Its df32 operator
    (df32.make_df_masked_apply) agrees with that to 1e-11
    (tests/test_df32.py) but costs about 220 s of XLA compilation per
    model on the CPU."""
    op = jstencil.build_stencil_operator(jm, dtype=jnp.float32)
    free = op.free_mask
    tables = {sig: dict(list(t.items())[::order])
              for sig, t in op.tables.items()}

    def A(u):
        return (free * jstencil._stencil_apply_jnp(tables, op.deltas,
                                                   free * u)
                + (1.0 - free) * u)

    t64, d64 = jstencil.exact_tables(jm)
    free64 = jnp.asarray(free, jnp.float64)

    def hi_lo(xh, xl):
        x = xh.astype(jnp.float64) + xl.astype(jnp.float64)
        f = (free64 * jstencil._stencil_apply_jnp(t64, d64, free64 * x)
             + (1.0 - free64) * x)
        fh = f.astype(jnp.float32)
        return fh, (f - fh.astype(jnp.float64)).astype(jnp.float32)

    b64 = (np.asarray(op.to_grid(jnp.asarray(jm.load_vector())), np.float64)
           * np.asarray(free, np.float64))
    res = jcg.pcg_certified(A, b64, hi_lo, diag=op.diagonal(), tol=TOL,
                            ndof=3 * jm.nnode)
    return b64, res


def _port_certified(m, **kw):
    op = stencil.build_stencil_operator(m, dtype=F32, device="cpu")
    ex = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    b64 = ex.free_mask * ex.to_grid(torch.as_tensor(m.load_vector(),
                                                    dtype=F64))
    res = cg.pcg_certified(op.apply, b64, ex.apply, diag=op.diagonal(),
                           tol=TOL, ndof=3 * m.nnode, **kw)
    return b64.numpy(), res


# The inner float32 CG's count moves with the float32 operator's summation
# order: the reference against itself, with the stencil offsets summed in
# reverse, takes 72 against 57 inner iterations on hex_beam(4, 2, 2, ...)
# and 87 against 70 on hex_beam(6, 5, 4) (3 cycles each). Each cycle after
# the first starts from a residual at the float32 operator's floor, which
# is rounding noise. So the counts are held to ITERS_RTOL, the spread of
# the reference against itself, and the schedule exactly by
# test_pcg_certified_cycle_tolerances_follow_the_schedule.
ITERS_RTOL = 0.3


@pytest.mark.parametrize("name", MODELS)
def test_pcg_certified_matches_reference(name):
    m, jm = _pair(name)
    jb, ref = _reference_certified(jm)
    b, res = _port_certified(m)
    np.testing.assert_array_equal(b, jb)
    assert isinstance(res.u, torch.Tensor) and res.u.dtype == F64
    assert res.u.shape == b.shape
    for r in (ref, res):
        assert r.converged and r.rel_residual <= TOL
        assert _host_rel(jm, b, r.u) <= HOST_TOL
    # The port's residual is float64 throughout: the host check agrees.
    assert _host_rel(jm, b, res.u) == pytest.approx(res.rel_residual,
                                                    rel=1e-3)
    assert abs(res.cycles - ref.cycles) <= 1
    assert abs(res.inner_iters - ref.inner_iters) <= (ITERS_RTOL
                                                      * ref.inner_iters)
    assert res.seconds > 0.0


def test_reference_iterations_move_with_summation_order():
    """The measurement behind ITERS_RTOL: the reference's own certified
    solve, its float32 offsets summed forwards and in reverse."""
    jm = _pair("4x2x2")[1]
    runs = [_reference_certified(jm, order)[1] for order in (1, -1)]
    assert all(r.converged for r in runs)
    a, b = sorted(r.inner_iters for r in runs)
    assert 0.1 * b < b - a <= ITERS_RTOL * b


def test_pcg_certified_cycle_tolerances_follow_the_schedule(monkeypatch):
    """Each cycle's tolerance is clip(0.3 tol / rel, inner_tol, 3e-2) of the
    residual read after the cycle before (1 at the start), and the loop
    stops once the residual reaches tol."""
    calls = []
    pcg = cg.pcg

    def spy(A, b, **kw):
        calls.append((float(torch.linalg.vector_norm(b.to(F64))), kw["tol"]))
        return pcg(A, b, **kw)

    monkeypatch.setattr(cg, "pcg", spy)
    m = _pair("6x5x4")[0]
    b, res = _port_certified(m)
    bnorm = np.linalg.norm(b)
    assert res.converged and len(calls) == res.cycles >= 2
    for k, (rnorm, t) in enumerate(calls):
        rel = 1.0 if k == 0 else rnorm / bnorm
        assert t == pytest.approx(min(max(0.3 * TOL / rel, 5e-3), 3e-2),
                                  rel=1e-6)
        if k:
            assert rel > TOL


def test_pcg_certified_zero_rhs():
    op = stencil.build_stencil_operator(meshgen.hex_beam(3, 2, 2), dtype=F32,
                                        device="cpu")
    b = torch.zeros((3, *op.node_shape), dtype=F64)
    res = cg.pcg_certified(op.apply, b, lambda x: x, diag=op.diagonal())
    assert res.converged and res.cycles == 0 and res.inner_iters == 0
    assert res.rel_residual == 0.0
    assert res.u.dtype == F64 and not bool(res.u.any())


def test_pcg_certified_stops_at_max_cycles():
    m, jm = _pair("6x5x4")
    b, res = _port_certified(m, max_cycles=1)
    assert res.cycles == 1 and not res.converged
    assert TOL < res.rel_residual < 3e-2
    assert _host_rel(jm, b, res.u) == pytest.approx(res.rel_residual,
                                                    rel=1e-3)


def test_pcg_certified_stops_when_a_cycle_does_not_improve():
    """A high-precision operator under which no correction lowers the
    residual: the second read equals the first, and the loop stops there
    with that cycle's x, as the reference's does."""
    m = meshgen.hex_beam(6, 5, 4)
    op = stencil.build_stencil_operator(m, dtype=F32, device="cpu")
    b = op.free_mask.to(F64) * op.to_grid(torch.as_tensor(m.load_vector(),
                                                          dtype=F64))
    res = cg.pcg_certified(op.apply, b, torch.zeros_like, diag=op.diagonal(),
                           tol=TOL, ndof=3 * m.nnode)
    assert res.cycles == 1 and not res.converged
    assert res.rel_residual == pytest.approx(1.0)
    assert res.inner_iters > 0 and bool(res.u.any())


def test_pcg_certified_measure_reports_the_same_solve():
    m, _ = _pair("4x2x2")
    _, once = _port_certified(m)
    _, twice = _port_certified(m, measure=True)
    assert (once.cycles, once.inner_iters, once.rel_residual) == (
        twice.cycles, twice.inner_iters, twice.rel_residual)
    torch.testing.assert_close(once.u, twice.u, rtol=0, atol=0)


# -- validate and the protobuf writer ---------------------------------------

def _bad_material(m):
    m.materials[1].E = -999.0


def _nan_coords_bad_conn(m):
    m.coords = m.coords.copy()
    m.coords[0, 0] = np.nan
    m.conn = m.conn.copy()
    m.conn[0, 0] = m.conn[0, 1]


def _mixed_families(m):
    m.elem_type = list(m.elem_type)
    m.elem_type[0] = "TET4_G2"


def _mixed_integration(m):
    m.elem_type = list(m.elem_type)
    m.elem_type[0] = "HEX8_G1"


def _no_spc(m):
    m.bcs = {k: v for k, v in m.bcs.items() if v.type != "SPC"}


# The invalid models of tests/test_aux.py:76-125.
INVALID = [_bad_material, _nan_coords_bad_conn, _mixed_families,
           _mixed_integration, _no_spc]


@pytest.mark.parametrize("spoil", INVALID, ids=lambda f: f.__name__[1:])
def test_validate_raises_the_reference_problems(spoil):
    m, jm = meshgen.hex_beam(2, 2, 2), jmeshgen.hex_beam(2, 2, 2)
    spoil(m)
    spoil(jm)
    with pytest.raises(jvalidate.ValidationError) as want:
        jvalidate.validate(jm)
    with pytest.raises(validate.ValidationError) as got:
        validate.validate(m)
    assert got.value.problems == want.value.problems
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)


def test_validate_accepts_a_valid_model():
    assert validate.validate(meshgen.hex_beam(3, 2, 2)) is None


@pytest.mark.parametrize("with_results", [False, True])
def test_to_proto_equals_serialize_and_reference(with_results):
    m = meshgen.hex_beam(3, 2, 2, load=(5.0, -2.0, -10.0))
    jm = jmeshgen.hex_beam(3, 2, 2, load=(5.0, -2.0, -10.0))
    if with_results:
        rng = np.random.default_rng(9)
        for model in (m, jm):
            model.disp = rng.standard_normal((2, m.nnode, 3))
            model.strain = rng.standard_normal((2, m.nelem, 8, 6))
            model.stress = rng.standard_normal((2, m.nelem, 8, 6))
            model.analysis.result_step_no = 1
            rng = np.random.default_rng(9)
    db = stdb.to_proto(m)
    assert isinstance(db, stdb_pb2.Database)
    wire = db.SerializeToString()
    for other in (stdb.serialize(m),
                  jstdb.to_proto(jm).SerializeToString()):
        parsed = stdb_pb2.Database()
        parsed.ParseFromString(other)
        assert parsed == db
    back = stdb.from_proto(stdb_pb2.Database.FromString(wire))
    np.testing.assert_array_equal(back.coords, m.coords)
    np.testing.assert_array_equal(back.conn, m.conn)
    if with_results:
        np.testing.assert_array_equal(back.disp, m.disp)
        np.testing.assert_array_equal(back.stress, m.stress)
