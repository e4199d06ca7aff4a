"""The NAFEMS LE10 plate on the port's general path, on the CPU.

The benchmark's LE10 generator (perfbench/plate.py) checked on its own;
the port's solve_linear_statics on a coarse LE10 mesh against the plain
general reference (perfbench/reference/general.py), in float64 and
certified from float32; the general operator's float64 host twin
(hostops.general_twin_np) against the formula it replaces
(hostops.general_apply_np); and check_model naming a mirrored element.
"""

import numpy as np
import pytest
import torch

from perfbench import plate as plate_mod
from perfbench.drivers.plate_solve import fe_model, set_load
from perfbench.reference import fem, general
from stan_tpu_torch.analysis.linear import solve_linear_statics
from stan_tpu_torch.core import meshgen, validate
from stan_tpu_torch.core.model import Material
from stan_tpu_torch.fem import elements, hostops
from stan_tpu_torch.utils.timing import PhaseTimer

LE10 = dict(inner=(2.0, 1.0), outer=(3.25, 2.75), thickness=0.6)
F64 = torch.float64


def _plate(n=(12, 8, 2)):
    return plate_mod.quarter_plate(*n, **LE10)


def _case(seed):
    """Seeded E, nu and pressure field (a, b)."""
    g = np.random.default_rng(seed)
    return (float(g.uniform(150e3, 250e3)), float(g.uniform(0.2, 0.4)),
            float(g.uniform(-0.5, 0.5)), float(g.uniform(-0.5, 0.5)))


def _model(p, E, nu, a, b, tol):
    m = fe_model(p, E=E, nu=nu, elem_type="HEX8_G2", tolerance=tol)
    set_load(m, p.load(a, b, 1.0))
    return m


def _reference(p, E, nu, a, b):
    """The reference's operator, its right-hand side and its float64
    solution to 1e-13."""
    lam, mu = fem.lame(E, nu)
    ref = general.ElementOperator(p.coords, p.conn, p.fixed, lam, mu)
    rhs = ref.free * torch.as_tensor(p.load(a, b, 1.0))
    u, _, rel = fem.cg(ref.masked, rhs[None], ref.diagonal(), tol=1e-13,
                       maxiter=100000)
    assert rel[0] <= 1e-13
    return ref, rhs, u[0]


# -- the generator ------------------------------------------------------------

def test_plate_jacobians_are_positive_at_every_gauss_point():
    p = _plate((9, 5, 4))
    dN = elements.get("HEX8_G2").gauss_dN  # [8, 3, 8]
    J = np.einsum("gkn,enj->egkj", dN, p.coords[p.conn])
    assert (np.linalg.det(J) > 0).all()


def test_plate_nodal_forces_sum_to_the_pressure_times_the_area():
    """Each upper quad is planar with straight edges: its area is its
    polygon's (the shoelace formula), independent of the Gauss sums."""
    p = _plate((9, 5, 4))
    q = p.coords[p.upper][..., :2]
    x, y = q[..., 0], q[..., 1]
    area = 0.5 * np.abs((x * np.roll(y, -1, 1)
                         - np.roll(x, -1, 1) * y).sum(1)).sum()
    f = p.load(0.0, 0.0, 1.0)
    assert abs(f[:, 2].sum() + area) <= 1e-12 * area
    assert not f[:, :2].any()
    assert set(np.flatnonzero(f.any(1))) == set(p.upper.ravel())
    # p = 2 (1 + x / a1): the forces' sum is -2 (area + first moment / a1)
    first = sum((p.load(1.0, 0.0, 1.0) - f)[:, 2])
    g = p.load(1.0, 0.0, 2.0)
    assert abs(g[:, 2].sum() - 2 * (f[:, 2].sum() + first)) <= 1e-12 * area


def test_plate_supports_and_point_d():
    nt, nr, nz = 9, 5, 4
    p = _plate((nt, nr, nz))
    face = (nr + 1) * (nz + 1)
    outer = (nt + 1) * (nz + 1)
    assert p.fixed[:, 0].sum() == face + outer - (nz + 1)
    assert p.fixed[:, 1].sum() == face + outer - (nz + 1)
    assert p.fixed[:, 2].sum() == nt + 1  # the outer face's mid-line
    mid = np.flatnonzero(p.fixed[:, 2])
    assert np.allclose(p.coords[mid, 2], 0.0)
    assert np.allclose((p.coords[mid, 0] / 3.25) ** 2
                       + (p.coords[mid, 1] / 2.75) ** 2, 1.0)
    assert np.allclose(p.coords[p.fixed[:, 1] & ~p.fixed[:, 0], 1], 0.0)
    assert np.allclose(p.coords[p.fixed[:, 0] & ~p.fixed[:, 1], 0], 0.0)
    assert np.allclose(p.coords[p.d_node], (2.0, 0.0, 0.3))
    assert p.conn[p.d_elem, p.d_corner] == p.d_node
    assert (p.conn == p.d_node).sum() == 1  # D belongs to one element
    with pytest.raises(ValueError):
        _plate((4, 3, 3))


# -- the port's solve against the reference ----------------------------------

@pytest.mark.parametrize("seed", [3, 4])
def test_port_float64_solve_matches_the_general_reference(seed):
    E, nu, a, b = _case(seed)
    p = _plate()
    res = solve_linear_statics(_model(p, E, nu, a, b, 1e-13), device="cpu",
                               dtype=F64, store=False)
    assert res.operator == "general" and res.converged
    ref, _, u_ref = _reference(p, E, nu, a, b)
    scale = u_ref.abs().max()
    assert (torch.as_tensor(res.u) - u_ref).abs().max() <= 1e-10 * scale
    _, sig, R = ref.recover(u_ref)
    assert (torch.as_tensor(res.stress) - sig).abs().max() <= (
        1e-8 * sig.abs().max())
    fixed = torch.as_tensor(p.fixed)
    assert (torch.as_tensor(res.reactions)[fixed] - R[fixed]).abs().max() <= (
        1e-8 * R[fixed].abs().max())


def test_port_float32_solve_is_certified_under_the_reference():
    E, nu, a, b = _case(5)
    p = _plate()
    timer = PhaseTimer(verbose=False)
    res = solve_linear_statics(_model(p, E, nu, a, b, 1e-6), device="cpu",
                               store=False, timer=timer)
    assert res.operator == "general" and res.converged
    assert res.u_certified is not None and res.true_residual <= 1e-6
    ref, rhs, _ = _reference(p, E, nu, a, b)
    u = torch.as_tensor(res.u_certified)
    assert fem.relative_residual(ref, u[None], rhs[None])[0] <= 1e-6
    cert = [r for r in timer.records if r["phase"].startswith("Certify")]
    assert len(cert) == 1
    assert cert[0]["sweeps"] == res.refine_cycles + 1


# -- the float64 host twin ----------------------------------------------------

def _distorted(kind):
    """A 4 x 3 x 2 beam (its HEX8 split into six TET4 each for "tet") with
    seeded jitter on the nodes, two materials and a seeded mask per DOF."""
    m = meshgen.hex_beam(4, 3, 2)
    g = np.random.default_rng(11)
    m.coords = m.coords + 0.15 * g.uniform(-1, 1, m.coords.shape)
    if kind == "tet":
        m.conn = np.asarray(m.conn)[:, [[0, 1, 2, 6], [0, 2, 3, 6],
                                        [0, 3, 7, 6], [0, 7, 4, 6],
                                        [0, 4, 5, 6], [0, 5, 1, 6]]
                                    ].reshape(-1, 4)
        m.elem_type = ["TET4_G2"] * len(m.conn)
    m.materials[2] = Material(id=2, name="soft", E=70000.0, poisson=0.33)
    m.elem_mat = 1 + (np.arange(len(m.conn)) % 2)
    fix = g.random((m.nnode, 3)) < 0.2
    return (m.coords, m.conn, np.asarray(m.elem_d_matrices(), np.float64),
            m.formulation(), fix)


@pytest.mark.parametrize("kind", ["hex", "tet"])
def test_general_twin_matches_the_formula_it_replaces(kind):
    args = _distorted(kind)
    u = np.random.default_rng(12).standard_normal((args[0].shape[0], 3))
    want = hostops.general_apply_np(*args)(u)
    twin = hostops.general_twin_np(*args)
    got = twin(u)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    np.testing.assert_array_equal(twin(u), got)  # the same bits each sweep


def test_masked_f64_apply_takes_the_native_twin_for_the_general_operator():
    from stan_tpu_torch.fem.operator import build_operator

    m = meshgen.hex_beam(4, 3, 2)
    m.coords = m.coords + 0.15 * np.random.default_rng(13).uniform(
        -1, 1, m.coords.shape)
    op = build_operator(m.coords, m.conn, m.elem_d_matrices(), m.fix_mask(),
                        m.formulation(), dtype=F64, device="cpu")
    twin = hostops.masked_f64_apply(m, op)
    assert twin.__qualname__ == "general_twin_np.<locals>.apply"
    u = np.random.default_rng(14).standard_normal((m.nnode, 3))
    want = op.apply(torch.as_tensor(u)).numpy()
    assert np.abs(twin(u) - want).max() <= 1e-12 * np.abs(want).max()


# -- validation ---------------------------------------------------------------

def test_check_model_names_a_mirrored_element():
    m = meshgen.hex_beam(3, 2, 2)
    assert validate.check_model(m) == []
    m.conn = m.conn.copy()
    m.conn[4] = m.conn[4][[3, 2, 1, 0, 7, 6, 5, 4]]
    problems = validate.check_model(m)
    assert len(problems) == 1
    assert "Jacobian" in problems[0] and f"[{m.elem_ids[4]}]" in problems[0]
    with pytest.raises(validate.ValidationError):
        validate.validate(m)


def test_check_model_names_a_mirrored_plate():
    """The LE10 mesh with its node order mirrored: every element is named,
    by count and by its first ids."""
    p = _plate((6, 4, 2))
    m = fe_model(p, E=210000.0, nu=0.3, elem_type="HEX8_G2", tolerance=1e-6)
    set_load(m, p.load(0.0, 0.0, 1.0))
    assert validate.check_model(m) == []
    m.conn = p.conn[:, [1, 0, 3, 2, 5, 4, 7, 6]]
    problems = validate.check_model(m)
    assert problems == [f"{p.nelem} element(s) with a Jacobian determinant "
                        "<= 0 at a Gauss point: inverted or mirrored node "
                        "order (element ids [1, 2, 3, 4, 5, 6, 7, 8, 9, 10] "
                        "...)"]
