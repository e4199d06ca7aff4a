"""The general reference (perfbench/reference/general.py) against the box
reference and a patch test; the LE10 driver's check, and its refusal of a
program that does not certify."""

import numpy as np
import pytest
import torch

from perfbench import harness, mesh, plate
from perfbench.reference import fem, general


def _jittered(seed=0, amp=0.2):
    beam = mesh.hex_beam(4, 3, 3)
    coords = beam.coords + amp * np.random.default_rng(seed).uniform(
        -1, 1, beam.coords.shape)
    return beam, coords


def test_general_matches_the_box_reference():
    beam = mesh.hex_beam(5, 3, 2)
    lam, mu = fem.lame(210000.0, 0.3)
    fixed = np.zeros((beam.nnode, 3), bool)
    fixed[beam.fixed_nodes] = True
    g = general.ElementOperator(beam.coords, beam.conn, fixed, lam, mu)
    box = fem.ElementOperator(beam.coords, beam.conn, beam.fixed_nodes, lam,
                              mu)
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (1, beam.nnode, 3)))
    for mine, theirs in ((g.masked(u), box.masked(u)),
                         (g.apply(u), box.apply(u)),
                         (g.diagonal(), box.diagonal())):
        assert (mine - theirs).abs().max() <= 1e-12 * theirs.abs().max()
    for mine, theirs in zip(g.recover(u[0]), fem.recover(box, u[0], lam, mu)):
        assert (mine - theirs).abs().max() <= 1e-12 * theirs.abs().max()


def test_patch_test_on_a_distorted_mesh():
    """u = A x + c: the same strain sym(A) at every Gauss point of every
    distorted element, the same stress at every node, and no force on a
    node that no support or load touches."""
    beam, coords = _jittered()
    A = np.array([[1.0, 2.0, -0.5], [0.3, -1.0, 0.7], [0.2, 0.4, 0.6]]) * 1e-3
    u = torch.as_tensor(coords @ A.T + np.array([0.1, -0.2, 0.3]))
    B, det = general.b_and_det(torch.as_tensor(coords[beam.conn]))
    assert bool((det > 0).all())
    eps_g = torch.einsum("egia,ea->egi", B, u[torch.as_tensor(beam.conn)]
                         .reshape(-1, 24))
    want = torch.as_tensor([A[0, 0], A[1, 1], A[2, 2], A[0, 1] + A[1, 0],
                            A[1, 2] + A[2, 1], A[0, 2] + A[2, 0]])
    assert (eps_g - want).abs().max() <= 1e-14
    lam, mu = fem.lame(1000.0, 0.25)
    g = general.ElementOperator(coords, beam.conn,
                                np.zeros((beam.nnode, 3), bool), lam, mu)
    eps, sig, f = g.recover(u)
    assert (eps - want).abs().max() <= 1e-13
    sig_want = torch.as_tensor(fem.d_matrix(lam, mu)) @ want
    assert (sig - sig_want).abs().max() <= 1e-12 * sig_want.abs().max()
    nx, ny, nz = beam.node_shape
    inner = np.zeros(beam.node_shape, bool)
    inner[1:-1, 1:-1, 1:-1] = True
    assert f[torch.as_tensor(inner.ravel())].abs().max() <= (
        1e-12 * f.abs().max())


def test_general_refuses_an_inverted_element():
    beam = mesh.hex_beam(2, 1, 1)
    conn = beam.conn.copy()
    conn[1] = conn[1][[1, 0, 3, 2, 5, 4, 7, 6]]
    with pytest.raises(ValueError):
        general.ElementOperator(beam.coords, conn,
                                np.zeros((beam.nnode, 3), bool), 1.0, 1.0)


def test_le10_check_limits_the_strain_and_reads_stress_and_reactions():
    """The full comparison is of the window's first solve, whose case the
    seed draws: the seeds give different cases. The strain is held to its
    limit; the stress and reaction gaps are read beside it, as notes."""
    cases = set()
    for seed in (2 ** 31 + 7, 2 ** 31 + 8, 2 ** 31 + 9):
        notes = {}
        code, res = harness.run_cell("le10-solve", seed, 0.2, False,
                                     device="cpu", scale=(8, 4, 2),
                                     notes=notes)
        assert code == 0 and res["correct"] is True, res["checks"]
        assert set(res["checks"]) == {"residual_max", "strain_gap",
                                      "le10_target_gap"}
        assert 0 < notes["stress_gap"] < 1e-3
        assert 0 < notes["reaction_gap"] < 1e-3
        cases.add(tuple(notes["full_case"]))
    assert len(cases) > 1


def test_le10_config_states_the_mesh_it_runs():
    cell = harness.find_cell("le10-solve")
    c = cell.config
    p = plate.quarter_plate(*c["grid"], inner=c["inner_semi_axes"],
                            outer=c["outer_semi_axes"],
                            thickness=c["thickness"])
    assert (p.nnode, p.nelem, 3 * p.nnode) == (c["nodes"], c["elements"],
                                               c["dof"])
    assert np.allclose(p.coords[p.d_node], c["target"]["point_D"])


def test_a_program_that_does_not_certify_is_refused_at_set_up(monkeypatch):
    """The solve that warms the shapes returns no certified displacement
    (as a program that skips certification at the cell's size does): the
    run raises before its window, so it ends at once and prints no
    result."""
    from stan_tpu_torch.analysis import linear

    solve = linear.solve_linear_statics

    def uncertified(*a, **k):
        res = solve(*a, **k)
        res.u_certified = None
        return res

    monkeypatch.setattr(linear, "solve_linear_statics", uncertified)
    with pytest.raises(RuntimeError, match="no certified displacement"):
        harness.run_cell("le10-solve", 5, 0.2, False, device="cpu",
                         scale=(4, 2, 2))
