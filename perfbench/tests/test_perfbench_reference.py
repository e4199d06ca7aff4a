"""The plain reference against closed forms and against itself."""

import numpy as np
import pytest
import torch

from perfbench import mesh
from perfbench.reference import calib, fem


def _solve(beam, E, nu, direction, total, tol=1e-13):
    lam, mu = fem.lame(E, nu)
    op = fem.ElementOperator(beam.coords, beam.conn, beam.fixed_nodes, lam, mu)
    f = op.free * torch.as_tensor(beam.load(direction, total))
    u, _, rel = fem.cg(op.masked, f[None], op.diagonal(), tol=tol,
                       maxiter=100000)
    assert rel[0] <= tol
    return op, u[0], lam, mu


def test_element_stiffness_symmetric_and_rigid_free():
    ke = fem.element_stiffness((1.0, 2.0, 0.5), 3.0, 1.5)
    assert np.abs(ke - ke.T).max() <= 1e-12 * np.abs(ke).max()
    for d in range(3):
        shift = np.tile(np.eye(3)[d], 8)
        assert np.abs(ke @ shift).max() <= 1e-12 * np.abs(ke).max()
    assert np.all(np.linalg.eigvalsh(ke)[6:] > 0)  # six rigid modes only


def test_axial_bar_is_exact():
    """ν = 0, an axial tip load on a 1 x 1 section: u_x = P x / (E A) and
    σ_xx = P / A everywhere, the clamp's reactions sum to -P."""
    beam = mesh.hex_beam(8, 1, 1)
    E, P = 1000.0, 5.0
    op, u, lam, mu = _solve(beam, E, 0.0, (1.0, 0.0, 0.0), P)
    x = beam.coords[:, 0]
    assert np.abs(u[:, 0].numpy() - P * x / E).max() <= 1e-12
    assert np.abs(u[:, 1:].numpy()).max() <= 1e-12
    eps, sig, R = fem.recover(op, u, lam, mu)
    assert np.abs(sig[..., 0].numpy() - P).max() <= 1e-10
    assert np.abs(eps[..., 0].numpy() - P / E).max() <= 1e-12
    assert np.allclose(R[beam.fixed_nodes].sum(0).numpy(), [-P, 0, 0],
                       atol=1e-10)


def test_cantilever_tip_deflection_near_euler_bernoulli():
    """A 20 x 4 x 4 cantilever under a tip load: the deflection is
    P L^3 / (3 E I) to within the full-integration HEX8's known stiffness
    in bending (shear locking, from below): 0.97 of it at this mesh."""
    beam = mesh.hex_beam(20, 4, 4)
    E, P = 210000.0, 10.0
    _, u, _, _ = _solve(beam, E, 0.3, (0.0, 0.0, -1.0), P, tol=1e-12)
    ratio = -float(u[beam.tip_nodes, 2].mean()) / (P * 20 ** 3 / (3 * E * 4 * 4 ** 3 / 12))
    assert 0.95 < ratio < 1.0


def test_posterior_gradient_matches_finite_differences():
    beam = mesh.hex_beam(4, 2, 2)
    load = ((0.0, 0.0, -1.0), 10.0)
    nodes, dirs, y, sigma = calib.observations(
        beam, 190000.0, 0.28, load, 5, n_nodes=8, noise=0.01,
        threshold=0.3, device="cpu", tol=1e-13)
    post = calib.Posterior(beam, nodes, dirs, y, sigma, load,
                           mu_logE=np.log(210000.0), sigma_logE=1.0,
                           device="cpu", tol=1e-13)
    theta = np.array([[np.log(200000.0), 0.3, 0.0], [np.log(185000.0), 0.1, 0.2]])
    logp, grad = post.logp_grad(theta)
    h = 1e-6
    for d in range(2):
        up, dn = theta.copy(), theta.copy()
        up[:, d] += h
        dn[:, d] -= h
        fd = (post.logp_grad(up)[0] - post.logp_grad(dn)[0]) / (2 * h)
        assert np.allclose(grad[:, d], fd, rtol=1e-5, atol=1e-6 * np.abs(fd).max())
    assert np.all(grad[:, 2] == 0.0)  # the load scale takes no part


def test_extrapolation_reproduces_a_trilinear_field():
    """A field linear in each coordinate sampled at the Gauss points comes
    back exactly at the nodes."""
    W = fem.extrapolation()
    field = lambda p: 1.0 + 2 * p[:, 0] - p[:, 1] + 0.5 * p[:, 2] + p[:, 0] * p[:, 1]
    assert np.allclose(W @ field(fem.GAUSS), field(fem.SIGNS), atol=1e-13)
