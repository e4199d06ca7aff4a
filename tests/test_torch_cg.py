"""Port parity: Jacobi PCG and float64 refinement of stan_tpu_torch against
stan_tpu.solvers.cg, in float64 on the CPU (iterations +-1, u to 1e-8)."""

import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stan_tpu.core import meshgen
from stan_tpu.fem import structured as jstructured
from stan_tpu.solvers import cg as jcg
from stan_tpu_torch import convert
from stan_tpu_torch.fem import stencil
from stan_tpu_torch.solvers import cg

F64 = torch.float64


def _operators(n=(4, 3, 3)):
    """The JAX structured operator and the port's twin built from its
    arrays, plus the masked load right-hand side of the beam."""
    m = meshgen.hex_beam(*n)
    jop = jstructured.build_structured_operator(m)
    op = convert.structured_operator_from_numpy(
        jop.nelems, np.asarray(jop.ke_lam), np.asarray(jop.ke_mu),
        np.asarray(jop.lam_e), np.asarray(jop.mu_e),
        np.asarray(jop.free_mask), jop.form, device="cpu")
    b = np.asarray(jop.free_mask) * np.asarray(
        jop.to_grid(jnp.asarray(m.load_vector())))
    return m, jop, op, b


@pytest.mark.parametrize("tol", [1e-6, 1e-10])
def test_pcg_matches_reference(tol):
    _, jop, op, b = _operators()
    ref = jax.jit(lambda b: jcg.pcg(jop.apply, b, diag=jop.diagonal(),
                                    tol=tol))(jnp.asarray(b))
    res = cg.pcg(op.apply, torch.as_tensor(b), diag=op.diagonal(), tol=tol)
    assert res.converged and bool(ref.converged)
    assert not res.diverged
    assert abs(res.iters - int(ref.iters)) <= 1
    want = np.asarray(ref.u)
    np.testing.assert_allclose(res.u.numpy(), want, rtol=1e-8,
                               atol=1e-8 * np.abs(want).max())
    assert res.residual <= tol * np.linalg.norm(b)


def test_maxiter_zero_means_ndof():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((6, 6))
    A = M @ M.T + 6 * np.eye(6)
    b = rng.standard_normal(6)
    At = torch.as_tensor(A)
    # tol 0 never converges, so the cap decides the count.
    res = cg.pcg(lambda x: At @ x, torch.as_tensor(b), tol=0.0, maxiter=0,
                 ndof=4)
    ref = jcg.pcg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), tol=0.0,
                  maxiter=0, ndof=4)
    assert res.iters == int(ref.iters) == 4
    assert cg.pcg(lambda x: At @ x, torch.as_tensor(b), tol=0.0,
                  maxiter=0).iters == 6  # ndof defaults to b.numel()
    short = cg.pcg(lambda x: At @ x, torch.as_tensor(b), tol=1e-12, maxiter=2)
    assert short.iters == 2 and not short.converged and not short.diverged
    full = cg.pcg(lambda x: At @ x, torch.as_tensor(b), tol=1e-12,
                  diag=torch.as_tensor(np.diag(A).copy()))
    assert full.converged
    np.testing.assert_allclose(full.u.numpy(), np.linalg.solve(A, b),
                               rtol=1e-9)
    zero = cg.pcg(lambda x: At @ x, torch.zeros(6, dtype=F64))
    assert zero.converged and zero.iters == 0


def test_divergence_guard_on_indefinite_operator():
    d = np.array([1.0, -1.0, 1.0, -1.0])
    b = np.ones(4)
    res = cg.pcg(lambda x: torch.as_tensor(d) * x, torch.as_tensor(b))
    ref = jcg.pcg(lambda x: jnp.asarray(d) * x, jnp.asarray(b))
    assert res.diverged and bool(ref.diverged)
    assert not res.converged and not bool(ref.converged)
    assert res.iters == int(ref.iters)


def _chain_laplacian(B, n=40):
    """B independent SPD systems A_c = (2 + s_c) I - shift - shift^T on a
    line of n points, applied elementwise (no BLAS), with their diagonals
    and right-hand sides of very different sizes."""
    s = torch.tensor([0.01, 0.3, 2.0, 0.05][:B], dtype=F64)[:, None]

    def A(x):  # x [B, n]
        left = torch.nn.functional.pad(x[:, :-1], (1, 0))
        right = torch.nn.functional.pad(x[:, 1:], (0, 1))
        return (2.0 + s) * x - left - right

    rng = np.random.default_rng(9)
    b = torch.as_tensor(rng.standard_normal((B, n))
                        * np.array([1.0, 1e3, 1e-3, 1.0])[:B, None])
    return A, (2.0 + s).expand(B, n).contiguous(), b


@pytest.mark.parametrize("tol", [1e-6, 1e-10])
def test_batched_pcg_equals_independent_solves(tol):
    """Each chain of a batched solve takes its own solve's iterations and
    ends on its residual, flags and u (same operations in the same order,
    so equal to the bit)."""
    A, diag, b = _chain_laplacian(4)
    b[3] = 0.0  # converged before the first iteration
    res = cg.pcg(A, b, diag=diag, tol=tol, batched=True)
    assert res.iters.shape == (4,) and res.iters[3] == 0
    for c in range(4):
        one = cg.pcg(lambda x: A(_pad_chain(x, c, 4))[c], b[c].clone(),
                     diag=diag[c], tol=tol)
        assert res.iters[c] == one.iters
        assert res.residual[c] == one.residual
        assert res.converged[c] == one.converged
        assert res.diverged[c] == one.diverged
        assert torch.equal(res.u[c], one.u)


def _pad_chain(x, c, B):
    """x as chain c of a batch of B (zeros elsewhere)."""
    out = x.new_zeros((B,) + x.shape)
    out[c] = x
    return out


def test_batched_pcg_cap_and_divergence_per_chain():
    A, diag, b = _chain_laplacian(3)
    res = cg.pcg(A, b, diag=diag, tol=1e-12, maxiter=5, batched=True)
    assert (res.iters == 5).all() and not res.converged.any()
    # One indefinite chain trips the guard alone; the others converge.
    d = torch.tensor([[1.0, -1.0, 1.0, -1.0], [1.0, 2.0, 3.0, 4.0],
                      [2.0, 2.0, 2.0, 2.0]], dtype=F64)
    res = cg.pcg(lambda x: d * x, torch.ones((3, 4), dtype=F64), batched=True)
    assert res.diverged.tolist() == [True, False, False]
    assert res.converged.tolist() == [False, True, True]
    one = cg.pcg(lambda x: d[0] * x, torch.ones(4, dtype=F64))
    assert res.iters[0] == one.iters and one.diverged


def test_batched_pcg_on_the_theta_operator():
    """The calibration's chain-batched stencil operator (one batched theta
    sweep per matvec) against each chain solved alone, at tol 1e-12:
    identical iteration counts, final residuals within 10% of the threshold
    of each other (both near the float64 floor there) and u to 1e-10 of
    max|u|. The two sides contract in other
    orders, so they agree to rounding, not to the bit; the elementwise
    operator above checks the bitwise contract."""
    from stan_tpu_torch.infer import forward

    fwd = forward.build_forward(meshgen.hex_beam(5, 4, 3), dtype=F64,
                                device="cpu")
    lam = torch.tensor([1.1e5, 2.3e5, 0.7e5], dtype=F64)
    mu = torch.tensor([7.9e4, 0.4e5, 1.6e5], dtype=F64)
    b = (fwd.free_mask * fwd.f0 * torch.tensor([1.0, 1e3, 1e-2],
                                               dtype=F64)[:, None, None, None,
                                                          None])
    matvec, diag = fwd.system(lam, mu)
    res = cg.pcg(matvec, b, diag=diag, tol=1e-12, batched=True)
    for c in range(3):
        matvec, diag = fwd.system(lam[c:c + 1], mu[c:c + 1])
        one = cg.pcg(matvec, b[c:c + 1], diag=diag, tol=1e-12)
        assert res.iters[c] == one.iters and res.converged[c]
        bnorm = float(torch.linalg.vector_norm(b[c]))
        assert abs(res.residual[c] - one.residual) <= 0.1 * 1e-12 * bnorm
        scale = float(one.u.abs().max())
        np.testing.assert_allclose(res.u[c].numpy(), one.u[0].numpy(),
                                   rtol=0, atol=1e-10 * scale)


def test_pcg_refined_reaches_f64_target():
    """float32 inner solves under the float64 true residual, on the CPU."""
    m = meshgen.hex_beam(5, 4, 4)
    lo = stencil.build_stencil_operator(m, dtype=torch.float32, device="cpu")
    hi = stencil.build_stencil_operator(m, dtype=F64, device="cpu")
    b64 = hi.free_mask * hi.to_grid(torch.as_tensor(m.load_vector()))
    base = cg.pcg(lo.apply, b64.to(torch.float32), diag=lo.diagonal(),
                  tol=1e-6)
    assert base.converged
    rr = cg.pcg_refined(lo.apply, b64, hi.apply, diag=lo.diagonal(), tol=1e-6,
                        x0=base.u, lo_dtype=torch.float32)
    assert rr.converged and rr.rel_residual <= 1e-6
    assert rr.u.dtype == F64
    true = float(torch.linalg.vector_norm(b64 - hi.apply(rr.u))
                 / torch.linalg.vector_norm(b64))
    assert true == pytest.approx(rr.rel_residual, rel=1e-9)
    # From a cold start the refinement needs at least one correction solve.
    cold = cg.pcg_refined(lo.apply, b64, hi.apply, diag=lo.diagonal(),
                          tol=1e-6, lo_dtype=torch.float32)
    assert cold.converged and cold.cycles >= 1 and cold.inner_iters > 0
    zero = cg.pcg_refined(lo.apply, torch.zeros_like(b64), hi.apply)
    assert zero.converged and zero.cycles == 0


def _block_cases():
    """(A, b, diag, tol, maxiter, x0) of each case the blocked loop must
    end as the per-iteration loop does."""
    m = meshgen.hex_beam(4, 3, 3)
    op = stencil.build_stencil_operator(m, dtype=torch.float32, device="cpu")
    b = (op.free_mask * op.to_grid(torch.as_tensor(
        m.load_vector(), dtype=torch.float32))).contiguous()
    x0 = 1e-4 * torch.as_tensor(np.random.default_rng(3).standard_normal(
        b.shape), dtype=torch.float32) * op.free_mask
    d = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=F64)
    return {
        "spd": (op.apply, b, op.diagonal(), 1e-6, 0, None),
        "maxiter": (op.apply, b, op.diagonal(), 1e-9, 7, None),
        "zero_rhs": (op.apply, torch.zeros_like(b), op.diagonal(), 1e-6, 0,
                     None),
        "x0": (op.apply, b, op.diagonal(), 1e-6, 0, x0),
        "met_at_start": (op.apply, b, op.diagonal(), 2.0, 0, None),
        "indefinite": (lambda x: d * x, torch.ones(4, dtype=F64), None, 1e-6,
                       0, None),
    }


def _bits(t):
    return t.view(torch.int64 if t.dtype == F64 else torch.int32)


@pytest.mark.parametrize("case", sorted(_block_cases()))
@pytest.mark.parametrize("k", [1, 3, 16])
def test_blocked_loop_equals_the_per_iteration_loop(case, k):
    """The CUDA path's loop (k iterations a block, the stopping test on the
    device, frozen after the stop), run eagerly here, against the loop
    that reads every iteration: the same count, residual, flags and u to
    the bit; at most k - 1 frozen iterations and one read a block besides
    the read before the loop."""
    A, b, diag, tol, maxiter, x0 = _block_cases()[case]
    one = cg._pcg_one(A, b, diag, tol, maxiter, None, x0, None)
    res = cg._pcg_blocks(A, b, diag, tol, maxiter, None, x0,
                         lambda *state: cg._Blocks(*state, k))
    assert (res.iters, res.residual, res.converged, res.diverged) == (
        one.iters, one.residual, one.converged, one.diverged)
    assert torch.equal(_bits(res.u), _bits(one.u))
    assert 0 <= res.frozen < k
    assert res.reads <= -(-res.iters // k) + 1
    assert one.reads == one.iters + 2 and one.frozen == 0
    want = {"maxiter": (7, False, False), "zero_rhs": (0, True, False),
            "met_at_start": (0, True, False),
            "indefinite": (one.iters, False, True)}.get(
        case, (one.iters, True, False))
    assert (res.iters, res.converged, res.diverged) == want


def _chain_cases(B):
    """(A, b, diag, tol, maxiter, x0) of each case the chain-batched blocks
    must end as the per-iteration batched loop does: B chains of A_c x =
    d_c x - c_c (shift x + shift^T x) on a line of 120 points, applied
    elementwise, with chains of very different conditioning (so they stop
    in different blocks) and right-hand sides of very different sizes; the
    last chain is the one a case sets apart."""
    n = 120
    s = torch.tensor([0.01, 0.3, 2.0, 0.05][:B], dtype=F64)[:, None]
    d, c = (2.0 + s).expand(B, n).contiguous(), torch.ones(B, 1, dtype=F64)

    def op(d, c):
        def A(x):
            left = torch.nn.functional.pad(x[:, :-1], (1, 0))
            right = torch.nn.functional.pad(x[:, 1:], (0, 1))
            return d * x - c * (left + right)
        return A

    rng = np.random.default_rng(11)
    b = torch.as_tensor(rng.standard_normal((B, n))
                        * np.array([1.0, 1e3, 1e-3, 1.0])[:B, None])
    zero = b.clone()
    zero[-1] = 0.0
    # The last chain starts at its solution, within 1e-10 of ||b||.
    K = np.diag(d[-1].numpy()) - np.eye(n, k=1) - np.eye(n, k=-1)
    x0 = torch.zeros_like(b)
    x0[-1] = torch.as_tensor(np.linalg.solve(K, b[-1].numpy()))
    # The last chain indefinite (alternating +-1, no coupling): its first
    # step divides by pAp = 0 and the guard stops it.
    d_bad, c_bad = d.clone(), c.clone()
    d_bad[-1] = torch.tensor([1.0, -1.0] * (n // 2), dtype=F64)
    c_bad[-1] = 0.0
    ones = torch.ones_like(b)
    return {
        "spread": (op(d, c), b, d, 1e-10, 0, None),
        "zero_rhs": (op(d, c), zero, d, 1e-10, 0, None),
        "met_at_start": (op(d, c), b, d, 1e-10, 0, x0),
        "cap_mid_block": (op(d, c), b, d, 1e-14, 7, None),
        "indefinite": (op(d_bad, c_bad), ones, None, 1e-10, 0, None),
    }


@pytest.mark.parametrize("case", sorted(_chain_cases(4)))
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("k", [1, 3, 16])
def test_chain_blocks_equal_the_batched_loop(case, B, k):
    """The CUDA path's chain-batched loop (k iterations a block, each
    chain's stopping test and freeze on the device, one read a block), run
    eagerly here, against the batched loop that reads every iteration: the
    same per-chain counts, residuals and flags, u to the bit; fewer than k
    iterations run past the slowest chain's stop, and one read a block
    besides the read before the loop."""
    A, b, diag, tol, maxiter, x0 = _chain_cases(B)[case]
    one = cg._pcg_batched(A, b, diag, tol, maxiter, None, x0, None)
    res = cg._pcg_chains(A, b, diag, tol, maxiter, None, x0,
                         lambda *state: (cg._ChainBlocks(*state, k), A))
    for name in ("iters", "residual", "converged", "diverged"):
        np.testing.assert_array_equal(getattr(res, name), getattr(one, name))
    assert torch.equal(_bits(res.u), _bits(one.u))
    assert 0 <= res.frozen < k
    assert res.reads <= -(-int(res.iters.max()) // k) + 1
    assert one.reads == one.iters.max() + 1 and one.frozen == 0
    last = {"zero_rhs": (0, True, False), "met_at_start": (0, True, False),
            "cap_mid_block": (7, False, False)}.get(case)
    if last is not None:
        assert (res.iters[-1], res.converged[-1], res.diverged[-1]) == last
    if case == "indefinite":
        assert res.diverged[-1] and not res.converged[-1]
        assert res.converged[:-1].all() and not res.diverged[:-1].any()
    if case == "spread" and B == 4:
        assert len({(n - 1) // cg.BLOCK for n in res.iters}) >= 3


def _calibration(m):
    from stan_tpu_torch.infer import calibrate, forward

    fwd = forward.build_forward(m, dtype=torch.float32, device="cpu",
                                cg_tol=1e-6)
    u = forward.displacement_fn(fwd, m.nelem)(torch.tensor(
        [np.log(190000.0), 0.28, 0.0])).numpy()
    nodes = np.argsort(-np.linalg.norm(u, axis=1))[:8]
    obs_nodes, obs_dirs = np.repeat(nodes, 3), np.tile([0, 1, 2], 8)
    y = u[obs_nodes, obs_dirs] * (1.0 + 0.01 * np.random.default_rng(
        5).standard_normal(24))
    return obs_nodes, obs_dirs, y, 0.01 * float(np.abs(y).max())


def _thetas(i):
    return torch.tensor(np.array([np.log(190000.0), 0.28, 0.0])
                        + np.random.default_rng(20 + i).normal(
                            0.0, 0.1, (4, 3)), dtype=torch.float32)


def _value_and_grad(logp, theta):
    theta = theta.clone().requires_grad_(True)
    v = logp(theta)
    v.sum().backward()
    return v.detach(), theta.grad


def test_static_parameters_are_refilled_every_call(monkeypatch):
    """The system path (the forward's system and parameters handed to pcg)
    with its blocks run eagerly on the CPU: three value-and-gradient calls
    at different θ on one StencilForwardProblem each equal the batched loop
    that builds the operator per call, to the bit, forward and adjoint,
    and the problem holds one capture, whose static parameters each call
    refills, for as long as the problem lives; the sharded forward, which
    passes dot, keeps the per-iteration loop."""
    from stan_tpu_torch.infer import calibrate, forward
    from stan_tpu_torch.parallel import distributed

    m = meshgen.hex_beam(7, 3, 3)  # 8 node planes: 2 slabs of 4
    obs = _calibration(m)
    prob = calibrate.make_problem(m, *obs, dtype=torch.float32,
                                  device="cpu", cg_tol=1e-6)
    assert isinstance(prob.fwd, forward.StencilForwardProblem)
    want = [_value_and_grad(prob.log_posterior, _thetas(i))
            for i in range(3)]
    monkeypatch.setattr(cg, "_blocked", lambda b: True)
    before = prob.fwd.stats.as_dict()
    for i in range(3):
        v, g = _value_and_grad(prob.log_posterior, _thetas(i))
        assert torch.equal(_bits(v), _bits(want[i][0]))
        assert torch.equal(_bits(g), _bits(want[i][1]))
        assert len(cg._captures(prob.fwd.system)) == 1
    d = prob.fwd.stats.since(before)
    assert d["forward_calls"] == d["adjoint_calls"] == 3
    for kind in ("forward", "adjoint"):
        assert d[f"{kind}_loop_iters"] > cg.BLOCK
        assert d[f"{kind}_reads"] <= (d[f"{kind}_loop_iters"] // cg.BLOCK
                                      + 2 * 3)
        assert 0 <= d[f"{kind}_frozen"] < 3 * cg.BLOCK

    def refuse(*a, **k):
        raise AssertionError("the sharded forward reached the system path")

    monkeypatch.setattr(cg, "_pcg_system", refuse)
    monkeypatch.setattr(cg._ChainBlocks, "step", refuse)
    mesh = distributed.device_mesh(2, 2, devices=["cpu"] * 4)
    sharded = calibrate.make_sharded_problem(m, mesh, *obs,
                                             dtype=torch.float32,
                                             cg_tol=1e-6)
    v, g = sharded.logp_grad_b()(_thetas(0))
    assert torch.isfinite(v).all() and torch.isfinite(g).all()
    st = sharded.fwd.stats
    assert st.forward_reads == st.forward_loop_iters + 1
    assert st.forward_frozen == 0
    # The captures hold their problem weakly: dropping it drops them.
    owner = id(prob.fwd)
    assert owner in cg._systems
    del prob
    gc.collect()
    assert owner not in cg._systems
