"""Tests of the port's CUDA kernels and CUDA paths; they need a card.

They skip where torch sees no CUDA device. This file imports no jax and
nothing of stan_tpu, so it also runs where jax is not installed, without
the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from stan_tpu_torch.core import meshgen
from stan_tpu_torch.analysis.linear import solve_linear_statics
from stan_tpu_torch.fem import launches, stencil

pytestmark = pytest.mark.gpu

# The kernel and the plain version sum the same products in other orders.
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("flags", [(1, 1), (0, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("n,kw", [((4, 4, 3), {}),
                                  ((5, 4, 3), {"lx": 6.0, "ly": 1.5,
                                               "lz": 3.0})])
def test_kernel_matches_plain_version(n, kw, flags, dtype):
    _need_cuda()
    op = stencil.build_stencil_operator(meshgen.hex_beam(*n, **kw),
                                        dtype=dtype, device="cuda")
    rng = np.random.default_rng(sum(n))
    up = torch.as_tensor(rng.standard_normal(
        (3, *(k + 2 for k in op.node_shape))), dtype=dtype, device="cuda")
    before = launches.counts["stencil_sweep"]
    f = stencil.stencil_sweep(up, op.table, *flags)
    assert launches.counts["stencil_sweep"] == before + 1
    f_ref = stencil.stencil_sweep_reference(up, op.table, *flags)
    torch.cuda.synchronize()
    err = float((f - f_ref).abs().max())
    assert err <= RTOL[dtype] * float(f_ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("flags", [(1, 1), (0, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("n,sx", [((32, 32, 32), None), ((32, 32, 32), 1),
                                  ((6, 9, 140), None), ((13, 5, 37), 1)])
def test_stencil_kernel_tiling(n, sx, flags, dtype):
    """Shapes that stress the kernel's tiles: the 32^3 grid (35 y and z
    nodes, which no tile width divides), one x-plane (every plane a face),
    z over two tiles (141 nodes); random ghosts."""
    _need_cuda()
    op = stencil.build_stencil_operator(meshgen.hex_beam(*n), dtype=dtype,
                                        device="cuda")
    shape = op.node_shape if sx is None else (sx, *op.node_shape[1:])
    rng = np.random.default_rng(sum(n) + (sx or 0))
    up = torch.as_tensor(rng.standard_normal((3, *(k + 2 for k in shape))),
                         dtype=dtype, device="cuda")
    f = stencil.stencil_sweep(up, op.table, *flags)
    ref = stencil.stencil_sweep_reference(up, op.table, *flags)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(f).all())
    assert float((f - ref).abs().max()) <= RTOL[dtype] * float(
        ref.abs().max())


def test_kernel_refuses_bad_input():
    _need_cuda()
    op = stencil.build_stencil_operator(meshgen.hex_beam(3, 3, 3),
                                        dtype=torch.float32, device="cuda")
    up = torch.zeros((3, 6, 6, 6), device="cuda")
    with pytest.raises(TypeError):
        stencil.stencil_sweep(up.half(), op.table.half(), 1, 1)
    with pytest.raises(ValueError):
        stencil.stencil_sweep(up.transpose(1, 2), op.table, 1, 1)
    with pytest.raises(ValueError):
        stencil.stencil_sweep(up, op.table[:26], 1, 1)


def test_cuda_solve_matches_cpu_float64():
    _need_cuda()
    m_gpu, m_cpu = meshgen.hex_beam(8, 5, 4), meshgen.hex_beam(8, 5, 4)
    before = launches.counts["stencil_sweep"]
    res = solve_linear_statics(m_gpu, device="cuda")
    ref = solve_linear_statics(m_cpu, device="cpu", dtype=torch.float64)
    assert res.operator == ref.operator == "stencil"
    assert res.converged and res.true_residual <= 1e-6
    assert launches.counts["stencil_sweep"] - before >= res.iters
    scale = np.abs(ref.u).max()
    np.testing.assert_allclose(res.u_certified, ref.u, atol=1e-5 * scale)
    assert np.isfinite(res.stress).all() and np.isfinite(res.reactions).all()


def test_cuda_solve_is_certified_by_the_host_twin(monkeypatch):
    """The float32 stencil solve's certified residual is the host float64
    twin's reading of its u_certified, and no float64 sweep runs in it."""
    from stan_tpu_torch.fem import hostops

    _need_cuda()
    m = meshgen.hex_beam(8, 5, 4)
    op = stencil.build_stencil_operator(m, dtype=torch.float32,
                                        device="cuda")
    sweep, dtypes = stencil.stencil_sweep, []

    def counted(up, *args):
        dtypes.append(up.dtype)
        return sweep(up, *args)

    monkeypatch.setattr(stencil, "stencil_sweep", counted)
    before = launches.counts["stencil_sweep"]
    res = solve_linear_statics(m, device="cuda")
    assert res.operator == "stencil" and res.converged
    # The wrapper sees the calls outside the CG's CUDA graph and the ones
    # that recorded it; the counter also counts the graph's replays.
    assert set(dtypes) == {torch.float32}
    assert (launches.counts["stencil_sweep"] - before
            >= res.iters + res.refine_iters)
    twin = hostops.masked_f64_apply(m, op)
    b = op.free_mask.cpu().double() * op.to_grid(
        torch.as_tensor(m.load_vector())).cpu()
    u = op.to_grid(torch.as_tensor(res.u_certified)).numpy()
    rel = np.linalg.norm(b.numpy() - twin(u)) / np.linalg.norm(b.numpy())
    assert res.true_residual == pytest.approx(rel, rel=1e-9)
    assert res.true_residual <= 1e-6


def _theta_case(n, kw, dtype, B, seed, sx=None):
    """Unit tables of hex_beam(*n, **kw), random slabs of B chains (of sx
    x-planes if given) with random ghosts, and random coefficients."""
    from stan_tpu_torch.fem import structured

    base = structured.build_structured_operator(
        meshgen.hex_beam(*n, **kw), dtype=torch.float64, device="cuda")
    t2 = stencil.pack_theta_tables(
        stencil.signature_tables(base.ke_lam.cpu().numpy()),
        stencil.signature_tables(base.ke_mu.cpu().numpy()), dtype, "cuda")
    shape = base.node_shape if sx is None else (sx, *base.node_shape[1:])
    rng = np.random.default_rng(seed)
    up = torch.as_tensor(rng.standard_normal(
        (B, 3, *(k + 2 for k in shape))), dtype=dtype, device="cuda")
    coef = torch.as_tensor(np.stack([rng.uniform(5e4, 2e5, B),
                                     rng.uniform(3e4, 1e5, B)], axis=1),
                           dtype=dtype, device="cuda")
    return up, t2, coef


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("flags", [(1, 1), (0, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("n,kw", [((4, 4, 3), {}),
                                  ((5, 4, 3), {"lx": 6.0, "ly": 1.5,
                                               "lz": 3.0})])
def test_theta_kernels_match_plain_version(n, kw, flags, dtype):
    _need_cuda()
    up, t2, coef = _theta_case(n, kw, dtype, 3, sum(n))
    before = launches.snapshot()
    f_b = stencil.theta_sweep_batched(up, t2, coef, *flags)
    f_1 = stencil.theta_sweep(up[1], t2, coef[1], *flags)
    delta = launches.snapshot() - before
    assert (delta["theta_sweep"], delta["theta_sweep_batched"]) == (1, 1)
    ref = stencil.theta_sweep_reference(up, t2, coef, *flags)
    torch.cuda.synchronize()
    for b in range(3):
        assert float((f_b[b] - ref[b]).abs().max()) <= RTOL[dtype] * float(
            ref[b].abs().max())
    assert float((f_1 - ref[1]).abs().max()) <= RTOL[dtype] * float(
        ref[1].abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("flags", [(1, 1), (0, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("n,sx", [((32, 32, 32), None), ((32, 32, 32), 1),
                                  ((6, 9, 140), None), ((13, 5, 37), 1)])
def test_theta_kernel_tiling(n, sx, B, flags, dtype):
    """Shapes that stress the kernel's tiles: the calibration grid (35 y and
    z nodes, which no tile width divides), one x-plane (every plane a face),
    z over two tiles (141 nodes), one chain and sixteen."""
    _need_cuda()
    up, t2, coef = _theta_case(n, {}, dtype, B, sum(n) + B, sx)
    f = (stencil.theta_sweep(up[0], t2, coef[0], *flags)[None] if B == 1
         else stencil.theta_sweep_batched(up, t2, coef, *flags))
    ref = stencil.theta_sweep_reference(up, t2, coef, *flags)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(f).all())
    assert float((f - ref).abs().max()) <= RTOL[dtype] * float(
        ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_theta_kernel_at_cli_smc_width(dtype):
    """One theta_sweep_batched launch at B = 256, the particle count of `cli
    calibrate --sampler smc` ([256, 3, 35, 35, 35] at 32^3), against the
    plain version in float64 on the CPU (in chunks of 32 chains)."""
    _need_cuda()
    up, t2, coef = _theta_case((32, 32, 32), {}, dtype, 256, 256)
    f = stencil.theta_sweep_batched(up, t2, coef, 1, 1).cpu()
    up64, t64, c64 = (x.cpu().double() for x in (up, t2, coef))
    for b in range(0, 256, 32):
        ref = stencil.theta_sweep_reference(up64[b:b + 32], t64,
                                            c64[b:b + 32], 1, 1)
        assert bool(torch.isfinite(f[b:b + 32]).all())
        assert float((f[b:b + 32].double() - ref).abs().max()) <= RTOL[
            dtype] * float(ref.abs().max())


def test_theta_kernels_refuse_bad_input():
    _need_cuda()
    up, t2, coef = _theta_case((3, 3, 3), {}, torch.float32, 2, 0)
    with pytest.raises(TypeError):
        stencil.theta_sweep_batched(up, t2, coef.double(), 1, 1)
    with pytest.raises(ValueError):
        stencil.theta_sweep_batched(up.transpose(3, 4), t2, coef, 1, 1)
    with pytest.raises(ValueError):
        stencil.theta_sweep_batched(up, t2[:1], coef, 1, 1)
    with pytest.raises(ValueError):
        stencil.theta_sweep_batched(up, t2, coef[:1], 1, 1)
    with pytest.raises(ValueError):
        stencil.theta_sweep(up[0], t2, coef[0].cpu(), 1, 1)


def test_chain_batched_solve_matches_cpu_float64():
    """16 chains solved at once on the card (float32, tol 1e-6) against the
    CPU float64 solve of the same θ (tol 1e-10), to 1e-4 of max|u|: the
    float32 solve stops at a relative residual of 1e-6, which the grid's
    conditioning turns into an error of about 1e-5 of max|u|."""
    _need_cuda()
    from stan_tpu_torch.infer import forward

    m = meshgen.hex_beam(8, 5, 4)
    rng = np.random.default_rng(3)
    thetas = np.stack([np.log(190000.0) + 0.2 * rng.standard_normal(16),
                       0.28 + 0.05 * rng.standard_normal(16),
                       0.1 * rng.standard_normal(16)], axis=1)
    gpu = forward.build_forward(m, device="cuda", cg_tol=1e-6)
    cpu = forward.build_forward(m, dtype=torch.float64, device="cpu",
                                cg_tol=1e-10)
    before = launches.counts["theta_sweep_batched"]
    u = forward.displacement_fn(gpu, m.nelem)(
        torch.as_tensor(thetas, device="cuda")).cpu().numpy()
    ref = forward.displacement_fn(cpu, m.nelem)(
        torch.as_tensor(thetas)).numpy()
    st = gpu.stats
    assert st.forward_solves == 16 and st.forward_unconverged == 0
    assert (launches.counts["theta_sweep_batched"] - before
            >= st.forward_loop_iters)
    for c in range(16):
        assert np.abs(u[c] - ref[c]).max() <= 1e-4 * np.abs(ref[c]).max()


def test_stencil_opt_in_on_every_device():
    """stencil_sweep at the 71^3 float32 shape ([3, 73, 73, 73], about
    59 KB of dynamic shared memory, above the 48 KB default) on every
    visible device in one process, in the order 0, 1, ...: the kernel's
    shared-memory opt-in is kept per device, so each card gets its own."""
    _need_cuda()
    tables = stencil.build_stencil_operator(
        meshgen.hex_beam(4, 4, 3), dtype=torch.float64, device="cpu").tables
    rng = np.random.default_rng(71)
    up_np = rng.standard_normal((3, 73, 73, 73))
    for d in range(torch.cuda.device_count()):
        dev = torch.device("cuda", d)
        table = stencil.pack_tables(tables, torch.float32, dev)
        up = torch.as_tensor(up_np, dtype=torch.float32, device=dev)
        f = stencil.stencil_sweep(up, table, 1, 1)
        ref = stencil.stencil_sweep_reference(up, table, 1, 1)
        torch.cuda.synchronize(dev)
        assert f.device == dev and bool(torch.isfinite(f).all())
        assert float((f - ref).abs().max()) <= RTOL[torch.float32] * float(
            ref.abs().max())


def test_fields_on_cuda_match_cpu_float64():
    _need_cuda()
    from stan_tpu_torch.post import fields

    m = meshgen.hex_beam(6, 5, 4)
    solve_linear_statics(m, device="cpu", dtype=torch.float64)
    got = fields.compute_all(m, 1, device="cuda")
    ref = fields.compute_all(m, 1, device="cpu")
    assert list(got) == list(ref) and len(got) == 96
    for name, want in ref.items():
        assert np.abs(got[name] - want).max() <= 1e-12 * max(
            np.abs(want).max(), 1e-300), name


@pytest.mark.parametrize("sampler", ["vi", "smc"])
def test_cli_calibrate_on_cuda(tmp_path, monkeypatch, sampler):
    """`cli calibrate --sampler vi|smc --device cuda` on a 4^3 STdb, short:
    5 ADVI steps; SMC with its 256 particles (4 chains), 1 Metropolis
    step and at most 2 stages. Exit code 0, and the batched kernel ran."""
    _need_cuda()
    pytest.importorskip("google.protobuf")
    import functools

    from stan_tpu_torch import cli
    from stan_tpu_torch.infer import smc
    from stan_tpu_torch.io import stdb

    monkeypatch.setattr(smc, "run_smc", functools.partial(
        smc.run_smc, n_mcmc=1, max_stages=2))
    path = str(tmp_path / "beam.STdb")
    stdb.write(meshgen.hex_beam(4, 4, 4), path)
    before = launches.counts["theta_sweep_batched"]
    assert cli.main(["calibrate", path, "--synthetic", "--sampler", sampler,
                     "--chains", "4", "--samples", "5",
                     "--device", "cuda"]) == 0
    assert launches.counts["theta_sweep_batched"] > before


def test_nuts_transition_on_cuda():
    """One NUTS transition of 4 chains on a 4^3 beam's posterior on the
    card: finite states and 1..2^max_depth - 1 gradient evaluations per
    chain."""
    _need_cuda()
    from stan_tpu_torch.infer import calibrate, forward, hmc, nuts

    m = meshgen.hex_beam(4, 4, 4)
    fwd = forward.build_forward(m, device="cuda", cg_tol=1e-6)
    u = forward.displacement_fn(fwd, m.nelem)(torch.tensor(
        [np.log(190000.0), 0.28, 0.0], device="cuda")).cpu().numpy()
    nodes = np.argsort(np.abs(u).max(axis=1))[-8:]
    prob = calibrate.make_problem(m, nodes, np.full(8, 2), u[nodes, 2],
                                  1e-3 * np.abs(u).max(), device="cuda",
                                  cg_tol=1e-6)
    theta = torch.tensor([[np.log(200000.0), 0.1, 0.0]] * 4, device="cuda",
                         dtype=torch.float64)
    target = hmc.guarded_logp_grad_b(prob.log_posterior)
    state = hmc.HMCState(theta, *target(theta))
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_depth = 4
    new, accept, n_evals = nuts.nuts_transition(
        target, gen, state, torch.full((4,), 0.02, dtype=torch.float64,
                                       device="cuda"),
        torch.ones_like(theta), max_depth)
    assert all(bool(torch.isfinite(t).all()) for t in new)
    assert ((n_evals >= 1) & (n_evals <= 2 ** max_depth - 1)).all()
    assert ((accept >= 0) & (accept <= 1)).all()


@pytest.mark.parametrize("solver", ["Cholesky", "LU"])
def test_cuda_dense_direct_matches_cpu_float64(solver):
    """The dense direct path on the card, float32 and float64, against the
    CPU's float64 solve of a TET4 model."""
    _need_cuda()
    from chip_smoke import tet_split

    ref_m = tet_split(meshgen.hex_beam(6, 4, 4))
    ref_m.analysis.lin_solver = solver
    ref = solve_linear_statics(ref_m, device="cpu", dtype=torch.float64)
    scale = np.abs(ref.u).max()
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        m = tet_split(meshgen.hex_beam(6, 4, 4))
        m.analysis.lin_solver = solver
        res = solve_linear_statics(m, device="cuda", dtype=dtype)
        assert res.operator == ref.operator == f"dense-{solver.lower()}"
        assert np.abs(res.u - ref.u).max() <= tol * scale
        assert res.true_residual <= (1e-12 if dtype == torch.float64
                                     else 1e-4)


def test_cuda_newton_increment_matches_cpu_float64():
    """One load increment of the Total-Lagrangian Newton solve on the card
    (float32) against the CPU's float64 solve."""
    _need_cuda()
    from stan_tpu_torch.analysis.nonlinear import solve_nonlinear_statics

    runs = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        m = meshgen.hex_beam(6, 3, 3, load=(0.0, 0.0, -3000.0))
        m.analysis.inc_numb = 1
        runs[device] = solve_nonlinear_statics(m, device=device, dtype=dtype)
    res, ref = runs["cuda"], runs["cpu"]
    assert res.converged and ref.converged and ref.newton_iters[0] >= 2
    assert abs(int(res.newton_iters[0]) - int(ref.newton_iters[0])) <= 1
    assert np.abs(res.u - ref.u).max() <= 1e-4 * np.abs(ref.u).max()


def test_cuda_general_forward_gradient_matches_cpu_float64():
    """A 4-chain gradient of Σu² through the general forward
    (prefer_stencil=False) on the card in float64 against the CPU's."""
    _need_cuda()
    from stan_tpu_torch.infer import forward

    m = meshgen.hex_beam(6, 4, 4)
    thetas = np.array([np.log(190000.0), 0.28, 0.0]) + np.random.default_rng(
        4).normal(0.0, 0.05, (4, 3))
    got = {}
    for device in ("cuda", "cpu"):
        fwd = forward.build_forward(m, dtype=torch.float64, device=device,
                                    cg_tol=1e-12, prefer_stencil=False)
        assert isinstance(fwd, forward.ForwardProblem)
        th = torch.tensor(thetas, device=device, requires_grad=True)
        u = forward.displacement_fn(fwd, m.nelem)(th)
        torch.sum(u ** 2).backward()
        got[device] = (u.detach().cpu().numpy(), th.grad.cpu().numpy())
    for a, b in zip(got["cuda"], got["cpu"]):
        assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max()


def _mesh(devices, n_chains, n_domain):
    from stan_tpu_torch.parallel import distributed

    return distributed.device_mesh(n_chains, n_domain,
                                   devices=[devices] * (n_chains * n_domain))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_apply_on_cuda_matches_cpu_slabs(dtype):
    """The x-slab stencil apply on [cuda:0] * 3 (one stencil_sweep launch
    per slab, flags (1,0), (0,0), (0,1)) against the same three slabs on
    the CPU (the plain sweep)."""
    _need_cuda()
    from stan_tpu_torch.parallel import sharded_stencil as ss

    m = meshgen.hex_beam(8, 4, 3)  # NNX = 9: three slabs of 3 planes
    u = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (3, 9, 5, 4)), dtype=dtype)
    got = {}
    for dev in ("cuda", "cpu"):
        op = ss.build_sharded_stencil_operator(m, 3, dtype=dtype, device=dev)
        before = launches.counts["stencil_sweep"]
        got[dev] = ss.sharded_apply(_mesh(dev, 1, 3), op, u.to(dev)).cpu()
        assert (launches.counts["stencil_sweep"] - before
                == (3 if dev == "cuda" else 0))
    err = float((got["cuda"] - got["cpu"]).abs().max())
    assert err <= RTOL[dtype] * float(got["cpu"].abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_theta_apply_on_cuda_matches_cpu_slabs(dtype):
    """The sharded forward's masked slab matvec (halo planes, then one theta
    sweep per slab with its flags) on [cuda:0] * 3 for 2 chains (batched
    launches) and for 1 chain (theta_sweep), against the CPU slabs."""
    _need_cuda()
    from stan_tpu_torch.infer import forward

    m = meshgen.hex_beam(8, 4, 3)
    rng = np.random.default_rng(10)
    for chains in (2, 1):
        u = torch.as_tensor(rng.standard_normal((chains, 3, 9, 5, 4)),
                            dtype=dtype)
        coef = torch.as_tensor([[1.3e5, 6.1e4], [1.1e5, 8.0e4]][:chains],
                               dtype=dtype)
        got = {}
        for dev in ("cuda", "cpu"):
            mesh = _mesh(dev, 1, 3)
            fwd = forward.build_sharded_stencil_forward(m, mesh, dtype=dtype)
            before = launches.snapshot()
            out = fwd._sweeps(coef.to(dev), mesh.split(u.to(dev), 2,
                                                       chains=True), True)
            got[dev] = out.gather().cpu()
            if dev == "cuda":
                delta = launches.snapshot() - before
                assert (delta["theta_sweep"], delta["theta_sweep_batched"]) \
                    == ((0, 3) if chains == 2 else (3, 0))
        err = float((got["cuda"] - got["cpu"]).abs().max())
        assert err <= RTOL[dtype] * float(got["cpu"].abs().max())


def test_sharded_logp_grad_on_cuda_matches_cpu_float64():
    """The chains x domain log posterior and gradient on a 2 x 3 mesh of
    [cuda:0] * 6 against the same mesh of CPU slabs, float64."""
    _need_cuda()
    from stan_tpu_torch.infer import calibrate

    m = meshgen.hex_beam(8, 3, 3)
    nodes = np.arange(m.nnode - 12, m.nnode)
    obs = (np.repeat(nodes, 3), np.tile([0, 1, 2], 12),
           np.full(36, -1e-4), 1e-5)
    thetas = np.array([np.log(190000.0), 0.28, 0.0]) + np.random.default_rng(
        5).normal(0.0, 0.05, (4, 3))
    got = {}
    for dev in ("cuda", "cpu"):
        prob = calibrate.make_sharded_problem(
            m, _mesh(dev, 2, 3), *obs, dtype=torch.float64, cg_tol=1e-12)
        v, g = prob.logp_grad_b()(torch.as_tensor(thetas, device=dev))
        got[dev] = (v.cpu().numpy(), g.cpu().numpy())
    for a, b in zip(got["cuda"], got["cpu"]):
        assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max()


def test_sharded_solves_across_cards():
    """One slab per visible card (two or more): the x-slab CG and the ring
    general CG, with halo copies between cards, against the same slabs on
    cuda:0 alone (the same operations: equal to rounding), and
    solve_linear_statics(n_domain=N) routed to the N cards. Skips on a
    one-card host."""
    _need_cuda()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards: the slabs copy between cards")
    from stan_tpu_torch.parallel import distributed, sharded
    from stan_tpu_torch.parallel import sharded_stencil as ss

    m = meshgen.hex_beam(4 * n - 1, 4, 4)  # NNX = 4n
    cards = distributed.device_mesh(1, n)
    one = _mesh("cuda:0", 1, n)
    op = ss.build_sharded_stencil_operator(m, n, dtype=torch.float64,
                                           device="cuda")
    f = op.free_mask.new_tensor(m.load_vector()).reshape(
        4 * n, 5, 5, 3).permute(3, 0, 1, 2).contiguous()
    a, b = (ss.sharded_stencil_pcg(mesh, op, f, tol=1e-12)
            for mesh in (cards, one))
    assert a.converged and a.iters == b.iters
    assert float((a.u - b.u).abs().max()) <= 1e-12 * float(b.u.abs().max())
    gop, part = sharded.build_sharded_operator(
        m.coords, m.conn, m.elem_d_matrices(), m.fix_mask(),
        m.formulation(), n, dtype=torch.float64, device="cuda")
    fp = gop.free_mask.new_tensor(sharded.shard_rhs(part, m.load_vector()))
    a, b = (sharded.sharded_pcg(mesh, gop, fp, tol=1e-12)
            for mesh in (cards, one))
    assert a.converged and gop.ring
    assert float((a.u - b.u).abs().max()) <= 1e-12 * float(b.u.abs().max())
    res = solve_linear_statics(m, device="cuda", n_domain=n, store=False)
    assert res.operator == f"sharded-stencilx{n}" and res.n_domain == n
    assert res.converged and res.true_residual <= 1e-6


def _placed_problems(mesh):
    """make_problem on hex_beam(4, 3, 3) in float64 on `mesh`, and the same
    problem on cuda:0 without a mesh."""
    from stan_tpu_torch.infer import calibrate

    m = meshgen.hex_beam(4, 3, 3)
    nodes = np.arange(m.nnode - 12, m.nnode)
    obs = (np.repeat(nodes, 3), np.tile([0, 1, 2], 12),
           np.full(36, -1e-4), 1e-5)
    kw = dict(dtype=torch.float64, cg_tol=1e-12)
    return (calibrate.make_problem(m, *obs, mesh=mesh, **kw),
            calibrate.make_problem(m, *obs, device="cuda", **kw))


def _placed_vs_unplaced(mesh):
    from stan_tpu_torch.infer import hmc

    placed, unplaced = _placed_problems(mesh)
    thetas = torch.as_tensor(np.array([np.log(190000.0), 0.28, 0.0])
                             + np.random.default_rng(6).normal(
                                 0.0, 0.05, (4, 3)), device="cuda")
    got = [lgb(thetas) for lgb in (
        mesh.by_rows(hmc.guarded_logp_grad_b(placed.log_posterior)),
        hmc.guarded_logp_grad_b(unplaced.log_posterior))]
    for a, b in zip(*got):
        assert a.device == b.device == thetas.device
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())
    assert placed.fwd.stats.forward_solves == 4
    return placed


def test_placed_posterior_on_cuda_matches_unplaced():
    """make_problem(mesh=) on [cuda:0] * 2: one forward, each row's chains
    solved as one batch on the card (theta_sweep_batched), the log
    posterior and gradient within 1e-10 of the unplaced problem's."""
    _need_cuda()
    before = launches.counts["theta_sweep_batched"]
    placed = _placed_vs_unplaced(_mesh("cuda:0", 2, 1))
    assert placed.row_fwds == ()
    assert launches.counts["theta_sweep_batched"] > before


def test_placed_posterior_across_cards():
    """make_problem(mesh=) over two cards: a forward on each, one
    SolveStats, row 1's chains solved on cuda:1. Skips on a one-card
    host."""
    _need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards: one forward per card")
    from stan_tpu_torch.parallel import distributed

    placed = _placed_vs_unplaced(distributed.device_mesh(2, 1))
    (other,) = placed.row_fwds
    assert other.device == torch.device("cuda", 1)
    assert other.stats is placed.fwd.stats


def test_cli_calibrate_refuses_a_mesh_beyond_the_cards(tmp_path, capsys):
    """A [sharding] mesh that needs more cards than are visible exits with
    code 2 and the ERROR line (chains = 2 on a one-card host); it is never
    repeated on cuda:0."""
    _need_cuda()
    pytest.importorskip("google.protobuf")
    from stan_tpu_torch import cli
    from stan_tpu_torch.io import stdb

    path = str(tmp_path / "beam.STdb")
    stdb.write(meshgen.hex_beam(3, 2, 2), path)
    cfg = tmp_path / "run.toml"
    n = torch.cuda.device_count() + 1
    cfg.write_text(f"[sharding]\nchains = {n}\n")
    assert cli.main(["calibrate", path, "--synthetic", "--sampler", "hmc",
                     "--chains", str(n), "--warmup", "1", "--samples", "2",
                     "--config", str(cfg), "--device", "cuda"]) == 2
    text = capsys.readouterr().out
    assert f"ERROR: [sharding] mesh {n}x1 needs {n} devices" in text
    assert "POSTERIOR" not in text


# Several processes (tests/torch_multiprocess_worker.py): two ranks on the
# card(s), against the one-process mesh of the same shape, bit for bit.
_TWO_RANK_SCENARIOS = ["dot", "stencil", "chains", "general"]


def _two_ranks_match_one_process(tmp_path, device, backend, one_process):
    import torch_multiprocess_worker as worker

    worker.spawn(tmp_path, device, backend, _TWO_RANK_SCENARIOS)
    for name in _TWO_RANK_SCENARIOS:
        ref = worker.SCENARIOS[name](one_process)
        for rank in (0, 1):
            got = worker.load(tmp_path, name, rank)
            for key, want in ref.items():
                if key != "describe":
                    np.testing.assert_array_equal(got[key], want,
                                                  err_msg=f"{name}.{key}")
    assert f"{backend})" in str(worker.load(tmp_path, "dot", 0)["describe"])


def test_two_ranks_on_one_card_over_gloo(tmp_path):
    """Two processes on cuda:0 over gloo, every CUDA tensor staged through
    pinned host memory: the dots, the x-slab stencil CG with the halo
    across the processes (stencil_sweep per slab), the chains x domain CG
    and the general ring and all-gather give the bits of one process's
    [cuda:0] * 4 mesh."""
    _need_cuda()
    _two_ranks_match_one_process(tmp_path, "cuda:0", "gloo",
                                 ["cuda:0"] * 4)


def test_two_ranks_over_nccl(tmp_path):
    """Rank r on cuda:r over NCCL against one process's mesh of the same
    cards. Skips on a one-card host, where NCCL refuses two ranks on one
    card (tests/test_torch_multiprocess.py checks the refusal)."""
    _need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more cards: NCCL gives each rank its own")
    _two_ranks_match_one_process(tmp_path, "cuda:{rank}", "nccl",
                                 ["cuda:0", "cuda:0", "cuda:1", "cuda:1"])


def test_nccl_refuses_two_ranks_on_one_card(tmp_path):
    """Two ranks that both name cuda:0 under NCCL meet in the rendezvous
    store (the card's UUID) and both raise before any collective, naming
    gloo; nothing is joined."""
    from concurrent.futures import ThreadPoolExecutor

    from stan_tpu_torch.parallel import distributed

    _need_cuda()
    init = f"file://{tmp_path / 'rendezvous'}"

    def rank(r):
        with pytest.raises(ValueError, match=r"ranks 0 and 1 on one card "
                           r"\(cuda:0 of rank 0, cuda:0 of rank 1\).*"
                           r"backend='gloo'"):
            distributed.initialize(init, 2, r, backend="nccl",
                                   local_devices=["cuda:0"], timeout=60.0)

    with ThreadPoolExecutor(2) as pool:
        list(pool.map(rank, (0, 1)))
    assert distributed.process_count() == 1 and distributed.backend() is None


@pytest.mark.parametrize("n,kw", [((6, 5, 4), {}),
                                  ((4, 2, 2), {"lx": 6.0, "ly": 1.5,
                                               "lz": 3.0})])
def test_exact_operator_on_cuda_matches_apply_numpy(n, kw):
    """The exact-table float64 apply on the card (the sweep's double
    instantiation) against the host sweep, to 1e-12 of max|f|."""
    _need_cuda()
    m = meshgen.hex_beam(*n, **kw)
    ex = stencil.build_stencil_operator(m, dtype=torch.float64,
                                        device="cuda")
    tables, deltas = stencil.exact_tables(m)
    free = ex.free_mask.cpu().numpy()
    u = np.random.default_rng(sum(n)).standard_normal((3, *ex.node_shape))
    before = launches.counts["stencil_sweep"]
    f = ex.apply(torch.as_tensor(u, device="cuda")).cpu().numpy()
    assert launches.counts["stencil_sweep"] == before + 1
    want = free * stencil.apply_numpy(tables, deltas, free * u) + (
        1.0 - free) * u
    assert np.abs(f - want).max() <= 1e-12 * np.abs(want).max()


def test_certified_solve_on_cuda_matches_cpu():
    """pcg_certified on the card (float32 corrections, float64 residual,
    both on the kernel) against the same solve on the CPU: cycles within
    one, and both certified by the host float64 twin."""
    _need_cuda()
    from stan_tpu_torch.fem import hostops
    from stan_tpu_torch.solvers import cg

    m = meshgen.hex_beam(12, 6, 6)
    runs = {}
    for dev in ("cpu", "cuda"):
        op = stencil.build_stencil_operator(m, dtype=torch.float32,
                                            device=dev)
        ex = stencil.build_stencil_operator(m, dtype=torch.float64,
                                            device=dev)
        b = ex.free_mask * ex.to_grid(torch.as_tensor(
            m.load_vector(), dtype=torch.float64, device=dev))
        before = launches.counts["stencil_sweep"]
        res = cg.pcg_certified(op.apply, b, ex.apply, diag=op.diagonal(),
                               tol=1e-6, ndof=3 * m.nnode)
        if dev == "cuda":
            assert (launches.counts["stencil_sweep"] - before
                    >= res.inner_iters + res.cycles)
        host = hostops.masked_f64_apply(m, op)
        b_np = b.cpu().numpy()
        true_rel = np.linalg.norm(b_np - host(res.u.cpu().numpy())) / (
            np.linalg.norm(b_np))
        assert res.u.device.type == dev
        assert res.converged and res.rel_residual <= 1e-6
        assert true_rel <= 1.2e-6
        runs[dev] = res
    assert abs(runs["cuda"].cycles - runs["cpu"].cycles) <= 1


def _graph_case(n):
    """The float32 stencil operator of hex_beam(*n) on the card, its
    diagonal and its masked tip load."""
    m = meshgen.hex_beam(*n)
    op = stencil.build_stencil_operator(m, dtype=torch.float32,
                                        device="cuda")
    b = (op.free_mask * op.to_grid(torch.as_tensor(
        m.load_vector(), dtype=torch.float32, device="cuda"))).contiguous()
    return op, op.diagonal(), b


def _eager_dot(u, v):
    """The default reduction, passed as dot: pcg then reads every
    iteration (the loop of the sharded solves)."""
    return torch.sum(u * v)


@pytest.mark.parametrize("n", [(20, 20, 20), (70, 70, 70)])
def test_graph_cg_equals_the_eager_loop(n):
    """The CUDA path's replayed blocks against the loop that reads every
    iteration, on one operator: the same iterations, residual and flags,
    u to the bit; a replayed solve launches the eager solve's sweeps plus
    one per frozen iteration."""
    from stan_tpu_torch.solvers import cg

    _need_cuda()
    op, diag, b = _graph_case(n)
    cg.pcg(op.apply, b, diag=diag, tol=1e-6)  # captures
    before = launches.counts["stencil_sweep"]
    eager = cg.pcg(op.apply, b, diag=diag, tol=1e-6, dot=_eager_dot)
    eager_launches = launches.counts["stencil_sweep"] - before
    before = launches.counts["stencil_sweep"]
    res = cg.pcg(op.apply, b, diag=diag, tol=1e-6)
    graph_launches = launches.counts["stencil_sweep"] - before
    assert eager.converged and eager.iters > cg.BLOCK
    assert (res.iters, res.residual, res.converged, res.diverged) == (
        eager.iters, eager.residual, eager.converged, eager.diverged)
    assert torch.equal(res.u.view(torch.int32), eager.u.view(torch.int32))
    assert 0 <= res.frozen < cg.BLOCK
    assert res.reads <= -(-res.iters // cg.BLOCK) + 1
    assert (eager.reads, eager.frozen) == (eager.iters + 2, 0)
    assert eager_launches == eager.iters + 1
    assert graph_launches == eager_launches + res.frozen


def test_certified_solve_captures_once(monkeypatch):
    """pcg_certified twice on one operator: every inner solve of both runs
    replays the one capture."""
    from stan_tpu_torch.solvers import cg

    _need_cuda()
    op, diag, b = _graph_case((12, 6, 6))
    ex = stencil.build_stencil_operator(meshgen.hex_beam(12, 6, 6),
                                        dtype=torch.float64, device="cuda")
    capture, captures = cg._Blocks.capture, []

    def counted(self, A):
        captures.append(A)
        return capture(self, A)

    monkeypatch.setattr(cg._Blocks, "capture", counted)
    runs = [cg.pcg_certified(op.apply, b.double(), ex.apply, diag=diag,
                             tol=1e-6) for _ in range(2)]
    assert all(r.converged for r in runs) and runs[0].cycles >= 2
    assert runs[0].inner_iters == runs[1].inner_iters
    assert len(captures) == 1


def test_pcg_with_dot_takes_the_eager_loop(monkeypatch):
    from stan_tpu_torch.solvers import cg

    _need_cuda()
    op, diag, b = _graph_case((12, 6, 6))
    monkeypatch.setattr(cg._Blocks, "capture", None)  # a capture would fail
    res = cg.pcg(op.apply, b, diag=diag, tol=1e-6, dot=_eager_dot)
    assert res.converged and res.frozen == 0
    assert res.reads == res.iters + 2


def _calib_thetas(B, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(np.array([np.log(190000.0), 0.28, 0.0])
                        + rng.normal(0.0, 0.1, (B, 3)), dtype=torch.float32,
                        device="cuda")


@pytest.mark.parametrize("B", [16, 1])
def test_system_graph_cg_equals_the_eager_batched_loop(B):
    """The calibration's batched CG at its cells' shapes ([B, 3, 33, 33,
    33], padded to [B, 3, 35, 35, 35] in each sweep) replayed as CUDA
    graphs of BLOCK iterations against the batched loop that reads every
    iteration, at two θ batches in turn on one capture: the same per-chain
    counts, residuals and flags, u to the bit; the replays launch the eager
    loop's sweeps plus one per frozen iteration."""
    from stan_tpu_torch.infer import forward
    from stan_tpu_torch.solvers import cg

    _need_cuda()
    fwd = forward.build_forward(meshgen.hex_beam(32, 32, 32), device="cuda",
                                cg_tol=1e-6)
    kernel = "theta_sweep_batched" if B > 1 else "theta_sweep"
    kw = dict(tol=fwd.cg_tol, maxiter=fwd.cg_maxiter, ndof=fwd.ndof)
    for seed in (1, 2):
        theta = _calib_thetas(B, seed)
        params = forward.lame_from_E_nu(torch.exp(theta[:, 0]),
                                        0.5 * torch.sigmoid(theta[:, 1]))
        b = (fwd.free_mask * fwd.f0 * torch.exp(theta[:, 2]).view(
            -1, 1, 1, 1, 1)).contiguous()
        matvec, diag = fwd.system(*params)
        before = launches.counts[kernel]
        eager = cg._pcg_batched(matvec, b, diag, fwd.cg_tol, fwd.cg_maxiter,
                                fwd.ndof, None, None)
        eager_launches = launches.counts[kernel] - before
        cg.pcg(fwd.system, b, params=params, batched=True, **kw)
        before = launches.counts[kernel]
        res = cg.pcg(fwd.system, b, params=params, batched=True, **kw)
        graph_launches = launches.counts[kernel] - before
        assert eager.converged.all() and eager.iters.max() > cg.BLOCK
        for name in ("iters", "residual", "converged", "diverged"):
            np.testing.assert_array_equal(getattr(res, name),
                                          getattr(eager, name))
        assert torch.equal(res.u.view(torch.int32), eager.u.view(torch.int32))
        assert 0 <= res.frozen < cg.BLOCK
        assert res.reads <= -(-int(res.iters.max()) // cg.BLOCK) + 1
        assert eager_launches == eager.iters.max() + 1
        assert graph_launches == eager_launches + res.frozen
    assert len(cg._captures(fwd.system)) == 1


def _gradients(prob, thetas):
    from stan_tpu_torch.infer import hmc

    grad = hmc.guarded_logp_grad_b(prob.log_posterior)
    return [grad(th) for th in thetas]


def _calib_problem(m, dtype=torch.float32, **kw):
    """The calibration posterior of m on the card, observed at 8 strongly
    deflected nodes of its own solve at θ_true."""
    from stan_tpu_torch.infer import calibrate, forward

    fwd = forward.build_forward(m, dtype=torch.float64, device="cpu",
                                cg_tol=1e-10, **kw)
    u = forward.displacement_fn(fwd, m.nelem)(torch.tensor(
        [np.log(190000.0), 0.28, 0.0], dtype=torch.float64)).numpy()
    nodes = np.argsort(-np.linalg.norm(u, axis=1))[:8]
    obs_nodes, obs_dirs = np.repeat(nodes, 3), np.tile([0, 1, 2], 8)
    y = u[obs_nodes, obs_dirs] * (1.0 + 0.01 * np.random.default_rng(
        5).standard_normal(24))
    return calibrate.make_problem(m, obs_nodes, obs_dirs, y,
                                  0.01 * float(np.abs(y).max()), dtype=dtype,
                                  device="cuda", cg_tol=1e-6, **kw)


def _eager_and_graph(monkeypatch, prob, thetas):
    """The gradients at thetas from the batched loop that reads every
    iteration, then from the replayed graphs, and the graphs' solve
    counts."""
    from stan_tpu_torch.solvers import cg

    with monkeypatch.context() as mp:
        mp.setattr(cg, "_blocked", lambda b: False)
        eager = _gradients(prob, thetas)
    before = prob.fwd.stats.as_dict()
    return eager, _gradients(prob, thetas), prob.fwd.stats.since(before)


def _same_bits(a, b):
    view = torch.int32 if a.dtype == torch.float32 else torch.int64
    return torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("B", [16, 1])
def test_hmc_gradient_through_the_graph_equals_the_eager_loop(B,
                                                              monkeypatch):
    """HMC's value and gradient (guarded_logp_grad_b over the posterior, its
    forward and adjoint solves through _ImplicitSolve) at the 32^3
    calibration on the replayed graphs, against the loop that reads every
    iteration: equal to the bit at three θ batches; the forward and adjoint
    solves read once a block."""
    from stan_tpu_torch.solvers import cg

    _need_cuda()
    prob = _calib_problem(meshgen.hex_beam(32, 32, 32))
    thetas = [_calib_thetas(B, seed) for seed in (3, 4, 5)]
    eager, graph, d = _eager_and_graph(monkeypatch, prob, thetas)
    for (v0, g0), (v1, g1) in zip(eager, graph):
        assert torch.isfinite(v0).all()
        assert _same_bits(v0, v1) and _same_bits(g0, g1)
    for kind in ("forward", "adjoint"):
        assert d[f"{kind}_calls"] == 3
        assert d[f"{kind}_reads"] <= (d[f"{kind}_loop_iters"] // cg.BLOCK
                                      + 2 * 3)


def test_ten_gradients_capture_once(monkeypatch):
    """Ten 16-chain value-and-gradient evaluations at different θ on one
    posterior: one capture serves every forward and adjoint solve."""
    from stan_tpu_torch.solvers import cg

    _need_cuda()
    prob = _calib_problem(meshgen.hex_beam(16, 8, 8))
    capture, captures = cg._Blocks.capture, []

    def counted(self, A):
        captures.append(type(self))
        return capture(self, A)

    monkeypatch.setattr(cg._Blocks, "capture", counted)
    before = prob.fwd.stats.as_dict()
    out = _gradients(prob, [_calib_thetas(16, s) for s in range(10)])
    assert all(torch.isfinite(v).all() for v, _ in out)
    d = prob.fwd.stats.since(before)
    assert d["forward_calls"] == d["adjoint_calls"] == 10
    assert captures == [cg._ChainBlocks]
    assert len(cg._captures(prob.fwd.system)) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["field", "general"])
def test_field_and_general_forwards_on_the_graph(kind, dtype, monkeypatch):
    """The field forward (a two-material beam) and the general forward
    (prefer_stencil=False) on the replayed graphs against the loop that
    reads every iteration, at a small size, 4 chains: value and gradient
    to the bit at two θ batches, on one capture."""
    from stan_tpu_torch.infer import forward
    from stan_tpu_torch.solvers import cg

    _need_cuda()
    m = meshgen.hex_beam(8, 4, 4)
    if kind == "field":
        from stan_tpu_torch.core.model import Material

        m.materials[2] = Material(id=2, name="soft", E=95000.0, poisson=0.3)
        mat = np.asarray(m.elem_mat).reshape(8, 4, 4).copy()
        mat[4:] = 2
        m.elem_mat = mat.reshape(-1)
        prob = _calib_problem(m, dtype=dtype)
        assert isinstance(prob.fwd, forward.StructuredFieldForwardProblem)
    else:
        prob = _calib_problem(m, dtype=dtype, prefer_stencil=False)
        assert isinstance(prob.fwd, forward.ForwardProblem)
    thetas = [_calib_thetas(4, seed).to(dtype) for seed in (6, 7)]
    eager, graph, _ = _eager_and_graph(monkeypatch, prob, thetas)
    for (v0, g0), (v1, g1) in zip(eager, graph):
        assert torch.isfinite(v0).all()
        assert _same_bits(v0, v1) and _same_bits(g0, g1)
    assert len(cg._captures(prob.fwd.system)) == 1


# The general operator's kernels (csrc/general_apply.cu) against its plain
# version: the same products summed in other orders (the kernel sums each
# Gauss point's H, σ and force in registers and the Gauss points by
# shuffles; the plain version through cuBLAS's batched products), so RTOL
# of the largest entry.
@pytest.mark.parametrize("B", [None, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["HEX8_G1", "HEX8_G2", "TET4_G1",
                                  "TET4_G2"])
@pytest.mark.parametrize("kind", ["beam", "plate"])
def test_general_apply_matches_plain_version(kind, form, dtype, B):
    from general_apply_cases import case

    _need_cuda()
    op, u = case(kind, form, dtype, "cuda", B=B)
    before = launches.counts["general_apply"]
    got = op.apply(u)
    ref = op.apply_reference(u)
    torch.cuda.synchronize()
    assert launches.counts["general_apply"] == before + 1
    assert got.shape == u.shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= RTOL[dtype] * float(
        ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_general_apply_shares_one_d_over_systems(dtype):
    """D [E, 6, 6] with u [B, nnode, 3]: every system sees the one D; and
    a D per system expanded over the elements (element stride 0, as the
    general forward passes a homogeneous material)."""
    import dataclasses

    from general_apply_cases import case

    _need_cuda()
    op, u = case("plate", "HEX8_G2", dtype, "cuda")
    us = torch.stack([u, 2.0 * u, -u])
    got = op.apply(us)
    torch.cuda.synchronize()
    for b in range(3):
        ref = op.apply_reference(us[b])
        assert float((got[b] - ref).abs().max()) <= RTOL[dtype] * float(
            ref.abs().max())
    op3, u3 = case("plate", "HEX8_G2", dtype, "cuda", B=3)
    op3 = dataclasses.replace(op3, D=op3.D[:, :1].expand(-1, op3.D.shape[1],
                                                         -1, -1))
    got, ref = op3.apply(u3), op3.apply_reference(u3)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= RTOL[dtype] * float(
        ref.abs().max())


def test_general_apply_gives_the_same_bits_twice():
    """No atomics: two applies of one input agree to the bit, and each
    counts one apply."""
    from general_apply_cases import case

    _need_cuda()
    for kind, form, B in (("plate", "HEX8_G2", None), ("plate", "HEX8_G2", 3),
                          ("beam", "TET4_G2", 3)):
        op, u = case(kind, form, torch.float32, "cuda", B=B)
        before = launches.counts["general_apply"]
        a, b = op.apply(u), op.apply(u)
        torch.cuda.synchronize()
        assert launches.counts["general_apply"] == before + 2
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_general_apply_refuses_bad_input_on_cuda():
    from stan_tpu_torch.fem import operator as general
    from general_apply_cases import case

    _need_cuda()
    op, u = case("beam", "HEX8_G2", torch.float32, "cuda")
    conn32, inc32 = op.index32()
    args = dict(u=u, free_mask=op.free_mask, conn32=conn32, dN=op.dN,
                detJw=op.detJw, D=op.D, inc32=inc32)
    flat = torch.zeros(op.dN.numel() + 1, device="cuda")
    for error, change in (
            (TypeError, {"u": u.half()}),
            (TypeError, {"conn32": op.conn}),
            (ValueError, {"u": u.T.contiguous().T}),
            (ValueError, {"u": u[:-1].contiguous()}),
            (ValueError, {"dN": op.dN[:, :2]}),
            (ValueError, {"dN": flat[1:].view(op.dN.shape)}),
            (ValueError, {"free_mask": op.free_mask.cpu()}),
            (ValueError, {"D": op.D.clone().requires_grad_()})):
        with pytest.raises(error):
            general.general_apply(**{**args, **change})


def test_general_forward_solves_share_the_int32_indices():
    """Each solve of the general forward applies the operator that its
    system builds for its D; all of them launch the kernels on the one
    int32 conn and incidence, made at the first CUDA apply."""
    import dataclasses

    from stan_tpu_torch.infer import forward
    from general_apply_cases import case

    _need_cuda()
    op, u = case("plate", "HEX8_G2", torch.float32, "cuda", B=2)
    fwd = forward.ForwardProblem(op0=dataclasses.replace(op, D=op.D[0]),
                                 f0=op.free_mask, cg_tol=1e-6,
                                 cg_maxiter=10)
    a, b = (fwd.system(D)[0].__self__ for D in (op.D, 2.0 * op.D))
    got_a, got_b = a.apply(u), b.apply(u)
    torch.cuda.synchronize()
    assert a.index32()[0] is b.index32()[0] is fwd.op0.index32()[0]
    assert a.index32()[1] is b.index32()[1]
    assert a.index32()[0].data_ptr() == b.index32()[0].data_ptr()
    m = op.free_mask
    assert float((got_b - 2.0 * got_a + (1.0 - m) * u).abs().max()) <= (
        RTOL[torch.float32] * float(got_b.abs().max()))


def test_graph_cg_on_the_general_operator_equals_the_eager_loop():
    """The CUDA graph CG on the LE10 plate's general operator against the
    loop that reads every iteration: the same iterations, residual and
    flags, u to the bit; the replays count their applies."""
    from stan_tpu_torch.solvers import cg
    from general_apply_cases import case

    _need_cuda()
    op, u = case("plate", "HEX8_G2", torch.float32, "cuda")
    b = (op.free_mask * u).contiguous()
    diag = op.diagonal()
    cg.pcg(op.apply, b, diag=diag, tol=1e-6)  # captures
    before = launches.counts["general_apply"]
    eager = cg.pcg(op.apply, b, diag=diag, tol=1e-6, dot=_eager_dot)
    eager_launches = launches.counts["general_apply"] - before
    before = launches.counts["general_apply"]
    res = cg.pcg(op.apply, b, diag=diag, tol=1e-6)
    graph_launches = launches.counts["general_apply"] - before
    assert eager.converged and eager.iters > cg.BLOCK
    assert (res.iters, res.residual, res.converged, res.diverged) == (
        eager.iters, eager.residual, eager.converged, eager.diverged)
    assert torch.equal(res.u.view(torch.int32), eager.u.view(torch.int32))
    assert eager_launches == eager.iters + 1
    assert graph_launches == eager_launches + res.frozen


def test_cuda_general_solve_runs_the_kernels(monkeypatch):
    """A solve on a curved mesh (the general operator) on the card: every
    apply goes through the kernels, none through the plain version; the
    answer is certified and agrees with the CPU's float64 solve."""
    import dataclasses

    from stan_tpu_torch.fem import operator as general
    from general_apply_cases import mesh

    _need_cuda()
    coords, _, _ = mesh("beam", "HEX8_G2")
    m = dataclasses.replace(meshgen.hex_beam(4, 3, 2, lx=4.0, ly=3.0,
                                             lz=2.0), coords=coords)
    ref = solve_linear_statics(m, device="cpu", dtype=torch.float64)

    def plain(self, u):
        raise AssertionError("the plain apply ran on the card")

    monkeypatch.setattr(general.StiffnessOperator, "apply_reference", plain)
    before = launches.counts["general_apply"]
    res = solve_linear_statics(m, device="cuda")
    assert res.operator == ref.operator == "general"
    assert res.converged and res.true_residual <= 1e-6
    assert (launches.counts["general_apply"] - before
            >= res.iters + res.refine_iters)
    scale = np.abs(ref.u).max()
    np.testing.assert_allclose(res.u_certified, ref.u, atol=1e-5 * scale)
