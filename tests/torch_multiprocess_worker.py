"""Scenarios of the port's several-process runtime, and the worker that runs
them in two processes.

Each scenario takes four devices g (g[0], g[1] on process 0 and g[2], g[3]
on process 1 after distributed.initialize; or four plain devices of one
process, the one-process mesh of the same shape) and returns numpy arrays.
tests/test_torch_multiprocess.py (gloo on the CPU) and the two-rank card
tests of tests/test_torch_gpu.py run them in two workers through spawn()
and hold each worker's arrays to the one-process run's.

A worker: python tests/torch_multiprocess_worker.py RANK INIT_FILE OUT_DIR
DEVICE BACKEND SCENARIO[,SCENARIO...], DEVICE formatted with the rank
("cuda:{rank}"). It imports nothing of jax or stan_tpu.
"""

import os
import subprocess
import sys

import numpy as np
import torch

F64 = torch.float64
THETAS = (np.array([np.log(200000.0), 0.1, 0.02])
          + np.random.default_rng(3).normal(0.0, 0.1, (8, 3)))


def _grid_f(m, op, device):
    """hex_beam's load in the channel-first grid layout [3, NNX, NNY, NNZ]
    of the sharded stencil operator op (meshgen numbering: node =
    i*nny*nnz + j*nnz + k)."""
    return torch.as_tensor(m.load_vector(), dtype=F64).reshape(
        *op.free_mask.shape[1:], 3).permute(3, 0, 1, 2).contiguous().to(
            device)


def dot(g):
    """Slabs.dot and gather: per chain on 2 x 2 (one row per process), and
    over the slabs of 1 x 4 (two slabs on each process)."""
    from stan_tpu_torch.parallel import distributed

    grid = distributed.device_mesh(2, 2, devices=g)
    row = distributed.device_mesh(1, 4, devices=g)
    rng = np.random.default_rng(0)
    a, b = (torch.as_tensor(rng.standard_normal((4, 3, 8, 2, 3)),
                            device=grid.home) for _ in range(2))
    sa, sb = grid.split(a, 2, chains=True), grid.split(b, 2, chains=True)
    ra, rb = row.split(a[0], 1), row.split(b[0], 1)
    return {"chains": sa.dot(sb).cpu().numpy(),
            "slabs": ra.dot(rb).cpu().numpy(),
            "gather": (sa * 2.0 + sb).gather().cpu().numpy(),
            "describe": np.array(distributed.describe(row))}


def stencil(g):
    """sharded_stencil_pcg on hex_beam(7, 2, 2) (NNX = 8) over 1 x 4: the
    halo between slabs 1 and 2 crosses the processes."""
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.parallel import distributed
    from stan_tpu_torch.parallel import sharded_stencil as ss

    mesh = distributed.device_mesh(1, 4, devices=g)
    m = meshgen.hex_beam(7, 2, 2)
    op = ss.build_sharded_stencil_operator(m, 4, dtype=F64, device=mesh.home)
    f = _grid_f(m, op, mesh.home)
    res = ss.sharded_stencil_pcg(mesh, op, f, tol=1e-12)
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(
        tuple(f.shape)), device=mesh.home)
    return {"u": res.u.cpu().numpy(), "iters": np.array(res.iters),
            "apply": ss.sharded_apply(mesh, op, u).cpu().numpy()}


def chains(g):
    """chain_batched_pcg on 2 x 2, one row of chains per process: two
    chains per row, each with its own right-hand side and count."""
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.parallel import distributed
    from stan_tpu_torch.parallel import sharded_stencil as ss

    mesh = distributed.device_mesh(2, 2, devices=g)
    m = meshgen.hex_beam(7, 2, 2)
    op = ss.build_sharded_stencil_operator(m, 2, dtype=F64, device=mesh.home)
    f0 = _grid_f(m, op, mesh.home)
    rough = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (3, *f0.shape)), device=mesh.home)
    f = torch.stack([f0, f0 + 0.5 * rough[0], 2.0 * f0, f0 - rough[1]])
    res = ss.chain_batched_pcg(mesh, op, f, scales=None, tol=1e-8,
                               maxiter=200)
    return {"u": res.u.cpu().numpy(), "iters": res.iters,
            "converged": res.converged}


GENERAL = {"ring-4": (4, True), "all-gather-3": (3, False)}


def general(g):
    """The general sharded_pcg on hex_beam(8, 2, 2): the ring over 1 x 4
    (two blocks on each process), the all-gather over 1 x 3 (two blocks
    on process 0, one on process 1)."""
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.parallel import distributed, sharded

    m = meshgen.hex_beam(8, 2, 2)
    out = {}
    for name, (ndev, ring) in GENERAL.items():
        mesh = distributed.device_mesh(1, ndev, devices=g)
        op, part = sharded.build_sharded_operator(
            m.coords, m.conn, m.elem_d_matrices(), m.fix_mask(),
            m.formulation(), ndev, dtype=F64, prefer_ring=ring,
            device=mesh.home)
        assert op.ring == ring
        fp = torch.as_tensor(sharded.shard_rhs(part, m.load_vector()),
                             device=mesh.home)
        res = sharded.sharded_pcg(mesh, op, fp, tol=1e-12)
        out[f"{name}.u"] = res.u.cpu().numpy()
        out[f"{name}.iters"] = np.array(res.iters)
    return out


def observations(m, sigma=1e-4):
    """Strongly deflected nodes x 3 directions of the port's float64 solve
    at θ_true, with noise of sigma (tests/test_torch_chain_mesh.py's)."""
    from stan_tpu_torch.infer import forward

    fwd = forward.build_forward(m, dtype=F64, device="cpu")
    u = forward.displacement_fn(fwd, m.nelem)(torch.tensor(
        [np.log(190000.0), 0.28, 0.0], dtype=F64)).numpy()
    total = np.linalg.norm(u, axis=1)
    nodes = np.nonzero(total > 0.3 * total.max())[0]
    obs_nodes, obs_dirs = np.repeat(nodes, 3), np.tile([0, 1, 2], len(nodes))
    y = u[obs_nodes, obs_dirs] + sigma * np.random.default_rng(0).normal(
        size=len(obs_nodes))
    return obs_nodes, obs_dirs, y, sigma


def hmc(g):
    """run_hmc(mesh=) in float64 on 2 x 1 (row r on process r) through
    make_problem(mesh=) on hex_beam(3, 2, 2); g None: the unplaced run."""
    from stan_tpu_torch.core import meshgen
    from stan_tpu_torch.infer import calibrate
    from stan_tpu_torch.infer import hmc as hmc_mod
    from stan_tpu_torch.parallel import distributed

    m = meshgen.hex_beam(3, 2, 2)
    mesh = (None if g is None
            else distributed.device_mesh(2, 1, devices=[g[0], g[2]]))
    prob = calibrate.make_problem(m, *observations(m), dtype=F64,
                                  cg_tol=1e-10, mesh=mesh,
                                  device="cpu" if mesh is None else None)
    res = hmc_mod.run_hmc(prob.log_posterior, torch.as_tensor(THETAS[:4]),
                          5, n_leapfrog=2, solve_stats=prob.fwd.stats,
                          mesh=mesh, n_samples=3, n_warmup=3, init_step=0.1,
                          target_accept=0.8)
    stats = res.solve_stats  # its counts; host times differ between runs
    return {"samples": res.samples, "step_size": res.step_size,
            "stats": np.array([stats[k] for k in sorted(stats)
                               if not k.endswith("_ns")])}


def _gauss_logp(theta):
    """A chain-batched correlated 2-D Gaussian log density, [C, 2] -> [C]."""
    cov_inv = torch.linalg.inv(torch.tensor([[1.0, 0.6], [0.6, 2.0]],
                                            dtype=F64))
    d = theta - torch.tensor([1.0, -2.0], dtype=F64)
    return -0.5 * torch.einsum("ci,ij,cj->c", d, cov_inv, d)


def samplers(g):
    """run_nuts(mesh=) and run_smc(mesh=) on a Gaussian target over 2 x 1
    (row r on process r)."""
    from stan_tpu_torch.infer import nuts, smc
    from stan_tpu_torch.parallel import distributed

    mesh = distributed.device_mesh(2, 1, devices=[g[0], g[2]])
    theta0 = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (4, 2)))
    res = nuts.run_nuts(_gauss_logp, theta0, 8, n_samples=10, n_warmup=10,
                        max_depth=4, mesh=mesh)
    part = smc.run_smc(
        lambda t: -0.5 * torch.sum((t / 5.0) ** 2, dim=1), _gauss_logp,
        lambda gen, n: 5.0 * torch.randn((n, 2), generator=gen, dtype=F64),
        3, n_particles=16, n_mcmc=3, mesh=mesh)
    return {"nuts": res.samples, "evals": res.evals_per_sample,
            "smc": part.particles, "temperatures": part.temperatures}


def linear(g):
    """solve_linear_statics(n_domain=4) on hex_beam(7, 3, 3) in float64:
    over the processes' four devices after initialize (the mesh is
    device_mesh over distributed.devices()), else four CPU slabs."""
    from stan_tpu_torch.analysis.linear import solve_linear_statics
    from stan_tpu_torch.core import meshgen

    m = meshgen.hex_beam(7, 3, 3)
    m.analysis.lin_solver_tolerance = 1e-12
    res = solve_linear_statics(m, device="cpu", dtype=F64, n_domain=4,
                               store=False)
    return {"u": res.u, "stress": res.stress, "iters": np.array(res.iters),
            "operator": np.array(res.operator)}


SCENARIOS = {f.__name__: f for f in (dot, stencil, chains, general, hmc,
                                     samplers, linear)}


def spawn(out_dir, device: str, backend: str, names, timeout: float = 120.0
          ) -> None:
    """Run the named scenarios in two worker processes (each with two
    devices, `device` formatted with the rank) that join over a file in
    out_dir; each writes out_dir/<scenario>.<key>.<rank>.npy. Raises with
    the workers' output if either fails or both have not ended within
    `timeout` seconds (then both are killed)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    init = os.path.join(str(out_dir), "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), init,
         str(out_dir), device, backend, ",".join(names)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise RuntimeError(f"workers did not end within {timeout} s")
    for rank, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"worker {rank} OK" not in text:
            raise RuntimeError(f"worker {rank} exit code {p.returncode}:\n"
                               f"{text[-4000:]}")


def load(out_dir, name: str, rank: int) -> dict:
    """One worker's arrays of one scenario."""
    prefix, suffix = f"{name}.", f".{rank}.npy"
    return {f[len(prefix):-len(suffix)]: np.load(os.path.join(str(out_dir),
                                                               f))
            for f in os.listdir(str(out_dir))
            if f.startswith(prefix) and f.endswith(suffix)}


def main(argv) -> None:
    rank, init, out_dir, device, backend, names = argv
    rank = int(rank)
    torch.set_num_threads(1)
    from stan_tpu_torch.parallel import distributed

    dev = device.format(rank=rank)
    distributed.initialize(f"file://{init}", 2, rank, backend=backend,
                           local_devices=[dev] * 2, timeout=60.0)
    g = distributed.devices()
    assert [d.process for d in g] == [0, 0, 1, 1], g
    for name in names.split(","):
        for key, value in SCENARIOS[name](g).items():
            np.save(os.path.join(out_dir, f"{name}.{key}.{rank}.npy"), value)
    torch.distributed.destroy_process_group()
    print(f"worker {rank} OK", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
