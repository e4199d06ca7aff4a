"""Several processes: parallel/distributed.initialize over torch.distributed
(gloo, on the CPU), and the sharded solve, the chains x domain CG and chain
placement with blocks on other processes.

Two worker processes (tests/torch_multiprocess_worker.py, two CPU devices
each, so g[0], g[1] on process 0 and g[2], g[3] on process 1) join over a
file in tmp_path and run every scenario once; each writes its results.
Both workers' results must equal, bit for bit, those of the one-process
mesh of the same shape (["cpu"] * 4 in this process), which the other
tests/test_torch_sharded*.py and tests/test_torch_chain_mesh.py hold to
stan_tpu. The partials of a dot cross the processes whole (one owner per
entry, -0.0 elsewhere) and are summed in slab order on every process, so
nothing depends on which process computed what. Where the JAX side is
cheap the results are also held to stan_tpu in float64: the general
sharded solve to jsharded.sharded_pcg (1e-10 of max|u|, as
tests/test_torch_sharded.py), the stencil solves to stan_tpu's
single-device solve (1e-8 of max|u|).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_multiprocess_worker as worker
from stan_tpu.analysis import linear as jlinear
from stan_tpu.core import meshgen as jmeshgen
from stan_tpu.parallel import sharded as jsharded
from stan_tpu_torch.core import meshgen
from stan_tpu_torch.infer.forward import SolveStats
from stan_tpu_torch.parallel import distributed, sharded


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The directory of both workers' results (every scenario, one spawn;
    each worker and every collective has a finite timeout)."""
    out = tmp_path_factory.mktemp("two_processes")
    worker.spawn(out, "cpu", "gloo", list(worker.SCENARIOS))
    return out


@functools.lru_cache(maxsize=None)
def _one_process(name):
    return worker.SCENARIOS[name](["cpu"] * 4)


def _bitwise(runs, name, keys=None):
    """Both workers' arrays of `name` equal the one-process run's, bit for
    bit (the sign of a zero too); returns rank 0's."""
    ref = _one_process(name)
    for rank in (0, 1):
        got = worker.load(runs, name, rank)
        for key in keys or ref:
            a, b = got[key], np.asarray(ref[key])
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{key}")
            if a.dtype.kind == "f":
                np.testing.assert_array_equal(np.signbit(a), np.signbit(b))
    return worker.load(runs, name, 0)


def test_global_dot_and_gather_across_processes(runs):
    """Slabs.dot per chain (rows on the two processes) and over the slabs
    (two on each), and gather, on every process."""
    got = _bitwise(runs, "dot", ["chains", "slabs", "gather"])
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((2, 4, 3, 8, 2, 3))
    np.testing.assert_allclose(got["chains"],
                               (a * b).reshape(4, -1).sum(1), rtol=1e-13)
    np.testing.assert_allclose(got["slabs"], np.sum(a[0] * b[0]),
                               rtol=1e-13)
    np.testing.assert_array_equal(got["gather"], a * 2.0 + b)


def test_describe_names_the_processes(runs):
    for rank in (0, 1):
        text = str(worker.load(runs, "dot", rank)["describe"])
        assert text == ("mesh chains=1 x domain=4 on 4 cpu device(s) (2 "
                        "distinct) in 2 processes (0, 1; gloo)")
    one = distributed.device_mesh(1, 4, devices=["cpu"] * 4)
    assert distributed.describe(one).endswith("(1 distinct) in one process")


def _flat(u_grid):
    """[3, NNX, NNY, NNZ] -> [nnode, 3] (meshgen numbering)."""
    return np.moveaxis(u_grid, 0, -1).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def _jax_single(n):
    """stan_tpu's single-device float64 answer on hex_beam(*n), from its
    general operator (its stencil path runs Pallas in interpret mode here;
    the system is the same)."""
    m = jmeshgen.hex_beam(*n)
    m.analysis.lin_solver_tolerance = 1e-12
    return jlinear.solve_linear_statics(m, store=False, n_domain=1,
                                        use_structured=False)


def test_sharded_stencil_cg_with_the_halo_across_processes(runs):
    """sharded_stencil_pcg on 1 x 4 (hex_beam(7, 2, 2), NNX = 8): the halo
    between slabs 1 and 2 crosses the processes; the same iterations and
    bits as one process, and stan_tpu's single-device answer."""
    got = _bitwise(runs, "stencil")
    ref = _jax_single((7, 2, 2))
    np.testing.assert_allclose(_flat(got["u"]), ref.u,
                               atol=1e-8 * np.abs(ref.u).max())


def test_chain_batched_pcg_with_rows_on_processes(runs):
    """chain_batched_pcg on 2 x 2, one row of chains per process: each
    chain's count and u as in one process (the per-chain norms reach every
    process whole, so every process stops at the same iteration)."""
    got = _bitwise(runs, "chains")
    assert got["converged"].all() and len(set(got["iters"].tolist())) > 1


@functools.lru_cache(maxsize=None)
def _jax_general(ndev, prefer_ring):
    m = meshgen.hex_beam(8, 2, 2)
    args = (m.coords, m.conn, m.elem_d_matrices(), m.fix_mask(),
            m.formulation(), ndev)
    jop, _ = jsharded.build_sharded_operator(*args, prefer_ring=prefer_ring)
    _, part = sharded.build_sharded_operator(*args, dtype=torch.float64,
                                             prefer_ring=prefer_ring,
                                             device="cpu")
    f = sharded.shard_rhs(part, m.load_vector())
    mesh = Mesh(np.array(jax.devices()[:ndev]), axis_names=("domain",))
    res = jsharded.sharded_pcg(mesh, jop, jnp.asarray(f), tol=1e-12)
    return np.asarray(res.u), int(res.iters)


@pytest.mark.parametrize("mode", sorted(worker.GENERAL))
def test_general_sharded_pcg_across_processes(runs, mode):
    """The ring (1 x 4) and the all-gather (1 x 3, two blocks on one
    process and one on the other) exchanges between processes."""
    got = _bitwise(runs, "general", [f"{mode}.u", f"{mode}.iters"])
    u_ref, iters = _jax_general(*worker.GENERAL[mode])
    assert abs(int(got[f"{mode}.iters"]) - iters) <= 2
    np.testing.assert_allclose(got[f"{mode}.u"], u_ref,
                               atol=1e-10 * np.abs(u_ref).max())


def test_placed_hmc_with_rows_on_processes(runs):
    """run_hmc(mesh=) in float64 on 2 x 1, row r on process r: the draws of
    the one-process placed run on both processes, those of the unplaced
    run to rtol 1e-12 (tests/test_torch_chain_mesh.py), and the solve
    counts summed over the processes (SummedSolveStats) those of one
    process."""
    got = _bitwise(runs, "hmc")
    ref = worker.hmc(None)
    np.testing.assert_allclose(got["samples"], ref["samples"], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got["step_size"], ref["step_size"],
                               rtol=1e-12)
    counts = [k for k in sorted(SolveStats().as_dict())
              if not k.endswith("_ns")]
    per_chain = [i for i, k in enumerate(counts)
                 if k.split("_", 1)[1] in ("solves", "iters", "unconverged")]
    np.testing.assert_array_equal(got["stats"][per_chain],
                                  ref["stats"][per_chain])


def test_placed_nuts_and_smc_with_rows_on_processes(runs):
    """run_nuts(mesh=) and run_smc(mesh=) on 2 x 1, row r on process r:
    every lockstep leaf and every SMC stage joins the rows on both
    processes, so both draw what one process draws."""
    got = _bitwise(runs, "samplers")
    assert np.isfinite(got["nuts"]).all() and got["temperatures"][-1] > 0


def test_linear_statics_n_domain_across_processes(runs):
    """solve_linear_statics(n_domain=4, device="cpu") after initialize: the
    mesh is device_mesh over the global devices (two per process), the
    operator sharded-stencilx4, u and stress those of one process and of
    stan_tpu."""
    got = _bitwise(runs, "linear")
    assert str(got["operator"]) == "sharded-stencilx4"
    ref = _jax_single((7, 3, 3))
    np.testing.assert_allclose(got["u"], ref.u,
                               atol=1e-8 * np.abs(ref.u).max())
    np.testing.assert_allclose(got["stress"], ref.stress,
                               atol=1e-8 * np.abs(ref.stress).max())


def _cards(monkeypatch, n):
    """n cards for initialize's checks on a host without one: the count,
    and each card's identity its index."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(distributed, "_card",
                        lambda dev: f"card {dev.index}")


def test_nccl_with_two_ranks_on_one_card_is_refused(tmp_path, monkeypatch):
    """NCCL gives each rank a card of its own: two ranks that name one
    card (cuda:0 on a host of two cards) are refused on both ranks, after
    the rendezvous and before any collective, naming the card and gloo;
    a CPU device is refused before the rendezvous. The backend is never
    switched."""
    _cards(monkeypatch, 2)
    init = f"file://{tmp_path / 'rendezvous'}"
    with pytest.raises(ValueError, match="needs CUDA devices"):
        distributed.initialize(init, 2, 0, backend="nccl",
                               local_devices=["cpu"])
    assert not (tmp_path / "rendezvous").exists()

    def rank(r):
        with pytest.raises(ValueError) as err:
            distributed.initialize(init, 2, r, backend="nccl",
                                   local_devices=["cuda:0"], timeout=60.0)
        return str(err.value)

    with ThreadPoolExecutor(2) as pool:
        msgs = list(pool.map(rank, (0, 1)))
    assert msgs[0] == msgs[1] and msgs[0] == (
        "backend='nccl' with ranks 0 and 1 on one card (cuda:0 of rank 0, "
        "cuda:0 of rank 1), which NCCL refuses; pass backend='gloo' to run "
        "several ranks on one card")
    assert distributed.process_count() == 1 and distributed.backend() is None


def test_default_devices_give_nccl_a_card_per_rank(monkeypatch):
    """Without local_devices: cuda:{LOCAL_RANK} under torchrun; else under
    NCCL (the default for cards) rank r on card r % cards, so two ranks on
    a host of two cards do not share one; under gloo every card."""
    _cards(monkeypatch, 2)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert [distributed._default_devices(r, b) for r, b in
            ((0, None), (1, None), (3, "nccl"))] == [["cuda:0"], ["cuda:1"],
                                                     ["cuda:1"]]
    assert distributed._default_devices(1, "gloo") == ["cuda:0", "cuda:1"]
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed._default_devices(0, "gloo") == ["cuda:1"]
    _cards(monkeypatch, 0)
    monkeypatch.delenv("LOCAL_RANK")
    with pytest.raises(ValueError, match="no CUDA device"):
        distributed._default_devices(0, None)


def test_global_devices_in_one_process():
    """Without initialize the global list is this process's cards (none on
    a CPU host); a mesh of global devices of process 0 is this process's
    own; a device of a process the runtime lacks, and a mesh mixing
    global and plain devices, are refused."""
    cpu = torch.device("cpu")
    assert all(d.process == 0 for d in distributed.devices())
    mesh = distributed.device_mesh(1, 2, devices=[distributed.Device(0, cpu)]
                                   * 2)
    assert not mesh.spmd and mesh.home == cpu and mesh.is_local(0, 1)
    assert distributed.describe(mesh).endswith("in one process")
    with pytest.raises(ValueError, match="names process 1"):
        distributed.DeviceMesh([[distributed.Device(1, cpu)]])
    with pytest.raises(ValueError, match="all global"):
        distributed.DeviceMesh([[distributed.Device(0, cpu), "cpu"]])
