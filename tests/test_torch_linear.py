"""The port's linear static solve as a whole, against stan_tpu.

solve_linear_statics of stan_tpu_torch (float64, CPU) against the JAX
package's on stencil, structured and general models: the same operator,
u, strain, stress and reactions to 1e-8 of their scale. Also the float32
certified solve, the CLI through an STdb round trip, the numpy bridge from
the JAX operators (convert.py), and that the port never imports jax.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from stan_tpu.analysis import linear as jlinear
from stan_tpu.core import meshgen
from stan_tpu.core.model import Material
from stan_tpu.fem import hostops
from stan_tpu.fem import operator as joperator
from stan_tpu.fem import stencil as jstencil
from stan_tpu.fem import structured as jstructured
from stan_tpu_torch import cli, convert
from stan_tpu_torch.analysis.linear import solve_linear_statics
from stan_tpu_torch.utils.timing import PhaseTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


def _multi_material():
    m = meshgen.hex_beam(4, 2, 2)
    m.materials[2] = Material(id=2, name="soft", E=70000.0, poisson=0.33)
    m.elem_mat = m.elem_mat.copy()
    m.elem_mat[::2] = 2
    return m


def _perturbed():
    m = meshgen.hex_beam(3, 3, 2)
    c = m.coords
    interior = ~np.logical_or.reduce([
        np.isclose(c[:, k], c[:, k].min()) | np.isclose(c[:, k], c[:, k].max())
        for k in range(3)])
    m.coords = c.copy()
    m.coords[interior] += np.random.default_rng(0).normal(
        0.0, 0.05, (interior.sum(), 3))
    return m


# name -> (model factory, operator both packages must pick)
MODELS = {
    "stencil": (lambda: meshgen.hex_beam(4, 3, 3), "stencil"),
    "stencil-nonuniform": (lambda: meshgen.hex_beam(
        4, 2, 2, lx=6.0, ly=1.5, lz=3.0), "stencil"),
    "structured-multi-material": (_multi_material, "structured"),
    "structured-bar-G1": (
        lambda: meshgen.uniaxial_bar(4, elem_type="HEX8_G1"), "structured"),
    "general": (_perturbed, "general"),
}


def _close(got, want, rel=1e-8):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


@pytest.fixture
def reference_stencil_plain(monkeypatch):
    """Run the reference's stencil operator through its plain jnp twin: its
    Pallas kernel in interpret mode costs ~40 s per solve on the CPU. The
    jit caches are cleared on both sides so no other test sees the patch."""
    jax.clear_caches()
    monkeypatch.setattr(
        jstencil.StencilOperator, "apply_raw",
        lambda self, u: jstencil._stencil_apply_jnp(self.tables, self.deltas,
                                                    u))
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("name", MODELS)
def test_solve_matches_reference(name, reference_stencil_plain):
    make, kind = MODELS[name]
    m_ref, m = make(), make()
    for model in (m_ref, m):
        model.analysis.lin_solver_tolerance = 1e-10
    ref = jlinear.solve_linear_statics(m_ref)
    res = solve_linear_statics(m, device="cpu", dtype=F64)
    assert res.operator == ref.operator == kind
    assert res.converged and ref.converged
    assert abs(res.iters - ref.iters) <= 1
    assert res.true_residual is None and res.u_certified is None
    _close(res.u, ref.u)
    _close(res.strain, ref.strain)
    _close(res.stress, ref.stress)
    _close(res.reactions, ref.reactions)
    for stored, want in ((m.disp, m_ref.disp), (m.strain, m_ref.strain),
                         (m.stress, m_ref.stress)):
        assert stored.shape == want.shape
        np.testing.assert_array_equal(stored[0], 0.0)
        _close(stored[1], want[1])
    assert m.analysis.result_step_no == m_ref.analysis.result_step_no == 1


@pytest.mark.parametrize("make,kind", [
    (lambda: meshgen.hex_beam(5, 4, 4), "stencil"),
    (_multi_material, "structured"),
    (_perturbed, "general"),
], ids=["stencil", "structured", "general"])
def test_float32_solve_is_certified(make, kind):
    m = make()
    timer = PhaseTimer(verbose=False)
    res = solve_linear_statics(m, device="cpu", timer=timer)
    assert res.operator == kind and res.converged
    assert res.true_residual is not None and res.true_residual <= 1e-6
    assert res.u.dtype == np.float32 and res.u_certified.dtype == np.float64
    np.testing.assert_array_equal(res.u, res.u_certified.astype(np.float32))
    # An independent float64 check on the host (numpy, no port code).
    A = hostops.general_apply_np(m.coords, m.conn, m.elem_d_matrices(),
                                 m.formulation(), m.fix_mask())
    b = (1.0 - m.fix_mask()) * m.load_vector()
    rel = np.linalg.norm(b - A(res.u_certified)) / np.linalg.norm(b)
    assert rel == pytest.approx(res.true_residual, rel=1e-6)
    phases = [r["phase"] for r in timer.records]
    assert phases == ["Operator setup", f"Linear solve (CG, {kind})",
                      "Certify (f64 refinement)", "Stress recovery"]
    assert timer.records[1]["iters"] == res.iters
    assert "Total" in timer.summary()


def test_solve_options():
    """store=False leaves the model alone, use_structured=False takes the
    general operator on a stencil-eligible grid, certify=False skips the
    float64 certificate."""
    m = meshgen.hex_beam(4, 3, 3)
    m.analysis.lin_solver_tolerance = 1e-10
    fast = solve_linear_statics(m, device="cpu", dtype=F64, store=False)
    assert fast.operator == "stencil" and m.disp is None
    general = solve_linear_statics(m, device="cpu", dtype=F64, store=False,
                                   use_structured=False)
    assert general.operator == "general"
    _close(general.u, fast.u)
    raw = solve_linear_statics(m, device="cpu", certify=False)
    assert raw.true_residual is None and raw.u_certified is None
    assert raw.refine_cycles == 0 and m.disp is not None


def test_float32_reactions_balance_loads():
    m = meshgen.hex_beam(3, 2, 2, load=(5.0, -2.0, -10.0))
    res = solve_linear_statics(m, device="cpu")
    fix = m.fix_mask()
    f = m.load_vector()
    supports = res.reactions.astype(np.float64).reshape(-1)[fix.reshape(-1)]
    np.testing.assert_allclose(supports.reshape(-1, 3).sum(axis=0),
                               -f.sum(axis=0), atol=1e-3 * np.abs(f).sum())


def test_cli_solve_roundtrip(tmp_path, capsys):
    from stan_tpu.io import stdb

    path, out = str(tmp_path / "beam.STdb"), str(tmp_path / "solved.STdb")
    stdb.write(meshgen.hex_beam(4, 3, 3), path)
    assert cli.main(["solve", path, "--out", out, "--device", "cpu",
                     "--tol", "1e-8"]) == 0
    text = capsys.readouterr().out
    assert "Operator: stencil" in text and "Certified f64 residual" in text
    solved = stdb.read(out)
    model = stdb.read(path)
    model.analysis.lin_solver_tolerance = 1e-8
    lib = solve_linear_statics(model, device="cpu")
    np.testing.assert_array_equal(solved.disp[-1], lib.u)
    np.testing.assert_array_equal(solved.stress[-1], lib.stress)
    assert solved.analysis.result_step_no == 1
    assert stdb.read(path).disp is None  # --out leaves the input alone

    # not converged -> 1; invalid model -> 2
    assert cli.main(["solve", path, "--out", out, "--device", "cpu",
                     "--maxiter", "1"]) == 1
    bad = meshgen.hex_beam(3, 2, 2)
    bad.materials[1].E = -999.0
    stdb.write(bad, path)
    assert cli.main(["solve", path, "--device", "cpu"]) == 2


def test_unported_paths_raise(monkeypatch):
    """Nothing is refused as unported any more: several processes (item
    10c) are refused only without an init method; the domain-sharded solve
    (item 10a) and Cholesky, each refused until it was ported, solve."""
    from stan_tpu_torch.parallel import distributed

    for name in ("MASTER_ADDR", "MASTER_PORT", "RANK"):
        monkeypatch.delenv(name, raising=False)
    m = meshgen.hex_beam(3, 2, 2)
    with pytest.raises(ValueError, match="init method"):
        distributed.initialize(num_processes=2)
    res = solve_linear_statics(m, device="cpu", dtype=F64, n_domain=2)
    assert res.operator == "sharded-stencilx2" and res.n_domain == 2
    assert res.converged
    m.analysis.lin_solver = "Cholesky"
    res = solve_linear_statics(m, device="cpu", dtype=F64)
    assert res.operator == "dense-cholesky" and res.converged
    assert res.true_residual < 1e-12
    m.analysis.lin_solver = "QR"
    with pytest.raises(ValueError, match="Unknown linear solver"):
        solve_linear_statics(m, device="cpu")


def test_convert_builds_identical_operators():
    m = meshgen.hex_beam(4, 3, 3)
    u = np.random.default_rng(0).standard_normal((m.nnode, 3))

    jop = joperator.build_operator(m.coords, m.conn, m.elem_d_matrices(),
                                   m.fix_mask(), m.formulation())
    op = convert.stiffness_operator_from_numpy(
        np.asarray(jop.conn), np.asarray(jop.dN), np.asarray(jop.detJw),
        np.asarray(jop.D), np.asarray(jop.free_mask), jop.nnode, jop.form,
        np.asarray(jop.inc_idx), device="cpu")
    assert op.dtype == F64
    _close(op.apply(torch.as_tensor(u)).numpy(), jop.apply(jnp.asarray(u)),
           1e-12)
    _close(op.diagonal().numpy(), jop.diagonal(), 1e-12)

    jst = jstructured.build_structured_operator(m)
    sop = convert.structured_operator_from_numpy(
        jst.nelems, np.asarray(jst.ke_lam), np.asarray(jst.ke_mu),
        np.asarray(jst.lam_e), np.asarray(jst.mu_e), np.asarray(jst.free_mask),
        jst.form, device="cpu")
    ug = np.array(jst.to_grid(jnp.asarray(u)))
    _close(sop.apply(torch.as_tensor(ug)).numpy(), jst.apply(jnp.asarray(ug)),
           1e-12)

    jsten = jstencil.build_stencil_operator(m)
    sten = convert.stencil_operator_from_numpy(sop, jsten.tables)
    fm = np.asarray(jst.free_mask)
    want = fm * np.asarray(jstencil._stencil_apply_jnp(
        jsten.tables, jsten.deltas, jnp.asarray(fm * ug))) + (1.0 - fm) * ug
    _close(sten.apply(torch.as_tensor(ug)).numpy(), want, 1e-12)
    _close(sten.diagonal().numpy(), jsten.diagonal(), 1e-12)


def _run(code, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_never_imports_jax(tmp_path):
    """In a fresh process: import every module of the port and chip_smoke,
    solve a beam from the port's own meshgen, and run the CLI's solve on an
    STdb the port's own stdb wrote; then nothing of stan_tpu, jax or jaxlib
    may be loaded."""
    proc = _run(f"""
        import importlib, pkgutil, sys
        import torch
        import chip_smoke
        import stan_tpu_torch
        for mod in pkgutil.walk_packages(stan_tpu_torch.__path__,
                                         "stan_tpu_torch."):
            importlib.import_module(mod.name)
        from stan_tpu_torch import cli
        from stan_tpu_torch.core import meshgen
        from stan_tpu_torch.io import stdb
        from stan_tpu_torch.analysis.linear import solve_linear_statics
        r = solve_linear_statics(meshgen.hex_beam(3, 3, 3), device="cpu",
                                 dtype=torch.float64)
        assert r.converged and r.operator == "stencil", r
        path = {str(tmp_path / "beam.STdb")!r}
        stdb.write(meshgen.hex_beam(3, 3, 3), path)
        assert cli.main(["solve", path, "--device", "cpu"]) == 0
        assert stdb.read(path).disp is not None
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("stan_tpu", "jax", "jaxlib"))
        assert not bad, bad
        print("ok")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the refusal path is for "
                    "machines without one")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
