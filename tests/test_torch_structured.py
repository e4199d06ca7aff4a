"""Port parity: structured-grid detection and StructuredOperator of
stan_tpu_torch against stan_tpu, in float64 on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stan_tpu.core import meshgen
from stan_tpu.core.model import Material
from stan_tpu.fem import structured as jstructured
from stan_tpu_torch.fem import structured

F64 = torch.float64


def _multi_material():
    m = meshgen.hex_beam(4, 2, 2)
    m.materials[2] = Material(id=2, name="soft", E=70000.0, poisson=0.33)
    m.elem_mat = m.elem_mat.copy()
    m.elem_mat[::2] = 2
    return m


def _perturbed():
    m = meshgen.hex_beam(3, 2, 2)
    m.coords = m.coords.copy()
    m.coords[5, 0] += 0.01
    return m


MODELS = {
    "4x3x2-G2": lambda: meshgen.hex_beam(4, 3, 2),
    "3x3x2-G1-nonuniform": lambda: meshgen.hex_beam(
        3, 3, 2, lx=6.0, ly=1.5, lz=3.0, elem_type="HEX8_G1"),
    "4x4x3-nonuniform": lambda: meshgen.hex_beam(4, 4, 3, lx=6.0, ly=1.5,
                                                 lz=3.0),
    "bar-G1": lambda: meshgen.uniaxial_bar(4, elem_type="HEX8_G1"),
    "multi-material": _multi_material,
}


@pytest.mark.parametrize("make", [*MODELS.values(), _perturbed],
                         ids=[*MODELS, "perturbed"])
def test_detect_structured_matches(make):
    m = make()
    assert structured.detect_structured(m) == jstructured.detect_structured(m)


def test_detect_spacing():
    m = meshgen.hex_beam(4, 2, 2, lx=8.0, ly=1.0, lz=3.0)
    info = structured.detect_structured(m)
    assert info == {"nelems": (4, 2, 2), "spacing": (2.0, 0.5, 1.5)}
    assert structured.detect_structured(_perturbed()) is None


@pytest.mark.parametrize("make", MODELS.values(), ids=MODELS)
def test_operator_matches_reference(make):
    m = make()
    jop = jstructured.build_structured_operator(m)
    op = structured.build_structured_operator(m, dtype=F64, device="cpu")
    assert op.node_shape == jop.node_shape and op.nelems == jop.nelems
    for name in ("ke_lam", "ke_mu", "lam_e", "mu_e", "free_mask"):
        want = np.asarray(getattr(jop, name))
        np.testing.assert_allclose(getattr(op, name).numpy(), want,
                                   rtol=1e-12, atol=1e-12 * np.abs(want).max())
    u = np.random.default_rng(0).standard_normal((3,) + op.node_shape)
    ut = torch.as_tensor(u)
    for method in ("apply_raw", "apply"):
        want = np.asarray(getattr(jop, method)(jnp.asarray(u)))
        got = getattr(op, method)(ut).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    want = np.asarray(jop.diagonal())
    np.testing.assert_allclose(op.diagonal().numpy(), want, rtol=1e-12)
    ue = np.asarray(jop.gather_elements(jnp.asarray(u)))
    np.testing.assert_array_equal(op.gather_elements(ut).numpy(), ue)
    fe = np.random.default_rng(1).standard_normal(ue.shape)
    np.testing.assert_allclose(
        op.scatter_elements(torch.as_tensor(fe)).numpy(),
        np.asarray(jop.scatter_elements(jnp.asarray(fe))), rtol=1e-14,
        atol=1e-14)


def test_build_refuses_unstructured():
    assert structured.build_structured_operator(
        _perturbed(), dtype=F64, device="cpu") is None
