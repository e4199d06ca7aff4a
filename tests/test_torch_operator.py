"""Port parity: element kernels and the general StiffnessOperator of
stan_tpu_torch against stan_tpu.fem, in float64 on the CPU, rtol 1e-12."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stan_tpu.core import meshgen
from stan_tpu.fem import kernels as jkernels
from stan_tpu.fem import operator as joperator
from stan_tpu.fem.elements import get as get_form
from stan_tpu_torch.fem import kernels, operator

F64 = torch.float64
RTOL = 1e-12


def _perturbed_beam(elem_type="HEX8_G2", seed=0):
    """A 3x3x2 beam whose interior nodes are moved off the lattice."""
    m = meshgen.hex_beam(3, 3, 2, elem_type=elem_type)
    c = m.coords
    interior = ~np.logical_or.reduce([
        np.isclose(c[:, k], c[:, k].min()) | np.isclose(c[:, k], c[:, k].max())
        for k in range(3)])
    m.coords = c.copy()
    m.coords[interior] += np.random.default_rng(seed).normal(
        0.0, 0.05, (interior.sum(), 3))
    return m


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_det3_inv3():
    J = np.random.default_rng(0).standard_normal((5, 4, 3, 3)) + 3 * np.eye(3)
    _close(kernels.det3(torch.as_tensor(J)), jkernels.det3(jnp.asarray(J)))
    _close(kernels.inv3(torch.as_tensor(J)), jkernels.inv3(jnp.asarray(J)))
    _close(kernels.inv3(torch.as_tensor(J)), np.linalg.inv(J), rtol=1e-10)


@pytest.mark.parametrize("elem_type", ["HEX8_G2", "HEX8_G1"])
def test_element_kernels(elem_type):
    m = _perturbed_beam(elem_type)
    form = get_form(elem_type)
    ce = m.coords[m.conn]
    dN, detJw = kernels.element_geometry(torch.as_tensor(ce), form)
    jdN, jdetJw = jkernels.element_geometry(jnp.asarray(ce), form)
    _close(dN, jdN)
    _close(detJw, jdetJw)
    rng = np.random.default_rng(1)
    u_e = rng.standard_normal((m.nelem, 8, 3))
    D = m.elem_d_matrices()
    _close(kernels.strain_at_gauss(dN, torch.as_tensor(u_e)),
           jkernels.strain_at_gauss(jdN, jnp.asarray(u_e)))
    s = rng.standard_normal((4, 6))
    _close(kernels.voigt_to_tensor(torch.as_tensor(s)),
           jkernels.voigt_to_tensor(jnp.asarray(s)))
    _close(kernels.internal_force(dN, detJw, torch.as_tensor(D),
                                  torch.as_tensor(u_e)),
           jkernels.internal_force(jdN, jdetJw, jnp.asarray(D),
                                   jnp.asarray(u_e)))
    eps, sig = kernels.recover_stress_strain(dN, detJw, torch.as_tensor(D),
                                             torch.as_tensor(u_e), form)
    jeps, jsig = jkernels.recover_stress_strain(jdN, jdetJw, jnp.asarray(D),
                                                jnp.asarray(u_e), form)
    _close(eps, jeps)
    _close(sig, jsig)


def test_node_incidence_equals_reference():
    m = _perturbed_beam()
    np.testing.assert_array_equal(
        operator.node_incidence(m.conn, m.nnode),
        joperator.node_incidence(m.conn, m.nnode))


@pytest.mark.parametrize("elem_type", ["HEX8_G2", "HEX8_G1"])
def test_stiffness_operator_matches_reference(elem_type):
    m = _perturbed_beam(elem_type, seed=2)
    args = (m.coords, m.conn, m.elem_d_matrices(), m.fix_mask(),
            m.formulation())
    jop = joperator.build_operator(*args)
    op = operator.build_operator(*args, dtype=F64, device="cpu")
    u = np.random.default_rng(3).standard_normal((m.nnode, 3))
    for method in ("apply_raw", "apply"):
        _close(getattr(op, method)(torch.as_tensor(u)),
               getattr(jop, method)(jnp.asarray(u)))
    _close(op.diagonal(), jop.diagonal())
    f_e = np.random.default_rng(4).standard_normal((m.nelem, 8, 3))
    _close(op.scatter_add(torch.as_tensor(f_e)),
           jop.scatter_add(jnp.asarray(f_e)))
    np.testing.assert_array_equal(op.gather(torch.as_tensor(u)).numpy(),
                                  np.asarray(jop.gather(jnp.asarray(u))))


def test_scatter_is_deterministic():
    m = _perturbed_beam()
    op = operator.build_operator(m.coords, m.conn, m.elem_d_matrices(),
                                 m.fix_mask(), m.formulation(), dtype=F64,
                                 device="cpu")
    u = torch.as_tensor(np.random.default_rng(5).standard_normal((m.nnode, 3)))
    assert torch.equal(op.apply(u), op.apply(u))


def test_dtype_policy_and_no_cpu_fallback():
    assert operator.default_dtype() == torch.float32
    m = meshgen.hex_beam(2, 2, 2)
    op = operator.build_operator(m.coords, m.conn, m.elem_d_matrices(),
                                 m.fix_mask(), m.formulation(), device="cpu")
    assert op.dtype == torch.float32 and op.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            operator.build_operator(m.coords, m.conn, m.elem_d_matrices(),
                                    m.fix_mask(), m.formulation())
