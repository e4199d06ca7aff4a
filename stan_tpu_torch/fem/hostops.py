# Copied from stan_tpu/fem/hostops.py (every function; the port reads its
# operators' tensors through .cpu()), with general_twin_np added: the
# general operator's twin in the host runtime, which certifies at 1M DOF.
"""Host-side float64 operators (numpy).

The port builds the structured grid's unit-Lame element stiffness
matrices from element_stiffness_np and d_np, in float64 on the host,
before moving them to the card. The rest of this module is the float64
action of the same assembled K for each operator family, in numpy on the
host, independent of the device code:

  * general_apply_np: matvec through per-element ke + np.add.at scatter
    (the spec, for small meshes),
  * general_twin_np: the same K from the host runtime (native.py): ke built
    and applied with OpenMP, scattered through the incidence map,
  * stencil_apply_np: the exact float64 signature tables
    (fem/stencil.exact_tables + apply_numpy),
  * structured_apply_np: the StructuredOperator slice-gather/scatter path,
  * masked_f64_apply: the twin of a device operator, by its family.

These are correctness/certification paths, not hot paths: one call costs a
few host-seconds at 1M DOF.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from stan_tpu_torch.fem.elements import ElementFormulation
from stan_tpu_torch.utils.timing import span


def _b_matrix_np(dN: np.ndarray) -> np.ndarray:
    """[..., 3, nn] gradients -> [..., 6, 3*nn] B, column 3*i+j = (node i,
    dir j) exactly as fem/kernels.b_matrix / BL0_Matrix (Element.cs:297-328)."""
    nn = dN.shape[-1]
    batch = dN.shape[:-2]
    B = np.zeros((*batch, 6, 3, nn), dtype=np.float64)
    dx, dy, dz = dN[..., 0, :], dN[..., 1, :], dN[..., 2, :]
    B[..., 0, 0, :] = dx
    B[..., 1, 1, :] = dy
    B[..., 2, 2, :] = dz
    B[..., 3, 0, :] = dy
    B[..., 3, 1, :] = dx
    B[..., 4, 1, :] = dz
    B[..., 4, 2, :] = dy
    B[..., 5, 0, :] = dz
    B[..., 5, 2, :] = dx
    return B.swapaxes(-1, -2).reshape(*batch, 6, 3 * nn)


def element_stiffness_np(
    coords_e: np.ndarray, D_e: np.ndarray, form: ElementFormulation
) -> np.ndarray:
    """float64 ke[E, 3nn, 3nn] = sum_g B^T D B detJ w on host.

    Twin of fem/kernels.element_stiffness (which runs at the device dtype);
    used where a float64 K is required on a TPU session with x64 disabled.
    """
    coords_e = np.asarray(coords_e, np.float64)
    D_e = np.asarray(D_e, np.float64)
    dN_local = np.asarray(form.gauss_dN, np.float64)  # [G, 3, nn]
    w = np.asarray(form.gauss_w, np.float64)  # [G]
    J = np.einsum("gkn,enj->egkj", dN_local, coords_e)
    detJ = np.linalg.det(J)
    Jinv = np.linalg.inv(J)
    dN = np.einsum("egkl,gln->egkn", Jinv, dN_local)
    B = _b_matrix_np(dN)  # [E, G, 6, 3nn]
    detJw = detJ * w[None, :]
    return np.einsum("egia,eij,egjb,eg->eab", B, D_e, B, detJw)


def d_np(lam: float, mu: float) -> np.ndarray:
    """float64 6x6 isotropic D from Lame constants (Material.cs:31-56),
    numpy twin of infer/forward.d_matrix_from_lame (which follows the jnp
    default dtype and is float32 on a TPU session)."""
    D = np.full((3, 3), lam, dtype=np.float64)
    D += 2.0 * mu * np.eye(3)
    out = np.zeros((6, 6), dtype=np.float64)
    out[:3, :3] = D
    out[3:, 3:] = mu * np.eye(3)
    return out


def general_apply_np(
    coords: np.ndarray,
    conn: np.ndarray,
    D_e: np.ndarray,
    form: ElementFormulation,
    fix_mask: np.ndarray,
) -> Callable[[np.ndarray], np.ndarray]:
    """Masked float64 K·u for an arbitrary mesh: u[nnode,3] -> f[nnode,3].

    Same masked-SPD convention as the device operators:
    f = M K (M u) + (I - M) u. Materializes ke[E, 3nn, 3nn] float64 once
    (~4.6 KB/element for HEX8) -- callers should bound nelem.
    """
    conn = np.asarray(conn)
    coords = np.asarray(coords, np.float64)
    ke = element_stiffness_np(coords[conn], D_e, form)  # [E, 3nn, 3nn]
    free = 1.0 - np.asarray(fix_mask, np.float64)
    E, nn = conn.shape

    def apply(u: np.ndarray) -> np.ndarray:
        u = np.asarray(u, np.float64)
        um = free * u
        u_e = um[conn].reshape(E, 3 * nn)
        f_e = np.einsum("eab,eb->ea", ke, u_e).reshape(E, nn, 3)
        f = np.zeros_like(um)
        np.add.at(f, conn, f_e)
        return free * f + (1.0 - free) * u

    return apply


def general_twin_np(
    coords: np.ndarray,
    conn: np.ndarray,
    D_e: np.ndarray,
    form: ElementFormulation,
    fix_mask: np.ndarray,
) -> Callable[[np.ndarray], np.ndarray]:
    """general_apply_np's masked float64 K·u, built and swept by the host
    runtime (native.element_stiffness_f64, element_apply_f64): ke [E, 3nn,
    3nn] float64 once (4.6 KB an element for HEX8), each sweep one product
    per element and a gather through fem/operator.node_incidence. The
    build and each sweep are spans (twin.general.build, .sweep)."""
    from stan_tpu_torch import native
    from stan_tpu_torch.fem.operator import node_incidence

    with span("twin.general.build"):
        coords = np.asarray(coords, np.float64)
        conn = np.ascontiguousarray(conn, dtype=np.int64)
        ke = native.element_stiffness_f64(coords, conn, D_e, form.gauss_dN,
                                          form.gauss_w)
        inc = node_incidence(conn, coords.shape[0])
        free = 1.0 - np.asarray(fix_mask, np.float64)
        fe = np.empty(ke.shape[0] * ke.shape[1] + 3)

    def apply(u: np.ndarray) -> np.ndarray:
        with span("twin.general.sweep"):
            u = np.asarray(u, np.float64)
            f = native.element_apply_f64(ke, conn, inc, free * u, fe)
            return free * f + (1.0 - free) * u

    return apply


def _host(t) -> np.ndarray:
    """A tensor of a (device) operator as a float64 numpy array."""
    return t.detach().cpu().numpy().astype(np.float64)


def stencil_apply_np(model, sop) -> Callable[[np.ndarray], np.ndarray]:
    """Masked float64 K·u for a StencilOperator (grid layout [3,nnx,nny,nnz])
    via the exact float64 signature tables (fem/stencil.exact_tables +
    apply_numpy)."""
    from stan_tpu_torch.fem import stencil as stencil_mod

    td = stencil_mod.exact_tables(model)
    if td is None:
        raise ValueError("model does not qualify for the stencil operator")
    tables, deltas = td
    free = _host(sop.free_mask)

    def apply(u: np.ndarray) -> np.ndarray:
        u = np.asarray(u, np.float64)
        um = free * u
        return (free * stencil_mod.apply_numpy(tables, deltas, um)
                + (1.0 - free) * u)

    return apply


def masked_f64_apply(model, op) -> Callable[[np.ndarray], np.ndarray]:
    """Float64 host twin of a device operator's masked apply, dispatched on
    the operator family. Input/output layout follows the operator: grid
    [3,nnx,nny,nnz] for stencil/structured, flat [nnode,3] for the general
    operator. Takes and returns numpy arrays, whatever the operator's
    device."""
    from stan_tpu_torch.fem.operator import StiffnessOperator
    from stan_tpu_torch.fem.stencil import StencilOperator
    from stan_tpu_torch.fem.structured import StructuredOperator

    if isinstance(op, StencilOperator):
        return stencil_apply_np(model, op)
    if isinstance(op, StructuredOperator):
        return structured_apply_np(model, op)
    if isinstance(op, StiffnessOperator):
        return general_twin_np(
            model.coords, model.conn,
            np.asarray(model.elem_d_matrices(), np.float64),
            model.formulation(), model.fix_mask())
    raise TypeError(f"unknown operator family {type(op).__name__}")


def structured_apply_np(model, sop) -> Callable[[np.ndarray], np.ndarray]:
    """Masked float64 K·u for a StructuredOperator, grid layout
    [3, nnx, nny, nnz]: the slice gather/scatter of
    fem/structured.StructuredOperator.apply, executed in numpy float64 with
    the unit-coefficient stiffness tables recomputed in float64 from the
    model's grid spacing (sop.ke_lam may be float32)."""
    from stan_tpu_torch.fem import structured as structured_mod

    nx, ny, nz = sop.nelems
    corners = structured_mod._CORNERS
    lam_e = _host(sop.lam_e)
    mu_e = _host(sop.mu_e)
    free = _host(sop.free_mask)
    info = structured_mod.detect_structured(model)
    if info is None:
        raise ValueError("model is not a structured grid")
    hx, hy, hz = info["spacing"]
    corner_xyz = np.asarray(
        [[dx * hx, dy * hy, dz * hz] for dx, dy, dz in corners], np.float64
    )[None]
    ke_lam = element_stiffness_np(corner_xyz, d_np(1.0, 0.0)[None], sop.form)[0]
    ke_mu = element_stiffness_np(corner_xyz, d_np(0.0, 1.0)[None], sop.form)[0]

    def apply(u: np.ndarray) -> np.ndarray:
        u = np.asarray(u, np.float64)
        um = free * u
        parts = [
            um[:, ox: ox + nx, oy: oy + ny, oz: oz + nz]
            for ox, oy, oz in corners
        ]
        u_e = np.concatenate(parts, axis=0).reshape(24, -1)
        f2 = (ke_lam @ u_e).reshape(24, nx, ny, nz) * lam_e[None]
        f2 = f2 + (ke_mu @ u_e).reshape(24, nx, ny, nz) * mu_e[None]
        total = np.zeros_like(um)
        for a, (ox, oy, oz) in enumerate(corners):
            slab = f2[3 * a: 3 * a + 3]
            pad = [(0, 0)] + [(o, 1 - o) for o in (ox, oy, oz)]
            total += np.pad(slab, pad)
        return free * total + (1.0 - free) * u

    return apply
