"""The general operator's apply on the CPU: the plain version keeps its bits,
the kernels' int32 indices equal the operator's, and the kernel wrapper
refuses what its kernels do not take before it builds anything. The
kernels themselves run in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from stan_tpu_torch import _build
from stan_tpu_torch.fem import kernels, launches, operator
from stan_tpu_torch.infer import forward

from general_apply_cases import FORMS, case


def _apply_before(op, u):
    """The operator's apply as it was written before the kernels came: the
    gather, fem/kernels.internal_force and the incidence scatter, masked."""
    m = op.free_mask
    f_e = kernels.internal_force(op.dN, op.detJw, op.D, (m * u)[..., op.conn,
                                                                :])
    flat = f_e.reshape(*f_e.shape[:-3], -1, 3)
    padded = torch.cat([flat, flat.new_zeros((*flat.shape[:-2], 1, 3))],
                       dim=-2)
    return m * padded[..., op.inc_idx, :].sum(dim=-2) + (1.0 - m) * u


@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_apply_keeps_its_bits(dtype, form, B):
    op, u = case("beam", form, dtype, "cpu", B=B)
    got = op.apply(u)
    assert got.dtype == dtype and got.shape == u.shape
    assert torch.equal(got, _apply_before(op, u))
    assert torch.equal(got, op.apply_reference(u))


@pytest.mark.parametrize("kind", ["beam", "plate"])
@pytest.mark.parametrize("form", FORMS)
def test_int32_indices_equal_the_operators(kind, form):
    op, _ = case(kind, form, torch.float64, "cpu")
    conn32, inc32 = op.index32()
    assert conn32.dtype == inc32.dtype == torch.int32
    assert conn32.is_contiguous() and inc32.is_contiguous()
    assert torch.equal(conn32.long(), op.conn)
    assert torch.equal(inc32.long(), op.inc_idx)
    assert int(inc32.max()) == op.conn.numel()  # the padding, one past
    again = op.index32()
    assert again[0] is conn32 and again[1] is inc32  # made once


def test_cpu_apply_makes_no_int32_copy():
    op, u = case("beam", "HEX8_G2", torch.float64, "cpu")
    op.apply(u)
    assert op._index32 == {}


def _args(form="HEX8_G2", dtype=torch.float32, B=None):
    op, u = case("beam", form, dtype, "cpu", B=B)
    conn32, inc32 = op.index32()
    return dict(u=u, free_mask=op.free_mask, conn32=conn32, dN=op.dN,
                detJw=op.detJw, D=op.D, inc32=inc32)


def _refused(monkeypatch, error, **changes):
    monkeypatch.setattr(_build, "library", None)  # a build would fail
    args = _args()
    args.update(changes)
    before = launches.snapshot()
    with pytest.raises(error):
        operator.general_apply(**args)
    assert launches.snapshot() == before


def test_wrapper_refuses_other_types(monkeypatch):
    a = _args()
    _refused(monkeypatch, TypeError, u=a["u"].half())
    _refused(monkeypatch, TypeError, D=a["D"].double())
    _refused(monkeypatch, TypeError, conn32=a["conn32"].long())
    _refused(monkeypatch, TypeError, inc32=a["inc32"].long())


def test_wrapper_refuses_other_shapes(monkeypatch):
    a = _args()
    _refused(monkeypatch, ValueError, u=a["u"][:, :2].contiguous())
    _refused(monkeypatch, ValueError, u=a["u"][None, None])
    _refused(monkeypatch, ValueError, free_mask=a["free_mask"][1:])
    _refused(monkeypatch, ValueError, conn32=a["conn32"][1:])
    _refused(monkeypatch, ValueError, detJw=a["detJw"][:, :4])
    _refused(monkeypatch, ValueError, inc32=a["inc32"][1:])
    _refused(monkeypatch, ValueError, dN=a["dN"][:, :2])  # no (8, 2) kernel
    _refused(monkeypatch, ValueError, dN=a["dN"][..., 0, :])
    # a D per system needs u with as many systems
    _refused(monkeypatch, ValueError, D=a["D"].expand(2, -1, -1, -1)
             .contiguous())
    _refused(monkeypatch, ValueError, u=a["u"].expand(70000, -1, -1),
             D=a["D"])
    _refused(monkeypatch, ValueError, D=a["D"][None, None].contiguous())


def test_wrapper_refuses_other_layouts(monkeypatch):
    a = _args()
    _refused(monkeypatch, ValueError,
             u=a["u"].T.contiguous().T)  # [nnode, 3] with strides (1, nnode)
    _refused(monkeypatch, ValueError, D=a["D"].transpose(1, 2))
    _refused(monkeypatch, ValueError,
             dN=a["dN"].transpose(2, 3).contiguous().transpose(2, 3))
    # a [3, nn] slice that does not start on 16 bytes
    flat = torch.zeros(a["dN"].numel() + 1, dtype=a["dN"].dtype)
    _refused(monkeypatch, ValueError, dN=flat[1:].view(a["dN"].shape))


def test_wrapper_refuses_a_gradient_and_the_cpu(monkeypatch):
    a = _args()
    _refused(monkeypatch, ValueError, D=a["D"].clone().requires_grad_())
    _refused(monkeypatch, ValueError)  # every check passed, but on the CPU


def test_wrapper_takes_the_operators_layouts(monkeypatch):
    """The layouts element_geometry gives (Gauss-point major dN and detJw,
    as build_operator stores them), and a D per system expanded over the
    elements (the general forward's, for a homogeneous material), pass
    every check but the device's."""
    monkeypatch.setattr(_build, "library", None)
    for form in FORMS:
        for a in (_args(form), _args(form, B=3)):
            assert not a["dN"].is_contiguous() or a["dN"].shape[1] == 1
            with pytest.raises(ValueError, match="CUDA device"):
                operator.general_apply(**a)
        a["D"] = a["D"][:, :1].expand(-1, a["D"].shape[1], -1, -1)
        assert a["D"].stride()[1] == 0
        with pytest.raises(ValueError, match="CUDA device"):
            operator.general_apply(**a)


def test_launch_counts_hold_the_general_applies(monkeypatch):
    monkeypatch.setattr(launches, "counts", launches.snapshot())
    launches.reset()
    launches.count("general_apply")
    launches.count("stencil_sweep", True, False)
    assert launches.snapshot() == {"general_apply": 1, "stencil_sweep": 1,
                                   ("stencil_sweep", 1, 0): 1}
    launches.add({"general_apply": 3}, 2)
    assert launches.counts["general_apply"] == 7
    launches.add({"general_apply": 3}, -1)
    assert launches.counts["general_apply"] == 4


def test_operator_with_shares_the_int32_indices():
    """The general forward's operator for each solve (its system's
    matvec, the operator's bound apply) carries the int32 copies of its
    geometry operator, made once."""
    op, _ = case("beam", "HEX8_G2", torch.float64, "cpu")
    fwd = forward.ForwardProblem(op0=op, f0=torch.zeros(op.nnode, 3),
                                 cg_tol=1e-8, cg_maxiter=10)
    a, b = (fwd.system(D)[0].__self__ for D in (op.D * 2, op.D[None] * 3))
    conn32, inc32 = a.index32()
    assert b.index32()[0] is conn32 and b.index32()[1] is inc32
    assert op.index32()[0] is conn32
    assert torch.equal(b.D, op.D[None] * 3) and b.conn is op.conn


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """apply sends everything off the CPU to the kernel wrapper."""
    op, u = case("beam", "HEX8_G2", torch.float32, "cpu")
    seen = []
    monkeypatch.setattr(operator, "general_apply",
                        lambda *args: seen.append(args) or args[0])
    monkeypatch.setattr(operator.StiffnessOperator, "apply_reference", None)
    meta = torch.empty(u.shape, dtype=u.dtype, device="meta")
    assert op.apply(meta) is meta
    (args,) = seen
    assert args[2].dtype == args[6].dtype == torch.int32
    assert np.array_equal(args[2].numpy(), op.conn.numpy())
