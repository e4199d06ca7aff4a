"""FEM calibration: posterior over material/load parameters from displacements.

Port of stan_tpu/infer/calibrate.py (CalibrationProblem, make_problem).
Given noisy displacement observations at selected DOFs, infer θ = (log E,
ν, log load scale) with the linear FEM solve as the forward model
(infer/forward.py, implicit-adjoint gradients), whichever of the three
forward problems build_forward picks for the model. The log posterior is
chain-batched: θ [C, 3] -> [C], one chain-batched solve for all chains.

Priors (weakly informative):
  log E        ~ Normal(mu_logE, sigma_logE)
  ν            ~ Uniform(0, 0.5)   via a logit transform with its Jacobian
  log s (load) ~ Normal(0, sigma_logs)
Likelihood: y ~ Normal(u_obs(θ), sigma_obs), independent per observed DOF.

On a device mesh, two forms:

  * make_problem(mesh=) places chains: one forward per distinct first
    device of the mesh's rows (of this process's rows when the mesh spans
    several processes), with the same routing, all counting into one
    SolveStats. log_posterior, log_likelihood and log_prior solve θ on
    θ's device, so a block of chains that run_hmc, run_nuts or run_smc
    (mesh=) hands to row r solves on row r's device. prob.fwd is the
    forward on the mesh's home device.
  * The chains x domain problem (make_sharded_problem, obs_grids,
    ShardedCalibrationProblem) has the same posterior with the forward
    solve also cut into x-slabs over the domain axis
    (forward.ShardedStencilForwardProblem); its logp_grad_b() places
    itself and feeds hmc.run_chains without mesh=.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from stan_tpu_torch.core.model import FEModel
from stan_tpu_torch.infer import forward as fwd_mod
from stan_tpu_torch.parallel.distributed import DeviceMesh, canonical


@dataclasses.dataclass
class CalibrationProblem:
    fwd: object  # a forward problem of infer/forward.py
    obs_idx: np.ndarray  # [n_obs, 2] (node, dir) indices
    y: torch.Tensor  # [n_obs] observations, on the forward's device
    sigma_obs: float
    mu_logE: float = float(np.log(210000.0))
    sigma_logE: float = 1.0
    sigma_logs: float = 0.5
    infer_load: bool = False  # fix log s = 0 unless enabled
    # The forwards on the other rows' devices of a mesh (make_problem(
    # mesh=)), each sharing fwd's SolveStats.
    row_fwds: tuple = ()

    def __post_init__(self):
        # Each observation's index into the forward's layout, on each
        # forward's device once, so the gather in u_obs copies nothing from
        # the host.
        idx = self.fwd.obs_index(self.obs_idx[:, 0], self.obs_idx[:, 1])
        self._on = {
            f.device: (f, tuple(torch.as_tensor(idx, device=f.device)),
                       self.y.to(f.device))
            for f in (self.fwd, *self.row_fwds)}

    @property
    def held(self) -> tuple:
        """The coordinates log_posterior does not depend on, for the
        samplers' ``held=``: log s unless the load is inferred."""
        return (False, False, not self.infer_load)

    def _at(self, device) -> tuple:
        """(forward, observation index, y) on `device`."""
        if device not in self._on:
            raise ValueError(f"θ lies on {device}; this problem's forwards "
                             f"are on {sorted(map(str, self._on))}")
        return self._on[device]

    def u_obs(self, theta: torch.Tensor) -> torch.Tensor:
        """Forward displacements at the observed DOFs, [C, n_obs], solved on
        θ's device; θ rows are (log E, ν, log s)."""
        fwd, idx, _ = self._at(theta.device)
        u = fwd_mod.solve_theta(fwd, theta)
        return u[(slice(None),) + idx]

    def log_posterior(self, theta: torch.Tensor) -> torch.Tensor:
        """Unnormalised log posterior [C] of θ [C, 3] in the unconstrained
        parameterisation (log E, logit(2ν), log s)."""
        log_E, t_nu = theta[:, 0], theta[:, 1]
        nu = 0.5 * torch.sigmoid(t_nu)
        log_s = theta[:, 2] if self.infer_load else torch.zeros_like(log_E)

        pred = self.u_obs(torch.stack([log_E, nu, log_s], dim=1))
        resid = (self._at(theta.device)[2] - pred) / self.sigma_obs
        loglike = -0.5 * torch.sum(resid ** 2, dim=1)
        return loglike + self._log_prior(theta, self.infer_load)

    def _log_prior(self, theta: torch.Tensor, load: bool) -> torch.Tensor:
        return _log_prior(self, theta, load)

    # SMC's split of the posterior (the reference CLI's, stan_tpu/cli.py:
    # 256-272): log_prior + log_likelihood = log_posterior. The prior always
    # holds log s's normal, as the reference's does, also when the load is
    # fixed and log_posterior has no log s term.

    def log_prior(self, theta: torch.Tensor) -> torch.Tensor:
        """Log prior [N] of θ [N, 3] (unconstrained)."""
        return self._log_prior(theta, True)

    def log_likelihood(self, theta: torch.Tensor) -> torch.Tensor:
        """log_posterior - log_prior, [N]."""
        return self.log_posterior(theta) - self.log_prior(theta)

    def sample_prior(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """n prior draws [n, 3] in float64 on the forward's device, from
        gen: log E normal, logit(2ν) standard logistic, log s normal."""
        like = dict(generator=gen, dtype=torch.float64,
                    device=self.fwd.device)
        u = torch.rand(n, **like)
        return torch.stack([
            self.mu_logE + self.sigma_logE * torch.randn(n, **like),
            torch.log(u) - torch.log1p(-u),
            self.sigma_logs * torch.randn(n, **like),
        ], dim=1)

    @staticmethod
    def constrain(samples: np.ndarray) -> np.ndarray:
        """[..., 3] unconstrained -> (E, ν, s)."""
        E = np.exp(samples[..., 0])
        nu = 0.5 / (1.0 + np.exp(-samples[..., 1]))
        s = np.exp(samples[..., 2])
        return np.stack([E, nu, s], axis=-1)


def _log_prior(prob, theta: torch.Tensor, load: bool) -> torch.Tensor:
    """The prior [C] of θ [C, 3] under prob's prior settings (both problem
    types); `load`: with log s's normal."""
    lp = -0.5 * ((theta[:, 0] - prob.mu_logE) / prob.sigma_logE) ** 2
    # logit-uniform Jacobian: log dν/dt = log 0.5 + log σ(t) + log σ(-t)
    lp = lp + F.logsigmoid(theta[:, 1]) + F.logsigmoid(-theta[:, 1])
    if load:
        lp = lp - 0.5 * (theta[:, 2] / prob.sigma_logs) ** 2
    return lp


@dataclasses.dataclass
class ShardedCalibrationProblem:
    """Chains x domain calibration: CalibrationProblem's posterior (the same
    priors and transform; the observation term a masked sum over the grid)
    with the forward solve on a device mesh
    (forward.ShardedStencilForwardProblem). Feed ``logp_grad_b()`` to
    hmc.run_chains."""

    fwd: fwd_mod.ShardedStencilForwardProblem
    w_grid: np.ndarray  # [3, NNX, NNY, NNZ] observation mask
    y_grid: np.ndarray  # observed values on the grid (0 where w is 0)
    sigma_obs: float
    mu_logE: float = float(np.log(210000.0))
    sigma_logE: float = 1.0
    sigma_logs: float = 0.5
    infer_load: bool = False

    def theta_to_material(self, theta: torch.Tensor):
        """Unconstrained θ [C, 3] = (log E, logit(2ν), log s) -> (λ, μ, load
        scale), [C] each: CalibrationProblem.log_posterior's transform."""
        nu = 0.5 * torch.sigmoid(theta[:, 1])
        lam, mu = fwd_mod.lame_from_E_nu(torch.exp(theta[:, 0]), nu)
        s = (torch.exp(theta[:, 2]) if self.infer_load
             else torch.ones_like(nu))
        return lam, mu, s

    def prior_logp(self, theta: torch.Tensor) -> torch.Tensor:
        return _log_prior(self, theta, self.infer_load)

    def logp_grad_b(self):
        """θ [C, D] -> (log posterior [C], gradient [C, D]) through the
        sharded forward, for hmc.run_chains."""
        return self.fwd.make_batched_logp_grad(
            self.w_grid, self.y_grid, self.sigma_obs,
            self.theta_to_material, self.prior_logp)

    constrain = staticmethod(CalibrationProblem.constrain)


def obs_grids(node_shape, obs_nodes, obs_dirs, y):
    """Scatter (node, dir) observations onto [3, NNX, NNY, NNZ] mask and
    value grids (meshgen numbering: id = i*nny*nnz + j*nnz + k). A repeated
    (node, dir) pair is refused, as the reference refuses it: the grid form
    holds one value per DOF (make_problem accepts repeats)."""
    nnx, nny, nnz = node_shape
    nodes = np.asarray(obs_nodes, np.int64)
    dirs = np.asarray(obs_dirs, np.int64)
    pairs = set(zip(nodes.tolist(), dirs.tolist()))
    if len(pairs) != len(nodes):
        raise ValueError("duplicate (node, dir) observations")
    i = nodes // (nny * nnz)
    j = (nodes // nnz) % nny
    k = nodes % nnz
    w = np.zeros((3, nnx, nny, nnz))
    yg = np.zeros((3, nnx, nny, nnz))
    w[dirs, i, j, k] = 1.0
    yg[dirs, i, j, k] = np.asarray(y, np.float64)
    return w, yg


def make_sharded_problem(
    model: FEModel,
    mesh: DeviceMesh,
    obs_nodes: Sequence[int],
    obs_dirs: Sequence[int],
    y: np.ndarray,
    sigma_obs: float,
    *,
    dtype: Optional[torch.dtype] = None,
    cg_tol: float = 1.0e-8,
    infer_load: bool = False,
    **prior_kwargs,
) -> ShardedCalibrationProblem:
    """The chains x domain calibration problem on `mesh`. Raises if the
    model does not qualify for the sharded stencil forward; the caller
    falls back to make_problem."""
    fwd = fwd_mod.build_sharded_stencil_forward(
        model, mesh, dtype=dtype, cg_tol=cg_tol)
    if fwd is None:
        raise ValueError(
            "model does not qualify for the sharded stencil forward "
            "(structured HEX8 grid with NNX divisible by the domain axis)")
    w, yg = obs_grids(fwd.node_shape, obs_nodes, obs_dirs, y)
    return ShardedCalibrationProblem(
        fwd=fwd, w_grid=w, y_grid=yg, sigma_obs=float(sigma_obs),
        infer_load=infer_load, **prior_kwargs)


def make_problem(
    model: FEModel,
    obs_nodes: Sequence[int],
    obs_dirs: Sequence[int],
    y: np.ndarray,
    sigma_obs: float,
    *,
    dtype=None,
    device=None,
    cg_tol: float = 1.0e-8,
    infer_load: bool = False,
    prefer_stencil: bool = True,
    mesh: Optional[DeviceMesh] = None,
    **prior_kwargs,
) -> CalibrationProblem:
    """The calibration posterior of `model` against observations y at
    (obs_nodes, obs_dirs), on `device` (default "cuda") in `dtype` (float32
    by default), with the forward problem build_forward routes to
    (prefer_stencil=False: the general one).

    With `mesh`, a forward on each distinct first device of its rows
    (forward.build_row_forwards; the module docstring); `device` defaults
    to the mesh's home device (its first device of this process), and
    another one is refused (ValueError)."""
    kw = dict(dtype=dtype, cg_tol=cg_tol, prefer_stencil=prefer_stencil)
    if mesh is None:
        fwds = [fwd_mod.build_forward(model, device=device or "cuda", **kw)]
    else:
        home = mesh.home
        if device is not None and canonical(device) != home:
            raise ValueError(f"device {device!r} is not the mesh's home, "
                             f"this process's first device {home}")
        fwds = fwd_mod.build_row_forwards(model, mesh, **kw)
    fwd = fwds[0]
    obs_idx = np.stack([np.asarray(obs_nodes, np.int64),
                        np.asarray(obs_dirs, np.int64)], axis=1)
    return CalibrationProblem(
        fwd=fwd, obs_idx=obs_idx,
        y=torch.as_tensor(np.asarray(y), dtype=fwd.dtype, device=fwd.device),
        sigma_obs=float(sigma_obs), infer_load=infer_load,
        row_fwds=tuple(fwds[1:]), **prior_kwargs)
