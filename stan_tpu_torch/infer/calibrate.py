"""FEM calibration: posterior over material/load parameters from displacements.

Port of stan_tpu/infer/calibrate.py (CalibrationProblem, make_problem).
Given noisy displacement observations at selected DOFs, infer θ = (log E,
ν, log load scale) with the linear FEM solve as the forward model
(infer/forward.py, implicit-adjoint gradients). The log posterior is
chain-batched: θ [C, 3] -> [C], one chain-batched solve for all chains.

Priors (weakly informative):
  log E        ~ Normal(mu_logE, sigma_logE)
  ν            ~ Uniform(0, 0.5)   via a logit transform with its Jacobian
  log s (load) ~ Normal(0, sigma_logs)
Likelihood: y ~ Normal(u_obs(θ), sigma_obs), independent per observed DOF.

The domain-sharded problem (make_sharded_problem, obs_grids) waits for
multi-GPU: ROADMAP.md queue 1, item 10.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from stan_tpu_torch.core.model import FEModel
from stan_tpu_torch.infer import forward as fwd_mod


@dataclasses.dataclass
class CalibrationProblem:
    fwd: fwd_mod.StencilForwardProblem
    obs_idx: np.ndarray  # [n_obs, 2] (node, dir) indices
    y: torch.Tensor  # [n_obs] observations, on the forward's device
    sigma_obs: float
    mu_logE: float = float(np.log(210000.0))
    sigma_logE: float = 1.0
    sigma_logs: float = 0.5
    infer_load: bool = False  # fix log s = 0 unless enabled

    def __post_init__(self):
        # (dir, i, j, k) of every observation on the node grid (meshgen
        # numbering: node = i*nny*nnz + j*nnz + k), on the device once, so
        # the gather in u_obs copies nothing from the host.
        _, nny, nnz = self.fwd.node_shape
        nodes, dirs = self.obs_idx[:, 0], self.obs_idx[:, 1]
        idx = np.stack([dirs, nodes // (nny * nnz), (nodes // nnz) % nny,
                        nodes % nnz])
        self._grid_idx = tuple(torch.as_tensor(idx, device=self.fwd.device))

    def u_obs(self, theta: torch.Tensor) -> torch.Tensor:
        """Forward displacements at the observed DOFs, [C, n_obs]; θ rows
        are (log E, ν, log s)."""
        u = fwd_mod.solve_theta(self.fwd, theta)
        return u[(slice(None),) + self._grid_idx]

    def log_posterior(self, theta: torch.Tensor) -> torch.Tensor:
        """Unnormalised log posterior [C] of θ [C, 3] in the unconstrained
        parameterisation (log E, logit(2ν), log s)."""
        log_E, t_nu = theta[:, 0], theta[:, 1]
        nu = 0.5 * torch.sigmoid(t_nu)
        log_s = theta[:, 2] if self.infer_load else torch.zeros_like(log_E)

        pred = self.u_obs(torch.stack([log_E, nu, log_s], dim=1))
        resid = (self.y - pred) / self.sigma_obs
        loglike = -0.5 * torch.sum(resid ** 2, dim=1)

        lp = -0.5 * ((log_E - self.mu_logE) / self.sigma_logE) ** 2
        # logit-uniform Jacobian: log dν/dt = log 0.5 + log σ(t) + log σ(-t)
        lp = lp + F.logsigmoid(t_nu) + F.logsigmoid(-t_nu)
        if self.infer_load:
            lp = lp - 0.5 * (log_s / self.sigma_logs) ** 2
        return loglike + lp

    @staticmethod
    def constrain(samples: np.ndarray) -> np.ndarray:
        """[..., 3] unconstrained -> (E, ν, s)."""
        E = np.exp(samples[..., 0])
        nu = 0.5 / (1.0 + np.exp(-samples[..., 1]))
        s = np.exp(samples[..., 2])
        return np.stack([E, nu, s], axis=-1)


def make_problem(
    model: FEModel,
    obs_nodes: Sequence[int],
    obs_dirs: Sequence[int],
    y: np.ndarray,
    sigma_obs: float,
    *,
    dtype=None,
    device="cuda",
    cg_tol: float = 1.0e-8,
    infer_load: bool = False,
    **prior_kwargs,
) -> CalibrationProblem:
    """The calibration posterior of `model` against observations y at
    (obs_nodes, obs_dirs), on `device` in `dtype` (float32 by default)."""
    fwd = fwd_mod.build_forward(model, dtype=dtype, device=device,
                                cg_tol=cg_tol)
    obs_idx = np.stack([np.asarray(obs_nodes, np.int64),
                        np.asarray(obs_dirs, np.int64)], axis=1)
    return CalibrationProblem(
        fwd=fwd, obs_idx=obs_idx,
        y=torch.as_tensor(np.asarray(y), dtype=fwd.dtype, device=fwd.device),
        sigma_obs=float(sigma_obs), infer_load=infer_load, **prior_kwargs)
