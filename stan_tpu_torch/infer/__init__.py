"""Probabilistic inference layer: FEM forward model + samplers.

Port of stan_tpu/infer/__init__.py: HMC, NUTS, VI and SMC over material
and load parameters, with the linear-statics solve as the differentiable
forward model. The same names, from the port's own modules.
"""

from stan_tpu_torch.infer.calibrate import CalibrationProblem, make_problem  # noqa: F401
from stan_tpu_torch.infer.forward import build_forward, displacement_fn  # noqa: F401
from stan_tpu_torch.infer.hmc import run_hmc  # noqa: F401
from stan_tpu_torch.infer.nuts import run_nuts  # noqa: F401
from stan_tpu_torch.infer.smc import run_smc  # noqa: F401
from stan_tpu_torch.infer.vi import run_advi  # noqa: F401
