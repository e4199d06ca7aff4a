"""stan_tpu_torch: the PyTorch/CUDA port of stan_tpu, for an NVIDIA H100.

It runs the linear static solve of a structured HEX8 grid end to end:
model -> structured-grid detection -> stencil tables -> masked stencil
operator (hand-written CUDA sweep, csrc/stencil_sweep.cu) -> Jacobi PCG ->
float64 certification -> stress recovery; and the HMC calibration whose
forward model is that solve (infer/, on csrc/theta_sweep.cu). Module names
mirror stan_tpu's.
The port imports torch and never jax, nor anything of stan_tpu: it keeps
its own copies of the numpy-only host modules it needs (core.model,
core.meshgen, core.validate, fem.elements, fem.hostops, io.stdb,
utils.config, utils.checkpoint), each headed by the name of its source.

Entry points default to ``device="cuda"`` and never move to the CPU on
their own. Tensors on the CPU take each kernel's plain PyTorch version,
which is what the CPU parity tests run (in float64).
"""

__version__ = "0.1.0"
