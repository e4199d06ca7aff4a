"""stan_tpu_torch: the PyTorch/CUDA port of stan_tpu, for an NVIDIA H100.

This slice runs the linear static solve of a structured HEX8 grid end to
end: model -> structured-grid detection -> stencil tables -> masked stencil
operator (hand-written CUDA sweep, csrc/stencil_sweep.cu) -> Jacobi PCG ->
float64 certification -> stress recovery. Module names mirror stan_tpu's.
The port imports torch and never jax; it shares stan_tpu's numpy-only host
modules (core, fem.elements, fem.hostops, io.stdb, utils.config).

Entry points default to ``device="cuda"`` and never move to the CPU on
their own. Tensors on the CPU take each kernel's plain PyTorch version,
which is what the CPU parity tests run (in float64).
"""

__version__ = "0.1.0"
