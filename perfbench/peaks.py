"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): HBM3 bandwidth, and the float32 and
float64 rates outside the tensor cores. Frozen with the values of the
port's stan_tpu_torch/bench.py (HBM_BYTES_PER_S, PEAK_FLOPS)."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}  # by bytes per element
