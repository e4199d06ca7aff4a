// Coefficient-parameterised stencil sweep f_b = a_b·K_λ u_b + b_b·K_μ u_b
// over a batch of ghost-padded node grids, written by hand for Hopper
// (sm_90a), float and double.
//
// Replaces the Pallas TPU kernels stan_tpu/fem/stencil.py:fused_sweep_theta
// (B = 1) and fused_sweep_theta_batched (one launch for B chains), both with
// body _make_fused_kernel_theta, and keeps their contract:
//   up     [B, 3, SX+2, NNY+2, NNZ+2]  one ghost-padded slab per chain
//   tables [2, 27, 27, 3, 3]           the unit-λ (0) and unit-μ (1)
//                                      signature tables, packed as in
//                                      stencil_sweep.cu
//   coef   [B, 2]                      (a_b, b_b) per chain, in device memory
//   out    [B, 3, SX, NNY, NNZ]
//   is_low / is_high                   the slab owns the global low / high x
//                                      face (the same flags for every chain)
//
// What bounds it on an H100. Per node the sweep reads 81 neighbour values
// and does 243 multiply-adds with coefficients that depend only on the
// chain and on the node's boundary signature; its compulsory traffic is one
// read of up and one write of out. At [16, 3, 35, 35, 35] float that is
// 15.1 MB (4.5 µs at 3.35 TB/s) against 0.28 GFLOP (4.2 µs at 67 TFLOP/s).
// What holds this kernel back instead is the shared-memory traffic of the
// coefficients and neighbours into registers and the latency of each
// block's start (fetching its first planes and forming its coefficients),
// which a short walk along x amortises over only a few groups.
//
// Design: the tile machinery of sweep_tile.cuh (2.5D blocking with a
// cp.async ring of x-planes, R = 4 x-planes per thread in registers,
// signature slots in shared memory, face planes as a difference row). Each
// block combines a·T_λ + b·T_μ for its chain into its slots once.

#include "sweep_tile.cuh"

namespace {

using namespace sweep_tile;

constexpr int kR = 4;  // x-planes per group (register blocking)
constexpr int kThreads = 256;
constexpr Sizing kSizing = {128, 2};  // max_tz, blocks_per_sm

// Slots a·T_λ + b·T_μ with (a, b) = coef[chain]: each thread forms one
// (q, c, d) entry of every slot.
template <typename T>
struct ThetaCoef {
  static constexpr bool COPIES = false;
  const T* tables;  // [2, 27, 27, 3, 3]
  const T* coef;    // [B, 2]
  __device__ __forceinline__ void fill(T* slots, const int* sig_of, int used,
                                       bool diff, int yz_n, int chain, int tid,
                                       int nthr) const {
    const T ca = coef[2 * chain], cb = coef[2 * chain + 1];
    for (int e = tid; e < kRow; e += nthr) {
      const int q = e / 9, c = (e / 3) % 3, d = e % 3;
      T* const col = slots + (q * 3 + d) * 4 + c;
#pragma unroll 6
      for (int s = 0; s < used; ++s) {
        const T* const t = tables + sig_of[s] * kRow + e;
        T v = ca * __ldg(t) + cb * __ldg(t + kTable);
        if (diff && s >= yz_n) {
          const T* const f = tables + sig_of[s % yz_n] * kRow + e;
          v -= ca * __ldg(f) + cb * __ldg(f + kTable);
        }
        col[s * kSlot] = v;
      }
    }
  }
};

template <typename T>
int launch_theta(const T* up, const T* tables, const T* coef, T* out, int B,
                 int SX, int NNY, int NNZ, int is_low, int is_high,
                 void* stream) {
  return launch<T, kR, 0, kThreads, row_pad<T>()>(
      up, ThetaCoef<T>{tables, coef}, out, B, SX, NNY, NNZ, is_low, is_high,
      kSizing, stream);
}

}  // namespace

extern "C" int theta_sweep_f32(const float* up, const float* tables,
                               const float* coef, float* out, int B, int SX,
                               int NNY, int NNZ, int is_low, int is_high,
                               void* stream) {
  return launch_theta<float>(up, tables, coef, out, B, SX, NNY, NNZ, is_low,
                             is_high, stream);
}

extern "C" int theta_sweep_f64(const double* up, const double* tables,
                               const double* coef, double* out, int B, int SX,
                               int NNY, int NNZ, int is_low, int is_high,
                               void* stream) {
  return launch_theta<double>(up, tables, coef, out, B, SX, NNY, NNZ, is_low,
                              is_high, stream);
}

extern "C" const char* theta_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
