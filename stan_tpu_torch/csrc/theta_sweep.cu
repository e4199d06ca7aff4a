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
// Design. The stencil_sweep kernel with a chain index: blockIdx.y is the
// chain, blockIdx.x * blockDim.x + threadIdx.x the node, and each thread
// picks its node's own signature table. The coefficients are read by every
// thread from device memory (one broadcast load per block): they come out
// of the sampler's state on the card, so reading them on the host would add
// a sync to every matvec. As on the TPU, each of the 243 coefficients of a
// node's row is formed as a·T_λ + b·T_μ (one extra multiply-add and one
// extra table load per coefficient) and then applied with the same 243
// FMAs as a fixed-table sweep: one pass over u instead of two.
//
// What bounds it on an H100: as for stencil_sweep, the load/store units,
// not device memory: a thread makes 81 neighbour loads and 486 table loads
// (the two tables, 52 KB float / 104 KB double, stay in L1/L2 and the
// threads of a warp almost always read the same entry) against 12 bytes of
// output. Consecutive threads take consecutive k, so each neighbour read of
// a warp is one coalesced row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTable = 27 * 27 * 9;  // one packed table set

template <typename T>
__global__ void __launch_bounds__(kThreads)
theta_sweep_kernel(const T* __restrict__ up, const T* __restrict__ tables,
                   const T* __restrict__ coef, T* __restrict__ out, int SX,
                   int NNY, int NNZ, int is_low, int is_high) {
  const long long n_nodes = (long long)SX * NNY * NNZ;
  const long long node = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n_nodes) return;
  const int chain = blockIdx.y;
  const T ca = __ldg(coef + 2 * chain);
  const T cb = __ldg(coef + 2 * chain + 1);
  const int k = (int)(node % NNZ);
  const int j = (int)((node / NNZ) % NNY);
  const int i = (int)(node / ((long long)NNZ * NNY));

  const int sx = (i == 0 && is_low) ? 1 : ((i == SX - 1 && is_high) ? 2 : 0);
  const int sy = (j == 0) ? 1 : ((j == NNY - 1) ? 2 : 0);
  const int sz = (k == 0) ? 1 : ((k == NNZ - 1) ? 2 : 0);
  const int sig = (9 * sx + 3 * sy + sz) * 243;
  const T* __restrict__ tl = tables + sig;
  const T* __restrict__ tm = tables + kTable + sig;

  const int NYp = NNY + 2, NZp = NNZ + 2;
  const long long comp = (long long)(SX + 2) * NYp * NZp;
  // Padded position of the node's (-1, -1, -1) neighbour in component 0 of
  // this chain's slab.
  const T* __restrict__ u =
      up + 3 * comp * chain + ((long long)i * NYp + j) * NZp + k;

  T f0 = 0, f1 = 0, f2 = 0;
#pragma unroll
  for (int ox = 0; ox < 3; ++ox) {
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
#pragma unroll
      for (int oz = 0; oz < 3; ++oz) {
        const long long p = ((long long)ox * NYp + oy) * NZp + oz;
        const T x = __ldg(u + p);
        const T y = __ldg(u + comp + p);
        const T z = __ldg(u + 2 * comp + p);
        const int q = 9 * (9 * ox + 3 * oy + oz);
        T w[9];
#pragma unroll
        for (int e = 0; e < 9; ++e)
          w[e] = ca * __ldg(tl + q + e) + cb * __ldg(tm + q + e);
        f0 += w[0] * x + w[1] * y + w[2] * z;
        f1 += w[3] * x + w[4] * y + w[5] * z;
        f2 += w[6] * x + w[7] * y + w[8] * z;
      }
    }
  }
  T* __restrict__ o = out + 3 * n_nodes * chain;
  o[node] = f0;
  o[n_nodes + node] = f1;
  o[2 * n_nodes + node] = f2;
}

template <typename T>
int launch(const T* up, const T* tables, const T* coef, T* out, int B, int SX,
           int NNY, int NNZ, int is_low, int is_high, void* stream) {
  const long long n_nodes = (long long)SX * NNY * NNZ;
  if (n_nodes == 0 || B == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((n_nodes + kThreads - 1) / kThreads),
                  (unsigned)B);
  theta_sweep_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      up, tables, coef, out, SX, NNY, NNZ, is_low, is_high);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int theta_sweep_f32(const float* up, const float* tables,
                               const float* coef, float* out, int B, int SX,
                               int NNY, int NNZ, int is_low, int is_high,
                               void* stream) {
  return launch<float>(up, tables, coef, out, B, SX, NNY, NNZ, is_low,
                       is_high, stream);
}

extern "C" int theta_sweep_f64(const double* up, const double* tables,
                               const double* coef, double* out, int B, int SX,
                               int NNY, int NNZ, int is_low, int is_high,
                               void* stream) {
  return launch<double>(up, tables, coef, out, B, SX, NNY, NNZ, is_low,
                        is_high, stream);
}

extern "C" const char* theta_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
