// Assembled 27-point stencil sweep K·u for a uniform-material structured
// HEX8 grid, written by hand for Hopper (sm_90a), float and double.
//
// Replaces the Pallas TPU kernel stan_tpu/fem/stencil.py:fused_sweep (body
// _make_fused_kernel) and keeps its contract:
//   up    [3, SX+2, NNY+2, NNZ+2]  node slab with a one-node ghost layer
//                                  (zeros for a whole grid; a neighbour's
//                                  boundary plane in x for a slab)
//   table [27, 27, 3, 3]           exact assembled 3x3 blocks per boundary
//                                  signature and lattice offset
//   out   [3, SX, NNY, NNZ]
//   is_low / is_high               the slab owns the global low / high x face
// Signature index 9*sx + 3*sy + sz with F=0, L=1, H=2 per axis (the order
// of stan_tpu_torch/fem/stencil.py:_SIGS); offset index
// 9*(ox+1) + 3*(oy+1) + (oz+1).
//
// Design. One thread per output node computes its three components. The TPU
// kernel applies the interior table to a whole block and then overwrites
// faces, edges and corners tier by tier; here each thread picks its node's
// own exact signature table directly (x from i against the slab ends and
// the two flags, y and z from j and k against the grid ends) and sums the
// 27 offsets of that table. The last tier that writes a node on the TPU is
// the one whose signature is exactly the node's, so the rows are the same,
// with no overwrite passes and no branch in the inner loop. The ghost layer
// keeps every read in bounds.
//
// What bounds it on an H100: device-memory bytes. A node costs 243 FMAs
// against 12 bytes of output and, once neighbours are reused through L1
// and L2, about 12 bytes of input (float); that is far below the card's
// FLOP-per-byte ridge. The design keeps the traffic near one read of `up`
// and one write of `out`: consecutive threads take consecutive k (the
// unit-stride axis), so every one of a warp's 81 neighbour reads is a
// coalesced row that neighbouring warps and planes share in cache, and the
// 26 KB (float) / 52 KB (double) table goes through the read-only data
// cache, where the threads of a warp almost always read the same entry.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_sweep_kernel(const T* __restrict__ up, const T* __restrict__ table,
                     T* __restrict__ out, int SX, int NNY, int NNZ,
                     int is_low, int is_high) {
  const long long n_nodes = (long long)SX * NNY * NNZ;
  const long long node = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n_nodes) return;
  const int k = (int)(node % NNZ);
  const int j = (int)((node / NNZ) % NNY);
  const int i = (int)(node / ((long long)NNZ * NNY));

  const int sx = (i == 0 && is_low) ? 1 : ((i == SX - 1 && is_high) ? 2 : 0);
  const int sy = (j == 0) ? 1 : ((j == NNY - 1) ? 2 : 0);
  const int sz = (k == 0) ? 1 : ((k == NNZ - 1) ? 2 : 0);
  const T* __restrict__ tab = table + (9 * sx + 3 * sy + sz) * 243;

  const int NYp = NNY + 2, NZp = NNZ + 2;
  const long long comp = (long long)(SX + 2) * NYp * NZp;
  // Padded position of the node's (-1, -1, -1) neighbour in component 0.
  const T* __restrict__ u = up + ((long long)i * NYp + j) * NZp + k;

  T f0 = 0, f1 = 0, f2 = 0;
#pragma unroll
  for (int ox = 0; ox < 3; ++ox) {
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
#pragma unroll
      for (int oz = 0; oz < 3; ++oz) {
        const long long p = ((long long)ox * NYp + oy) * NZp + oz;
        const T a = __ldg(u + p);
        const T b = __ldg(u + comp + p);
        const T c = __ldg(u + 2 * comp + p);
        const T* t = tab + 9 * (9 * ox + 3 * oy + oz);
        f0 += __ldg(t + 0) * a + __ldg(t + 1) * b + __ldg(t + 2) * c;
        f1 += __ldg(t + 3) * a + __ldg(t + 4) * b + __ldg(t + 5) * c;
        f2 += __ldg(t + 6) * a + __ldg(t + 7) * b + __ldg(t + 8) * c;
      }
    }
  }
  out[node] = f0;
  out[n_nodes + node] = f1;
  out[2 * n_nodes + node] = f2;
}

template <typename T>
int launch(const T* up, const T* table, T* out, int SX, int NNY, int NNZ,
           int is_low, int is_high, void* stream) {
  const long long n_nodes = (long long)SX * NNY * NNZ;
  if (n_nodes == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n_nodes + kThreads - 1) / kThreads);
  stencil_sweep_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      up, table, out, SX, NNY, NNZ, is_low, is_high);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stencil_sweep_f32(const float* up, const float* table,
                                 float* out, int SX, int NNY, int NNZ,
                                 int is_low, int is_high, void* stream) {
  return launch<float>(up, table, out, SX, NNY, NNZ, is_low, is_high, stream);
}

extern "C" int stencil_sweep_f64(const double* up, const double* table,
                                 double* out, int SX, int NNY, int NNZ,
                                 int is_low, int is_high, void* stream) {
  return launch<double>(up, table, out, SX, NNY, NNZ, is_low, is_high, stream);
}

extern "C" const char* stencil_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
