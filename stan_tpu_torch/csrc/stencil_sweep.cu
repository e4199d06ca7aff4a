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
// What bounds it on an H100. A node costs 243 multiply-adds against 12
// bytes of output and about 12 bytes of input (float): with up [3, 73, 73,
// 73] one read of up and one write of out is 9.0 MB (2.7 µs at 3.35 TB/s)
// against 0.17 GFLOP (2.6 µs at 67 TFLOP/s), so the card could do it in
// about 3 µs. What holds a sweep of this size back is the issue of loads
// (a node's 81 neighbours and 243 coefficients) and the latency of each
// block's start, on a grid that gives each SM only about 2,700 nodes.
//
// Design: the tile machinery of sweep_tile.cuh, shared with theta_sweep.cu
// (2.5D blocking with a cp.async ring of x-planes, R x-planes per thread in
// registers, signature slots in shared memory filled once per block, face
// planes swept as interior and corrected by a difference row), with B = 1
// and the one table copied into the slots. The TPU kernel's tiers of
// overwrites for faces, edges and corners become the per-lane choice of a
// slot; the ghost layer keeps every read in bounds. Each type has its own
// launch shape (Shape below): float and double differ in registers and in
// shared memory per plane.

#include "sweep_tile.cuh"

namespace {

using namespace sweep_tile;

// Launch shape per type: x-planes per group, threads per block, tile-row
// padding, widest z tile, blocks per SM aimed for by the x chunks, planes
// of the two face chunks (0: as long as the others).
template <typename T>
struct Shape;
template <>
struct Shape<float> {
  static constexpr int R = 4, THREADS = 256, PAD = 2, MAX_TZ = 128,
                       BLOCKS_PER_SM = 2, EDGE = 4;
};
template <>
struct Shape<double> {
  static constexpr int R = 3, THREADS = 128, PAD = 2, MAX_TZ = 40,
                       BLOCKS_PER_SM = 4, EDGE = 0;
};

// Slots copied from the one table (no chain) with cp.async, so the copy
// runs beside the fetch of the block's first planes, in flight with it;
// the entries of all slots are spread over the block. Face slots hold
// their own rows (no differences): a face plane's correction forms its
// difference to the interior row as it goes.
template <typename T>
struct TableCoef {
  static constexpr bool COPIES = true;
  const T* table;  // [27, 27, 3, 3]
  __device__ __forceinline__ void fill(T* slots, const int* sig_of, int used,
                                       bool, int, int, int tid,
                                       int nthr) const {
    const unsigned base =
        static_cast<unsigned>(__cvta_generic_to_shared(slots));
    for (int i = tid; i < used * kRow; i += nthr) {
      const int s = i / kRow, e = i - s * kRow;
      cp_async<T>(base + (unsigned)((s * kSlot + (e / 9 * 3 + e % 3) * 4 +
                                     e / 3 % 3) * sizeof(T)),
                  table + sig_of[s] * kRow + e);
    }
    cp_async_commit();
  }
};

template <typename T>
int launch_stencil(const T* up, const T* table, T* out, int SX, int NNY,
                   int NNZ, int is_low, int is_high, void* stream) {
  using S = Shape<T>;
  return launch<T, S::R, S::EDGE, S::THREADS, S::PAD>(
      up, TableCoef<T>{table}, out, 1, SX, NNY, NNZ, is_low, is_high,
      Sizing{S::MAX_TZ, S::BLOCKS_PER_SM}, stream);
}

}  // namespace

extern "C" int stencil_sweep_f32(const float* up, const float* table,
                                 float* out, int SX, int NNY, int NNZ,
                                 int is_low, int is_high, void* stream) {
  return launch_stencil<float>(up, table, out, SX, NNY, NNZ, is_low, is_high,
                               stream);
}

extern "C" int stencil_sweep_f64(const double* up, const double* table,
                                 double* out, int SX, int NNY, int NNZ,
                                 int is_low, int is_high, void* stream) {
  return launch_stencil<double>(up, table, out, SX, NNY, NNZ, is_low, is_high,
                                stream);
}

extern "C" const char* stencil_sweep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
