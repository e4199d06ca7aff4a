// The general operator's masked action A·u = M K (M u) + (1 - M) u on any
// uniform element block, written by hand for Hopper (sm_90a), float and
// double: an element kernel and a node pass, launched back to back.
//
// Replaces no Pallas kernel: the JAX package leaves this apply to XLA
// (stan_tpu/fem/operator.py, StiffnessOperator.apply), and the port's plain
// version (stan_tpu_torch/fem/operator.py, StiffnessOperator.
// apply_reference) ran it as a gather, three einsums and a scatter, about
// 15 library launches over [E, nn, ...] tensors. It serves the meshes only
// this operator takes: imported, curved parts.
//
//   u      [B, nnode, 3]     (B = 1 for one system)
//   m      [nnode, 3]        free mask, 1 where the DOF is free
//   conn   i32[E, nn]        element nodes
//   dN     [E, G, 3, nn]     shape-function gradients at the Gauss points,
//                            element and Gauss-point strides given (the
//                            operator stores them Gauss-point major), each
//                            [3, nn] slice contiguous on 16 bytes
//   detJw  [E, G]            det J times the Gauss weight, strides given
//   D      [B, E, 6, 6]      system and element strides given (0 where one D
//                            serves every system or element), each 6 x 6
//                            contiguous on 16 bytes
//   inc    i32[nnode, maxdeg] positions in the flattened [E*nn] element-
//                            node axis that touch each node, in index order;
//                            padding points one past the end
//   f      [B, E, nn, 3]     scratch: the element forces
//   out    [B, nnode, 3]
// (nn, G) is (8, 1), (8, 8), (4, 1) or (4, 4): HEX8_G1, HEX8_G2, TET4_G1,
// TET4_G2. Voigt order (xx, yy, zz, xy, yz, xz), engineering shear, as
// fem/kernels.py.
//
// What bounds it on an H100. The work is 2 (3 nn)^2 flops an element (one
// ke·u_e), 5.7 µs at LE10 (331,776 HEX8) at 67 TFLOP/s. The least traffic
// is the connectivity, the coordinates, u, the mask, the result and one D:
// 27.5 MB at LE10, 8.2 µs at 3.35 TB/s (perfbench/rooflines/
// general_apply.py). This design streams the stored geometry instead of
// recomputing it from the coordinates: dN (255 MB at LE10 in float), D
// (48 MB), detJw (11 MB), conn (11 MB), and writes and reads back the
// element forces (32 MB) and the incidence (11 MB): about 0.11 ms at the
// HBM rate, 13 times the bound. Recomputing the geometry in the kernel is
// the next step.
//
// Design. Element kernel: G lanes per element, one Gauss point each (4 HEX8_G2
// elements a warp; one lane an element for G = 1), 128 threads a block. Lane g
// gathers m·u at nodes g, g + G, ... through conn (coalesced int32 reads), and
// the element's lanes exchange them by shuffles; it loads its own dN[e, g]
// slice (3 nn values, contiguous) with 16-byte loads, so every sector of dN a
// warp touches is used whole (the lanes of one Gauss point read consecutive
// elements' slices), and D[e] (the same 36 values in every lane of the
// element, one transaction for them). In registers it forms H = dN·u_e, ε =
// sym(H), σ = D ε and its contribution detJw_g dN_gᵀ T(σ_g) to the element's 3
// nn forces; the G lanes then sum those by halving exchanges (xor shuffles 1,
// 2, 4 apart: each step a lane keeps half of its values and adds its partner's
// half), so each force is summed once, in one fixed order, and lane g ends
// with nodes g nn/G to (g + 1) nn/G - 1, which it writes. Node pass: a thread
// per (system, node, direction) sums the element forces through inc in index
// order and writes m·sum + (1 - m)·u. No atomics: the same input gives the
// same bits on every run. Both kernels launch on the caller's stream, allocate
// nothing and never synchronise, so a CUDA graph can record them.

#include <cuda_runtime.h>


namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;       // element kernel: threads a block
constexpr int NODE_THREADS = 256;  // node pass

// 16-byte vector of T and how to spill it into consecutive registers.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int W = 4;
  __device__ static void put(float* d, const float4& v) {
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int W = 2;
  __device__ static void put(double* d, const double2& v) {
    d[0] = v.x;
    d[1] = v.y;
  }
};

// N consecutive values from 16-byte-aligned global memory into registers.
template <typename T, int N>
__device__ __forceinline__ void load(T (&dst)[N], const T* src) {
  using V = Vec<T>;
  static_assert(N % V::W == 0, "a 16-byte multiple");
  const typename V::type* s = reinterpret_cast<const typename V::type*>(src);
#pragma unroll
  for (int i = 0; i < N / V::W; ++i) V::put(dst + i * V::W, __ldg(s + i));
}

// Sum acc over the S-aligned groups of 2S lanes, keeping half: a lane with
// bit S set keeps the upper half of the first Q values, the other the
// lower, each adding its partner's copy; then the same on the Q/2 values
// kept, S/2 apart, down to S = 1. Each sum is formed on one lane only.
template <typename T, int N, int Q, int S>
__device__ __forceinline__ void reduce_scatter(T (&acc)[N], int lane) {
  if constexpr (S > 0) {
    const bool up = (lane & S) != 0;
#pragma unroll
    for (int i = 0; i < Q / 2; ++i) {
      const T send = up ? acc[i] : acc[i + Q / 2];
      const T keep = up ? acc[i + Q / 2] : acc[i];
      acc[i] = keep + __shfl_xor_sync(FULL, send, S);
    }
    reduce_scatter<T, N, Q / 2, S / 2>(acc, lane);
  }
}

template <typename T, int NN, int G>
__global__ void __launch_bounds__(THREADS)
    general_element_kernel(const T* __restrict__ u, const T* __restrict__ m,
                           const int* __restrict__ conn,
                           const T* __restrict__ dN,
                           const T* __restrict__ detJw,
                           const T* __restrict__ D, T* __restrict__ f, int E,
                           int nnode, int d_sb, int d_se, int dn_se,
                           int dn_sg, int w_se, int w_sg) {
  static_assert(NN % G == 0 && 32 % G == 0, "G lanes an element, in a warp");
  constexpr int EPB = THREADS / G;  // elements a block
  constexpr int PER = NN / G;       // nodes a lane gathers and writes
  const int g = threadIdx.x % G;
  const long long e_raw = (long long)blockIdx.x * EPB + threadIdx.x / G;
  const bool live = e_raw < E;
  // A lane past the last element still takes part in the shuffles.
  const long long e = live ? e_raw : E - 1;
  const long long b = blockIdx.y;
  const T* ub = u + b * nnode * 3;

  // m·u at this lane's nodes g, g + G, ...
  T mu[PER][3];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const long long node = __ldg(conn + e * NN + g + i * G);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      mu[i][j] = __ldg(m + node * 3 + j) * __ldg(ub + node * 3 + j);
  }
  T d[3 * NN];  // dN[e, g]: d[k * NN + n]
  load(d, dN + e * dn_se + (long long)g * dn_sg);
  T Dm[36];
  load(Dm, D + b * d_sb + e * d_se);
  const T w = __ldg(detJw + e * w_se + (long long)g * w_sg);

  // H[k][j] = Σ_n dN[k][n] u[n][j]
  T H[3][3] = {};
#pragma unroll
  for (int n = 0; n < NN; ++n) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T un = mu[n / G][j];
      if constexpr (G > 1) un = __shfl_sync(FULL, un, n % G, G);
#pragma unroll
      for (int k = 0; k < 3; ++k) H[k][j] += d[k * NN + n] * un;
    }
  }
  const T eps[6] = {H[0][0],           H[1][1],           H[2][2],
                    H[0][1] + H[1][0], H[1][2] + H[2][1], H[0][2] + H[2][0]};
  T s[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < 6; ++j) acc += Dm[i * 6 + j] * eps[j];
    s[i] = acc * w;
  }
  // T(σ) detJw, row j: (xx, xy, xz), (xy, yy, yz), (xz, yz, zz)
  const T t[3][3] = {{s[0], s[3], s[5]}, {s[3], s[1], s[4]},
                     {s[5], s[4], s[2]}};
  T acc[3 * NN];  // this Gauss point's share of f[n][j], at n * 3 + j
#pragma unroll
  for (int n = 0; n < NN; ++n) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T v = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k) v += d[k * NN + n] * t[j][k];
      acc[n * 3 + j] = v;
    }
  }
  reduce_scatter<T, 3 * NN, 3 * NN, G / 2>(acc, g);
  if (live) {
    T* fe = f + ((b * E + e) * NN + g * PER) * 3;
#pragma unroll
    for (int q = 0; q < 3 * PER; ++q) fe[q] = acc[q];
  }
}

template <typename T>
__global__ void __launch_bounds__(NODE_THREADS)
    general_node_kernel(const T* __restrict__ f, const int* __restrict__ inc,
                        const T* __restrict__ u, const T* __restrict__ m,
                        T* __restrict__ out, int nnode, int maxdeg, int en) {
  const int t = blockIdx.x * NODE_THREADS + threadIdx.x;  // node * 3 + dir
  if (t >= nnode * 3) return;
  const long long b = blockIdx.y;
  const int node = t / 3, dir = t - 3 * node;
  const T* fb = f + b * en * 3;
  const int* row = inc + (long long)node * maxdeg;
  T sum = T(0);
  for (int k = 0; k < maxdeg; ++k) {
    const int idx = __ldg(row + k);
    if (idx < en) sum += __ldg(fb + (long long)idx * 3 + dir);
  }
  const T mm = __ldg(m + t);
  const long long o = b * nnode * 3 + t;
  out[o] = mm * sum + (T(1) - mm) * __ldg(u + o);
}

template <typename T, int NN, int G>
int launch_element(const T* u, const T* m, const int* conn, const T* dN,
                   const T* detJw, const T* D, T* f, int B, int E, int nnode,
                   const int* st, cudaStream_t s) {
  constexpr int EPB = THREADS / G;
  const dim3 grid((E + EPB - 1) / EPB, B);
  general_element_kernel<T, NN, G><<<grid, THREADS, 0, s>>>(
      u, m, conn, dN, detJw, D, f, E, nnode, st[0], st[1], st[2], st[3], st[4],
      st[5]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* u, const T* m, const int* conn, const T* dN,
           const T* detJw, const T* D, const int* inc, T* f, T* out, int B,
           int E, int nn, int G, int nnode, int maxdeg, int d_sb, int d_se,
           int dn_se, int dn_sg, int w_se, int w_sg, void* stream) {
  if (B < 1 || B > 65535 || E < 1 || nnode < 1 || maxdeg < 0)
    return (int)cudaErrorInvalidValue;
  const int st[6] = {d_sb, d_se, dn_se, dn_sg, w_se, w_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int code;
  if (nn == 8 && G == 8)
    code = launch_element<T, 8, 8>(u, m, conn, dN, detJw, D, f, B, E, nnode,
                                   st, s);
  else if (nn == 8 && G == 1)
    code = launch_element<T, 8, 1>(u, m, conn, dN, detJw, D, f, B, E, nnode,
                                   st, s);
  else if (nn == 4 && G == 4)
    code = launch_element<T, 4, 4>(u, m, conn, dN, detJw, D, f, B, E, nnode,
                                   st, s);
  else if (nn == 4 && G == 1)
    code = launch_element<T, 4, 1>(u, m, conn, dN, detJw, D, f, B, E, nnode,
                                   st, s);
  else
    return (int)cudaErrorInvalidValue;
  if (code != 0) return code;
  const dim3 grid((nnode * 3 + NODE_THREADS - 1) / NODE_THREADS, B);
  general_node_kernel<T><<<grid, NODE_THREADS, 0, s>>>(f, inc, u, m, out,
                                                        nnode, maxdeg, E * nn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int general_apply_f32(const float* u, const float* m,
                                 const int* conn, const float* dN,
                                 const float* detJw, const float* D,
                                 const int* inc, float* f, float* out, int B,
                                 int E, int nn, int G, int nnode, int maxdeg,
                                 int d_sb, int d_se, int dn_se, int dn_sg,
                                 int w_se, int w_sg, void* stream) {
  return launch<float>(u, m, conn, dN, detJw, D, inc, f, out, B, E, nn, G,
                       nnode, maxdeg, d_sb, d_se, dn_se, dn_sg, w_se, w_sg,
                       stream);
}

extern "C" int general_apply_f64(const double* u, const double* m,
                                 const int* conn, const double* dN,
                                 const double* detJw, const double* D,
                                 const int* inc, double* f, double* out,
                                 int B, int E, int nn, int G, int nnode,
                                 int maxdeg, int d_sb, int d_se, int dn_se,
                                 int dn_sg, int w_se, int w_sg, void* stream) {
  return launch<double>(u, m, conn, dN, detJw, D, inc, f, out, B, E, nn, G,
                        nnode, maxdeg, d_sb, d_se, dn_se, dn_sg, w_se, w_sg,
                        stream);
}

extern "C" const char* general_apply_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
