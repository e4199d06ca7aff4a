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
// Design.
//  * One block owns one chain, a (y, z) tile of TY x TZ node columns (one
//    thread per column; TZ spans the whole z extent up to 128 nodes) and a
//    chunk of XC consecutive x-planes, which it walks in groups of R planes.
//  * 2.5D blocking: a ring of NP = 2R + 2 ghost-padded x-planes of the tile
//    (all 3 components, with the one-node y/z halo) lives in shared memory.
//    A group needs R + 2 of them; the R planes of the next group are fetched
//    with cp.async into the other R slots while the current group computes,
//    so each byte of up is read from device memory about once, plus halos.
//  * Register blocking along x: a thread computes its column's R nodes of
//    the group at once, so each coefficient read from shared memory feeds
//    R x 3 FMAs and each neighbour value read feeds up to 3 x 3.
//  * Coefficients combined once per chain: at its start a block forms
//    a·T_λ + b·T_μ for just the signatures its tile and chunk meet (at most
//    3 x-classes x 3 y-classes x 3 z-classes), laid out [sig][27][3 d][4]
//    with c padded to 4, so one (offset, d) column is one 16-byte shared
//    load. Lanes of a warp read the same address (a broadcast) or, at a y/z
//    face, another signature's slot, which lies in other banks.
//  * Boundary nodes stay on the fast path: a node's own signature picks its
//    slot (sy, sz from j, k; sx from i and the flags, the same for the whole
//    block within a plane). A group is swept with the interior x-class; a
//    face plane (i = 0 with is_low, i = SX-1 with is_high) then adds the
//    difference of its own row, which its slot holds in place of the row.

#include <cuda_runtime.h>

namespace {

constexpr int kR = 4;              // x-planes per group (register blocking)
constexpr int kNP = 2 * kR + 2;    // ring slots
constexpr int kMaxThreads = 256;
constexpr int kBlocksPerSM = 2;  // x chunks: aim for this many blocks per SM
constexpr int kMaxTZ = 128;
// Cells of a padded tile plane per thread: (TY+2)(TZ+2) <= 3·TY·TZ + 6
// with TY·TZ <= threads, and at least 32 threads.
constexpr int kMaxPos = 4;
// Padded tile row in shared memory: TZ + row_pad<T>, at least TZ + 2 (the
// z halo) and congruent to TZ modulo one 128-byte row of banks, so the
// lanes of a warp, which run along z and wrap onto the next row, never
// read two words of one bank.
template <typename T>
__host__ __device__ constexpr int row_pad() { return 128 / (int)sizeof(T); }
constexpr int kSlot = 27 * 3 * 4;  // one combined signature: [q][d][c pad 4]
constexpr int kTable = 27 * 27 * 9;  // one packed table set

__device__ __forceinline__ int cls(int i, int n, int low, int high) {
  return (i == 0 && low) ? 1 : ((i == n - 1 && high) ? 2 : 0);
}

// Bit c set where class c (0 F, 1 L, 2 H) occurs among nodes [lo, hi) of n.
__device__ __forceinline__ int class_mask(int lo, int hi, int n, int low,
                                          int high) {
  int m = 0;
  if (lo == 0) m |= 1 << cls(0, n, low, high);
  if (hi == n) m |= 1 << cls(n - 1, n, low, high);
  if (hi - lo > (lo == 0) + (hi == n)) m |= 1;
  return m;
}

__device__ __forceinline__ int class_index(int mask, int c) {
  return __popc(mask & ((1 << c) - 1));
}

// The class of the n-th set bit of mask (its inverse).
__device__ __forceinline__ int nth_class(int mask, int n) {
  int c = 0;
  while (!(mask >> c & 1) || n-- > 0) ++c;
  return c;
}

__device__ __forceinline__ void load3(const float* p, float& a, float& b,
                                      float& c) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a = v.x;
  b = v.y;
  c = v.z;
}

__device__ __forceinline__ void load3(const double* p, double& a, double& b,
                                      double& c) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  a = v.x;
  b = v.y;
  c = p[2];
}

// One element, global -> shared (a shared-window address), asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async(unsigned dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(src), "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for all but the newest commit group.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// acc[c][r] += Σ_{ox,oy,oz,d} w[q][c][d] · up[d][plane r+ox][oy][oz] for
// the R nodes of one column, all with the coefficients of one signature
// slot w. plane[m]: the ring offset of the group's padded plane m.
template <typename T>
__device__ __forceinline__ void sweep_group(const T* __restrict__ ring,
                                            const int (&plane)[kR + 2],
                                            int PS, int rowp, int nb,
                                            const T* __restrict__ w,
                                            T (&acc)[3][kR]) {
#pragma unroll 1
  for (int oy = 0; oy < 3; ++oy) {
#pragma unroll
    for (int oz = 0; oz < 3; ++oz) {
      const int p = nb + oy * rowp + oz;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T v[kR + 2];
#pragma unroll
        for (int m = 0; m < kR + 2; ++m) v[m] = ring[plane[m] + d * PS + p];
#pragma unroll
        for (int ox = 0; ox < 3; ++ox) {
          T w0, w1, w2;
          load3(w + ((9 * ox + 3 * oy + oz) * 3 + d) * 4, w0, w1, w2);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            acc[0][r] += w0 * v[r + ox];
            acc[1][r] += w1 * v[r + ox];
            acc[2][r] += w2 * v[r + ox];
          }
        }
      }
    }
  }
}

template <typename T>
struct Row3 {
  T f[3];
};

// Σ_{ox,oy,oz,d} Δ[q][c][d] · up[d][plane ox][oy][oz] for one node whose
// signature differs from the one its group was swept with (a face plane):
// the correction that turns the group's row into its own. Δ is w_own
// itself when w_grp is null (the slot holds the difference to the group's
// row), else w_own - w_grp. p0, p1, p2: ring offsets of the node's padded
// planes x-1, x, x+1.
template <typename T>
__device__ __forceinline__ Row3<T> sweep_plane(
    const T* __restrict__ ring, int p0, int p1, int p2, int PS, int rowp,
    int nb, const T* __restrict__ w_own, const T* __restrict__ w_grp) {
  Row3<T> f = {{T(0), T(0), T(0)}};
  const int pl[3] = {p0, p1, p2};
#pragma unroll 1
  for (int oy = 0; oy < 3; ++oy) {
#pragma unroll
    for (int oz = 0; oz < 3; ++oz) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
#pragma unroll
        for (int ox = 0; ox < 3; ++ox) {
          const T x = ring[pl[ox] + d * PS + nb + oy * rowp + oz];
          const int e = ((9 * ox + 3 * oy + oz) * 3 + d) * 4;
          T a0, a1, a2;
          load3(w_own + e, a0, a1, a2);
          if (w_grp != nullptr) {
            T b0, b1, b2;
            load3(w_grp + e, b0, b1, b2);
            a0 -= b0;
            a1 -= b1;
            a2 -= b2;
          }
          f.f[0] += a0 * x;
          f.f[1] += a1 * x;
          f.f[2] += a2 * x;
        }
      }
    }
  }
  return f;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
theta_sweep_kernel(const T* __restrict__ up, const T* __restrict__ tables,
                   const T* __restrict__ coef, T* __restrict__ out, int SX,
                   int NNY, int NNZ, int is_low, int is_high, int TY, int TZ,
                   int nzt, int XC, int n_slots) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const slots = reinterpret_cast<T*>(smem_raw);
  T* const ring = slots + n_slots * kSlot;

  const int chain = blockIdx.z;
  const int y0 = (blockIdx.x / nzt) * TY, z0 = (blockIdx.x % nzt) * TZ;
  const int x0 = blockIdx.y * XC;
  const int y1 = min(NNY, y0 + TY), z1 = min(NNZ, z0 + TZ);
  const int x1 = min(SX, x0 + XC);
  const int NYp = NNY + 2, NZp = NNZ + 2;
  const int rowp = TZ + row_pad<T>();  // padded tile row in shared memory
  const int PS = (TY + 2) * rowp;   // one component of one padded plane
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long comp = (long long)(SX + 2) * NYp * NZp;
  const T* __restrict__ src = up + 3 * comp * chain;

  // This thread's cells of a padded tile plane (at most kMaxPos; see
  // launch): shared address in ring slot 0 and global address in padded
  // plane 0, component 0.
  const int rows = min(TY + 2, NYp - y0), cols = min(TZ + 2, NZp - z0);
  const unsigned ring_s = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  unsigned s_cell[kMaxPos];
  const T* g_cell[kMaxPos];
  bool has[kMaxPos];
#pragma unroll
  for (int n = 0; n < kMaxPos; ++n) {
    const int cell = tid + n * nthr, yy = cell / cols, zz = cell - yy * cols;
    has[n] = cell < rows * cols;
    s_cell[n] = ring_s + (unsigned)((yy * rowp + zz) * sizeof(T));
    g_cell[n] = src + (long long)(y0 + yy) * NZp + z0 + zz;
  }
  // Ghost-padded planes [plo, phi] of the tile -> their ring slots.
  auto fetch = [&](int plo, int phi) {
    for (int P = plo; P <= min(phi, x1 + 1); ++P) {
      const unsigned slot = (unsigned)((P - x0) % kNP * 3 * PS * sizeof(T));
      const long long plane = (long long)P * NYp * NZp;
#pragma unroll
      for (int n = 0; n < kMaxPos; ++n) {
        if (has[n]) {
          const T* const g = g_cell[n] + plane;
#pragma unroll
          for (int d = 0; d < 3; ++d)
            cp_async<T>(s_cell[n] + slot + (unsigned)(d * PS * sizeof(T)),
                        g + d * comp);
        }
      }
    }
  };

  fetch(x0, x0 + kR + 1);
  cp_async_commit();

  // Combine the tables once per chain for the signatures this block meets.
  const int xm = class_mask(x0, x1, SX, is_low, is_high);
  const int ym = class_mask(y0, y1, NNY, 1, 1);
  const int zm = class_mask(z0, z1, NNZ, 1, 1);
  const int ny_c = __popc(ym), nz_c = __popc(zm);
  const int used = __popc(xm) * ny_c * nz_c;
  __shared__ int sig_of[27];  // slot -> signature
  if (tid < used)
    sig_of[tid] = 9 * nth_class(xm, tid / (nz_c * ny_c)) +
                  3 * nth_class(ym, tid / nz_c % ny_c) + nth_class(zm, tid % nz_c);
  __syncthreads();
  // With the interior x-class present (slots ix = 0), a face x-class slot
  // holds its difference to the interior slot of the same (y, z) classes.
  const bool has_f = xm & 1;
  const int yz_n = ny_c * nz_c;
  {
    const T ca = coef[2 * chain], cb = coef[2 * chain + 1];
    for (int e = tid; e < 243; e += nthr) {
      const int q = e / 9, c = (e / 3) % 3, d = e % 3;
      T* const col = slots + (q * 3 + d) * 4 + c;
#pragma unroll 6
      for (int s = 0; s < used; ++s) {
        const T* const t = tables + sig_of[s] * 243 + e;
        T v = ca * __ldg(t) + cb * __ldg(t + kTable);
        if (has_f && s >= yz_n) {
          const T* const f = tables + sig_of[s % yz_n] * 243 + e;
          v -= ca * __ldg(f) + cb * __ldg(f + kTable);
        }
        col[s * kSlot] = v;
      }
    }
  }

  const int ty = tid / TZ, tz = tid - ty * TZ;
  const int j = y0 + ty, k = z0 + tz;
  const bool active = ty < TY && j < NNY && k < NNZ;
  const int nb = ty * rowp + tz;
  const int yz_slot = active ? class_index(ym, cls(j, NNY, 1, 1)) * nz_c +
                                   class_index(zm, cls(k, NNZ, 1, 1))
                             : 0;
  const long long n_nodes = (long long)SX * NNY * NNZ;
  T* __restrict__ dst = out + 3 * n_nodes * chain + (long long)j * NNZ + k;

  const int groups = (x1 - x0 + kR - 1) / kR;
  for (int g = 0; g < groups; ++g) {
    const int i0 = x0 + g * kR;
    fetch(i0 + kR + 2, i0 + 2 * kR + 1);  // the next group's new planes
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    if (active) {
      int plane[kR + 2];
#pragma unroll
      for (int m = 0; m < kR + 2; ++m) plane[m] = (i0 - x0 + m) % kNP * 3 * PS;
      // The signature slot of node plane i of this column.
      auto slot_of = [&](int i) {
        return slots + (class_index(xm, cls(i, SX, is_low, is_high)) * ny_c *
                            nz_c +
                        yz_slot) *
                           kSlot;
      };
      // The group is swept with the interior x-class (in a chunk of face
      // planes only, with its plane 1's), and a plane of another class gets
      // its correction.
      const T* const grp =
          has_f ? slots + yz_slot * kSlot : slot_of(min(i0 + 1, x1 - 1));
      T acc[3][kR];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int r = 0; r < kR; ++r) acc[c][r] = T(0);
      sweep_group<T>(ring, plane, PS, rowp, nb, grp, acc);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (i0 + r >= x1) break;
        const T* const own = slot_of(i0 + r);
        if (own == grp) continue;
        const auto f =
            sweep_plane<T>(ring, plane[r], plane[r + 1], plane[r + 2], PS, rowp,
                           nb, own, has_f ? nullptr : grp);
        acc[0][r] += f.f[0];
        acc[1][r] += f.f[1];
        acc[2][r] += f.f[2];
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (i0 + r < x1) {
          const long long o = (long long)(i0 + r) * NNY * NNZ;
          dst[o] = acc[0][r];
          dst[n_nodes + o] = acc[1][r];
          dst[2 * n_nodes + o] = acc[2][r];
        }
      }
    }
    __syncthreads();
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int launch(const T* up, const T* tables, const T* coef, T* out, int B, int SX,
           int NNY, int NNZ, int is_low, int is_high, void* stream) {
  if ((long long)SX * NNY * NNZ == 0 || B == 0) return (int)cudaSuccess;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  // Tile: the whole z extent up to kMaxTZ nodes, as many y rows as fit in
  // kMaxThreads threads, both balanced over the tiles.
  const int nzt = cdiv(NNZ, kMaxTZ), TZ = cdiv(NNZ, nzt);
  const int nyt = cdiv(NNY, kMaxThreads / TZ), TY = cdiv(NNY, nyt);
  // x chunks, a multiple of kR planes each: enough blocks for kBlocksPerSM
  // per SM.
  const int tiles = nyt * nzt;
  const int want = cdiv(kBlocksPerSM * n_sm, B * tiles);
  const int nxc0 = want < cdiv(SX, kR) ? want : cdiv(SX, kR);
  const int XC = cdiv(cdiv(SX, nxc0), kR) * kR, nxc = cdiv(SX, XC);
  // Signature slots a block may meet: all three classes along an axis
  // only when one tile or chunk spans it.
  const int n_slots =
      (nxc == 1 ? 3 : 2) * (nyt == 1 ? 3 : 2) * (nzt == 1 ? 3 : 2);
  const size_t bytes =
      sizeof(T) * ((size_t)n_slots * kSlot +
                   (size_t)kNP * 3 * (TY + 2) * (TZ + row_pad<T>()));
  static size_t allowed = 0;  // per instantiation
  if (bytes > allowed) {
    // Above 48 KB only on request; and the largest shared-memory carveout,
    // so that more than one block fits on an SM.
    err = cudaFuncSetAttribute(theta_sweep_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          theta_sweep_kernel<T>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  const int threads = cdiv(TY * TZ, 32) * 32;
  const dim3 grid((unsigned)tiles, (unsigned)nxc, (unsigned)B);
  theta_sweep_kernel<T><<<grid, threads, bytes, (cudaStream_t)stream>>>(
      up, tables, coef, out, SX, NNY, NNZ, is_low, is_high, TY, TZ, nzt, XC,
      n_slots);
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
