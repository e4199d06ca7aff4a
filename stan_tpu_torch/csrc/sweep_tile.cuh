// Tile machinery shared by the port's 27-point stencil sweeps
// (stencil_sweep.cu: K·u with one table; theta_sweep.cu: a·K_λu + b·K_μu
// per chain), written by hand for Hopper (sm_90a), float and double.
//
// Both sweeps take the same slab contract:
//   up     [B, 3, SX+2, NNY+2, NNZ+2]  one ghost-padded slab per chain
//                                      (B = 1 for stencil_sweep)
//   out    [B, 3, SX, NNY, NNZ]
//   is_low / is_high                   the slab owns the global low / high x
//                                      face (the same flags for every chain)
// and tables packed as [27 signatures][27 offsets][3 c][3 d] (pack_tables):
// signature 9*sx + 3*sy + sz with F=0, L=1, H=2 per axis, offset
// 9*(ox+1) + 3*(oy+1) + (oz+1).
//
// Design.
//  * One block owns one chain, a (y, z) tile of TY x TZ node columns (one
//    thread per column) and a chunk of XC consecutive x-planes, which it
//    walks in groups of R planes.
//  * 2.5D blocking: a ring of NP = 2R + 2 ghost-padded x-planes of the tile
//    (all 3 components, with the one-node y/z halo) lives in shared memory.
//    A group needs R + 2 of them; the R planes of the next group are fetched
//    with cp.async into the other R slots while the current group computes,
//    so each byte of up is read from device memory about once, plus halos.
//  * Register blocking along x: a thread computes its column's R nodes of
//    the group at once, so each coefficient read from shared memory feeds
//    R x 3 FMAs and each neighbour value read feeds up to 3 x 3.
//  * Coefficients formed once per block: at its start a block fills a slot
//    for just the signatures its tile and chunk meet (at most 3 x-classes x
//    3 y-classes x 3 z-classes), laid out [sig][27][3 d][4] with c padded to
//    4, so one (offset, d) column is one 16-byte shared load. How a slot's
//    entries are formed is the sweep's own (its Coef type). Lanes of a warp
//    read the same address (a broadcast) or, at a y/z face, another
//    signature's slot, which lies in other banks.
//  * Boundary nodes stay on the fast path: a node's own signature picks its
//    slot (sy, sz from j, k; sx from i and the flags, the same for the whole
//    block within a plane). A group is swept with the interior x-class; a
//    face plane (i = 0 with is_low, i = SX-1 with is_high) then adds the
//    difference of its own row, which its slot holds in place of the row.

#pragma once

#include <cuda_runtime.h>

namespace sweep_tile {

// Cells of a padded tile plane per thread: (TY+2)(TZ+2) <= 3·TY·TZ + 6
// with TY·TZ <= threads, and at least 32 threads.
constexpr int kMaxPos = 4;
constexpr int kRow = 27 * 9;         // one signature's row: [q][c][d]
constexpr int kSlot = 27 * 3 * 4;    // one signature's slot: [q][d][c pad 4]
constexpr int kTable = 27 * 27 * 9;  // one packed table set
constexpr int kMaxDevices = 64;      // device ordinals launch() keeps state for

// Padding of a tile row in shared memory that keeps it congruent to TZ
// modulo one 128-byte row of banks, so the lanes of a warp, which run along
// z and wrap onto the next row, never read two words of one bank.
template <typename T>
__host__ __device__ constexpr int row_pad() { return 128 / (int)sizeof(T); }

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
template <typename T, int R>
__device__ __forceinline__ void sweep_group(const T* __restrict__ ring,
                                            const int (&plane)[R + 2],
                                            int PS, int rowp, int nb,
                                            const T* __restrict__ w,
                                            T (&acc)[3][R]) {
#pragma unroll 1
  for (int oy = 0; oy < 3; ++oy) {
#pragma unroll
    for (int oz = 0; oz < 3; ++oz) {
      const int p = nb + oy * rowp + oz;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T v[R + 2];
#pragma unroll
        for (int m = 0; m < R + 2; ++m) v[m] = ring[plane[m] + d * PS + p];
#pragma unroll
        for (int ox = 0; ox < 3; ++ox) {
          T w0, w1, w2;
          load3(w + ((9 * ox + 3 * oy + oz) * 3 + d) * 4, w0, w1, w2);
#pragma unroll
          for (int r = 0; r < R; ++r) {
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

// The sweep of one block. Coef fills the slots: coef.fill(slots, sig_of,
// used, diff, yz_n, chain, tid, nthr) writes, with the nthr threads of the
// block, slot s < used as the row of signature sig_of[s] for this chain,
// [q][d][c pad 4] (see above), and where diff and s >= yz_n as that row
// minus the row of slot s % yz_n (a face x-class's difference to the
// interior). Coef::COPIES: the fill copies rows with cp.async, never with
// differences (diff is false), and commits them itself. R: x-planes per
// group; E: 0, or the planes of the first and the last x chunk (the face
// chunks), which then do less than the others to make up for their face
// correction; PAD: row padding of the tile in shared memory (at least 2,
// the z halo).
template <typename T, int R, int E, int PAD, class Coef>
__device__ __forceinline__ void sweep_block(
    const T* __restrict__ up, Coef coef, T* __restrict__ out, int SX,
    int NNY, int NNZ, int is_low, int is_high, int TY, int TZ, int nzt,
    int XC, int n_slots) {
  constexpr int NP = 2 * R + 2;  // ring slots
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const slots = reinterpret_cast<T*>(smem_raw);
  T* const ring = slots + n_slots * kSlot;

  const int chain = blockIdx.z;
  const int y0 = (blockIdx.x / nzt) * TY, z0 = (blockIdx.x % nzt) * TZ;
  const int y1 = min(NNY, y0 + TY), z1 = min(NNZ, z0 + TZ);
  int x0, x1;  // this block's x chunk
  if constexpr (E > 0) {
    const int c = blockIdx.y, last = gridDim.y - 1;
    x0 = c == 0 ? 0 : (c == last ? SX - E : E + (c - 1) * XC);
    x1 = c == last ? SX : (c == 0 ? E : min(SX - E, x0 + XC));
  } else {
    x0 = blockIdx.y * XC;
    x1 = min(SX, x0 + XC);
  }
  const int NYp = NNY + 2, NZp = NNZ + 2;
  const int rowp = TZ + PAD;       // padded tile row in shared memory
  const int PS = (TY + 2) * rowp;  // one component of one padded plane
  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long comp = (long long)(SX + 2) * NYp * NZp;
  const T* __restrict__ src = up + 3 * comp * chain;

  // This thread's cells of a padded tile plane (at most kMaxPos; see
  // kMaxPos): shared address in ring slot 0 and global address in padded
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
      const unsigned slot = (unsigned)((P - x0) % NP * 3 * PS * sizeof(T));
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

  fetch(x0, x0 + R + 1);
  cp_async_commit();

  // Form the slots once per block for the signatures this block meets.
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
  // holds its difference to the interior slot of the same (y, z) classes,
  // unless the Coef copies rows.
  const bool has_f = xm & 1, diff = has_f && !Coef::COPIES;
  const int yz_n = ny_c * nz_c;
  coef.fill(slots, sig_of, used, diff, yz_n, chain, tid, nthr);

  const int ty = tid / TZ, tz = tid - ty * TZ;
  const int j = y0 + ty, k = z0 + tz;
  const bool active = ty < TY && j < NNY && k < NNZ;
  const int nb = ty * rowp + tz;
  const int yz_slot = active ? class_index(ym, cls(j, NNY, 1, 1)) * nz_c +
                                   class_index(zm, cls(k, NNZ, 1, 1))
                             : 0;
  const long long n_nodes = (long long)SX * NNY * NNZ;
  T* __restrict__ dst = out + 3 * n_nodes * chain + (long long)j * NNZ + k;

  const int groups = (x1 - x0 + R - 1) / R;
  for (int g = 0; g < groups; ++g) {
    const int i0 = x0 + g * R;
    fetch(i0 + R + 2, i0 + 2 * R + 1);  // the next group's new planes
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    if (active) {
      int plane[R + 2];
#pragma unroll
      for (int m = 0; m < R + 2; ++m) plane[m] = (i0 - x0 + m) % NP * 3 * PS;
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
      T acc[3][R];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[c][r] = T(0);
      sweep_group<T, R>(ring, plane, PS, rowp, nb, grp, acc);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (i0 + r >= x1) break;
        const T* const own = slot_of(i0 + r);
        if (own == grp) continue;
        const auto f =
            sweep_plane<T>(ring, plane[r], plane[r + 1], plane[r + 2], PS, rowp,
                           nb, own, diff ? nullptr : grp);
        acc[0][r] += f.f[0];
        acc[1][r] += f.f[1];
        acc[2][r] += f.f[2];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
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

template <typename T, int R, int E, int THREADS, int PAD, class Coef>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const T* __restrict__ up, Coef coef, T* __restrict__ out,
             int SX, int NNY, int NNZ, int is_low, int is_high, int TY,
             int TZ, int nzt, int XC, int n_slots) {
  sweep_block<T, R, E, PAD>(up, coef, out, SX, NNY, NNZ, is_low, is_high, TY,
                            TZ, nzt, XC, n_slots);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The runtime part of a sweep's launch sizing (host side).
struct Sizing {
  int max_tz;         // widest tile along z, in nodes; at most THREADS
  int blocks_per_sm;  // x chunks: aim for this many blocks per SM
};

// Launch sweep_kernel over the B slabs on the stream; returns a CUDA error
// code. Tile: the whole z extent up to max_tz nodes, as many y rows as fit
// in THREADS threads, both balanced over the tiles; x chunks, a multiple of
// R planes each (besides the two of E planes, when E > 0), enough for
// blocks_per_sm blocks per SM.
template <typename T, int R, int E, int THREADS, int PAD, class Coef>
int launch(const T* up, Coef coef, T* out, int B, int SX, int NNY, int NNZ,
           int is_low, int is_high, Sizing sz, void* stream) {
  if ((long long)SX * NNY * NNZ == 0 || B == 0) return (int)cudaSuccess;
  if (sz.max_tz < 1 || sz.max_tz > THREADS || sz.blocks_per_sm < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  const int nzt = cdiv(NNZ, sz.max_tz), TZ = cdiv(NNZ, nzt);
  const int nyt = cdiv(NNY, THREADS / TZ), TY = cdiv(NNY, nyt);
  const int tiles = nyt * nzt;
  const int want = cdiv(sz.blocks_per_sm * n_sm, B * tiles);
  int XC, nxc;
  if constexpr (E > 0) {
    const int mid = SX - 2 * E;  // planes of the middle chunks
    if (mid <= 0) {
      XC = SX;
      nxc = 1;
    } else {
      const int most = cdiv(mid, R);  // one group per middle chunk
      const int n0 = want - 2 < 1 ? 1 : (want - 2 < most ? want - 2 : most);
      XC = cdiv(cdiv(mid, n0), R) * R;
      nxc = cdiv(mid, XC) + 2;
    }
  } else {
    const int nxc0 = want < cdiv(SX, R) ? want : cdiv(SX, R);
    XC = cdiv(cdiv(SX, nxc0), R) * R;
    nxc = cdiv(SX, XC);
  }
  // Signature slots a block may meet: all three classes along an axis
  // only when one tile or chunk spans it.
  const int n_slots =
      (nxc == 1 ? 3 : 2) * (nyt == 1 ? 3 : 2) * (nzt == 1 ? 3 : 2);
  const size_t bytes =
      sizeof(T) * ((size_t)n_slots * kSlot +
                   (size_t)(2 * R + 2) * 3 * (TY + 2) * (TZ + PAD));
  // The runtime applies a function attribute to the function as loaded on
  // the current device, so the opt-in is kept per device ordinal (and per
  // instantiation): a second card in the same process gets its own.
  static size_t allowed[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (bytes > allowed[dev]) {
    // Above 48 KB only on request; and the largest shared-memory carveout,
    // so that more than one block fits on an SM.
    err = cudaFuncSetAttribute(sweep_kernel<T, R, E, THREADS, PAD, Coef>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sweep_kernel<T, R, E, THREADS, PAD, Coef>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = bytes;
  }
  const int threads = cdiv(TY * TZ, 32) * 32;
  const dim3 grid((unsigned)tiles, (unsigned)nxc, (unsigned)B);
  sweep_kernel<T, R, E, THREADS, PAD, Coef>
      <<<grid, threads, bytes, (cudaStream_t)stream>>>(
          up, coef, out, SX, NNY, NNZ, is_low, is_high, TY, TZ, nzt, XC,
          n_slots);
  return (int)cudaGetLastError();
}

}  // namespace sweep_tile
