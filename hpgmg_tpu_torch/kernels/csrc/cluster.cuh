// What the two thread-block-cluster kernels share (K2c in
// fv4_gsrb2_cluster.cu, K4 in tail.cu): the cluster launcher, and the fv4
// half-sweep on i-planes held in shared memory with their 2-cell (j, k)
// ghost frame.
//
// A cluster is a group of blocks that the hardware schedules together on
// the SMs of one GPC. Its blocks read each other's shared memory
// (distributed shared memory: cg::this_cluster().map_shared_rank gives the
// address of the same variable in another block) and meet at a hardware
// barrier, cg::this_cluster().sync() (barrier.cluster.arrive.release,
// then wait.acquire: every write made before it, to shared or global
// memory, is visible to every thread of the cluster after it; a bare
// __syncthreads orders nothing between blocks). A cluster is launched as
// an ordinary kernel with a cluster dimension (cudaLaunchKernelEx).
//
// Layout of a plane in shared memory: (n+4) x (n+4) values, row pitch
// n+4, cell (j, k) at (j+2) * (n+4) + (k+2), the frame of (j, k) ghosts
// around the cells; planes of one buffer sit plane_pitch(n) values apart
// (a multiple of 4 values, so that a plane copies in 16-byte vectors).

#pragma once

#include "fv4_stream.cuh"  // ghost_taps

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;

// The most dynamic shared memory one block may use on sm_90 (227 KB).
constexpr int kMaxClusterSmem = 232448;
// 8 blocks is the portable cluster size; 16 needs the non-portable opt-in.
constexpr int kMaxCluster = 16;
// cluster_launch's code for a cluster that the card cannot hold at its
// size and shared memory (cudaOccupancyMaxActiveClusters found none).
constexpr int kClusterUnschedulable = -2;

// A kernel's launch state: its attributes (the dynamic shared memory
// ceiling, non-portable sizes allowed) are set at its first launch, and
// `fits` is the most shared memory a block of its cluster has been checked
// to be schedulable with, so that a launch queries the occupancy API only
// for a shared memory size it has not met. A kernel launches clusters of
// one size, its source's constant.
struct ClusterKernel {
  bool attrs = false;
  size_t fits = 0;
};

// Launch `kernel(params)` as `clusters` clusters of `csize` blocks of
// `threads` threads with `smem` bytes of dynamic shared memory each, on
// stream s. Returns a cudaError_t, or kClusterUnschedulable; never falls
// back to another launch.
template <typename P>
int cluster_launch(ClusterKernel& k, void (*kernel)(P), const P& params, int clusters,
                   int csize, int threads, size_t smem, cudaStream_t s) {
  if (csize < 1 || csize > kMaxCluster || clusters < 1 || smem > kMaxClusterSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = cudaSuccess;
  if (!k.attrs) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxClusterSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    k.attrs = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * csize);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (smem > k.fits) {
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, fn, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (active < 1) return kClusterUnschedulable;
    k.fits = smem;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, params);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// values between two planes of a buffer: (n+4)^2 rounded up to 4
__host__ __device__ __forceinline__ int plane_pitch(int n) {
  return ((n + 4) * (n + 4) + 3) & ~3;
}

// cp.async of 16 bytes past L1 (.cg: the source may have been written in
// this launch by another SM, whose writes L1 does not see)
__device__ __forceinline__ void cp_async16_cg(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// `count` values from device memory to shared memory (dst 16-byte
// aligned), past L1: cp.async 16 bytes a copy where the source allows
// (the caller commits and waits), else plain loads.
template <typename T>
__device__ __forceinline__ void stage_l2(T* dst, const T* src, int count) {
  if ((count * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = count * static_cast<int>(sizeof(T)) / 16;
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
      cp_async16_cg(reinterpret_cast<int4*>(dst) + v, reinterpret_cast<const int4*>(src) + v);
    }
  } else {
    for (int t = threadIdx.x; t < count; t += blockDim.x) dst[t] = __ldcg(src + t);
  }
}

// cp.async `planes` consecutive planes of an n^3 field (src: the first
// plane's first cell) into the cells of consecutive padded planes from
// `first` (ps values apart): pairs of values a copy where n is even. The
// caller commits and waits; the frames are not touched.
template <typename T>
__device__ __forceinline__ void load_planes_async(T* first, int ps, const T* src, int planes,
                                                  int n) {
  const int np = n + 4;
  if ((n & 1) == 0 && pair_aligned(src)) {
    const int h = n / 2, per = n * h;
    for (int t = threadIdx.x; t < planes * per; t += blockDim.x) {
      const int pl = t / per, r = t - pl * per, j = r / h, k = 2 * (r - j * h);
      cp_async2(first + pl * ps + (j + 2) * np + k + 2,
                src + (static_cast<int64_t>(pl) * n + j) * n + k);
    }
  } else {
    const int per = n * n;
    for (int t = threadIdx.x; t < planes * per; t += blockDim.x) {
      const int pl = t / per, r = t - pl * per, j = r / n;
      cp_async(first + pl * ps + (j + 2) * np + (r - j * n) + 2,
               src + static_cast<int64_t>(pl) * per + r);
    }
  }
}

// Copy `planes` padded planes of `count` values (a multiple of 16 bytes,
// 16-byte aligned): plane i from src(i), which may lie in another block's
// shared memory, to dst(i). 16-byte vectors, eight in flight a thread
// (a remote load costs about an L2 load; one at a time they serialize).
template <typename T, typename Src, typename Dst>
__device__ __forceinline__ void copy_planes(int planes, int count, const Src& src,
                                            const Dst& dst) {
  constexpr int B = 8;
  const int nv = count * static_cast<int>(sizeof(T)) / 16, total = planes * nv;
  for (int v0 = threadIdx.x; v0 < total; v0 += B * blockDim.x) {
    int4 r[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v < total) {
        const int i = v / nv;
        r[u] = reinterpret_cast<const int4*>(src(i))[v - i * nv];
      }
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v < total) {
        const int i = v / nv;
        reinterpret_cast<int4*>(dst(i))[v - i * nv] = r[u];
      }
    }
  }
}

// The (j, k) ghost frames of `count` planes (ps values apart from
// `first`) of an n^3 level, each from its own plane's cells (ghost_taps:
// the bits of K1's ghosts; on a ghost plane the frame's values are its
// cells' taps in j and k, the tensor product of K1 summed in another
// order). The block's threads share the ghost cells; call once the cells
// are visible to the block.
template <typename T>
__device__ void make_frames(T* first, int count, int ps, int n) {
  const int np = n + 4, rows = 4 * np, per = rows + 4 * n;
  for (int t = threadIdx.x; t < count * per; t += blockDim.x) {
    const int pl = t / per, u = t - pl * per;
    int j, k;
    if (u < rows) {  // rows -2, -1, n, n+1, every column
      const int r = u / np;
      j = r < 2 ? r - 2 : n + r - 2;
      k = u - r * np - 2;
    } else {  // columns -2, -1, n, n+1 of rows 0 .. n-1
      const int v = u - rows, c = v & 3;
      j = v >> 2;
      k = c < 2 ? c - 2 : n + c - 2;
    }
    T* plane = first + pl * ps;
    plane[(j + 2) * np + (k + 2)] = ghost_taps<T>(
        [&](int, int b, int c) { return plane[(b + 2) * np + (c + 2)]; }, n, 0, j, k);
  }
}

// The ghost planes on one face of an n^3 level: near (i = -1 or n) and
// far (-2 or n+1; null: not wanted), each value a quartic combination
// (axis_taps' weights) of the same value of the four planes next to the
// face, src[a] the a-th from it: over their cells (K1's bits), or, with
// `padded`, over the whole padded planes, frames included (the frames'
// values then are K1's tensor product of taps summed in another order).
// far may be the buffer of src[3] or of no source: a value's taps are read
// before it is written.
template <typename T>
__device__ void ghost_planes(T* near, T* far, const T* const (&src)[4], int n, bool padded) {
  const int np = n + 4, count = padded ? np * np : n * n;
  int id[4];
  T wn[4], wf[4];
  axis_taps(-1, n, id, wn);
  axis_taps(-2, n, id, wf);
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    const int j = padded ? 0 : t / n, o = padded ? t : (j + 2) * np + (t - j * n) + 2;
    T v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = src[q][o];
    T sn = T(0), sf = T(0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sn += wn[q] * v[q];
      sf += wf[q] * v[q];
    }
    near[o] = sn;
    if (far != nullptr) far[o] = sf;
  }
}

// What a half-sweep reads besides x.
template <typename T>
struct Fv4Coefs {
  const T* bie;
  const T* bje;
  const T* bke;
  const T* alpha;  // nullptr: no a*alpha*x term
  const T* rhs;
  int n;
  T scale;   // -b / h^2
  T a_coef;  // a
};

// A x at cell (i, j, k) (flat index c), x read around xc (the cell in a
// buffer of padded planes ps apart), the face coefficients through L1:
// the arithmetic of K1 (fv4_stream.cu:stream_ax).
template <typename T>
__device__ __forceinline__ T plane_ax(const Fv4Coefs<T>& p, const T* xc, int ps, int i,
                                      int j, int k, int64_t c) {
  const int np = p.n + 4;
  const int64_t n1 = p.n + 1, n2 = p.n + 2;
  auto X = [&](int di, int dj, int dk) -> T { return xc[di * ps + dj * np + dk]; };
  // face f (0 low, 1 high) of the cell, shifted tangentially
  auto BI = [&](int f, int dj, int dk) -> T {
    return __ldg(p.bie + ((i + f) * n2 + (1 + j + dj)) * n2 + (1 + k + dk));
  };
  auto BJ = [&](int f, int di, int dk) -> T {
    return __ldg(p.bje + ((1 + i + di) * n1 + (j + f)) * n2 + (1 + k + dk));
  };
  auto BK = [&](int f, int di, int dj) -> T {
    return __ldg(p.bke + ((1 + i + di) * n2 + (1 + j + dj)) * n1 + (k + f));
  };
  T ax = p.scale * fv4_combination<T>(X, BI, BJ, BK);
  if (p.alpha != nullptr) ax = p.a_coef * __ldg(p.alpha + c) * X(0, 0, 0) + ax;
  return ax;
}

// A GSRB half-sweep of `count` consecutive planes i0, i0+1, ... (x read
// from `first`, the padded plane i0 of a buffer of planes ps apart, with
// planes i0-2 .. i0+count+1 in place): put(il, j, k, v) receives
// x + kd * (rhs - A x) at the cells of the sweep's colour ((i+j+k) % 2 ==
// parity, the colour kd carries) and x at the others, as K1's gsrb mode.
// Each thread takes a pair of neighbouring k cells, one of each colour; a
// warp takes up to 16 pairs of each of two neighbouring rows (or whole
// rows of fewer pairs), whose colours' cells alternate, so that with an
// even row pitch its shared-memory reads meet no bank twice (one row of
// 32 pairs read every other word: a two-way conflict). rhs is read past
// L1 (it may have been written in this launch by another SM).
template <typename T, typename Put>
__device__ __forceinline__ void half_sweep(const Fv4Coefs<T>& p, const T* first, int ps,
                                          int i0, int count, int parity, const T* kd,
                                          const Put& put) {
  const int n = p.n, np = n + 4, half = (n + 1) / 2;
  // rows of `w` pairs: `segs` segments of each row, ordered (row pair,
  // segment, row), so that a warp's two rows of 16 pairs are neighbours
  const int w = half < 16 ? half : 16, segs = (half + w - 1) / w;
  const int rows = segs == 1 ? n : (n + 1) / 2 * 2;
  const int total = count * rows * segs * w;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int v = t / w, kk = t - v * w;
    const int il = v / (rows * segs), u = v - il * (rows * segs);
    int j = u, kp = kk;
    if (segs > 1) {
      const int jp = u / (2 * segs), rem = u - jp * 2 * segs;
      j = 2 * jp + (rem & 1);
      kp = (rem >> 1) * w + kk;
    }
    if (j >= n || kp >= half) continue;
    const int i = i0 + il;
    const int q = (parity + i + j) & 1;  // the colour's cell of the pair
    const int k = 2 * kp + q, ko = 2 * kp + (q ^ 1);
    const T* row = first + il * ps + (j + 2) * np + 2;
    if (k < n) {
      const int64_t c = (static_cast<int64_t>(i) * n + j) * n + k;
      const T ax = plane_ax(p, row + k, ps, i, j, k, c);
      put(il, j, k, row[k] + __ldg(kd + c) * (__ldcg(p.rhs + c) - ax));
    }
    if (ko < n) put(il, j, ko, row[ko]);
  }
}

}  // namespace
