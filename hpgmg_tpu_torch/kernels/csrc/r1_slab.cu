// K8c: the radius-1 stencil of the fv7pt, fv2 and 27pt suites (the var7
// and 27pt bodies of r1_common.cuh) on one rank's local block of a level
// decomposed over an i/j process grid, the i and j ghosts read from four
// thin halo slabs that the exchange (parallel/shard_kernels.py) filled.
// K8d, the full red+black sweep of such a block, is K6's kernel
// (r1_gsrb2.cu).
//
// K8c replaces hpgmg_tpu/kernels/stencils_r1.py:r1_call_slab (:574, the
// pallas_call at :645, body _r1_kernel with slab=True): K5's four modes
// (apply, residual, gsrb, fres) with 1-deep slab ghosts. None of its
// layout (pl.Element windows, the j padding to 8 rows, kbk_top) is
// carried over.
//
// Layouts (k fastest), for a local block of ni x nj x nk cells:
//   x, alpha, rhs, kdinv, out   (ni, nj, nk)
//   ilo, ihi   (1, nj, nk): the cells i = -1 and i = ni
//   jlo, jhi   (ni+2, 1, nk): the cells j = -1 and j = nj at i = -1 .. ni
//              (the i-extended strips: the (i, j) edge ghosts arrive with
//              them, in the i-then-j order of the separable fills)
//   beta_i (ni+1, nj, nk), beta_j (ni, nj+1, nk), beta_k (ni, nj, nk+1):
//              the rank's cut of the natural face arrays (var7)
// The k axis is never split: a k ghost is the 2-tap Dirichlet one over the
// two nearest ij values, or the wrapped cell (periodic).
//
// Design: K5's shared-memory tile (Tile in r1_common.cuh) with its 1-cell
// halo loaded from the slabs where it leaves the block.
//
// What bounds it on an H100: device-memory bandwidth, as K5 (var7 gsrb ~7
// values a cell against ~21 flops); the slabs add 2 (ni + nj) nk values.
// Plain version: hpgmg_tpu_torch/kernels/stencils_r1.py: r1_slab_plain.

#include "r1_common.cuh"

namespace {

template <typename T>
struct SlabR1 {
  const T* x;
  const T* ilo;
  const T* ihi;
  const T* jlo;
  const T* jhi;
  const T* beta_i;
  const T* beta_j;
  const T* beta_k;
  const T* alpha;
  const T* rhs;
  const T* kdinv;   // gsrb: the half's
  T* out;
  int ni, nj, nk;
  T b_h2inv, a_coef, t1, t2;
  int periodic;    // k ghosts wrap
};

// x at (i, j, k), i in [-1, ni], j in [-1, nj], k in [0, nk): the block's
// cell, else the slab cell
template <typename T>
__device__ __forceinline__ T ij_value(const SlabR1<T>& p, int i, int j, int k) {
  const int64_t nk = p.nk;
  if (j < 0) return ld(p.jlo + (i + 1) * nk + k);
  if (j >= p.nj) return ld(p.jhi + (i + 1) * nk + k);
  if (i < 0) return ld(p.ilo + static_cast<int64_t>(j) * nk + k);
  if (i >= p.ni) return ld(p.ihi + static_cast<int64_t>(j) * nk + k);
  return ld(p.x + (static_cast<int64_t>(i) * p.nj + j) * nk + k);
}

// ... and k in [-1, nk]: a k ghost is t1 x1 + t2 x2 of the nearest ij
// values, or the wrapped cell
template <typename T>
__device__ __forceinline__ T slab_value(const SlabR1<T>& p, int i, int j, int k) {
  const int nk = p.nk;
  if (k >= 0 && k < nk) return ij_value<T>(p, i, j, k);
  if (p.periodic) return ij_value<T>(p, i, j, k < 0 ? nk - 1 : 0);
  const bool lo = k < 0;
  return p.t1 * ij_value<T>(p, i, j, lo ? 0 : nk - 1) +
         p.t2 * ij_value<T>(p, i, j, lo ? 1 : nk - 2);
}

// xs <- x at tile offsets [-1, T+1): the block's cells and the slab cells
// next to it in i and j, the ghosts at k = -1, nk; zeros further out (read
// only by results at positions that are discarded)
template <typename T, int TI, int TJ, int TK>
__device__ __forceinline__ void load_slab_tile(const SlabR1<T>& p, T* xs, int i0,
                                               int j0, int k0) {
  constexpr int XJ = TJ + 2, XK = TK + 2, XSIZE = (TI + 2) * XJ * XK;
  for (int t = threadIdx.x; t < XSIZE; t += kTileThreads) {
    const int c = t % XK, r = t / XK;
    const int i = i0 + r / XJ - 1, j = j0 + r % XJ - 1, k = k0 + c - 1;
    const bool near = i >= -1 && i <= p.ni && j >= -1 && j <= p.nj && k >= -1 && k <= p.nk;
    xs[t] = near ? slab_value<T>(p, i, j, k) : T(0);
  }
}

// K8c: K5's modes on the block
template <typename T, bool VAR7, int MODE>
__global__ void __launch_bounds__(kTileThreads) r1_slab_kernel(const SlabR1<T> p) {
  constexpr int TI = Tile<T>::I, TJ = Tile<T>::J, TK = Tile<T>::K;
  constexpr int XJ = TJ + 2, XK = TK + 2, XSIZE = (TI + 2) * XJ * XK;
  constexpr int TSIZE = TI * TJ * TK;
  __shared__ T xs[XSIZE];
  __shared__ T rs[MODE == kFres ? TSIZE : 1];  // fres: the tile's residuals
  const int ni = p.ni, nj = p.nj, nk = p.nk;
  const int i0 = blockIdx.z * TI, j0 = blockIdx.y * TJ, k0 = blockIdx.x * TK;

  load_slab_tile<T, TI, TJ, TK>(p, xs, i0, j0, k0);
  __syncthreads();

  for (int t = threadIdx.x; t < TSIZE; t += kTileThreads) {
    const int c = t % TK, r = t / TK, a = r / TJ, b = r % TJ;
    const int i = i0 + a, j = j0 + b, k = k0 + c;
    if (!(in_range(i, ni) && in_range(j, nj) && in_range(k, nk))) continue;
    const T* xc = xs + ((a + 1) * XJ + (b + 1)) * XK + (c + 1);
    auto X = [&](int di, int dj, int dk) -> T { return xc[(di * XJ + dj) * XK + dk]; };
    const R1Index q = r1_index(i, j, k, ni, nj, nk);
    const T ax = r1_ax<T, VAR7>(p.beta_i, p.beta_j, p.beta_k, p.alpha, p.b_h2inv,
                                p.a_coef, X, q);
    const int64_t g = q.ca;
    if constexpr (MODE == kApply) {
      p.out[g] = ax;
    } else if constexpr (MODE == kResidual) {
      p.out[g] = ld(p.rhs + g) - ax;
    } else if constexpr (MODE == kGsrb) {
      p.out[g] = xc[0] + ld(p.kdinv + g) * (ld(p.rhs + g) - ax);
    } else {
      rs[t] = ld(p.rhs + g) - ax;
    }
  }

  if constexpr (MODE == kFres) {
    __syncthreads();
    constexpr int CJ = TJ / 2, CK = TK / 2, CSIZE = (TI / 2) * CJ * CK;
    const int mi = ni / 2, mj = nj / 2, mk = nk / 2;
    for (int t = threadIdx.x; t < CSIZE; t += kTileThreads) {
      const int c = t % CK, r = t / CK, a = r / CJ, b = r % CJ;
      const int I = i0 / 2 + a, J = j0 / 2 + b, K = k0 / 2 + c;
      if (!(in_range(I, mi) && in_range(J, mj) && in_range(K, mk))) continue;
      const T* rc = rs + ((2 * a) * TJ + 2 * b) * TK + 2 * c;
      T sum = T(0);
#pragma unroll
      for (int d = 0; d < 8; ++d)
        sum += rc[((d >> 2) * TJ + ((d >> 1) & 1)) * TK + (d & 1)];
      p.out[(static_cast<int64_t>(I) * mj + J) * mk + K] = T(0.125) * sum;
    }
  }
}

template <typename T>
dim3 slab_grid(int ni, int nj, int nk) {
  return dim3((nk + Tile<T>::K - 1) / Tile<T>::K, (nj + Tile<T>::J - 1) / Tile<T>::J,
              (ni + Tile<T>::I - 1) / Tile<T>::I);
}

template <typename T, bool VAR7>
cudaError_t launch_slab_body(const SlabR1<T>& p, int mode, cudaStream_t s) {
  const dim3 grid = slab_grid<T>(p.ni, p.nj, p.nk);
  switch (mode) {
    case kApply: r1_slab_kernel<T, VAR7, kApply><<<grid, kTileThreads, 0, s>>>(p); break;
    case kResidual: r1_slab_kernel<T, VAR7, kResidual><<<grid, kTileThreads, 0, s>>>(p); break;
    case kGsrb: r1_slab_kernel<T, VAR7, kGsrb><<<grid, kTileThreads, 0, s>>>(p); break;
    default: r1_slab_kernel<T, VAR7, kFres><<<grid, kTileThreads, 0, s>>>(p); break;
  }
  return cudaGetLastError();
}

bool bad_extents(int ni, int nj, int nk) {
  return ni < 2 || nj < 2 || nk < 2 || ni > 65535 * 8 || nj > 65535 * 8;
}

template <typename T>
int launch_r1_slab(const void* x, const void* ilo, const void* ihi, const void* jlo,
                   const void* jhi, const void* beta_i, const void* beta_j,
                   const void* beta_k, const void* alpha, const void* rhs,
                   const void* kdinv, void* out, int ni, int nj, int nk, int mode,
                   int var7, int periodic, double b_h2inv, double a_coef, double t1,
                   double t2, void* stream) {
  if (bad_extents(ni, nj, nk) || mode < kApply || mode > kFres ||
      (mode == kFres && (ni % 2 || nj % 2 || nk % 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SlabR1<T> p{};
  p.x = static_cast<const T*>(x);
  p.ilo = static_cast<const T*>(ilo);
  p.ihi = static_cast<const T*>(ihi);
  p.jlo = static_cast<const T*>(jlo);
  p.jhi = static_cast<const T*>(jhi);
  p.beta_i = static_cast<const T*>(beta_i);
  p.beta_j = static_cast<const T*>(beta_j);
  p.beta_k = static_cast<const T*>(beta_k);
  p.alpha = static_cast<const T*>(alpha);
  p.rhs = static_cast<const T*>(rhs);
  p.kdinv = static_cast<const T*>(kdinv);
  p.out = static_cast<T*>(out);
  p.ni = ni; p.nj = nj; p.nk = nk;
  p.b_h2inv = static_cast<T>(b_h2inv);
  p.a_coef = static_cast<T>(a_coef);
  p.t1 = static_cast<T>(t1);
  p.t2 = static_cast<T>(t2);
  p.periodic = periodic != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(var7 ? launch_slab_body<T, true>(p, mode, s)
                               : launch_slab_body<T, false>(p, mode, s));
}

}  // namespace

// K8c. var7 != 0: the 7-point body (beta_* read; alpha may be null); else
// the 27pt body (a_coef the constant a). periodic != 0: k ghosts wrap
extern "C" int hpgmg_r1_slab_f32(const void* x, const void* ilo, const void* ihi,
                                 const void* jlo, const void* jhi, const void* beta_i,
                                 const void* beta_j, const void* beta_k,
                                 const void* alpha, const void* rhs, const void* kdinv,
                                 void* out, int ni, int nj, int nk, int mode, int var7,
                                 int periodic, double b_h2inv, double a_coef,
                                 double t1, double t2, void* stream) {
  return launch_r1_slab<float>(x, ilo, ihi, jlo, jhi, beta_i, beta_j, beta_k, alpha,
                               rhs, kdinv, out, ni, nj, nk, mode, var7, periodic,
                               b_h2inv, a_coef, t1, t2, stream);
}

extern "C" int hpgmg_r1_slab_f64(const void* x, const void* ilo, const void* ihi,
                                 const void* jlo, const void* jhi, const void* beta_i,
                                 const void* beta_j, const void* beta_k,
                                 const void* alpha, const void* rhs, const void* kdinv,
                                 void* out, int ni, int nj, int nk, int mode, int var7,
                                 int periodic, double b_h2inv, double a_coef,
                                 double t1, double t2, void* stream) {
  return launch_r1_slab<double>(x, ilo, ihi, jlo, jhi, beta_i, beta_j, beta_k, alpha,
                                rhs, kdinv, out, ni, nj, nk, mode, var7, periodic,
                                b_h2inv, a_coef, t1, t2, stream);
}
