// K8a and K8b: the fv4 stencil of K1 (operators.fv4.c:87-114) on one rank's
// local block of a level decomposed over an i/j process grid, its 2-deep
// i and j ghosts read from four thin halo slabs that the exchange
// (parallel/shard_kernels.py) filled, in three modes:
//
//   apply     out = A x
//   residual  out = rhs - A x
//   gsrb      out = x + kdinv * (rhs - A x)   (kdinv: dinv with the red/black
//                                             parity mask folded in)
//
// where A x = scale * (main/12 + mixed/48) [+ a * alpha * x], scale = -b/h^2.
//
// K8a replaces hpgmg_tpu/kernels/stencils.py:fv4_call_slab (:1194, the
// pallas_call at :1268, body _fv4_kernel with slab=True). K8b replaces
// fv4_call_overlap (:1292): its interior pass (:1370), which reads no slab
// and so may run while the exchange is in flight, and its edge pass
// (:1421) over the remaining tiles into the same output. Neither the
// pl.Element windows nor the j padding to 8 rows nor kbk_top is carried
// over: the slabs hold exactly their ghost rows, the face coefficients
// are cuts of the port's tangentially-extended arrays.
//
// Layouts (k fastest), for a local block of ni x nj x nk cells:
//   x, alpha, rhs, kdinv, out   (ni, nj, nk)
//   ilo, ihi   (2, nj, nk): the cells i = -2, -1 and i = ni, ni+1
//   jlo, jhi   (ni+4, 2, nk): the cells j = -2, -1 and j = nj, nj+1 at
//              i = -2 .. ni+1 (the i-extended strips, so the (i, j) edge
//              ghosts arrive with them, in the i-then-j order of the
//              separable fill)
//   bie (ni+1, nj+2, nk+2), bje (ni+2, nj+1, nk+2), bke (ni+2, nj+2, nk+1):
//              the rank's cut of the tangentially-extended face arrays;
//              their tangential margins hold the true neighbour faces
//              (or the extrapolated ghosts at a domain face)
// The k axis is never split: its ghosts are the quartic Dirichlet ones,
// synthesized from the four cells nearest the face (the ij values, slab
// cells included), or the periodic wrap.
//
// Design: K1s's (fv4_subtile.cu) shared-memory tile. A block owns a
// TI x TJ x TK tile and loads x on it with a 2-cell halo; a halo cell that
// lies outside the block in i or j comes from the slabs instead of being
// synthesized, a k ghost is synthesized over those values. Then each of
// the TJ x TK threads walks the TI cells of its (j, k) row along i with
// the arithmetic of K1 (fv4_combination). K8b launches the same body
// twice: once over the tiles whose halo lies inside the block (no slab
// pointer read; interior tiles need nti, ntj >= 3), once over the others,
// so its result equals K8a's bit for bit. Local extents are even (the
// decomposition's gate), so an interior tile's halo never reaches a slab.
//
// What bounds it on an H100: device-memory bandwidth, as K1s: gsrb reads
// x, the three beta arrays, rhs and kdinv and writes out, ~7 values a cell
// against ~113 flops; the slabs add 2 (ni + nj + 4) nk values.
// Plain version: hpgmg_tpu_torch/kernels/stencils.py:fv4_slab_plain.

#include "fv4_common.cuh"

namespace {

constexpr int kSlabThreads = 256;

template <typename T>
struct SlabTile {
  static constexpr int I = 16, J = 8, K = 32, MinBlocks = 4;
};
template <>
struct SlabTile<double> {
  static constexpr int I = 8, J = 8, K = 32, MinBlocks = 1;
};

template <typename T>
struct SlabArgs {
  const T* x;
  const T* ilo;
  const T* ihi;
  const T* jlo;
  const T* jhi;
  const T* bie;
  const T* bje;
  const T* bke;
  const T* alpha;  // nullptr: no a*alpha*x term
  const T* rhs;
  const T* kdinv;
  T* out;
  int ni, nj, nk;
  int periodic;  // k ghosts wrap
  T scale;       // -b / h^2
  T a_coef;
};

// x at (i, j, k), i in [-2, ni+2), j in [-2, nj+2), k in [0, nk): the
// block's cell, else the slab cell
template <typename T>
__device__ __forceinline__ T ij_value(const SlabArgs<T>& p, int i, int j, int k) {
  const int64_t nk = p.nk;
  if (j < 0) return __ldg(p.jlo + ((i + 2) * 2 + (j + 2)) * nk + k);
  if (j >= p.nj) return __ldg(p.jhi + ((i + 2) * 2 + (j - p.nj)) * nk + k);
  if (i < 0) return __ldg(p.ilo + (static_cast<int64_t>(i + 2) * p.nj + j) * nk + k);
  if (i >= p.ni) return __ldg(p.ihi + (static_cast<int64_t>(i - p.ni) * p.nj + j) * nk + k);
  return __ldg(p.x + (static_cast<int64_t>(i) * p.nj + j) * nk + k);
}

// ... and k in [-2, nk+2): a k ghost is the quartic Dirichlet one over the
// four nearest ij values, or the wrapped cell
template <typename T>
__device__ __forceinline__ T slab_value(const SlabArgs<T>& p, int i, int j, int k) {
  if (k >= 0 && k < p.nk) return ij_value(p, i, j, k);
  if (p.periodic) return ij_value(p, i, j, k < 0 ? k + p.nk : k - p.nk);
  int kk[4];
  T wk[4];
  const int m = axis_taps(k, p.nk, kk, wk);
  T s = T(0);
  for (int c = 0; c < m; ++c) s += wk[c] * ij_value(p, i, j, kk[c]);
  return s;
}

// PASS 0: every tile (grid (ntk, ntj, nti)); 1: the interior tiles
// (grid (ntk, ntj-2, nti-2)); 2: the edge tiles (grid (ntk, n_edge)).
template <int PASS>
__device__ __forceinline__ void tile_coords(int nti, int ntj, int& ti, int& tj) {
  if constexpr (PASS == 0) {
    ti = blockIdx.z;
    tj = blockIdx.y;
  } else if constexpr (PASS == 1) {
    ti = blockIdx.z + 1;
    tj = blockIdx.y + 1;
  } else {
    const int t = blockIdx.y;
    if (t < ntj) {
      ti = 0; tj = t;
    } else if (t < 2 * ntj) {
      ti = nti - 1; tj = t - ntj;
    } else {
      const int r = t - 2 * ntj;
      ti = 1 + r / 2;
      tj = (r & 1) ? ntj - 1 : 0;
    }
  }
}

template <typename T, int MODE, int PASS>
__global__ void __launch_bounds__(kSlabThreads, SlabTile<T>::MinBlocks)
    fv4_slab_kernel(const SlabArgs<T> p) {
  constexpr int TI = SlabTile<T>::I, TJ = SlabTile<T>::J, TK = SlabTile<T>::K;
  constexpr int XJ = TJ + 4, XK = TK + 4, XSIZE = (TI + 4) * XJ * XK;
  static_assert(TJ * TK == kSlabThreads, "one thread per (j, k) of the tile");
  __shared__ T xs[XSIZE];
  const int ni = p.ni, nj = p.nj, nk = p.nk;
  const int nti = (ni + TI - 1) / TI, ntj = (nj + TJ - 1) / TJ;
  int ti, tj;
  tile_coords<PASS>(nti, ntj, ti, tj);
  const int i0 = ti * TI, j0 = tj * TJ, k0 = blockIdx.x * TK;

  // x on the tile and its 2-cell halo; zeros beyond the ghosts (read only
  // by cells outside the block). An interior tile's halo lies inside the
  // block in i and j, so it reads no slab.
  for (int t = threadIdx.x; t < XSIZE; t += kSlabThreads) {
    const int c = t % XK, r = t / XK;
    const int i = i0 + r / XJ - 2, j = j0 + r % XJ - 2, k = k0 + c - 2;
    const bool near = i >= -2 && i < ni + 2 && j >= -2 && j < nj + 2 && k >= -2 &&
                      k < nk + 2;
    xs[t] = near ? slab_value(p, i, j, k) : T(0);
  }
  __syncthreads();

  const int kl = threadIdx.x % TK, jl = threadIdx.x / TK;
  const int j = j0 + jl, k = k0 + kl;
  if (j >= nj || k >= nk) return;
  const int64_t sj1 = nj + 1, sj2 = nj + 2, sk1 = nk + 1, sk2 = nk + 2;
  for (int il = 0; il < TI && i0 + il < ni; ++il) {
    const int i = i0 + il;
    const T* xc = xs + ((il + 2) * XJ + (jl + 2)) * XK + (kl + 2);
    auto X = [&](int di, int dj, int dk) -> T { return xc[(di * XJ + dj) * XK + dk]; };
    auto BI = [&](int f, int dj, int dk) -> T {
      return __ldg(p.bie + ((i + f) * sj2 + (1 + j + dj)) * sk2 + (1 + k + dk));
    };
    auto BJ = [&](int f, int di, int dk) -> T {
      return __ldg(p.bje + ((1 + i + di) * sj1 + (j + f)) * sk2 + (1 + k + dk));
    };
    auto BK = [&](int f, int di, int dj) -> T {
      return __ldg(p.bke + ((1 + i + di) * sj2 + (1 + j + dj)) * sk1 + (k + f));
    };
    const int64_t c = (static_cast<int64_t>(i) * nj + j) * nk + k;
    const T x0 = X(0, 0, 0);
    T ax = p.scale * fv4_combination<T>(X, BI, BJ, BK);
    if (p.alpha != nullptr) ax = p.a_coef * __ldg(p.alpha + c) * x0 + ax;
    if constexpr (MODE == kApply) {
      p.out[c] = ax;
    } else if constexpr (MODE == kResidual) {
      p.out[c] = __ldg(p.rhs + c) - ax;
    } else {
      p.out[c] = x0 + __ldg(p.kdinv + c) * (__ldg(p.rhs + c) - ax);
    }
  }
}

template <typename T, int PASS>
cudaError_t launch_pass(const SlabArgs<T>& p, int mode, cudaStream_t s) {
  constexpr int TI = SlabTile<T>::I, TJ = SlabTile<T>::J, TK = SlabTile<T>::K;
  const int nti = (p.ni + TI - 1) / TI, ntj = (p.nj + TJ - 1) / TJ;
  const int ntk = (p.nk + TK - 1) / TK;
  dim3 grid(ntk, ntj, nti);
  if (PASS == 1) grid = dim3(ntk, ntj - 2, nti - 2);
  if (PASS == 2) grid = dim3(ntk, 2 * ntj + 2 * (nti - 2), 1);
  switch (mode) {
    case kApply: fv4_slab_kernel<T, kApply, PASS><<<grid, kSlabThreads, 0, s>>>(p); break;
    case kResidual: fv4_slab_kernel<T, kResidual, PASS><<<grid, kSlabThreads, 0, s>>>(p); break;
    default: fv4_slab_kernel<T, kGsrb, PASS><<<grid, kSlabThreads, 0, s>>>(p); break;
  }
  return cudaGetLastError();
}

template <typename T>
int launch_slab(const void* x, const void* ilo, const void* ihi, const void* jlo,
                const void* jhi, const void* bie, const void* bje, const void* bke,
                const void* alpha, const void* rhs, const void* kdinv, void* out,
                int ni, int nj, int nk, int mode, int periodic, double scale,
                double a_coef, int pass, void* stream) {
  constexpr int TI = SlabTile<T>::I, TJ = SlabTile<T>::J;
  const int nti = (ni + TI - 1) / TI, ntj = (nj + TJ - 1) / TJ;
  if (ni < 4 || nj < 4 || nk < 4 || ni % 2 || nj % 2 || ni > 65535 * TI ||
      nj > 65535 * TJ || mode < kApply || mode > kGsrb || pass < 0 || pass > 2 ||
      (pass != 0 && (nti < 3 || ntj < 3))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SlabArgs<T> p{static_cast<const T*>(x),     static_cast<const T*>(ilo),
                      static_cast<const T*>(ihi),   static_cast<const T*>(jlo),
                      static_cast<const T*>(jhi),   static_cast<const T*>(bie),
                      static_cast<const T*>(bje),   static_cast<const T*>(bke),
                      static_cast<const T*>(alpha), static_cast<const T*>(rhs),
                      static_cast<const T*>(kdinv), static_cast<T*>(out),
                      ni, nj, nk, periodic != 0,
                      static_cast<T>(scale),        static_cast<T>(a_coef)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (pass == 0) err = launch_pass<T, 0>(p, mode, s);
  else if (pass == 1) err = launch_pass<T, 1>(p, mode, s);
  else err = launch_pass<T, 2>(p, mode, s);
  return static_cast<int>(err);
}

}  // namespace

// pass 0: K8a over every tile; 1: K8b's interior pass (slab pointers
// unread); 2: K8b's edge pass, writing the rest of `out`
extern "C" int hpgmg_fv4_slab_f32(const void* x, const void* ilo, const void* ihi,
                                  const void* jlo, const void* jhi, const void* bie,
                                  const void* bje, const void* bke, const void* alpha,
                                  const void* rhs, const void* kdinv, void* out,
                                  int ni, int nj, int nk, int mode, int periodic,
                                  double scale, double a_coef, int pass,
                                  void* stream) {
  return launch_slab<float>(x, ilo, ihi, jlo, jhi, bie, bje, bke, alpha, rhs, kdinv,
                            out, ni, nj, nk, mode, periodic, scale, a_coef, pass,
                            stream);
}

extern "C" int hpgmg_fv4_slab_f64(const void* x, const void* ilo, const void* ihi,
                                  const void* jlo, const void* jhi, const void* bie,
                                  const void* bje, const void* bke, const void* alpha,
                                  const void* rhs, const void* kdinv, void* out,
                                  int ni, int nj, int nk, int mode, int periodic,
                                  double scale, double a_coef, int pass,
                                  void* stream) {
  return launch_slab<double>(x, ilo, ihi, jlo, jhi, bie, bje, bke, alpha, rhs, kdinv,
                             out, ni, nj, nk, mode, periodic, scale, a_coef, pass,
                             stream);
}
