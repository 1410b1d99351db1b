// K8c and K8d: the radius-1 stencils of the fv7pt, fv2 and 27pt suites (the
// var7 and 27pt bodies of r1_common.cuh) on one rank's local block of a
// level decomposed over an i/j process grid, the i and j ghosts read from
// four thin halo slabs that the exchange (parallel/shard_kernels.py) filled.
//
// K8c replaces hpgmg_tpu/kernels/stencils_r1.py:r1_call_slab (:574, the
// pallas_call at :645, body _r1_kernel with slab=True): K5's four modes
// (apply, residual, gsrb, fres) with 1-deep slab ghosts. K8d replaces
// r1_gsrb2_call_slab (:960, the pallas_call at :1029, body _r1_gsrb2_kernel
// with slab=True): K6's full red+black sweep from ONE 2-deep exchange. None
// of their layout (pl.Element windows, the j padding to 8 rows, kbk_top,
// the (1, 8, nk) float edge flags) is carried over.
//
// Layouts (k fastest), for a local block of ni x nj x nk cells with D-deep
// ghosts (K8c: D = 1, K8d: D = 2):
//   x, alpha, rhs, kdinv, out   (ni, nj, nk)
//   ilo, ihi   (D, nj, nk): the cells i = -D .. -1 and i = ni .. ni+D-1
//   jlo, jhi   (ni+2D, D, nk): the cells j = -D .. -1 and j = nj .. nj+D-1
//              at i = -D .. ni+D-1 (the i-extended strips: the (i, j) edge
//              ghosts arrive with them, in the i-then-j order of the
//              separable fills)
//   beta_i (ni+1, nj, nk), beta_j (ni, nj+1, nk), beta_k (ni, nj, nk+1):
//              the rank's cut of the natural face arrays (K8c, var7)
// The k axis is never split: a k ghost is the 2-tap Dirichlet one over the
// two nearest ij values, or the wrapped cell (K8c periodic).
//
// K8d's operands add the ring views, each on the block and a 1-cell ring
// in i and j (zeros outside the domain), cut once per level
// (shard_kernels.build_sharded_k2_r1): kdinv0 (the red half's dinv), alpha,
// rhs (exchanged once per smooth call, r1_gsrb2_rhs_sharded) as
// (ni+2, nj+2, nk), the faces as beta_i (ni+3, nj+2, nk), beta_j
// (ni+2, nj+3, nk), beta_k (ni+2, nj+2, nk+1); kdinv1 (the black half's) on
// the block; and four edge flags, one per i/j side, set where that side is
// a domain face. Dirichlet only.
//
// Design. K8c: K5's shared-memory tile (Tile in r1_common.cuh) with its
// 1-cell halo loaded from the slabs where it leaves the block. K8d: K6's
// four steps on a tile with a 2-cell halo: (1) load x, i/j halo from the
// 2-deep slabs; (2) red on the tile and its 1-cell ring at every cell
// inside the DOMAIN (a ring cell on a side that is not a domain face is a
// neighbour's cell, computed here from the 2-deep halo and the ring
// views, as the neighbour computes it); (3) at the ring cells outside the
// domain (a flagged side, or k = -1, nk) the red iterate's ghost, the
// tensor product of the 2-tap rule over red values; (4) black on the tile.
// Each half evaluates the stencil at its parity's cells only (the kdinv
// pair vanishes off its parity, ops/base.py:RadiusOneSuite.fold_kdinv);
// local offsets are even, so the local parity is the global one.
//
// What bounds them on an H100: device-memory bandwidth, as K5 and K6 (var7
// gsrb ~7 values a cell against ~21 flops); the slabs add 2 D (ni + nj)
// nk values, K8d's ring views their 1-cell margins.
// Plain versions: hpgmg_tpu_torch/kernels/stencils_r1.py: r1_slab_plain,
// r1_gsrb2_slab_plain.

#include "r1_common.cuh"

namespace {

template <typename T>
struct SlabR1 {
  const T* x;
  const T* ilo;
  const T* ihi;
  const T* jlo;
  const T* jhi;
  const T* beta_i;  // K8d: the ring views
  const T* beta_j;
  const T* beta_k;
  const T* alpha;
  const T* rhs;
  const T* kdinv;   // K8c gsrb: the half's; K8d: kdinv0's ring view
  const T* kdinv1;  // K8d: the black half's, on the block
  T* out;
  int ni, nj, nk;
  T b_h2inv, a_coef, t1, t2;
  int periodic;    // K8c: k ghosts wrap
  int edge[4];     // K8d: i low, i high, j low, j high is a domain face
};

// x at (i, j, k), i in [-D, ni+D), j in [-D, nj+D), k in [0, nk): the
// block's cell, else the slab cell
template <typename T, int D>
__device__ __forceinline__ T ij_value(const SlabR1<T>& p, int i, int j, int k) {
  const int64_t nk = p.nk;
  if (j < 0) return ld(p.jlo + ((i + D) * D + (j + D)) * nk + k);
  if (j >= p.nj) return ld(p.jhi + ((i + D) * D + (j - p.nj)) * nk + k);
  if (i < 0) return ld(p.ilo + (static_cast<int64_t>(i + D) * p.nj + j) * nk + k);
  if (i >= p.ni) return ld(p.ihi + (static_cast<int64_t>(i - p.ni) * p.nj + j) * nk + k);
  return ld(p.x + (static_cast<int64_t>(i) * p.nj + j) * nk + k);
}

// ... and k in [-1, nk]: a k ghost is t1 x1 + t2 x2 of the nearest ij
// values, or the wrapped cell
template <typename T, int D>
__device__ __forceinline__ T slab_value(const SlabR1<T>& p, int i, int j, int k) {
  const int nk = p.nk;
  if (k >= 0 && k < nk) return ij_value<T, D>(p, i, j, k);
  if (p.periodic) return ij_value<T, D>(p, i, j, k < 0 ? nk - 1 : 0);
  const bool lo = k < 0;
  return p.t1 * ij_value<T, D>(p, i, j, lo ? 0 : nk - 1) +
         p.t2 * ij_value<T, D>(p, i, j, lo ? 1 : nk - 2);
}

// xs <- x at tile offsets [-H, T+H): the block's cells and the slab cells
// within D of it in i and j, the ghosts at k = -1, nk; zeros further out
// (read only by results at positions that are discarded or rebuilt)
template <typename T, int D, int H, int TI, int TJ, int TK>
__device__ __forceinline__ void load_slab_tile(const SlabR1<T>& p, T* xs, int i0,
                                               int j0, int k0) {
  constexpr int XJ = TJ + 2 * H, XK = TK + 2 * H, XSIZE = (TI + 2 * H) * XJ * XK;
  for (int t = threadIdx.x; t < XSIZE; t += kTileThreads) {
    const int c = t % XK, r = t / XK;
    const int i = i0 + r / XJ - H, j = j0 + r % XJ - H, k = k0 + c - H;
    const bool near = i >= -D && i < p.ni + D && j >= -D && j < p.nj + D &&
                      k >= -1 && k <= p.nk;
    xs[t] = near ? slab_value<T, D>(p, i, j, k) : T(0);
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

  load_slab_tile<T, 1, 1, TI, TJ, TK>(p, xs, i0, j0, k0);
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

// The coefficient indices of cell (i, j, k), i in [-1, ni], j in [-1, nj],
// in K8d's ring views
__device__ __forceinline__ R1Index ring_index(int i, int j, int k, int ni, int nj,
                                              int nk) {
  const int64_t c = ((static_cast<int64_t>(i) + 1) * (nj + 2) + (j + 1)) * nk + k;
  return {c, static_cast<int64_t>(nj + 2) * nk,
          ((static_cast<int64_t>(i) + 1) * (nj + 3) + (j + 1)) * nk + k, nk,
          ((static_cast<int64_t>(i) + 1) * (nj + 2) + (j + 1)) * (nk + 1) + k, c};
}

// K8d: one full red+black sweep of the block (see the top of the file)
template <typename T, bool VAR7>
__global__ void __launch_bounds__(kTileThreads) r1_gsrb2_slab_kernel(const SlabR1<T> p) {
  constexpr int TI = Tile<T>::I, TJ = Tile<T>::J, TK = Tile<T>::K;
  constexpr int XJ = TJ + 4, XK = TK + 4, XSIZE = (TI + 4) * XJ * XK;
  constexpr int RJ = TJ + 2, RK = TK + 2, RSIZE = (TI + 2) * RJ * RK;
  __shared__ T xs[XSIZE];
  __shared__ T rs[RSIZE];
  const int ni = p.ni, nj = p.nj, nk = p.nk;
  const int i0 = blockIdx.z * TI, j0 = blockIdx.y * TJ, k0 = blockIdx.x * TK;
  // the range of i and j inside the domain: the block, and the ring on the
  // sides that are not domain faces
  const int ilo = p.edge[0] ? 0 : -1, ihi = p.edge[1] ? ni : ni + 1;
  const int jlo = p.edge[2] ? 0 : -1, jhi = p.edge[3] ? nj : nj + 1;
  auto inside = [&](int i, int j, int k) {
    return i >= ilo && i < ihi && j >= jlo && j < jhi && in_range(k, nk);
  };

  // 1. x at tile offsets [-2, T+2)
  load_slab_tile<T, 2, 2, TI, TJ, TK>(p, xs, i0, j0, k0);
  __syncthreads();

  // 2. red at tile offsets [-1, T+1), cells inside the domain: one thread
  //    per pair of cells along k, the stencil at the red one of the pair,
  //    a copy of x at the black one
  for (int t = threadIdx.x; t < RSIZE / 2; t += kTileThreads) {
    const int r = t / (RK / 2), a = r / RJ, b = r % RJ;
    const int i = i0 + a - 1, j = j0 + b - 1;
    const int c = 2 * (t % (RK / 2)) + ((i + j + k0 - 1) & 1);  // red: i+j+k even
    const int k = k0 + c - 1;
    const int q = (a * RJ + b) * RK + c;
    const T* xc = xs + ((a + 1) * XJ + (b + 1)) * XK + (c + 1);
    const int cb = c ^ 1;  // the black cell of the pair
    if (inside(i, j, k0 + cb - 1)) rs[q - c + cb] = xc[cb - c];
    if (!inside(i, j, k)) continue;
    auto X = [&](int di, int dj, int dk) -> T { return xc[(di * XJ + dj) * XK + dk]; };
    const R1Index w = ring_index(i, j, k, ni, nj, nk);
    const T ax = r1_ax<T, VAR7>(p.beta_i, p.beta_j, p.beta_k, p.alpha, p.b_h2inv,
                                p.a_coef, X, w);
    rs[q] = xc[0] + ld(p.kdinv + w.ca) * (ld(p.rhs + w.ca) - ax);
  }
  __syncthreads();

  // 3. the red iterate's ghosts at the ring cells outside the domain:
  //    tensor product of the per-axis taps on the ghost axes over red
  //    values inside the domain (all inside the tile and its ring)
  auto taps = [&](int idx, int n, bool ghost, int (&id)[2], T (&wt)[2]) {
    if (!ghost) {
      id[0] = idx;
      wt[0] = T(1);
      return 1;
    }
    const bool lo = idx < 0;
    id[0] = lo ? 0 : n - 1;
    id[1] = lo ? 1 : n - 2;
    wt[0] = p.t1;
    wt[1] = p.t2;
    return 2;
  };
  for (int t = threadIdx.x; t < RSIZE; t += kTileThreads) {
    const int c = t % RK, r = t / RK, a = r / RJ, b = r % RJ;
    const int i = i0 + a - 1, j = j0 + b - 1, k = k0 + c - 1;
    if (i < -1 || i > ni || j < -1 || j > nj || k < -1 || k > nk) continue;
    if (inside(i, j, k)) continue;
    int ii[2], jj[2], kk[2];
    T wi[2], wj[2], wk[2];
    const int mi = taps(i, ni, i < ilo || i >= ihi, ii, wi);
    const int mj = taps(j, nj, j < jlo || j >= jhi, jj, wj);
    const int mk = taps(k, nk, !in_range(k, nk), kk, wk);
    T s = T(0);
    for (int u = 0; u < mi; ++u) {
      for (int v = 0; v < mj; ++v) {
        const T wuv = wi[u] * wj[v];
        for (int w = 0; w < mk; ++w)
          s += wuv * wk[w] *
               rs[((ii[u] - i0 + 1) * RJ + (jj[v] - j0 + 1)) * RK + (kk[w] - k0 + 1)];
      }
    }
    rs[t] = s;
  }
  __syncthreads();

  // 4. black on the tile: the stencil at the black cell of each pair, the
  //    red value at the red one
  constexpr int TSIZE = TI * TJ * TK;
  for (int t = threadIdx.x; t < TSIZE / 2; t += kTileThreads) {
    const int r = t / (TK / 2), a = r / TJ, b = r % TJ;
    const int i = i0 + a, j = j0 + b;
    const int c = 2 * (t % (TK / 2)) + ((i + j + k0 + 1) & 1);  // black: i+j+k odd
    const int k = k0 + c;
    const T* rc = rs + ((a + 1) * RJ + (b + 1)) * RK + (c + 1);
    const int cr = c ^ 1;  // the red cell of the pair
    if (in_range(i, ni) && in_range(j, nj) && in_range(k0 + cr, nk))
      p.out[(static_cast<int64_t>(i) * nj + j) * nk + k0 + cr] = rc[cr - c];
    if (!(in_range(i, ni) && in_range(j, nj) && in_range(k, nk))) continue;
    auto R = [&](int di, int dj, int dk) -> T { return rc[(di * RJ + dj) * RK + dk]; };
    const R1Index w = ring_index(i, j, k, ni, nj, nk);
    const T ax = r1_ax<T, VAR7>(p.beta_i, p.beta_j, p.beta_k, p.alpha, p.b_h2inv,
                                p.a_coef, R, w);
    const int64_t g = (static_cast<int64_t>(i) * nj + j) * nk + k;
    p.out[g] = rc[0] + ld(p.kdinv1 + g) * (ld(p.rhs + w.ca) - ax);
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

template <typename T>
int launch_r1_gsrb2_slab(const void* x, const void* ilo, const void* ihi,
                         const void* jlo, const void* jhi, const void* rbeta_i,
                         const void* rbeta_j, const void* rbeta_k, const void* ralpha,
                         const void* rrhs, const void* rkdinv0, const void* kdinv1,
                         void* out, int ni, int nj, int nk, int edges, int var7,
                         double b_h2inv, double a_coef, double t1, double t2,
                         void* stream) {
  if (bad_extents(ni, nj, nk) || ni % 2 || nj % 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SlabR1<T> p{};
  p.x = static_cast<const T*>(x);
  p.ilo = static_cast<const T*>(ilo);
  p.ihi = static_cast<const T*>(ihi);
  p.jlo = static_cast<const T*>(jlo);
  p.jhi = static_cast<const T*>(jhi);
  p.beta_i = static_cast<const T*>(rbeta_i);
  p.beta_j = static_cast<const T*>(rbeta_j);
  p.beta_k = static_cast<const T*>(rbeta_k);
  p.alpha = static_cast<const T*>(ralpha);
  p.rhs = static_cast<const T*>(rrhs);
  p.kdinv = static_cast<const T*>(rkdinv0);
  p.kdinv1 = static_cast<const T*>(kdinv1);
  p.out = static_cast<T*>(out);
  p.ni = ni; p.nj = nj; p.nk = nk;
  p.b_h2inv = static_cast<T>(b_h2inv);
  p.a_coef = static_cast<T>(a_coef);
  p.t1 = static_cast<T>(t1);
  p.t2 = static_cast<T>(t2);
  p.periodic = 0;
  for (int e = 0; e < 4; ++e) p.edge[e] = (edges >> e) & 1;
  const dim3 grid = slab_grid<T>(ni, nj, nk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (var7) {
    r1_gsrb2_slab_kernel<T, true><<<grid, kTileThreads, 0, s>>>(p);
  } else {
    r1_gsrb2_slab_kernel<T, false><<<grid, kTileThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
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

// K8d. The r* operands are the ring views; edges: bit e set where side e
// (i low, i high, j low, j high) is a domain face
extern "C" int hpgmg_r1_gsrb2_slab_f32(const void* x, const void* ilo, const void* ihi,
                                       const void* jlo, const void* jhi,
                                       const void* rbeta_i, const void* rbeta_j,
                                       const void* rbeta_k, const void* ralpha,
                                       const void* rrhs, const void* rkdinv0,
                                       const void* kdinv1, void* out, int ni, int nj,
                                       int nk, int edges, int var7, double b_h2inv,
                                       double a_coef, double t1, double t2,
                                       void* stream) {
  return launch_r1_gsrb2_slab<float>(x, ilo, ihi, jlo, jhi, rbeta_i, rbeta_j, rbeta_k,
                                     ralpha, rrhs, rkdinv0, kdinv1, out, ni, nj, nk,
                                     edges, var7, b_h2inv, a_coef, t1, t2, stream);
}

extern "C" int hpgmg_r1_gsrb2_slab_f64(const void* x, const void* ilo, const void* ihi,
                                       const void* jlo, const void* jhi,
                                       const void* rbeta_i, const void* rbeta_j,
                                       const void* rbeta_k, const void* ralpha,
                                       const void* rrhs, const void* rkdinv0,
                                       const void* kdinv1, void* out, int ni, int nj,
                                       int nk, int edges, int var7, double b_h2inv,
                                       double a_coef, double t1, double t2,
                                       void* stream) {
  return launch_r1_gsrb2_slab<double>(x, ilo, ihi, jlo, jhi, rbeta_i, rbeta_j, rbeta_k,
                                      ralpha, rrhs, rkdinv0, kdinv1, out, ni, nj, nk,
                                      edges, var7, b_h2inv, a_coef, t1, t2, stream);
}
