// Device building blocks of the radius-1 kernels (K5 in r1_stencil.cu and
// r1_stream.cu, K6 in r1_gsrb2.cu, K8c and K8d in r1_slab.cu): the 2-tap
// Dirichlet ghost of x, and A x at one cell from an accessor of its
// neighbourhood and the indices of its face coefficients (r1_ax; r1_index
// for an ni x nj x nk block), for the two bodies:
//
//   var7  A x = -b/h^2 * sum over the six faces of beta_f * (x_nb - x_c)
//               [+ a * alpha * x_c]                      (fv7pt, fv2)
//   27pt  A x = a * x_c - b/h^2 * (C0 x_c + C1 faces + C2 edges + C3 corners)
//               with (C0..C3) = (-128, 14, 3, 1) / 30    (27pt),
//               summed as C1 (faces - x_c) + C2 (edges - x_c) + C3 (corners
//               - x_c) (C0 = -(6 C1 + 12 C2 + 8 C3)): the terms of the
//               first form cancel to ~h^2 of their size, which costs float32
//               ~3 decimal digits of A x at 512^3.
//
// Layouts: a cell field is (n, n, n) with k fastest. The face coefficients
// are the natural face arrays, as the radius-1 suites keep them: beta_i
// (n+1, n, n), beta_j (n, n+1, n), beta_k (n, n, n+1); face f (0 low,
// 1 high) of cell (i, j, k) along i is beta_i[i + f, j, k], and so on.
//
// Dirichlet ghosts: a ghost one cell outside a domain face is
// g = t1 * x1 + t2 * x2 of the two nearest interior cells along that axis
// (fv7pt (-1, 0), fv2 (-5/2, 1/2), 27pt (-2, 1/3)); a ghost outside on
// several axes (the edges and corners the 27pt body reads) is the tensor
// product of the per-axis taps, which is what the separable i -> j -> k
// fills of ops/bc.py and ops/bc_fv.py produce. Needs n >= 2.
//
// Periodic ghosts (K7b, R1Args::periodic): a ghost one cell outside is the
// cell at the opposite face, index mod n on each axis it crosses (edges
// and corners wrap on each axis), with weight 1. At n = 2 the low and the
// high ghost of an axis are the same two cells.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Mode : int { kApply = 0, kResidual = 1, kGsrb = 2, kFres = 3 };

template <typename T>
struct R1Args {
  const T* x;
  const T* beta_i;  // var7 only
  const T* beta_j;
  const T* beta_k;
  const T* alpha;   // var7 with a*alpha*x; nullptr otherwise
  const T* rhs;
  const T* kdinv;   // K5 gsrb: the half's parity-folded dinv; K6: red's
  const T* kdinv1;  // K6: black's
  T* out;
  int n;
  T b_h2inv;  // b / h^2
  T a_coef;   // var7: a (with alpha); 27pt: the constant a of a*x
  T t1, t2;   // Dirichlet ghost taps
  int periodic;  // K7b: ghosts wrap (t1, t2 unused); K5 and K6: 0
};

template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return __ldg(p);
}

__device__ __forceinline__ bool in_range(int idx, int n) {
  return idx >= 0 && idx < n;
}

// 1D taps of index idx in [-1, n] on an axis of n cells: itself inside the
// domain, else the two interior cells nearest the face.
template <typename T>
__device__ __forceinline__ int r1_taps(int idx, int n, T t1, T t2,
                                       int (&id)[2], T (&w)[2]) {
  if (in_range(idx, n)) {
    id[0] = idx;
    w[0] = T(1);
    return 1;
  }
  const bool lo = idx < 0;
  id[0] = lo ? 0 : n - 1;
  id[1] = lo ? 1 : n - 2;
  w[0] = t1;
  w[1] = t2;
  return 2;
}

// x at (i, j, k), each in [-1, n]: the cell inside the domain, else the
// tensor product of the per-axis ghost taps.
template <typename T>
__device__ __forceinline__ T r1_value(const T* x, int n, T t1, T t2, int i,
                                      int j, int k) {
  int ii[2], jj[2], kk[2];
  T wi[2], wj[2], wk[2];
  const int ni = r1_taps(i, n, t1, t2, ii, wi);
  const int nj = r1_taps(j, n, t1, t2, jj, wj);
  const int nk = r1_taps(k, n, t1, t2, kk, wk);
  if (ni == 1 && nj == 1 && nk == 1)
    return ld(x + (static_cast<int64_t>(i) * n + j) * n + k);
  T s = T(0);
  for (int a = 0; a < ni; ++a) {
    for (int b = 0; b < nj; ++b) {
      const T wab = wi[a] * wj[b];
      for (int c = 0; c < nk; ++c)
        s += wab * wk[c] * ld(x + (static_cast<int64_t>(ii[a]) * n + jj[b]) * n + kk[c]);
    }
  }
  return s;
}

// x at (i, j, k), each in [-1, n], under periodic BCs: the cell at each
// index mod n.
template <typename T>
__device__ __forceinline__ T r1_wrap_value(const T* x, int n, int i, int j,
                                           int k) {
  auto wrap = [n](int idx) { return idx < 0 ? idx + n : (idx >= n ? idx - n : idx); };
  return ld(x + (static_cast<int64_t>(wrap(i)) * n + wrap(j)) * n + wrap(k));
}

// --------------------------------------------------------------------------
// Tiles in shared memory. A block owns a TI x TJ x TK box of cells at
// (i0, j0, k0) (k fastest) and keeps x on it with an H-cell halo.

constexpr int kTileThreads = 256;

// Output tile per block (i, j, k); f64 halves k to keep K6's two shared
// arrays under 48 KB of static shared memory.
template <typename T>
struct Tile {
  static constexpr int I = 8, J = 8, K = 32;
};
template <>
struct Tile<double> {
  static constexpr int I = 8, J = 8, K = 16;
};

__device__ __forceinline__ bool near_domain(int idx, int n) {
  return idx >= -1 && idx <= n;
}

// xs <- x at tile offsets [-H, T+H) on each axis: the cells inside the
// domain, the ghosts one cell outside it (Dirichlet taps or the periodic
// wrap), zeros further out (read only by results at ghost positions, which
// are discarded).
template <typename T, int H, int TI, int TJ, int TK>
__device__ __forceinline__ void load_tile(const R1Args<T>& p, T* xs, int i0,
                                          int j0, int k0) {
  constexpr int XJ = TJ + 2 * H, XK = TK + 2 * H, XSIZE = (TI + 2 * H) * XJ * XK;
  const int n = p.n;
  for (int t = threadIdx.x; t < XSIZE; t += kTileThreads) {
    const int c = t % XK, r = t / XK;
    const int i = i0 + r / XJ - H, j = j0 + r % XJ - H, k = k0 + c - H;
    xs[t] = !(near_domain(i, n) && near_domain(j, n) && near_domain(k, n))
                ? T(0)
                : p.periodic ? r1_wrap_value(p.x, n, i, j, k)
                             : r1_value(p.x, n, p.t1, p.t2, i, j, k);
  }
}

// Where the var7 body finds a cell's coefficients: its low i, j, k faces at
// beta_i[ci], beta_j[cj], beta_k[ck], the high ones si, sj and 1 further,
// alpha at ca.
struct R1Index {
  int64_t ci, si, cj, sj, ck, ca;
};

// The face indices of cell (i, j, k) in the natural face arrays of an
// ni x nj x nk block (beta_i (ni+1, nj, nk) and so on).
__device__ __forceinline__ R1Index r1_index(int i, int j, int k, int ni, int nj,
                                            int nk) {
  const int64_t c = (static_cast<int64_t>(i) * nj + j) * nk + k;
  return {c, static_cast<int64_t>(nj) * nk,
          (static_cast<int64_t>(i) * (nj + 1) + j) * nk + k, nk,
          (static_cast<int64_t>(i) * nj + j) * (nk + 1) + k, c};
}

// A x at one cell from its face coefficients (found by `q`) and X(di, dj,
// dk), which reads x (ghosts included) around it. The sums run in the
// order of the plain versions (kernels/stencils_r1.py: beta_laplacian,
// laplacian_27pt).
template <typename T, bool VAR7, typename FX>
__device__ __forceinline__ T r1_ax(const T* beta_i, const T* beta_j, const T* beta_k,
                                   const T* alpha, T b_h2inv, T a_coef, const FX& X,
                                   const R1Index& q) {
  const T xc = X(0, 0, 0);
  if constexpr (VAR7) {
    const T lap = ld(beta_i + q.ci + q.si) * (X(1, 0, 0) - xc) +
                  ld(beta_i + q.ci) * (X(-1, 0, 0) - xc) +
                  ld(beta_j + q.cj + q.sj) * (X(0, 1, 0) - xc) +
                  ld(beta_j + q.cj) * (X(0, -1, 0) - xc) +
                  ld(beta_k + q.ck + 1) * (X(0, 0, 1) - xc) +
                  ld(beta_k + q.ck) * (X(0, 0, -1) - xc);
    T ax = -b_h2inv * lap;
    if (alpha != nullptr) ax = a_coef * ld(alpha + q.ca) * xc + ax;
    return ax;
  } else {
    T face = T(0), edge = T(0), corner = T(0);
#pragma unroll
    for (int di = -1; di <= 1; ++di) {
#pragma unroll
      for (int dj = -1; dj <= 1; ++dj) {
#pragma unroll
        for (int dk = -1; dk <= 1; ++dk) {
          const int m = (di != 0) + (dj != 0) + (dk != 0);
          if (m == 0) continue;
          const T v = X(di, dj, dk) - xc;
          if (m == 1) face += v;
          else if (m == 2) edge += v;
          else corner += v;
        }
      }
    }
    const T lap = T(14.0 / 30.0) * face + T(3.0 / 30.0) * edge +
                  T(1.0 / 30.0) * corner;
    return a_coef * xc - b_h2inv * lap;
  }
}

// A x at cell (i, j, k) of the n^3 level of `p`
template <typename T, bool VAR7, typename FX>
__device__ __forceinline__ T r1_cell_ax(const R1Args<T>& p, const FX& X, int i,
                                        int j, int k) {
  return r1_ax<T, VAR7>(p.beta_i, p.beta_j, p.beta_k, p.alpha, p.b_h2inv, p.a_coef, X,
                        r1_index(i, j, k, p.n, p.n, p.n));
}

}  // namespace
