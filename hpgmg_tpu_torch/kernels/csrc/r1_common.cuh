// Device building blocks of the radius-1 kernels (K5/K7b's 27pt body in
// r1_stream.cu, their var7 body and K8c in r1_var7_stream.cu, K6 and K8d in
// r1_gsrb2.cu): the register windows of the streaming kernels, their
// Dirichlet ghosts, and A x at one cell from an
// accessor of its neighbourhood and the indices of its face coefficients
// (r1_ax; r1_index for an ni x nj x nk block), for the two bodies:
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
  const T* kdinv;   // gsrb: the half's parity-folded dinv
  T* out;
  int n;
  T b_h2inv;  // b / h^2
  T a_coef;   // var7: a (with alpha); 27pt: the constant a of a*x
  T t1, t2;   // Dirichlet ghost taps
  int periodic;  // K7b: ghosts wrap (t1, t2 unused); K5: 0
};

template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return __ldg(p);
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

// --------------------------------------------------------------------------
// Register windows of the streaming kernels (r1_stream.cu, r1_gsrb2.cu): a
// thread owns two neighbouring k cells of a row and holds three planes of
// their neighbourhood.

// the 3 x 4 values of one plane in a thread's window: rows j-1 .. j+1,
// columns kb-1 .. kb+2
template <typename T>
using Rows = T[3][4];

// Where a thread's window holds Dirichlet (j, k) ghosts: row 0 (j = 0),
// row 2 (j = n-1), column 0 (kb = 0), column 3 (kb = n-2) or column 2
// (kb = n-1, n odd)
struct Faces {
  bool jlo, jhi, klo;
  int khi;  // the window column of the ghost k = n, or -1
};

// the (j, k) Dirichlet ghosts of one plane of the window, from its cells:
// rows, then columns (edges: the tensor product of the taps)
template <typename T>
__device__ __forceinline__ void ghost_rows_cols(Rows<T>& w, const Faces& f, T t1, T t2) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (f.jlo) w[0][c] = t1 * w[1][c] + t2 * w[2][c];
    if (f.jhi) w[2][c] = t1 * w[1][c] + t2 * w[0][c];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (f.klo) w[r][0] = t1 * w[r][1] + t2 * w[r][2];
    if (f.khi == 3) w[r][3] = t1 * w[r][2] + t2 * w[r][1];
    if (f.khi == 2) w[r][2] = t1 * w[r][1] + t2 * w[r][0];
  }
}

// out = t1 * a + t2 * b over a plane of the window (a Dirichlet ghost plane)
template <typename T>
__device__ __forceinline__ void ghost_plane(Rows<T>& out, const Rows<T>& a, const Rows<T>& b,
                                            T t1, T t2) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[r][c] = t1 * a[r][c] + t2 * b[r][c];
  }
}

}  // namespace
