// Device building blocks of the fv4 kernels (K1/K7a in fv4_stream.cu, K1s
// in fv4_subtile.cu, K2 in fv4_gsrb2.cu, K2c in fv4_gsrb2_cluster.cu, K4
// in tail.cu, K8a/K8b in fv4_slab.cu): the quartic Dirichlet ghost of x,
// the fv4 stencil's arithmetic over accessors of x and the face
// coefficients, and the v2 interpolation taps.
//
// Layouts: a cell field is (n, n, n) with k fastest. The face
// coefficients are the port's tangentially-extended arrays: beta_i
// (n+1, n+2, n+2), beta_j (n+2, n+1, n+2), beta_k (n+2, n+2, n+1), indexed
// as hpgmg_tpu/ops/fv4.py:127-138 slices them.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Mode : int { kApply = 0, kResidual = 1, kGsrb = 2, kFres = 3 };

// 1D taps of cell index `idx` on an axis of n cells: itself with weight 1
// inside the domain, else the 4 interior cells of the quartic ghost
// (bc_fv.py:67-74: near (-77,43,-17,3)/12, far (-505,335,-145,27)/12).
template <typename T>
__device__ __forceinline__ int axis_taps(int idx, int n, int (&id)[4],
                                         T (&w)[4]) {
  if (idx >= 0 && idx < n) {
    id[0] = idx;
    w[0] = T(1);
    return 1;
  }
  const bool lo = idx < 0;
  const bool far = lo ? (idx < -1) : (idx > n);
  const T c = T(1) / T(12);
  if (far) {
    w[0] = T(-505) * c; w[1] = T(335) * c; w[2] = T(-145) * c; w[3] = T(27) * c;
  } else {
    w[0] = T(-77) * c; w[1] = T(43) * c; w[2] = T(-17) * c; w[3] = T(3) * c;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) id[q] = lo ? q : n - 1 - q;
  return 4;
}

// A read-only view of a cell field: cell (i, j, k) at
// src[((i+off)*s + (j+off))*s + (k+off)]; src == nullptr reads zeros.
template <typename T>
struct CellView {
  const T* src;
  int off, s;
  __device__ __forceinline__ T at(int i, int j, int k) const {
    return src[(static_cast<int64_t>(i + off) * s + (j + off)) * s + (k + off)];
  }
};

// Value of x at (i, j, k), any of them in [-2, n+2): the cell inside the
// domain, else the tensor product of the per-axis quartic ghost taps (the
// operator of the separable i -> j -> k fill ghost_fill_fv, with another
// rounding order). Edges and corners are filled too: the mixed terms read
// the (+-1, +-1, 0)-type edge ghosts.
template <typename T>
__device__ __forceinline__ T ghost_value(const CellView<T>& x, int n, int i,
                                         int j, int k) {
  if (x.src == nullptr) return T(0);
  int ii[4], jj[4], kk[4];
  T wi[4], wj[4], wk[4];
  const int ni = axis_taps(i, n, ii, wi);
  const int nj = axis_taps(j, n, jj, wj);
  const int nk = axis_taps(k, n, kk, wk);
  T s = T(0);
  for (int a = 0; a < ni; ++a) {
    for (int b = 0; b < nj; ++b) {
      const T wab = wi[a] * wj[b];
      for (int c = 0; c < nk; ++c) s += wab * wk[c] * x.at(ii[a], jj[b], kk[c]);
    }
  }
  return s;
}

template <typename T>
struct Args {
  const T* xp;  // x, the n^3 cell field
  const T* bie;
  const T* bje;
  const T* bke;
  const T* alpha;  // nullptr: no a*alpha*x term
  const T* rhs;
  const T* kdinv;
  T* out;
  int n;
  T scale;   // -b / h^2
  T a_coef;  // a
};

// The fv4 combination main/12 + mixed/48 (the arithmetic of
// hpgmg_tpu/ops/fv4.py:stencil_ax) from accessors: X(di, dj, dk) of x, and
// BI(f, dj, dk), BJ(f, di, dk), BK(f, di, dj) of face f (0 low, 1 high) of
// the cell along i, j, k, shifted tangentially.
template <typename T, typename FX, typename FI, typename FJ, typename FK>
__device__ __forceinline__ T fv4_combination(const FX& X, const FI& BI,
                                             const FJ& BJ, const FK& BK) {
  const T x0 = X(0, 0, 0);
  const T xim1 = X(-1, 0, 0), xip1 = X(1, 0, 0);
  const T xjm1 = X(0, -1, 0), xjp1 = X(0, 1, 0);
  const T xkm1 = X(0, 0, -1), xkp1 = X(0, 0, 1);
  const T main =
      BI(0, 0, 0) * (T(15) * (xim1 - x0) - (X(-2, 0, 0) - xip1)) +
      BI(1, 0, 0) * (T(15) * (xip1 - x0) - (X(2, 0, 0) - xim1)) +
      BJ(0, 0, 0) * (T(15) * (xjm1 - x0) - (X(0, -2, 0) - xjp1)) +
      BJ(1, 0, 0) * (T(15) * (xjp1 - x0) - (X(0, 2, 0) - xjm1)) +
      BK(0, 0, 0) * (T(15) * (xkm1 - x0) - (X(0, 0, -2) - xkp1)) +
      BK(1, 0, 0) * (T(15) * (xkp1 - x0) - (X(0, 0, 2) - xkm1));

  // mixed terms: for each face (axis, f) and tangent t, the tangential
  // difference of that face's beta times the cross second difference
  // x(ea+et) - x(et) - x(ea-et) + x(-et), ea = (2f-1) along axis
  T mixed = T(0);
#pragma unroll
  for (int f = 0; f < 2; ++f) {  // i faces: tangents j, k
    const int s = 2 * f - 1;
    mixed += (BI(f, 1, 0) - BI(f, -1, 0)) *
             (X(s, 1, 0) - xjp1 - X(s, -1, 0) + xjm1);
    mixed += (BI(f, 0, 1) - BI(f, 0, -1)) *
             (X(s, 0, 1) - xkp1 - X(s, 0, -1) + xkm1);
  }
#pragma unroll
  for (int f = 0; f < 2; ++f) {  // j faces: tangents i, k
    const int s = 2 * f - 1;
    mixed += (BJ(f, 1, 0) - BJ(f, -1, 0)) *
             (X(1, s, 0) - xip1 - X(-1, s, 0) + xim1);
    mixed += (BJ(f, 0, 1) - BJ(f, 0, -1)) *
             (X(0, s, 1) - xkp1 - X(0, s, -1) + xkm1);
  }
#pragma unroll
  for (int f = 0; f < 2; ++f) {  // k faces: tangents i, j
    const int s = 2 * f - 1;
    mixed += (BK(f, 1, 0) - BK(f, -1, 0)) *
             (X(1, 0, s) - xip1 - X(-1, 0, s) + xim1);
    mixed += (BK(f, 0, 1) - BK(f, 0, -1)) *
             (X(0, 1, s) - xjp1 - X(0, -1, s) + xjm1);
  }
  return T(1.0 / 12.0) * main + T(0.25 / 12.0) * mixed;
}

// 1D taps of the v2 interpolation (interpolation_v2.c:55-57) for fine index
// i on an axis of dc coarse cells: the even child of coarse I takes
// c[I] + (c[I-1] - c[I+1])/8, the odd child c[I] + (c[I+1] - c[I-1])/8; a
// coarse ghost is the quadratic Dirichlet one, g = -5/2 c0 + 1/2 c1
// (bc_fv.py:43). Needs dc >= 2; returns the number of taps (<= 5).
template <typename T>
__device__ __forceinline__ int interp_v2_taps(int i, int dc, int (&id)[5],
                                              T (&w)[5]) {
  const int I = i >> 1;
  const T s = (i & 1) ? T(1) : T(-1);  // sign of the I+1 tap / 8
  int m = 0;
  id[m] = I; w[m++] = T(1);
  const T wlo = -s * T(0.125), whi = s * T(0.125);
  if (I - 1 >= 0) {
    id[m] = I - 1; w[m++] = wlo;
  } else {
    id[m] = 0; w[m++] = T(-2.5) * wlo;
    id[m] = 1; w[m++] = T(0.5) * wlo;
  }
  if (I + 1 < dc) {
    id[m] = I + 1; w[m++] = whi;
  } else {
    id[m] = dc - 1; w[m++] = T(-2.5) * whi;
    id[m] = dc - 2; w[m++] = T(0.5) * whi;
  }
  return m;
}

}  // namespace
