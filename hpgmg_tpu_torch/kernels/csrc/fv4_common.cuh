// Device building blocks of the fv4 kernels (K1/K7a in fv4_stream.cu, K1s
// in fv4_subtile.cu, K2 in fv4_gsrb2.cu, K2c in fv4_gsrb2_coop.cu, K4 in
// tail.cu, K8a/K8b in fv4_slab.cu): the quartic Dirichlet
// ghost of x, the fv4 stencil on a ghost-filled (n+4)^3 buffer, the v2
// interpolation taps, and the grid-stride phases and the cooperative launch
// that the cooperative kernels (K2c, K4) chain with grid-wide barriers.
//
// Layouts: a cell field is (n, n, n) with k fastest. A ghost-filled field
// xp is (n+4)^3 with cell (i, j, k) at (i+2, j+2, k+2). The face
// coefficients are the port's tangentially-extended arrays: beta_i
// (n+1, n+2, n+2), beta_j (n+2, n+1, n+2), beta_k (n+2, n+2, n+1), indexed
// as hpgmg_tpu/ops/fv4.py:127-138 slices them.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

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
  const T* xp;  // (n+4)^3 ghost-filled x
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

// A x at cell (i, j, k) with flat index c: scale * (main/12 + mixed/48)
// [+ a*alpha*x], x from the ghost-filled p.xp.
template <typename T>
__device__ __forceinline__ T cell_ax(const Args<T>& p, int i, int j, int k,
                                     int64_t c) {
  const int64_t n1 = p.n + 1, n2 = p.n + 2, np = p.n + 4;
  const T* __restrict__ xc = p.xp + ((i + 2) * np + (j + 2)) * np + (k + 2);
  auto X = [&](int di, int dj, int dk) -> T {
    return xc[(di * np + dj) * np + dk];
  };
  // face f (0 low, 1 high) of the cell, shifted tangentially
  auto BI = [&](int f, int dj, int dk) -> T {
    return p.bie[((i + f) * n2 + (1 + j + dj)) * n2 + (1 + k + dk)];
  };
  auto BJ = [&](int f, int di, int dk) -> T {
    return p.bje[((1 + i + di) * n1 + (j + f)) * n2 + (1 + k + dk)];
  };
  auto BK = [&](int f, int di, int dj) -> T {
    return p.bke[((1 + i + di) * n2 + (1 + j + dj)) * n1 + (k + f)];
  };

  T ax = p.scale * fv4_combination<T>(X, BI, BJ, BK);
  if (p.alpha != nullptr) ax = p.a_coef * p.alpha[c] * X(0, 0, 0) + ax;
  return ax;
}

// x at cell (i, j, k) read back from a ghost-filled buffer
template <typename T>
__device__ __forceinline__ T center(const T* xp, int n, int i, int j, int k) {
  const int64_t np = n + 4;
  return xp[((i + 2) * np + (j + 2)) * np + (k + 2)];
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

// --------------------------------------------------------------------------
// Grid-stride phases of the fused kernels; a grid barrier separates them.

constexpr int kCoopThreads = 256;

__device__ __forceinline__ int64_t gtid() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ int64_t gstride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}

// xp <- x with its 2-deep ghost shell; shell_only leaves the interior as
// it is (x then is xp's own interior).
template <typename T>
__device__ void ghost_fill_phase(const CellView<T>& x, T* xp, int n,
                                 bool shell_only) {
  const int np = n + 4;
  const int64_t total = static_cast<int64_t>(np) * np * np;
  for (int64_t t = gtid(); t < total; t += gstride()) {
    const unsigned u = static_cast<unsigned>(t), unp = np;  // total < 2^31
    const unsigned r = u / unp;
    const int i = static_cast<int>(r / unp) - 2, j = static_cast<int>(r % unp) - 2,
              k = static_cast<int>(u % unp) - 2;
    const bool inside = i >= 0 && i < n && j >= 0 && j < n && k >= 0 && k < n;
    if (inside) {
      if (!shell_only) xp[t] = x.src == nullptr ? T(0) : x.at(i, j, k);
    } else {
      xp[t] = ghost_value(x, n, i, j, k);
    }
  }
}

// Registers of one thread marching along i at fixed (j, k): the values of x
// and of the face coefficients that the stencil of cell i reads. When the
// thread steps to i+1 it shifts them by one plane and loads only the new
// ones (13 of the 25 x reads, 17 of the 30 beta reads), so its loads per
// cell drop from ~57 to ~34: the stencil is bound by the L1 load
// throughput, not by device memory.
template <typename T>
struct StencilWindow {
  // x: planes i-2 and i+2 at (j, k); planes i-1, i+1 at the 5-point star
  // {c, j-1, j+1, k-1, k+1}; plane i at the 13-point star
  // {c, j-1, j+1, k-1, k+1, j-2, j+2, k-2, k+2, (j-1,k-1), (j-1,k+1),
  //  (j+1,k-1), (j+1,k+1)}
  T xm2, xp2, xm1[5], xp1[5], x0[13];
  // beta_i on faces i (lo) and i+1 (hi), 5-point star {c, j-1, j+1, k-1, k+1}
  T bil[5], bih[5];
  // beta_j per face f: plane i-1 and i+1 at k, plane i at {k, k-1, k+1};
  // beta_k per face f: the same with j for k
  T bjm[2], bjp[2], bj0[2][3], bkm[2], bkp[2], bk0[2][3];
};

// index of in-plane offset (a, b) in the 13-point star (5-point: first 5)
__device__ __forceinline__ constexpr int star(int a, int b) {
  return a == 0 ? (b == 0 ? 0 : b == -1 ? 3 : b == 1 ? 4 : b == -2 ? 7 : 8)
                : b == 0 ? (a == -1 ? 1 : a == 1 ? 2 : a == -2 ? 5 : 6)
                         : (a < 0 ? (b < 0 ? 9 : 10) : (b < 0 ? 11 : 12));
}

template <typename T>
struct WindowLoader {
  const Args<T>& p;
  int j, k;
  int64_t np, n1, n2;
  // x at plane i (cell index), in-plane offset (a, b) in (j, k)
  __device__ __forceinline__ T x(int i, int a, int b) const {
    return p.xp[((i + 2) * np + (j + 2 + a)) * np + (k + 2 + b)];
  }
  __device__ __forceinline__ T bi(int face, int a, int b) const {
    return p.bie[(face * n2 + (1 + j + a)) * n2 + (1 + k + b)];
  }
  __device__ __forceinline__ T bj(int i, int f, int b) const {
    return p.bje[((1 + i) * n1 + (j + f)) * n2 + (1 + k + b)];
  }
  __device__ __forceinline__ T bk(int i, int f, int a) const {
    return p.bke[((1 + i) * n2 + (1 + j + a)) * n1 + (k + f)];
  }
};

// Cells along i that one thread of a half-sweep marches: up to 16, fewer
// on small levels so that the n^2 * (n / seg) threads still fill the card
// (~64K threads; at 32^3 every thread takes one cell).
__device__ __forceinline__ int segment_length(int n) {
  const int64_t per = static_cast<int64_t>(n) * n * n / 65536;
  return per >= 16 ? 16 : (per < 1 ? 1 : static_cast<int>(per));
}

// One GSRB half-sweep into dst, x read from p.xp:
// dst = x + kdinv * (rhs - A x) at every cell (kdinv carries the parity).
// One thread per (segment of cells along i, j, k), k fastest, so a warp's
// loads coalesce along k; each thread marches its segment with a
// StencilWindow. dst may be a cell field (dst_off 0, dst_s n) or a
// ghost-filled buffer's interior (dst_off 2, dst_s n+4).
template <typename T>
__device__ void gsrb_phase(const Args<T>& p, const T* kdinv, T* dst,
                           int dst_off, int dst_s) {
  const int n = p.n, seg = segment_length(n), nseg = (n + seg - 1) / seg;
  const int64_t total = static_cast<int64_t>(n) * n * nseg;
  for (int64_t t = gtid(); t < total; t += gstride()) {
    const unsigned u = static_cast<unsigned>(t), un = n;  // total < 2^31
    const unsigned r = u / un;
    const int k = static_cast<int>(u % un), j = static_cast<int>(r % un);
    const int i0 = static_cast<int>(r / un) * seg;
    const int i1 = i0 + seg < n ? i0 + seg : n;
    const WindowLoader<T> L{p, j, k, n + 4, n + 1, n + 2};
    StencilWindow<T> w;
    // fill the window for cell i0
    w.xm2 = L.x(i0 - 2, 0, 0);
    w.xp2 = L.x(i0 + 2, 0, 0);
#pragma unroll
    for (int q = 0; q < 13; ++q) {
      const int a = q == 1 ? -1 : q == 2 ? 1 : q == 5 ? -2 : q == 6 ? 2
                  : q >= 9 ? (q < 11 ? -1 : 1) : 0;
      const int b = q == 3 ? -1 : q == 4 ? 1 : q == 7 ? -2 : q == 8 ? 2
                  : q >= 9 ? ((q & 1) ? -1 : 1) : 0;
      w.x0[q] = L.x(i0, a, b);
      if (q < 5) {
        w.xm1[q] = L.x(i0 - 1, a, b);
        w.xp1[q] = L.x(i0 + 1, a, b);
        w.bil[q] = L.bi(i0, a, b);
        w.bih[q] = L.bi(i0 + 1, a, b);
      }
    }
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      w.bjm[f] = L.bj(i0 - 1, f, 0);
      w.bjp[f] = L.bj(i0 + 1, f, 0);
      w.bkm[f] = L.bk(i0 - 1, f, 0);
      w.bkp[f] = L.bk(i0 + 1, f, 0);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int o = d == 0 ? 0 : d == 1 ? -1 : 1;
        w.bj0[f][d] = L.bj(i0, f, o);
        w.bk0[f][d] = L.bk(i0, f, o);
      }
    }
    for (int i = i0;; ++i) {
      auto X = [&](int di, int dj, int dk) -> T {
        if (di == -2) return w.xm2;
        if (di == 2) return w.xp2;
        if (di == -1) return w.xm1[star(dj, dk)];
        if (di == 1) return w.xp1[star(dj, dk)];
        return w.x0[star(dj, dk)];
      };
      auto BI = [&](int f, int dj, int dk) -> T {
        return f == 0 ? w.bil[star(dj, dk)] : w.bih[star(dj, dk)];
      };
      auto BJ = [&](int f, int di, int dk) -> T {
        return di == -1 ? w.bjm[f] : di == 1 ? w.bjp[f]
                                             : w.bj0[f][dk == 0 ? 0 : dk < 0 ? 1 : 2];
      };
      auto BK = [&](int f, int di, int dj) -> T {
        return di == -1 ? w.bkm[f] : di == 1 ? w.bkp[f]
                                             : w.bk0[f][dj == 0 ? 0 : dj < 0 ? 1 : 2];
      };
      const int64_t c = (static_cast<int64_t>(i) * n + j) * n + k;
      T ax = p.scale * fv4_combination<T>(X, BI, BJ, BK);
      if (p.alpha != nullptr) ax = p.a_coef * p.alpha[c] * w.x0[0] + ax;
      dst[(static_cast<int64_t>(i + dst_off) * dst_s + (j + dst_off)) * dst_s +
          (k + dst_off)] = w.x0[0] + kdinv[c] * (p.rhs[c] - ax);
      if (i + 1 == i1) break;
      // shift the window to cell i+1 and load what is new
      w.xm2 = w.xm1[0];
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        w.xm1[q] = w.x0[q];
        w.x0[q] = w.xp1[q];
        w.bil[q] = w.bih[q];
        w.bih[q] = L.bi(i + 2, q == 1 ? -1 : q == 2 ? 1 : 0,
                        q == 3 ? -1 : q == 4 ? 1 : 0);
      }
#pragma unroll
      for (int q = 5; q < 13; ++q) {
        const int a = q == 5 ? -2 : q == 6 ? 2 : q >= 9 ? (q < 11 ? -1 : 1) : 0;
        const int b = q == 7 ? -2 : q == 8 ? 2 : q >= 9 ? ((q & 1) ? -1 : 1) : 0;
        w.x0[q] = L.x(i + 1, a, b);
      }
      w.xp1[0] = w.xp2;
#pragma unroll
      for (int q = 1; q < 5; ++q) {
        w.xp1[q] = L.x(i + 2, q == 1 ? -1 : q == 2 ? 1 : 0,
                       q == 3 ? -1 : q == 4 ? 1 : 0);
      }
      w.xp2 = L.x(i + 3, 0, 0);
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        w.bjm[f] = w.bj0[f][0];
        w.bj0[f][0] = w.bjp[f];
        w.bj0[f][1] = L.bj(i + 1, f, -1);
        w.bj0[f][2] = L.bj(i + 1, f, 1);
        w.bjp[f] = L.bj(i + 2, f, 0);
        w.bkm[f] = w.bk0[f][0];
        w.bk0[f][0] = w.bkp[f];
        w.bk0[f][1] = L.bk(i + 1, f, -1);
        w.bk0[f][2] = L.bk(i + 1, f, 1);
        w.bkp[f] = L.bk(i + 2, f, 0);
      }
    }
  }
}

// p.out[C] = restrict_cell(rhs - A x) over the (n/2)^3 coarse cells.
template <typename T>
__device__ void fres_phase(const Args<T>& p) {
  const int n = p.n, m = n / 2;
  const int64_t total = static_cast<int64_t>(m) * m * m;
  for (int64_t t = gtid(); t < total; t += gstride()) {
    const unsigned u = static_cast<unsigned>(t), um = m;  // total < 2^31
    const unsigned r = u / um;
    const int I = static_cast<int>(r / um), J = static_cast<int>(r % um),
              K = static_cast<int>(u % um);
    T sum = T(0);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int i = 2 * I + (d >> 2), j = 2 * J + ((d >> 1) & 1), k = 2 * K + (d & 1);
      const int64_t c = (static_cast<int64_t>(i) * n + j) * n + k;
      sum += p.rhs[c] - cell_ax(p, i, j, k, c);
    }
    p.out[t] = T(0.125) * sum;
  }
}

// Launch `kernel(params)` cooperatively on stream s with kCoopThreads per
// block and as many blocks as are co-resident (at most what `work` items
// need), so that cg::this_grid().sync() is a valid grid-wide barrier.
template <typename P>
cudaError_t coop_launch(void (*kernel)(P), const P& params, int64_t work,
                        cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kCoopThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t want = (work + kCoopThreads - 1) / kCoopThreads;
  const int64_t cap = static_cast<int64_t>(per_sm) * sms;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  P local = params;
  void* args[] = {&local};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(blocks), dim3(kCoopThreads), args, 0,
                                     s);
}

}  // namespace
