// Device building blocks of the fv4 kernels that stream i-planes through a
// ring in shared memory (K1/K7a in fv4_stream.cu, K2 in fv4_gsrb2.cu): the
// quartic Dirichlet ghost as a tensor product of taps over any accessor of
// the cells (ghost_taps), and the copies of face arrays and of Dirichlet
// ghosts from device memory; cp.async, Pairs and paired loads and stores
// come from stream.cuh.

#pragma once

#include "fv4_common.cuh"
#include "stream.cuh"

#include <cstdint>
#include <type_traits>

namespace {

// ghost_value's tensor product of the per-axis quartic taps (the same
// products and sums in the same order, so the same bits), over an accessor
// x(i, j, k) of the cells: device memory, or a plane of the ring. Unrolled
// with guards, so that the taps stay in registers and the loads issue
// together.
template <typename T, typename XA>
__device__ __forceinline__ T ghost_taps(const XA& x, int n, int i, int j, int k) {
  int ii[4], jj[4], kk[4];
  T wi[4], wj[4], wk[4];
  const int ni = axis_taps(i, n, ii, wi);
  const int nj = axis_taps(j, n, jj, wj);
  const int nk = axis_taps(k, n, kk, wk);
  T s = T(0);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (a >= ni) break;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b >= nj) break;
      const T wab = wi[a] * wj[b];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c >= nk) break;
        s += wab * wk[c] * x(ii[a], jj[b], kk[c]);
      }
    }
  }
  return s;
}

// The pairs of rows x cols of one plane of a face array of shape
// (*, nr, nc), from row r0 and column c0 (either may be negative: rows
// and columns outside the array are not copied), into a plane of pitch BP;
// THREADS: the block's threads
template <int BP, int THREADS, typename T, typename PB>
__device__ __forceinline__ void beta_pairs(PB& P, const T* src, int nr, int nc, int r0,
                                           int c0, int rows, int cols) {
#pragma unroll
  for (int e = 0; e < PB::count; ++e) {
    const int t = threadIdx.x + e * THREADS;
    const int a = t / (BP / 2), b = 2 * (t - a * (BP / 2));
    const int r = r0 + a, col = c0 + b;
    unsigned f = 0;
    const unsigned g = static_cast<unsigned>(r) * nc + col;
    if (t < rows * (BP / 2) && r >= 0 && r < nr) {
      f = (b < cols && col >= 0 && col < nc ? kE0 : 0u) |
          (b + 1 < cols && col + 1 >= 0 && col + 1 < nc ? kE1 : 0u);
      // every plane keeps the pair's alignment where nr * nc is even
      if (((static_cast<unsigned>(nr) * nc) & 1) == 0 && f == (kE0 | kE1) &&
          pair_aligned(src + g))
        f |= kPair;
    }
    P.set(e, g, static_cast<unsigned>(a * BP + b) << kMetaShift | f);
  }
}

// A Dirichlet ghost of x (stored in S) from device memory, in Wide<S>
// (out of line: the path is rare and its code long)
template <typename S>
__device__ __noinline__ Wide<S> ghost_from_memory(const S* __restrict__ x, int n, int i,
                                                  int j, int k) {
  return ghost_taps<Wide<S>>(
      [&](int a, int b, int c) {
        return ldv<Wide<S>>(x + (static_cast<int64_t>(a) * n + b) * n + c);
      },
      n, i, j, k);
}

// One plane of a face array (plane `plane`, planes of nr * nc values)
// into the ring plane dst by cp.async; an array stored in bf16 as its
// values' words (stream.cuh: cp_async_word), which widen_beta turns into
// floats once this thread's copies have arrived.
template <typename T, typename S, typename PB>
__device__ __forceinline__ void load_beta(T* dst, const S* __restrict__ src, const PB& P,
                                          int plane, int nr, int nc, int planes) {
  const S* base = src + static_cast<int64_t>(plane) * nr * nc;
#pragma unroll
  for (int e = 0; e < PB::count; ++e) {
    const unsigned m = P.meta(e);
    T* d = dst + (m >> kMetaShift);
    const S* g = base + P.goff(e);
    if constexpr (std::is_same_v<T, S>) {
      if (m & kPair) {
        cp_async2(d, g);
      } else {
        if (m & kE0) cp_async(d, g);
        if (m & kE1) cp_async(d + 1, g + 1);
      }
    } else {
      const S* end = src + static_cast<int64_t>(planes) * nr * nc;
      if (m & kPair) {
        cp_async_pair(d, g);
      } else {
        if (m & kE0) cp_async_word(d, g, end);
        if (m & kE1) cp_async_word(d + 1, g + 1, end);
      }
    }
  }
}

// load_beta of an array stored in the ring's type
template <typename T, typename PB>
__device__ __forceinline__ void load_beta(T* dst, const T* __restrict__ src, const PB& P,
                                          int plane, int nr, int nc) {
  load_beta(dst, src, P, plane, nr, nc, 0);
}

// The words load_beta copied into the ring plane dst for plane `plane`,
// widened in place (nothing where the array is stored in the ring's type).
template <typename T, typename S, typename PB>
__device__ __forceinline__ void widen_beta(T* dst, const S* __restrict__ src, const PB& P,
                                           int plane, int nr, int nc) {
  if constexpr (!std::is_same_v<T, S>) {
    const S* base = src + static_cast<int64_t>(plane) * nr * nc;
#pragma unroll
    for (int e = 0; e < PB::count; ++e) {
      const unsigned m = P.meta(e);
      T* d = dst + (m >> kMetaShift);
      if (m & kPair) {
        widen_pair(d);
      } else {
        if (m & kE0) widen_word(d, base + P.goff(e));
        if (m & kE1) widen_word(d + 1, base + P.goff(e) + 1);
      }
    }
  }
}

}  // namespace
