// Device building blocks of the fv4 kernels that stream i-planes through a
// ring in shared memory (K1/K7a in fv4_stream.cu, K2 in fv4_gsrb2.cu):
// cp.async copies, each thread's pairs of copies fixed for the block
// (Pairs), the quartic Dirichlet ghost as a tensor product of taps over
// any accessor of the cells (ghost_taps), and paired loads and stores.

#pragma once

#include "fv4_common.cuh"

#include <cstdint>
#include <type_traits>

namespace {

// cp.async of one value, or of two neighbouring ones (8 or 16 bytes)
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
                 : "memory");
  }
}

template <typename T>
__device__ __forceinline__ void cp_async2(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
                 : "memory");
  }
}

template <typename T>
__device__ __forceinline__ bool pair_aligned(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & (2 * sizeof(T) - 1)) == 0;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's newest groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

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

// s + d mod N for 0 <= s < N, 0 <= d < N
__device__ __forceinline__ int ring_add(int s, int d, int N) {
  return s + d >= N ? s + d - N : s + d;
}

// A thread's share of the copies of one plane of a field: up to E pairs
// of neighbouring k values, fixed for the block, so that a plane costs an
// add and a cp.async a pair. goff: the pair's first value's offset in the
// source plane; meta: its offset in the ring plane << kMetaShift | flags.
enum PairFlag : unsigned {
  kE0 = 1,    // first value present
  kE1 = 2,    // second value present
  kPair = 4,  // both copied by one aligned copy (every plane: n even)
  kG0 = 8,    // x: the first value is a (j, k) ghost
  kG1 = 16,   // x: the second value is a (j, k) ghost
  kW1 = 32,   // x, periodic: the second value wraps to k = 0 (goff + 1 - n)
};
constexpr int kMetaShift = 6;

// The pairs of one field, slots FIRST .. FIRST+E-1 of a thread's SLOTS:
// in shared memory after the ring, at a stride of STRIDE (the block's
// threads; b points at the thread's slot 0, the same for every field, so
// the views share one register), or in registers.
template <int E, int FIRST, int STRIDE, int SLOTS>
struct SmemPairs {
  static constexpr int count = E;
  unsigned* b;
  __device__ __forceinline__ unsigned goff(int e) const {
    return b[(FIRST + e) * STRIDE];
  }
  __device__ __forceinline__ unsigned meta(int e) const {
    return b[(SLOTS + FIRST + e) * STRIDE];
  }
  __device__ __forceinline__ void set(int e, unsigned g, unsigned m) {
    b[(FIRST + e) * STRIDE] = g;
    b[(SLOTS + FIRST + e) * STRIDE] = m;
  }
};
template <int E, int FIRST>
struct RegPairs {
  static constexpr int count = E;
  unsigned g_[E], m_[E];
  __device__ __forceinline__ unsigned goff(int e) const { return g_[e]; }
  __device__ __forceinline__ unsigned meta(int e) const { return m_[e]; }
  __device__ __forceinline__ void set(int e, unsigned g, unsigned m) {
    g_[e] = g;
    m_[e] = m;
  }
};
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

// A Dirichlet ghost of x from device memory (out of line: the path is
// rare and its code long)
template <typename T>
__device__ __noinline__ T ghost_from_memory(const T* __restrict__ x, int n, int i,
                                            int j, int k) {
  return ghost_taps<T>(
      [&](int a, int b, int c) { return __ldg(x + (static_cast<int64_t>(a) * n + b) * n + c); },
      n, i, j, k);
}

// One plane of a face array (plane `plane`, planes of nr * nc values)
// into the ring plane dst.
template <typename T, typename PB>
__device__ __forceinline__ void load_beta(T* dst, const T* __restrict__ src, const PB& P,
                                          int plane, int nr, int nc) {
  const T* base = src + static_cast<int64_t>(plane) * nr * nc;
#pragma unroll
  for (int e = 0; e < PB::count; ++e) {
    const unsigned m = P.meta(e);
    T* d = dst + (m >> kMetaShift);
    if (m & kPair) {
      cp_async2(d, base + P.goff(e));
    } else {
      if (m & kE0) cp_async(d, base + P.goff(e));
      if (m & kE1) cp_async(d + 1, base + P.goff(e) + 1);
    }
  }
}

__device__ __forceinline__ void store2(float* dst, float lo, float hi) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}
__device__ __forceinline__ void store2(double* dst, double lo, double hi) {
  *reinterpret_cast<double2*>(dst) = make_double2(lo, hi);
}

__device__ __forceinline__ void load2(const float* src, float& lo, float& hi) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(src));
  lo = v.x;
  hi = v.y;
}
__device__ __forceinline__ void load2(const double* src, double& lo, double& hi) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(src));
  lo = v.x;
  hi = v.y;
}

// out[c], out[c+1] = lo, hi: one vector store where n is even (the pair
// then lies in the domain and c is even), else each cell in the domain
template <typename T>
__device__ __forceinline__ void store_pair(T* out, int64_t c, T lo, T hi, bool vec,
                                           bool has_hi) {
  if (vec) {
    store2(out + c, lo, hi);
  } else {
    out[c] = lo;
    if (has_hi) out[c + 1] = hi;
  }
}

}  // namespace
