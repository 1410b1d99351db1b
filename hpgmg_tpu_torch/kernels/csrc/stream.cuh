// Device building blocks of the kernels that stream i-planes through a
// ring in shared memory (K1/K7a in fv4_stream.cu, K2 in fv4_gsrb2.cu, the
// 27pt body of K5/K7b in r1_stream.cu), none of them tied to an operator:
// cp.async copies, each thread's pairs of copies fixed for the block
// (Pairs), ring slot arithmetic, and paired loads and stores.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

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

// lo, hi from two neighbouring values of shared memory (an aligned pair)
__device__ __forceinline__ void lds2(const float* src, float& lo, float& hi) {
  const float2 v = *reinterpret_cast<const float2*>(src);
  lo = v.x;
  hi = v.y;
}
__device__ __forceinline__ void lds2(const double* src, double& lo, double& hi) {
  const double2 v = *reinterpret_cast<const double2*>(src);
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
