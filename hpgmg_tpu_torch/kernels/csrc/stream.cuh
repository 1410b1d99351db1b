// Device building blocks of the kernels that stream i-planes through a
// ring in shared memory (K1/K7a in fv4_stream.cu, K2 in fv4_gsrb2.cu, the
// 27pt body of K5/K7b in r1_stream.cu), none of them tied to an operator:
// cp.async copies, each thread's pairs of copies fixed for the block
// (Pairs), ring slot arithmetic, and paired loads and stores.

#pragma once

#include "storage.cuh"

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

// two neighbouring bf16 values (an aligned pair), widened
__device__ __forceinline__ void load2(const bf16* src, float& lo, float& hi) {
  const unsigned v = __ldg(reinterpret_cast<const unsigned*>(src));
  lo = bf16_bits_to_float(v & 0xffffu);
  hi = bf16_bits_to_float(v >> 16);
}
__device__ __forceinline__ void store2(bf16* dst, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
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
// (stored in S, each value rounded to it once)
template <typename S, typename T>
__device__ __forceinline__ void store_pair(S* out, int64_t c, T lo, T hi, bool vec,
                                           bool has_hi) {
  if (vec) {
    store2(out + c, lo, hi);
  } else {
    out[c] = narrow<S>(lo);
    if (has_hi) out[c + 1] = narrow<S>(hi);
  }
}

// bf16 values copied by cp.async into a float ring or box: cp.async moves
// at least 4 bytes and cannot widen, so each value's aligned 32-bit word
// (two bf16, the value one of its halves) lands in the value's own float
// slot, and the thread that copied it turns the slot into the float it
// holds (widen_word) once its own copies have arrived; a barrier after that
// publishes the slots. An aligned pair lands as one word in the pair's
// first slot (widen_pair). The word of a field's last value reaches past
// the field's end where the field has an odd number of values: that value
// is loaded at once and stored as its word (its low half, where it sits).
__device__ __forceinline__ void cp_async_word(float* d, const bf16* src, const bf16* end) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const bf16* w = reinterpret_cast<const bf16*>(a & ~static_cast<uintptr_t>(3));
  if (w + 2 > end) {
    *reinterpret_cast<unsigned*>(d) = __ldg(reinterpret_cast<const unsigned short*>(src));
  } else {
    cp_async(reinterpret_cast<unsigned*>(d), reinterpret_cast<const unsigned*>(w));
  }
}

__device__ __forceinline__ void cp_async_pair(float* d, const bf16* src) {
  cp_async(reinterpret_cast<unsigned*>(d), reinterpret_cast<const unsigned*>(src));
}

// slot d held the word of the value at src: now the value, widened
__device__ __forceinline__ void widen_word(float* d, const bf16* src) {
  const unsigned w = *reinterpret_cast<const unsigned*>(d);
  *d = bf16_bits_to_float((reinterpret_cast<uintptr_t>(src) & 2) ? w >> 16 : w & 0xffffu);
}

// slots d, d+1 held an aligned pair's word in d: now its two values
__device__ __forceinline__ void widen_pair(float* d) {
  const unsigned w = *reinterpret_cast<const unsigned*>(d);
  d[0] = bf16_bits_to_float(w & 0xffffu);
  d[1] = bf16_bits_to_float(w >> 16);
}

}  // namespace
