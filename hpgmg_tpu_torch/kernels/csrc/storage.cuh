// Storage types of the kernels' operands and the type they compute in.
//
// A kernel instantiated on a storage type S computes in Wide<S>: S itself
// for float and double, float for bfloat16. A bf16 operand is widened to
// float right after its load (exact: a bf16 is the top half of a float's
// bits), and each output is rounded to bf16 once, to nearest even, as
// torch's .to(torch.bfloat16) rounds, so that a kernel and its plain
// version (float32 arithmetic on widened operands, one rounding) differ
// only where they sum in another order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

template <typename S>
struct WideOf {
  using type = S;
};
template <>
struct WideOf<bf16> {
  using type = float;
};
template <typename S>
using Wide = typename WideOf<S>::type;

// the float whose top 16 bits are b
__device__ __forceinline__ float bf16_bits_to_float(unsigned b) {
  return __uint_as_float(b << 16);
}

// v widened to T
template <typename T, typename S>
__device__ __forceinline__ T widen(S v) {
  if constexpr (std::is_same_v<S, bf16>) {
    return __bfloat162float(v);
  } else {
    return static_cast<T>(v);
  }
}

// *p widened to T, through the read-only cache
template <typename T, typename S>
__device__ __forceinline__ T ldv(const S* p) {
  if constexpr (std::is_same_v<S, bf16>) {
    return bf16_bits_to_float(__ldg(reinterpret_cast<const unsigned short*>(p)));
  } else {
    return static_cast<T>(__ldg(p));
  }
}

// *p widened to T, past L1 (the value may have been written in this launch
// by another SM)
template <typename T, typename S>
__device__ __forceinline__ T ldcgv(const S* p) {
  if constexpr (std::is_same_v<S, bf16>) {
    return bf16_bits_to_float(__ldcg(reinterpret_cast<const unsigned short*>(p)));
  } else {
    return static_cast<T>(__ldcg(p));
  }
}

// v rounded to the storage type S
template <typename S, typename T>
__device__ __forceinline__ S narrow(T v) {
  if constexpr (std::is_same_v<S, bf16>) {
    return __float2bfloat16_rn(v);
  } else {
    return static_cast<S>(v);
  }
}

// v rounded to S and widened back: what a launch storing v in S would leave
template <typename S, typename T>
__device__ __forceinline__ T rounded(T v) {
  if constexpr (std::is_same_v<S, bf16>) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

}  // namespace
