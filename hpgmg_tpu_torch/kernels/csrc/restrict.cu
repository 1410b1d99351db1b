// K3: piecewise-constant 8->1 cell restriction (restriction.c:6-94,
// restriction_pc_block): coarse(I,J,K) = 0.125 * sum of its 2x2x2 children,
// on any (2 mi, 2 mj, 2 mk) block: a level's cube, or one rank's local
// block of a decomposed level (parallel/), whose extents are even.
//
// Replaces hpgmg_tpu/kernels/restrict.py:_restrict_kernel (reached through
// restrict_ik_pallas), which halved i and k inside the TPU kernel (x0.25,
// the k halving as an MXU matmul) and left the j halving (x0.5) to an XLA
// einsum outside (restrict_j_einsum). Here one pass does all three axes.
//
// What bounds it on an H100: device-memory bandwidth. It reads the block and
// writes an eighth of it with 8 adds per output, far below the compute roof.
// Design: one thread per coarse cell with k fastest, so a warp reads two
// contiguous 64-value runs per fine row and writes one contiguous run.
// A bf16 block is summed in float and each mean rounded to bf16 once.
// Plain version: hpgmg_tpu_torch/kernels/restrict.py:restrict_cell_plain.

#include "storage.cuh"

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// K from the thread index, J = blockIdx.y, I = blockIdx.z; V the storage
// type, T = Wide<V> the sum's
template <typename V, typename T = Wide<V>>
__global__ void restrict_cell_kernel(const V* __restrict__ x,
                                     V* __restrict__ out, int mj, int mk) {
  const int64_t K = blockIdx.x * blockDim.x + threadIdx.x;
  if (K >= mk) return;
  const int64_t J = blockIdx.y, I = blockIdx.z;
  const int64_t t = (I * mj + J) * mk + K;
  const int64_t sj = 2 * static_cast<int64_t>(mk);
  const int64_t si = 2 * static_cast<int64_t>(mj) * sj;
  const V* p = x + (2 * I) * si + (2 * J) * sj + 2 * K;
  auto v = [&](int64_t o) { return widen<T>(p[o]); };
  const T s = ((v(0) + v(1)) + (v(sj) + v(sj + 1))) +
              ((v(si) + v(si + 1)) + (v(si + sj) + v(si + sj + 1)));
  out[t] = narrow<V>(T(0.125) * s);
}

template <typename T>
int launch_restrict(const void* x, void* out, int mi, int mj, int mk,
                    void* stream) {
  if (mi <= 0 || mj <= 0 || mk <= 0 || mi > 65535 || mj > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = mk >= 128 ? 128 : ((mk + 31) / 32) * 32;
  const dim3 grid((mk + threads - 1) / threads, mj, mi);
  restrict_cell_kernel<T><<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), mj, mk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out is (mi, mj, mk), x (2 mi, 2 mj, 2 mk)
extern "C" int hpgmg_restrict_cell_f32(const void* x, void* out, int mi, int mj,
                                       int mk, void* stream) {
  return launch_restrict<float>(x, out, mi, mj, mk, stream);
}

extern "C" int hpgmg_restrict_cell_f64(const void* x, void* out, int mi, int mj,
                                       int mk, void* stream) {
  return launch_restrict<double>(x, out, mi, mj, mk, stream);
}

extern "C" int hpgmg_restrict_cell_bf16(const void* x, void* out, int mi, int mj,
                                        int mk, void* stream) {
  return launch_restrict<bf16>(x, out, mi, mj, mk, stream);
}
