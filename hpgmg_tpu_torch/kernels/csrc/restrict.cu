// K3: piecewise-constant 8->1 cell restriction (restriction.c:6-94,
// restriction_pc_block): coarse(I,J,K) = 0.125 * sum of its 2x2x2 children.
//
// Replaces hpgmg_tpu/kernels/restrict.py:_restrict_kernel (reached through
// restrict_ik_pallas), which halved i and k inside the TPU kernel (x0.25,
// the k halving as an MXU matmul) and left the j halving (x0.5) to an XLA
// einsum outside (restrict_j_einsum). Here one pass does all three axes.
//
// What bounds it on an H100: device-memory bandwidth. It reads n^3 and
// writes n^3/8 values with 8 adds per output, far below the compute roof.
// Design: one thread per coarse cell with k fastest, so a warp reads two
// contiguous 64-value runs per fine row and writes one contiguous run.
// Plain version: hpgmg_tpu_torch/kernels/restrict.py:restrict_cell_plain.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// K from the thread index, J = blockIdx.y, I = blockIdx.z
template <typename T>
__global__ void restrict_cell_kernel(const T* __restrict__ x,
                                     T* __restrict__ out, int m) {
  const int64_t K = blockIdx.x * blockDim.x + threadIdx.x;
  if (K >= m) return;
  const int64_t J = blockIdx.y, I = blockIdx.z;
  const int64_t t = (I * m + J) * m + K;
  const int64_t n = 2 * static_cast<int64_t>(m);
  const int64_t sj = n;
  const int64_t si = n * n;
  const T* p = x + (2 * I) * si + (2 * J) * sj + 2 * K;
  const T s = ((p[0] + p[1]) + (p[sj] + p[sj + 1])) +
              ((p[si] + p[si + 1]) + (p[si + sj] + p[si + sj + 1]));
  out[t] = T(0.125) * s;
}

template <typename T>
int launch_restrict(const void* x, void* out, int m, void* stream) {
  if (m <= 0 || m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = m >= 128 ? 128 : ((m + 31) / 32) * 32;
  const dim3 grid((m + threads - 1) / threads, m, m);
  restrict_cell_kernel<T><<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hpgmg_restrict_cell_f32(const void* x, void* out, int m,
                                       void* stream) {
  return launch_restrict<float>(x, out, m, stream);
}

extern "C" int hpgmg_restrict_cell_f64(const void* x, void* out, int m,
                                       void* stream) {
  return launch_restrict<double>(x, out, m, stream);
}
