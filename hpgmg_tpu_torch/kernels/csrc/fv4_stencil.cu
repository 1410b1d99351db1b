// K1 and K7a: the 4th-order variable-coefficient finite-volume operator
// (fv4, operators.fv4.c:87-114) with quartic volume-averaged Dirichlet
// ghosts (K1) or periodic ghosts (K7a), in four modes:
//
//   apply     out = A x
//   residual  out = rhs - A x
//   gsrb      out = x + kdinv * (rhs - A x)   (kdinv: dinv with the red/black
//                                             parity mask folded in)
//   fres      out = restrict_cell(rhs - A x)  (one thread per coarse cell)
//
// where A x = scale * (main/12 + mixed/48) [+ a * alpha * x], scale = -b/h^2.
//
// Replaces hpgmg_tpu/kernels/stencils.py:_fv4_kernel (reached through
// _fv4_call and the fv4_{apply,residual,gsrb_sweep,restrict_residual}_pallas
// entries). That kernel worked on (bi, bj, n) VMEM tiles with j-padded,
// lane-aligned coefficient views and rebuilt the k ghosts of x and beta in
// lanes; none of that layout is carried over. This kernel reads the port's
// tangentially-extended beta arrays directly: beta_i (n+1, n+2, n+2),
// beta_j (n+2, n+1, n+2), beta_k (n+2, n+2, n+1), indexed exactly as
// hpgmg_tpu/ops/fv4.py:127-138 slices them.
//
// K7a replaces hpgmg_tpu/kernels/stencils.py:fv4_call_ext, the same Pallas
// body in its ext mode (kperiodic): XLA materialized the i/j wrap ghosts
// into a j-padded (n+4, n+16, n) block and the kernel wrapped k in lanes.
// Here the wrap is one pass over the (n+4)^3 buffer, then the same stencil
// kernel as K1 reads it, with the face coefficients wrapped tangentially at
// build time (ops/bc_fv.py:extend_beta_tangential); beta_i keeps its n+1
// faces, face n being face 0 again.
//
// Two kernels, each with its own C entry and launch, on one stream:
//
// 1. ghost_fill_kernel writes x with a 2-deep ghost shell into the
//    (n+4)^3 scratch buffer xp. An index outside [0, n) on one axis maps to
//    the 4 taps of the quartic formula (bc_fv.py:67-74: near
//    (-77,43,-17,3)/12, far (-505,335,-145,27)/12); a ghost outside on
//    several axes is the tensor product of the per-axis taps. That is the
//    operator of the separable i -> j -> k fill (ghost_fill_fv), with a
//    different rounding order. The stencil reads the radius-2 star and the
//    (+-1,+-1,0)-type edge ghosts of the mixed terms, so edges are filled
//    too, not only faces. For K7a, wrap_fill_kernel writes the cell at
//    (i mod n, j mod n, k mod n) instead, edges and corners included.
// 2. fv4_kernel evaluates the stencil branch-free from xp.
//
// The device code they share with K2 (fv4_gsrb2.cu) and K4 (tail.cu) is in
// fv4_common.cuh.
//
// Why the split: resolving the ghosts per thread inside the stencil made
// every warp that holds a k-boundary cell (half of them, k being the fast
// axis) run the slow ghost path; measured 0.96 ms per apply at 128^3 f32
// on an H100. The extra pass costs ~2 n^3 values of traffic.
//
// GSRB is out of place: the stencil couples same-parity cells (the +-2
// neighbours and the diagonal mixed terms), so the wrapper passes a separate
// output buffer and every cell reads the old iterate.
//
// What bounds it on an H100: device-memory bandwidth. Per cell the pair of
// passes moves x twice (+ xp once written, once read), the three beta arrays,
// and by mode rhs, kdinv and the output: ~9 values, ~36 B in f32, against
// ~150 flops, ~4 flop/B, below the card's f32 ridge. The 25 x and 30 beta
// reads per cell overlap the neighbours' and are served by L1/L2. Design:
// one thread per cell with k fastest, so every load of a warp is coalesced
// along k.
// K7a's wrap pass moves x once and xp once (a copy: bound by bandwidth,
// like K1's ghost pass); its stencil pass is K1's.
// Plain version: hpgmg_tpu_torch/kernels/stencils.py:fv4_stencil_plain.

#include "fv4_common.cuh"

namespace {

// xp[(i+2, j+2, k+2)] = x at (i, j, k), ghosts synthesized; one thread per
// cell of the (n+4)^3 buffer, on a grid3d(n+4) launch.
template <typename T>
__global__ void ghost_fill_kernel(const T* __restrict__ x, T* __restrict__ xp,
                                  int n) {
  const int np = n + 4;
  const int kp = blockIdx.x * blockDim.x + threadIdx.x;
  if (kp >= np) return;
  const int64_t t = (static_cast<int64_t>(blockIdx.z) * np + blockIdx.y) * np + kp;
  const int i = static_cast<int>(blockIdx.z) - 2;
  const int j = static_cast<int>(blockIdx.y) - 2;
  const int k = kp - 2;
  if (i >= 0 && i < n && j >= 0 && j < n && k >= 0 && k < n) {
    xp[t] = x[(static_cast<int64_t>(i) * n + j) * n + k];
    return;
  }
  xp[t] = ghost_value(CellView<T>{x, 0, n}, n, i, j, k);
}

// The same buffer with periodic ghosts: the cell at each index mod n (one
// wrap suffices, n >= 4 > the ghost depth of 2).
template <typename T>
__global__ void wrap_fill_kernel(const T* __restrict__ x, T* __restrict__ xp,
                                 int n) {
  const int np = n + 4;
  const int kp = blockIdx.x * blockDim.x + threadIdx.x;
  if (kp >= np) return;
  const int64_t t = (static_cast<int64_t>(blockIdx.z) * np + blockIdx.y) * np + kp;
  auto wrap = [n](int idx) { return idx < 0 ? idx + n : (idx >= n ? idx - n : idx); };
  const int i = wrap(static_cast<int>(blockIdx.z) - 2);
  const int j = wrap(static_cast<int>(blockIdx.y) - 2);
  const int k = wrap(kp - 2);
  xp[t] = x[(static_cast<int64_t>(i) * n + j) * n + k];
}

// One thread per output cell on a grid3d launch over the output extent:
// k from the thread index (fastest, coalesced), j = blockIdx.y,
// i = blockIdx.z.
template <typename T, int MODE>
__global__ void fv4_kernel(const Args<T> p) {
  const int n = p.n;
  const int ext = MODE == kFres ? n / 2 : n;
  const int kk = blockIdx.x * blockDim.x + threadIdx.x;
  if (kk >= ext) return;
  const int jj = blockIdx.y, ii = blockIdx.z;
  const int64_t t = (static_cast<int64_t>(ii) * ext + jj) * ext + kk;
  if constexpr (MODE == kFres) {
    const int I = ii, J = jj, K = kk;
    T sum = T(0);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const int i = 2 * I + (d >> 2), j = 2 * J + ((d >> 1) & 1), k = 2 * K + (d & 1);
      const int64_t c = (static_cast<int64_t>(i) * n + j) * n + k;
      sum += p.rhs[c] - cell_ax(p, i, j, k, c);
    }
    p.out[t] = T(0.125) * sum;
  } else {
    const int i = ii, j = jj, k = kk;
    const T ax = cell_ax(p, i, j, k, t);
    if constexpr (MODE == kApply) {
      p.out[t] = ax;
    } else if constexpr (MODE == kResidual) {
      p.out[t] = p.rhs[t] - ax;
    } else {
      p.out[t] = center(p.xp, n, i, j, k) + p.kdinv[t] * (p.rhs[t] - ax);
    }
  }
}

// Launch shape over an ext^3 box: rows of up to 128 threads along k, one
// block row per (j, i) in blockIdx.y / blockIdx.z (ext <= 65535).
struct Grid3 {
  dim3 grid, block;
};

Grid3 grid3d(int ext) {
  const int threads = ext >= 128 ? 128 : ((ext + 31) / 32) * 32;
  return {dim3((ext + threads - 1) / threads, ext, ext), dim3(threads)};
}

template <typename T>
int launch_ghost_fill(const void* x, void* xp, int n, bool periodic,
                      void* stream) {
  if (n < 4 || n > 65531) return static_cast<int>(cudaErrorInvalidValue);
  const Grid3 gp = grid3d(n + 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (periodic) {
    wrap_fill_kernel<T><<<gp.grid, gp.block, 0, s>>>(static_cast<const T*>(x),
                                                     static_cast<T*>(xp), n);
  } else {
    ghost_fill_kernel<T><<<gp.grid, gp.block, 0, s>>>(static_cast<const T*>(x),
                                                      static_cast<T*>(xp), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fv4(const void* xp, const void* bie, const void* bje,
               const void* bke, const void* alpha, const void* rhs,
               const void* kdinv, void* out, int n, int mode, double scale,
               double a_coef, void* stream) {
  if (n < 4 || n > 65531 || mode < kApply || mode > kFres ||
      (mode == kFres && n % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args<T> p{static_cast<const T*>(xp),    static_cast<const T*>(bie),
                  static_cast<const T*>(bje),   static_cast<const T*>(bke),
                  static_cast<const T*>(alpha), static_cast<const T*>(rhs),
                  static_cast<const T*>(kdinv), static_cast<T*>(out),
                  n,                            static_cast<T>(scale),
                  static_cast<T>(a_coef)};
  const Grid3 g = grid3d(mode == kFres ? n / 2 : n);
  switch (mode) {
    case kApply: fv4_kernel<T, kApply><<<g.grid, g.block, 0, s>>>(p); break;
    case kResidual: fv4_kernel<T, kResidual><<<g.grid, g.block, 0, s>>>(p); break;
    case kGsrb: fv4_kernel<T, kGsrb><<<g.grid, g.block, 0, s>>>(p); break;
    default: fv4_kernel<T, kFres><<<g.grid, g.block, 0, s>>>(p); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xp: (n+4)^3 values of the same type, x with its ghost shell
extern "C" int hpgmg_fv4_ghost_fill_f32(const void* x, void* xp, int n,
                                        void* stream) {
  return launch_ghost_fill<float>(x, xp, n, false, stream);
}

extern "C" int hpgmg_fv4_ghost_fill_f64(const void* x, void* xp, int n,
                                        void* stream) {
  return launch_ghost_fill<double>(x, xp, n, false, stream);
}

extern "C" int hpgmg_fv4_ghost_fill_periodic_f32(const void* x, void* xp, int n,
                                                 void* stream) {
  return launch_ghost_fill<float>(x, xp, n, true, stream);
}

extern "C" int hpgmg_fv4_ghost_fill_periodic_f64(const void* x, void* xp, int n,
                                                 void* stream) {
  return launch_ghost_fill<double>(x, xp, n, true, stream);
}

// xp: the ghost-filled x written by hpgmg_fv4_ghost_fill_*
extern "C" int hpgmg_fv4_stencil_f32(const void* xp, const void* bie,
                                     const void* bje, const void* bke,
                                     const void* alpha, const void* rhs,
                                     const void* kdinv, void* out, int n,
                                     int mode, double scale, double a_coef,
                                     void* stream) {
  return launch_fv4<float>(xp, bie, bje, bke, alpha, rhs, kdinv, out, n, mode,
                           scale, a_coef, stream);
}

extern "C" int hpgmg_fv4_stencil_f64(const void* xp, const void* bie,
                                     const void* bje, const void* bke,
                                     const void* alpha, const void* rhs,
                                     const void* kdinv, void* out, int n,
                                     int mode, double scale, double a_coef,
                                     void* stream) {
  return launch_fv4<double>(xp, bie, bje, bke, alpha, rhs, kdinv, out, n, mode,
                            scale, a_coef, stream);
}
