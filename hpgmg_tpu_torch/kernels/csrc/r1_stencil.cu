// K5 and K7b for the var7 body: the radius-1 stencils of the fv7pt and fv2
// suites (the 7-point variable-coefficient flux, operators.7pt.c:52-76 and
// operators.fv2.c:55-92) with 2-tap Dirichlet ghosts (K5) or periodic
// ghosts (K7b, the `periodic` argument), in four modes:
//
//   apply     out = A x
//   residual  out = rhs - A x
//   gsrb      out = x + kdinv * (rhs - A x)   (kdinv: dinv with the red/black
//                                             parity mask folded in)
//   fres      out = restrict_cell(rhs - A x)  (the 8 children averaged in
//                                             shared memory)
//
// The 27pt body (operators.27pt.c:48-92) runs on r1_stream.cu, which beat
// this tile kernel in every mode at every size from 16^3 to 512^3
// (PERF.md); the var7 body, at 75-77% of its byte bound here, stays.
//
// Replaces hpgmg_tpu/kernels/stencils_r1.py:_r1_kernel for the var7 body
// (reached through _r1_call and the
// r1_{apply,residual,gsrb_sweep,restrict_residual}_pallas entries). That
// kernel worked on (bi, bj, n) VMEM tiles and read j-padded, split-k
// coefficient views built for the TPU's (8, 128) tiling; none of that is
// carried over: the face coefficients are the natural face arrays.
// K7b replaces the same body's ext mode, hpgmg_tpu/kernels/stencils_r1.py:
// r1_call_ext with kperiodic (reached through _r1_call on a periodic
// level), where XLA materialized the i/j wrap into a j-padded block and the
// kernel wrapped k in lanes: here the wrapped cells are read while x is
// loaded into the tile, the rest of the kernel unchanged.
// No separate ghost pass is needed: a radius-1 Dirichlet ghost is a 2-tap
// function of the two cells nearest the face (r1_common.cuh), synthesized
// while x is loaded.
//
// What bounds it on an H100: device-memory bandwidth. A gsrb reads x,
// three face arrays, rhs and kdinv and writes out: 7 values, 28 B a cell
// in f32, against ~21 flops, far below the card's f32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20 flop/B). What the design has to keep off the
// critical path is the neighbour reads: 7 a cell.
//
// Design: a block owns a TI x TJ x TK tile of cells (Tile in r1_common.cuh,
// k fastest) and first loads x on it with a 1-cell halo into shared memory,
// ghosts included (load_tile, the K6 loader); every thread then evaluates
// its cells' stencils from shared memory, reading the coefficients, rhs and
// kdinv straight from device memory (coalesced along k). fres writes the
// tile's residuals to a second shared array and each thread averages the
// 8 children of one coarse cell (TI, TJ, TK even: a coarse cell's children
// lie in one tile).
// Plain version: hpgmg_tpu_torch/kernels/stencils_r1.py:r1_stencil_plain.

#include "r1_common.cuh"

namespace {

template <typename T, int MODE>
__global__ void __launch_bounds__(kTileThreads) r1_kernel(const R1Args<T> p) {
  constexpr int TI = Tile<T>::I, TJ = Tile<T>::J, TK = Tile<T>::K;
  constexpr int XJ = TJ + 2, XK = TK + 2, XSIZE = (TI + 2) * XJ * XK;
  constexpr int TSIZE = TI * TJ * TK;
  __shared__ T xs[XSIZE];
  __shared__ T rs[MODE == kFres ? TSIZE : 1];  // fres: the tile's residuals
  const int n = p.n;
  const int i0 = blockIdx.z * TI, j0 = blockIdx.y * TJ, k0 = blockIdx.x * TK;

  load_tile<T, 1, TI, TJ, TK>(p, xs, i0, j0, k0);
  __syncthreads();

  for (int t = threadIdx.x; t < TSIZE; t += kTileThreads) {
    const int c = t % TK, r = t / TK, a = r / TJ, b = r % TJ;
    const int i = i0 + a, j = j0 + b, k = k0 + c;
    if (!(in_range(i, n) && in_range(j, n) && in_range(k, n))) continue;
    const T* xc = xs + ((a + 1) * XJ + (b + 1)) * XK + (c + 1);
    auto X = [&](int di, int dj, int dk) -> T { return xc[(di * XJ + dj) * XK + dk]; };
    const int64_t g = (static_cast<int64_t>(i) * n + j) * n + k;
    const T ax = r1_cell_ax<T, true>(p, X, i, j, k);
    if constexpr (MODE == kApply) {
      p.out[g] = ax;
    } else if constexpr (MODE == kResidual) {
      p.out[g] = ld(p.rhs + g) - ax;
    } else if constexpr (MODE == kGsrb) {
      p.out[g] = xc[0] + ld(p.kdinv + g) * (ld(p.rhs + g) - ax);
    } else {
      rs[t] = ld(p.rhs + g) - ax;
    }
  }

  if constexpr (MODE == kFres) {
    __syncthreads();
    constexpr int CJ = TJ / 2, CK = TK / 2, CSIZE = (TI / 2) * CJ * CK;
    const int m = n / 2;
    for (int t = threadIdx.x; t < CSIZE; t += kTileThreads) {
      const int c = t % CK, r = t / CK, a = r / CJ, b = r % CJ;
      const int I = i0 / 2 + a, J = j0 / 2 + b, K = k0 / 2 + c;
      if (!(in_range(I, m) && in_range(J, m) && in_range(K, m))) continue;
      const T* rc = rs + ((2 * a) * TJ + 2 * b) * TK + 2 * c;
      T sum = T(0);
#pragma unroll
      for (int d = 0; d < 8; ++d)
        sum += rc[((d >> 2) * TJ + ((d >> 1) & 1)) * TK + (d & 1)];
      p.out[(static_cast<int64_t>(I) * m + J) * m + K] = T(0.125) * sum;
    }
  }
}

template <typename T>
int launch_r1(const void* x, const void* beta_i, const void* beta_j,
              const void* beta_k, const void* alpha, const void* rhs,
              const void* kdinv, void* out, int n, int mode, int periodic,
              double b_h2inv, double a_coef, double t1, double t2, void* stream) {
  if (n < 2 || n > 524280 || mode < kApply || mode > kFres ||
      (mode == kFres && n % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const R1Args<T> p{static_cast<const T*>(x),      static_cast<const T*>(beta_i),
                    static_cast<const T*>(beta_j), static_cast<const T*>(beta_k),
                    static_cast<const T*>(alpha),  static_cast<const T*>(rhs),
                    static_cast<const T*>(kdinv),  nullptr,
                    static_cast<T*>(out),          n,
                    static_cast<T>(b_h2inv),       static_cast<T>(a_coef),
                    static_cast<T>(t1),            static_cast<T>(t2),
                    periodic != 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + Tile<T>::K - 1) / Tile<T>::K, (n + Tile<T>::J - 1) / Tile<T>::J,
                  (n + Tile<T>::I - 1) / Tile<T>::I);
  switch (mode) {
    case kApply: r1_kernel<T, kApply><<<grid, kTileThreads, 0, s>>>(p); break;
    case kResidual: r1_kernel<T, kResidual><<<grid, kTileThreads, 0, s>>>(p); break;
    case kGsrb: r1_kernel<T, kGsrb><<<grid, kTileThreads, 0, s>>>(p); break;
    default: r1_kernel<T, kFres><<<grid, kTileThreads, 0, s>>>(p); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the var7 body: beta_* read, alpha may be null (no a*alpha*x);
// periodic != 0: wrapped ghosts (t1, t2 unused)
extern "C" int hpgmg_r1_stencil_f32(const void* x, const void* beta_i,
                                    const void* beta_j, const void* beta_k,
                                    const void* alpha, const void* rhs,
                                    const void* kdinv, void* out, int n,
                                    int mode, int periodic, double b_h2inv,
                                    double a_coef, double t1, double t2,
                                    void* stream) {
  return launch_r1<float>(x, beta_i, beta_j, beta_k, alpha, rhs, kdinv, out, n,
                          mode, periodic, b_h2inv, a_coef, t1, t2, stream);
}

extern "C" int hpgmg_r1_stencil_f64(const void* x, const void* beta_i,
                                    const void* beta_j, const void* beta_k,
                                    const void* alpha, const void* rhs,
                                    const void* kdinv, void* out, int n,
                                    int mode, int periodic, double b_h2inv,
                                    double a_coef, double t1, double t2,
                                    void* stream) {
  return launch_r1<double>(x, beta_i, beta_j, beta_k, alpha, rhs, kdinv, out, n,
                           mode, periodic, b_h2inv, a_coef, t1, t2, stream);
}
