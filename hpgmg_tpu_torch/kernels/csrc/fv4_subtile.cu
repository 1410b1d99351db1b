// K1s: the fv4 stencil of K1 (operators.fv4.c:87-114) in one pass, with the
// quartic volume-averaged Dirichlet ghosts of x synthesized inside the
// kernel, in three modes:
//
//   apply     out = A x
//   residual  out = rhs - A x
//   gsrb      out = x + kdinv * (rhs - A x)   (kdinv: dinv with the red/black
//                                             parity mask folded in)
//
// where A x = scale * (main/12 + mixed/48) [+ a * alpha * x], scale = -b/h^2.
//
// Replaces hpgmg_tpu/kernels/stencils.py:_fv4_kernel_subtile (:918), reached
// through _fv4_call_subtile (:1028) when SUBTILE is set. That kernel fetched
// one (bi, bj) window of x and beta per tile once and ran the stencil body
// over si-row sub-tiles along i, so that its VMEM temporaries stayed
// sub-tile sized; the Dirichlet ghosts were built in the kernel from the
// window. None of its layout (pl.Element windows, the j padding, kbk_top,
// the PREDIFF operands) is carried over: this kernel reads the port's
// tangentially-extended beta arrays as K1 does (fv4_common.cuh).
//
// Design (the K5 pattern, r1_stencil.cu): a block owns a TI x TJ x TK tile
// of cells (SubTile below, k fastest) and first loads x on it with a 2-cell
// halo into shared memory. Cells of the halo outside the domain get their
// quartic ghost while they are loaded (ghost_value: the tensor product of
// the per-axis taps, edges included, which the mixed terms read; a ghost
// reads up to 4 interior cells along its normal straight from device
// memory, so a tile thinner than 4 cells needs nothing beyond its halo).
// Then each of the TJ x TK threads walks the TI cells of its (j, k) row
// along i (the sub-tile), one cell at a time: the stencil's 25 x reads
// from shared memory, its 30 beta reads and alpha, rhs and kdinv through
// the read-only path, the arithmetic of K1 (fv4_combination, so the result
// equals K1's bit for bit). One launch per call, no (n+4)^3 ghost buffer.
// The output is out of place: every cell is written, x unchanged where
// kdinv is 0.
//
// Measured on an H100 (chip_smoke.py, 512^3 f32 gsrb; the two-pass K1 that
// fv4_stream.cu replaced: 3.30 ms): a first version carried K2's register window along i
// (StencilWindow, 13 x and 17 beta loads a cell) at ~110 registers a
// thread, two blocks an SM: 3.83 ms. One cell at a time without the
// window: 4.26 ms at 80 registers (three blocks an SM); with the register
// cap of four blocks an SM (64 registers, 60-72 bytes spilled; f32 only,
// f64 keeps its 8-cell tile uncapped) 3.65 ms. Shorter sub-tiles were
// slower (more halo). It
// beats K1 only on the smaller levels, where launches dominate (one launch
// instead of two; 128^3 and below); stencils.SUBTILE_MAX_DIM gates it.
//
// What bounds it on an H100: device-memory bandwidth. gsrb reads x, the
// three beta arrays, rhs and kdinv and writes out: 7 values a cell, 28 B in
// f32, against ~113 flops (~4 flop/B, below the card's f32 ridge of
// 20 flop/B). The two-pass K1 moved x three more times (its ghost pass
// wrote and its stencil read an (n+4)^3 buffer). The x tile is read
// from device memory once per block plus its halo (2.1x in f32, 3.4x in
// f64, mostly from L2), and its 25 reads a cell come from shared memory
// instead of L1.
//
// f64 halves TI to keep the x tile under 48 KB of static shared memory.
// Periodic levels are refused by the wrapper (kernels/stencils.py), which
// routes them to K7a.
// Plain version: hpgmg_tpu_torch/kernels/stencils.py:fv4_subtile_plain.

#include "fv4_common.cuh"

namespace {

constexpr int kSubThreads = 256;

// Output tile per block (i, j, k): J * K = kSubThreads threads, each
// walking I cells along i.
// MinBlocks: the blocks an SM must hold (the register cap of
// __launch_bounds__).
template <typename T>
struct SubTile {
  static constexpr int I = 16, J = 8, K = 32, MinBlocks = 4;
};
template <>
struct SubTile<double> {
  static constexpr int I = 8, J = 8, K = 32, MinBlocks = 1;
};

// p.xp holds the cell field x itself (n^3), not a ghost-filled buffer.
template <typename T, int MODE>
__global__ void __launch_bounds__(kSubThreads, SubTile<T>::MinBlocks)
    fv4_subtile_kernel(const Args<T> p) {
  constexpr int TI = SubTile<T>::I, TJ = SubTile<T>::J, TK = SubTile<T>::K;
  constexpr int XJ = TJ + 4, XK = TK + 4, XSIZE = (TI + 4) * XJ * XK;
  static_assert(TJ * TK == kSubThreads, "one thread per (j, k) of the tile");
  __shared__ T xs[XSIZE];
  const int n = p.n;
  const int i0 = blockIdx.z * TI, j0 = blockIdx.y * TJ, k0 = blockIdx.x * TK;

  // x on the tile and its 2-cell halo: cells, ghosts within 2 of the
  // domain, zeros further out (read only by cells outside the domain)
  const CellView<T> xv{p.xp, 0, n};
  auto near = [n](int idx) { return idx >= -2 && idx < n + 2; };
  auto inside = [n](int idx) { return idx >= 0 && idx < n; };
  for (int t = threadIdx.x; t < XSIZE; t += kSubThreads) {
    const int c = t % XK, r = t / XK;
    const int i = i0 + r / XJ - 2, j = j0 + r % XJ - 2, k = k0 + c - 2;
    T v = T(0);
    if (inside(i) && inside(j) && inside(k)) {
      v = __ldg(p.xp + (static_cast<int64_t>(i) * n + j) * n + k);
    } else if (near(i) && near(j) && near(k)) {
      v = ghost_value(xv, n, i, j, k);
    }
    xs[t] = v;
  }
  __syncthreads();

  // thread (jl, kl) walks il = 0 .. TI-1 of its row
  const int kl = threadIdx.x % TK, jl = threadIdx.x / TK;
  const int j = j0 + jl, k = k0 + kl;
  if (j >= n || k >= n) return;
  const int64_t n1 = n + 1, n2 = n + 2;
  for (int il = 0; il < TI && i0 + il < n; ++il) {
    const int i = i0 + il;
    const T* xc = xs + ((il + 2) * XJ + (jl + 2)) * XK + (kl + 2);
    auto X = [&](int di, int dj, int dk) -> T { return xc[(di * XJ + dj) * XK + dk]; };
    // face f (0 low, 1 high) of the cell, shifted tangentially
    auto BI = [&](int f, int dj, int dk) -> T {
      return __ldg(p.bie + ((i + f) * n2 + (1 + j + dj)) * n2 + (1 + k + dk));
    };
    auto BJ = [&](int f, int di, int dk) -> T {
      return __ldg(p.bje + ((1 + i + di) * n1 + (j + f)) * n2 + (1 + k + dk));
    };
    auto BK = [&](int f, int di, int dj) -> T {
      return __ldg(p.bke + ((1 + i + di) * n2 + (1 + j + dj)) * n1 + (k + f));
    };
    const int64_t c = (static_cast<int64_t>(i) * n + j) * n + k;
    const T x0 = X(0, 0, 0);
    T ax = p.scale * fv4_combination<T>(X, BI, BJ, BK);
    if (p.alpha != nullptr) ax = p.a_coef * __ldg(p.alpha + c) * x0 + ax;
    if constexpr (MODE == kApply) {
      p.out[c] = ax;
    } else if constexpr (MODE == kResidual) {
      p.out[c] = __ldg(p.rhs + c) - ax;
    } else {
      p.out[c] = x0 + __ldg(p.kdinv + c) * (__ldg(p.rhs + c) - ax);
    }
  }
}

template <typename T>
int launch_subtile(const void* x, const void* bie, const void* bje,
                   const void* bke, const void* alpha, const void* rhs,
                   const void* kdinv, void* out, int n, int mode, double scale,
                   double a_coef, void* stream) {
  if (n < 4 || n > 65535 || mode < kApply || mode > kGsrb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args<T> p{static_cast<const T*>(x),     static_cast<const T*>(bie),
                  static_cast<const T*>(bje),   static_cast<const T*>(bke),
                  static_cast<const T*>(alpha), static_cast<const T*>(rhs),
                  static_cast<const T*>(kdinv), static_cast<T*>(out),
                  n,                            static_cast<T>(scale),
                  static_cast<T>(a_coef)};
  constexpr int TI = SubTile<T>::I, TJ = SubTile<T>::J, TK = SubTile<T>::K;
  const dim3 grid((n + TK - 1) / TK, (n + TJ - 1) / TJ, (n + TI - 1) / TI);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kApply: fv4_subtile_kernel<T, kApply><<<grid, kSubThreads, 0, s>>>(p); break;
    case kResidual: fv4_subtile_kernel<T, kResidual><<<grid, kSubThreads, 0, s>>>(p); break;
    default: fv4_subtile_kernel<T, kGsrb><<<grid, kSubThreads, 0, s>>>(p); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: the n^3 cell field (no ghosts); mode 0 apply, 1 residual, 2 gsrb
extern "C" int hpgmg_fv4_subtile_f32(const void* x, const void* bie,
                                     const void* bje, const void* bke,
                                     const void* alpha, const void* rhs,
                                     const void* kdinv, void* out, int n,
                                     int mode, double scale, double a_coef,
                                     void* stream) {
  return launch_subtile<float>(x, bie, bje, bke, alpha, rhs, kdinv, out, n,
                               mode, scale, a_coef, stream);
}

extern "C" int hpgmg_fv4_subtile_f64(const void* x, const void* bie,
                                     const void* bje, const void* bke,
                                     const void* alpha, const void* rhs,
                                     const void* kdinv, void* out, int n,
                                     int mode, double scale, double a_coef,
                                     void* stream) {
  return launch_subtile<double>(x, bie, bje, bke, alpha, rhs, kdinv, out, n,
                                mode, scale, a_coef, stream);
}
