// K2c: K2's full fv4 GSRB sweep (red half-sweep, then black) in ONE
// cooperative launch, kept for the small levels where it beats both the
// streaming K2 (fv4_gsrb2.cu) and two K1 launches (stencils.GSRB2_MAX_DIM;
// on an H100 at 64^3, f32 and f64, the grid barriers cost less than the
// streaming kernel's per-plane latency on so few columns, PERF.md):
//
//   y   = x + kdinv0 * (rhs - A x)
//   out = y + kdinv1 * (rhs - A y)
//
// with kdinv0/kdinv1 the parity-folded dinv pair (zeros off the parity a
// half-sweep updates) and the quartic Dirichlet ghosts of x and of y
// synthesized before each half, as gsrb.c:24-41 refills the ghosts between
// the two. Equal to two K1 gsrb launches (fv4_stream.cu) to rounding (its
// half-sweeps march along i with another order of operations).
//
// Replaces hpgmg_tpu/kernels/stencils.py:_fv4_gsrb2_kernel (reached through
// fv4_gsrb2_pallas) on those levels. That kernel held a radius-4 window of x per VMEM tile
// so that it could apply the red half on the tile's radius-2 ring and the
// black half on the tile from one read of x (with padded ring copies of
// rhs and dinv, and the ghosts of the updated ring fixed in place). Here the
// dependency between the halves is crossed with grid-wide barriers instead:
// one cooperative launch of co-resident blocks runs four grid-stride phases
//
//   1. xp <- x with its ghost shell           ((n+4)^3 scratch)
//   2. yp interior <- red update from xp      ((n+4)^3 scratch)
//   3. yp shell <- ghosts of yp's interior
//   4. out <- black update from yp
//
// separated by cg::this_grid().sync(). Every cell reads the iterate of the
// previous half only (out of place, as the stencil couples same-parity
// cells), so the sweep is two K1 half-sweeps: each half computes
// x + kdinv * (rhs - A x) at every cell, kdinv carrying the parity.
//
// What bounds it on an H100: the L1 load throughput of the stencil (~57
// loads per cell in K1's form). The half-sweeps march each thread along i
// with the stencil's x and beta values in registers (fv4_common.cuh:
// StencilWindow), which cuts that to ~34. At 8^3-64^3 the barriers (a few
// microseconds each) and the single launch dominate. Design:
// kCoopThreads-thread blocks, as many as are co-resident, grid-stride loops
// with k fastest.
// Plain version: hpgmg_tpu_torch/kernels/stencils.py:fv4_gsrb2_plain.

#include "fv4_common.cuh"

namespace {

template <typename T>
struct CoopArgs {
  const T* x;
  T* xp;  // (n+4)^3 scratch: x with ghosts
  T* yp;  // (n+4)^3 scratch: the red iterate with ghosts
  const T* bie;
  const T* bje;
  const T* bke;
  const T* alpha;  // nullptr: no a*alpha*x term
  const T* rhs;
  const T* kd0;
  const T* kd1;
  T* out;
  int n;
  T scale;
  T a_coef;
};

template <typename T>
__global__ void __launch_bounds__(kCoopThreads)
    fv4_gsrb2_coop_kernel(const CoopArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  const int n = a.n, np = n + 4;
  Args<T> p{a.xp, a.bie, a.bje, a.bke, a.alpha, a.rhs, nullptr, nullptr,
            n,    a.scale, a.a_coef};
  ghost_fill_phase(CellView<T>{a.x, 0, n}, a.xp, n, false);
  grid.sync();
  gsrb_phase(p, a.kd0, a.yp, 2, np);
  grid.sync();
  ghost_fill_phase(CellView<T>{a.yp, 2, np}, a.yp, n, true);
  grid.sync();
  p.xp = a.yp;
  gsrb_phase(p, a.kd1, a.out, 0, n);
}

template <typename T>
int launch_gsrb2_coop(const void* x, const void* bie, const void* bje,
                 const void* bke, const void* alpha, const void* rhs,
                 const void* kd0, const void* kd1, void* xp, void* yp,
                 void* out, int n, double scale, double a_coef, void* stream) {
  // grid-stride indices are 32-bit: (n+4)^3 < 2^31
  if (n < 4 || n > 1200) return static_cast<int>(cudaErrorInvalidValue);
  const CoopArgs<T> a{static_cast<const T*>(x),     static_cast<T*>(xp),
                       static_cast<T*>(yp),          static_cast<const T*>(bie),
                       static_cast<const T*>(bje),   static_cast<const T*>(bke),
                       static_cast<const T*>(alpha), static_cast<const T*>(rhs),
                       static_cast<const T*>(kd0),   static_cast<const T*>(kd1),
                       static_cast<T*>(out),         n,
                       static_cast<T>(scale),        static_cast<T>(a_coef)};
  const int64_t work = static_cast<int64_t>(n + 4) * (n + 4) * (n + 4);
  cudaError_t err = coop_launch(fv4_gsrb2_coop_kernel<T>, a, work,
                                static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// xp, yp: caller-allocated scratch of (n+4)^3 values each; out: n^3
extern "C" int hpgmg_fv4_gsrb2_coop_f32(const void* x, const void* bie,
                                   const void* bje, const void* bke,
                                   const void* alpha, const void* rhs,
                                   const void* kd0, const void* kd1, void* xp,
                                   void* yp, void* out, int n, double scale,
                                   double a_coef, void* stream) {
  return launch_gsrb2_coop<float>(x, bie, bje, bke, alpha, rhs, kd0, kd1, xp, yp,
                             out, n, scale, a_coef, stream);
}

extern "C" int hpgmg_fv4_gsrb2_coop_f64(const void* x, const void* bie,
                                   const void* bje, const void* bke,
                                   const void* alpha, const void* rhs,
                                   const void* kd0, const void* kd1, void* xp,
                                   void* yp, void* out, int n, double scale,
                                   double a_coef, void* stream) {
  return launch_gsrb2_coop<double>(x, bie, bje, bke, alpha, rhs, kd0, kd1, xp, yp,
                              out, n, scale, a_coef, stream);
}
