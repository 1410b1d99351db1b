// K6: one full red+black GSRB sweep of a radius-1 suite (var7 or 27pt body,
// r1_common.cuh) in one launch, equal to two K5 gsrb half-sweeps (kdinv0,
// then kdinv1) to rounding:
//
//   r   = x + kdinv0 * (rhs - A x)
//   out = r + kdinv1 * (rhs - A r)
//
// Replaces hpgmg_tpu/kernels/stencils_r1.py:_r1_gsrb2_kernel (reached
// through r1_gsrb2_pallas). The TPU kernel computed red on a +1 ring of each
// (bi, bj, n) VMEM tile from a radius-2 window, rebuilt the red iterate's
// Dirichlet ghosts (_fix_ghost_axis_r1) and ran black on the tile from the
// resident red values, reading j-padded pre-padded views. The same dataflow
// fits a thread block, so unlike K2c (fv4, radius 2: red planes shared
// across a cluster of blocks) this kernel needs no barrier beyond its
// block. Each block owns a TI x TJ x TK tile of the output and
//
//   1. loads x on the tile with a radius-2 halo into shared memory, the
//      ghosts one cell outside the domain synthesized (2-tap, tensor product
//      at edges and corners), zeros further out (read only by red at ghost
//      positions, which step 3 overwrites);
//   2. computes red at the cells of the tile and its 1-cell ring that lie
//      inside the domain, into a second shared array;
//   3. writes the red iterate's ghosts at the ring positions outside the
//      domain, from the red values of the interior cells nearest the face;
//   4. computes black on the tile from the shared red iterate.
//
// Each half evaluates the stencil only at the cells of its parity (red:
// i+j+k even), one thread per pair of cells along k, and copies the other
// cell of the pair: the kdinv pair must vanish off its parity, as the suites
// build it (ops/base.py:RadiusOneSuite.fold_kdinv); then the copy is what
// x + 0 * (rhs - A x) gives. Neighbouring tiles recompute each other's ring:
// red costs (TI+2)(TJ+2)(TK+2)/2 stencils per TI*TJ*TK outputs (0.83x at
// 8x8x32), black TI*TJ*TK/2. Out of place: every output cell reads the old
// iterate through the shared arrays.
//
// What bounds it on an H100: device-memory bandwidth. One sweep reads x,
// rhs, kdinv0, kdinv1 (and for var7 three face arrays) once and writes out
// once, against two half-sweeps' 2 x 7 values; the ring's extra reads of
// rhs, kdinv0 and the faces come from L2. Coefficients are read from global
// memory (L1/L2), x and the red iterate from shared memory.
// Plain version: hpgmg_tpu_torch/kernels/stencils_r1.py:r1_gsrb2_plain.

#include "r1_common.cuh"

namespace {

// Shared memory per block: x (TI+4)(TJ+4)(TK+4), red (TI+2)(TJ+2)(TK+2)
// (Tile in r1_common.cuh: 34 KB in f32, 37 KB in f64).
template <typename T, bool VAR7>
__global__ void __launch_bounds__(kTileThreads) r1_gsrb2_kernel(const R1Args<T> p) {
  constexpr int TI = Tile<T>::I, TJ = Tile<T>::J, TK = Tile<T>::K;
  constexpr int XJ = TJ + 4, XK = TK + 4, XSIZE = (TI + 4) * XJ * XK;
  constexpr int RJ = TJ + 2, RK = TK + 2, RSIZE = (TI + 2) * RJ * RK;
  __shared__ T xs[XSIZE];
  __shared__ T rs[RSIZE];
  const int n = p.n;
  const int i0 = blockIdx.z * TI, j0 = blockIdx.y * TJ, k0 = blockIdx.x * TK;

  // 1. x at tile offsets [-2, T+2) on each axis
  load_tile<T, 2, TI, TJ, TK>(p, xs, i0, j0, k0);
  __syncthreads();

  // 2. red at tile offsets [-1, T+1), cells inside the domain: one thread
  //    per pair of cells along k, the stencil at the red one of the pair,
  //    a copy of x at the black one
  for (int t = threadIdx.x; t < RSIZE / 2; t += kTileThreads) {
    const int r = t / (RK / 2), a = r / RJ, b = r % RJ;
    const int i = i0 + a - 1, j = j0 + b - 1;
    const int c = 2 * (t % (RK / 2)) + ((i + j + k0 - 1) & 1);  // red: i+j+k even
    const int k = k0 + c - 1;
    const int q = (a * RJ + b) * RK + c;
    const T* xc = xs + ((a + 1) * XJ + (b + 1)) * XK + (c + 1);
    const int cb = c ^ 1;  // the black cell of the pair
    if (in_range(i, n) && in_range(j, n) && in_range(k0 + cb - 1, n))
      rs[q - c + cb] = xc[cb - c];
    if (!(in_range(i, n) && in_range(j, n) && in_range(k, n))) continue;
    auto X = [&](int di, int dj, int dk) -> T { return xc[(di * XJ + dj) * XK + dk]; };
    const int64_t g = (static_cast<int64_t>(i) * n + j) * n + k;
    const T ax = r1_cell_ax<T, VAR7>(p, X, i, j, k);
    rs[q] = xc[0] + ld(p.kdinv + g) * (ld(p.rhs + g) - ax);
  }
  __syncthreads();

  // 3. the red iterate's ghosts at the ring positions just outside the
  //    domain: tensor product of the per-axis taps over in-domain red values
  //    (all of them inside the tile and its ring)
  for (int t = threadIdx.x; t < RSIZE; t += kTileThreads) {
    const int c = t % RK, r = t / RK, a = r / RJ, b = r % RJ;
    const int i = i0 + a - 1, j = j0 + b - 1, k = k0 + c - 1;
    if (in_range(i, n) && in_range(j, n) && in_range(k, n)) continue;
    if (!(near_domain(i, n) && near_domain(j, n) && near_domain(k, n))) continue;
    int ii[2], jj[2], kk[2];
    T wi[2], wj[2], wk[2];
    const int ni = r1_taps(i, n, p.t1, p.t2, ii, wi);
    const int nj = r1_taps(j, n, p.t1, p.t2, jj, wj);
    const int nk = r1_taps(k, n, p.t1, p.t2, kk, wk);
    T s = T(0);
    for (int u = 0; u < ni; ++u) {
      for (int v = 0; v < nj; ++v) {
        const T wuv = wi[u] * wj[v];
        for (int w = 0; w < nk; ++w)
          s += wuv * wk[w] *
               rs[((ii[u] - i0 + 1) * RJ + (jj[v] - j0 + 1)) * RK + (kk[w] - k0 + 1)];
      }
    }
    rs[t] = s;
  }
  __syncthreads();

  // 4. black on the tile: the stencil at the black cell of each pair, the
  //    red value at the red one
  constexpr int TSIZE = TI * TJ * TK;
  for (int t = threadIdx.x; t < TSIZE / 2; t += kTileThreads) {
    const int r = t / (TK / 2), a = r / TJ, b = r % TJ;
    const int i = i0 + a, j = j0 + b;
    const int c = 2 * (t % (TK / 2)) + ((i + j + k0 + 1) & 1);  // black: i+j+k odd
    const int k = k0 + c;
    const T* rc = rs + ((a + 1) * RJ + (b + 1)) * RK + (c + 1);
    const int cr = c ^ 1;  // the red cell of the pair
    if (in_range(i, n) && in_range(j, n) && in_range(k0 + cr, n))
      p.out[(static_cast<int64_t>(i) * n + j) * n + k0 + cr] = rc[cr - c];
    if (!(in_range(i, n) && in_range(j, n) && in_range(k, n))) continue;
    auto R = [&](int di, int dj, int dk) -> T { return rc[(di * RJ + dj) * RK + dk]; };
    const int64_t g = (static_cast<int64_t>(i) * n + j) * n + k;
    const T ax = r1_cell_ax<T, VAR7>(p, R, i, j, k);
    p.out[g] = rc[0] + ld(p.kdinv1 + g) * (ld(p.rhs + g) - ax);
  }
}

template <typename T>
int launch_gsrb2(const void* x, const void* beta_i, const void* beta_j,
                 const void* beta_k, const void* alpha, const void* rhs,
                 const void* kdinv0, const void* kdinv1, void* out, int n,
                 int var7, double b_h2inv, double a_coef, double t1, double t2,
                 void* stream) {
  if (n < 2 || n > 524280) return static_cast<int>(cudaErrorInvalidValue);
  const R1Args<T> p{static_cast<const T*>(x),      static_cast<const T*>(beta_i),
                    static_cast<const T*>(beta_j), static_cast<const T*>(beta_k),
                    static_cast<const T*>(alpha),  static_cast<const T*>(rhs),
                    static_cast<const T*>(kdinv0), static_cast<const T*>(kdinv1),
                    static_cast<T*>(out),          n,
                    static_cast<T>(b_h2inv),       static_cast<T>(a_coef),
                    static_cast<T>(t1),            static_cast<T>(t2),
                    0};  // Dirichlet only: the wrapper refuses periodic levels
  const dim3 grid((n + Tile<T>::K - 1) / Tile<T>::K, (n + Tile<T>::J - 1) / Tile<T>::J,
                  (n + Tile<T>::I - 1) / Tile<T>::I);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (var7) {
    r1_gsrb2_kernel<T, true><<<grid, kTileThreads, 0, s>>>(p);
  } else {
    r1_gsrb2_kernel<T, false><<<grid, kTileThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kdinv0 / kdinv1: the red / black parity-folded dinv; the other operands
// as hpgmg_r1_stencil_* takes them
extern "C" int hpgmg_r1_gsrb2_f32(const void* x, const void* beta_i,
                                  const void* beta_j, const void* beta_k,
                                  const void* alpha, const void* rhs,
                                  const void* kdinv0, const void* kdinv1,
                                  void* out, int n, int var7, double b_h2inv,
                                  double a_coef, double t1, double t2,
                                  void* stream) {
  return launch_gsrb2<float>(x, beta_i, beta_j, beta_k, alpha, rhs, kdinv0,
                             kdinv1, out, n, var7, b_h2inv, a_coef, t1, t2,
                             stream);
}

extern "C" int hpgmg_r1_gsrb2_f64(const void* x, const void* beta_i,
                                  const void* beta_j, const void* beta_k,
                                  const void* alpha, const void* rhs,
                                  const void* kdinv0, const void* kdinv1,
                                  void* out, int n, int var7, double b_h2inv,
                                  double a_coef, double t1, double t2,
                                  void* stream) {
  return launch_gsrb2<double>(x, beta_i, beta_j, beta_k, alpha, rhs, kdinv0,
                              kdinv1, out, n, var7, b_h2inv, a_coef, t1, t2,
                              stream);
}
