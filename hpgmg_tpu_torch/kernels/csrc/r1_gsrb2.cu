// K6 and K8d: one full red+black GSRB sweep of a radius-1 suite (var7 or
// 27pt body, r1_common.cuh) in one launch, equal to two K5 gsrb
// half-sweeps (kdinv0, then kdinv1) to rounding:
//
//   r   = x + kdinv0 * (rhs - A x)
//   out = r + kdinv1 * (rhs - A r)
//
// K6 sweeps a whole Dirichlet level; K8d one rank's (ni, nj, nk) block of
// a level decomposed over a process grid, its i/j ghosts read from four
// 2-deep halo slabs (and on a block split along k its k ghosts from two
// more, KSLAB) and its coefficients from ring views (below).
//
// Replaces hpgmg_tpu/kernels/stencils_r1.py:_r1_gsrb2_kernel (:783),
// reached through r1_gsrb2_pallas (:904, pallas_call :948; K6) and through
// r1_gsrb2_call_slab (:960, pallas_call :1029, the same body with
// slab=True; K8d). The TPU kernel computed red on a +1 ring of each (bi,
// bj, n) VMEM tile from a radius-2 window, rebuilt the red iterate's
// Dirichlet ghosts (_fix_ghost_axis_r1) and ran black on the tile from
// the resident red values, reading j-padded views; none of that layout is
// carried over.
//
// What bounds it on an H100: device-memory bandwidth. A sweep reads x,
// rhs, kdinv0, kdinv1 (var7: the three face arrays) once and writes out
// once: 8 values a cell for var7 and 5 for 27pt, against two half-sweeps'
// 14 and 8, at ~21 (var7) or ~39 (27pt) flops a cell.
//
// Design: K5's streaming column (r1_stream.cu). A block owns a TJ x TK
// column of (j, k) (k fastest) and marches a chunk of i-planes. x planes
// arrive by cp.async in a ring of kSwRing slots, each with the 2-cell
// (j, k) halo that red on the column's 1-cell ring needs; kSwRing - 4
// planes are in flight while a plane computes. Iteration q (one
// __syncthreads):
//
//   1. red at plane q on the column and its 1-cell (j, k) ring, (TJ+2)
//      rows of (TK+2)/2 pairs of cells along k: the stencil at the red
//      cell of the pair ((i+j+k) even), read straight from the x slots of
//      planes q-1 .. q+1, and a copy of x at the black one, into one of
//      two red planes in shared memory. A thread takes the pair of its
//      own black cells' row and, in two warps, one of the ring's 50 other
//      pairs: red costs (TJ+2)(TK+2)/(TJ TK) = 1.20 stencils of the
//      column's (the TPU kernel's ring, on two axes);
//   2. black at plane q-2 from a register window over the red planes
//      q-3 .. q-1, as K5's 27pt gsrb (r1_stream.cu) over x: the newest
//      plane read once (six paired reads) into the role of the plane the
//      window drops, the stencil at the black cell of the thread's pair
//      and the red value copied at the red one, out written once.
//
// Black lags red by two planes so that each red plane is complete (the
// barrier of the next iteration) before any thread reads it, with one
// barrier an iteration. What a stencil reads from device memory (rhs, its
// kdinv, var7's six faces) is read into registers at the top of the
// iteration, before the barrier, for all of the thread's stencils at
// once: the iteration waits for one round trip to memory, not one per
// stencil, and the loads overlap the barrier (the kernel is bound by that
// latency more than by bandwidth: f32 holds two blocks an SM at ~120
// registers, f64 one at ~190-230, with no spill). Levels too small to fill
// the card split i into chunks; the launcher picks the chunk whose waves
// of co-resident blocks times a block's iterations is least, so a small
// level's blocks fit one wave. Dirichlet ghosts are made in registers, never
// stored: red's x ghosts from the stencil's own values (a face
// neighbour outside the domain is t1 * x1 + t2 * x2 of the centre and the
// opposite neighbour; the 27pt window rows, then columns, then planes,
// which is the tensor product at edges and corners), black's from the
// window (ghost_rows_cols, ghost_plane in r1_common.cuh). So red is
// computed only at cells inside the domain, and the red ghosts of the TPU
// kernel's rebuild step never exist.
//
// K8d is the same kernel (SLAB): an x plane with i < 0 or i >= ni is a
// plane of the slab ilo or ihi, a halo row with j < 0 or j >= nj a row of
// the strip jlo or jhi (so red reads its i/j ghosts as slab cells, as the
// plain version does; only k ghosts are made), the coefficients, rhs and
// kdinv0 are indexed in the ring-view layout. Its six edge flags say which
// sides are domain faces: only there are red's ghosts made; on the other
// sides the ring cells are the neighbour's, red there is computed from the
// 2-deep halo as the neighbour computes it. A block whole along k has both
// k sides on domain faces. On a block split along k (KSLAB) a halo column
// k < 0 or k >= nk of x plane P is the k slab klo's or khi's cell ((P+2)
// (nj+4) + j+2) 2 + r, the ring views and rhs hold a 1-cell ring along k
// too, and red also runs on the k ring where that side is not a domain
// face; only one exchange a sweep, as on i and j. K6 is the kernel with
// every flag set and no slab.
// Each half evaluates the stencil at its colour's cells only: the kdinv
// pair vanishes off its colour (ops/base.py:RadiusOneSuite.fold_kdinv),
// and the copy equals x + 0 * (rhs - A x). Block offsets of K8d are even,
// so local parity is global. A chunk that starts at i0 > 0 computes red at
// plane i0-1 again from x planes i0-2 .. i0, so every cell's red and
// black values are computed from the same values in the same order
// whatever the chunk: any chunk gives the same bits.
// bfloat16 (K6 and K8d of a bf16 solve; K8d's ring views bf16 as x is,
// its slabs float: the exchange widens them, and a Dirichlet domain face's
// ghost is kept as float, as K6 makes it): the x ring and the red planes
// hold float and the arithmetic is the float kernel's; each bf16 x value's
// aligned 32-bit word lands in its float slot by cp.async and the thread
// that copied it widens the slot in place before the barrier that
// publishes the plane (stream.cuh: cp_async_value, widen_ring_plane; K8d's
// x copies only, widen_value), the slab cells are copied as they are; the
// operands are widened as they are read (ld). Each red value is rounded to
// bf16 (rounded<S>) before black reads it, as the red half-sweep's stored
// output is, so K6 in bf16 equals two K5 bf16 half-sweeps but for the
// order of the float sums; out is rounded once. On an H100 80GB HBM3 at
// 700 W the 512^3 var7 sweep ran 3.03 ms against 1.90 ms in float32 in
// turns (chip_smoke.py phase 19a, PERF.md).
// Plain versions: hpgmg_tpu_torch/kernels/stencils_r1.py: r1_gsrb2_plain,
// r1_gsrb2_slab_plain.
//
// Layouts of K8d (k fastest), for a local block of ni x nj x nk cells:
//   x, kdinv1, out   (ni, nj, nk)
//   ilo, ihi   (2, nj, nk): the cells i = -2, -1 and i = ni, ni+1
//   jlo, jhi   (ni+4, 2, nk): the cells j = -2, -1 and j = nj, nj+1 at
//              i = -2 .. ni+1 (the i-extended strips)
//   klo, khi   (ni+4, nj+4, 2), KSLAB only: the cells k = -2, -1 and
//              k = nk, nk+1 at i = -2 .. ni+1, j = -2 .. nj+1
//   the ring views, each on the block and a 1-cell ring in i and j (zeros
//   outside the domain; shard_kernels.build_sharded_k2_r1): kdinv0, alpha,
//   rhs (ni+2, nj+2, nk), beta_i (ni+3, nj+2, nk), beta_j (ni+2, nj+3, nk),
//   beta_k (ni+2, nj+2, nk+1); KSLAB: with a 1-cell ring in k too, nk+2
//   values a row (beta_k nk+3).

#include "r1_common.cuh"
#include "stream.cuh"

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kSwThreads = 256;
// column tile (j, k) per block: a pair of black cells a thread, two rows
// of the same colour phase a warp (rows j and j+2)
constexpr int SJ = 16;
constexpr int SK = 32;
static_assert(SJ * SK / 2 == kSwThreads && SK == 32, "a pair a thread, two rows a warp");
// ring slots of x planes: the three red reads and kSwRing - 3 more, of
// which kSwRing - 4 are in flight behind the one an iteration waits for
constexpr int kSwRing = 6;
// blocks an SM must hold (the register cap of __launch_bounds__)
template <typename T>
constexpr int kSwBlocks = sizeof(T) == 4 ? 2 : 1;
// the iterations a chunk of c i-planes takes beyond c: red at the plane
// before it and black's lag of two (the launcher's chunk rule)
constexpr int kSwFill = 3;

constexpr int SXP = SK + 4;              // x plane pitch: k0-2 .. k0+SK+1
constexpr int SXPLANE = (SJ + 4) * SXP;  // rows j0-2 .. j0+SJ+1
constexpr int SRP = SK + 2;              // red plane pitch: k0-1 .. k0+SK (even)
constexpr int SRPLANE = (SJ + 2) * SRP;  // rows j0-1 .. j0+SJ
constexpr int kSwXE = (SXPLANE + kSwThreads - 1) / kSwThreads;  // copies a thread
// the red pairs beyond one a thread: the ring's rows 0 and SJ+1 (SRP/2
// pairs each) and the last pair of rows 1 .. SJ, in two warps of 25
constexpr int kRedPairs = (SJ + 2) * (SRP / 2);
static_assert(kRedPairs - kSwThreads == 2 * 25 && SRP / 2 == 17, "two warps take the rest");
constexpr unsigned kSwNoCopy = ~0u;
// a copy's source (x or a slab plane, jlo strip, jhi strip, klo slab, khi
// slab) in the top bits of its offset
constexpr int kSrcShift = 29;
constexpr unsigned kOffMask = (1u << kSrcShift) - 1;

// S: the storage type of every field, T = Wide<S> the arithmetic's and
// the slabs'
template <typename S, typename T = Wide<S>>
struct SweepArgs {
  const S* x;
  const T* ilo;  // K8d: the slabs; K6: null
  const T* ihi;
  const T* jlo;
  const T* jhi;
  const T* klo;  // K8d on a block split along k (KSLAB); null otherwise
  const T* khi;
  const S* beta_i;  // var7 only (K8d: the ring views)
  const S* beta_j;
  const S* beta_k;
  const S* alpha;   // var7 with a*alpha*x; nullptr otherwise
  const S* rhs;     // K8d: the ring view
  const S* kdinv0;  // red's (K8d: the ring view)
  const S* kdinv1;  // black's, on the block
  S* out;
  int ni, nj, nk;
  T b_h2inv;  // b / h^2
  T a_coef;   // var7: a (with alpha); 27pt: the constant a of a*x
  T t1, t2;   // Dirichlet ghost taps
  // bit e: side e (i low, i high, j low, j high, k low, k high) is a domain
  // face
  int edges;
};

// The coefficient indices of cell (i, j, k), i in [-1, ni], j in [-1, nj]
// (KSLAB: k in [-1, nk]), in K8d's ring views
template <bool KSLAB>
__device__ __forceinline__ R1Index ring_index(int i, int j, int k, int ni, int nj,
                                              int nk) {
  const int nr = KSLAB ? nk + 2 : nk, kr = KSLAB ? k + 1 : k;
  const int64_t c = ((static_cast<int64_t>(i) + 1) * (nj + 2) + (j + 1)) * nr + kr;
  return {c, static_cast<int64_t>(nj + 2) * nr,
          ((static_cast<int64_t>(i) + 1) * (nj + 3) + (j + 1)) * nr + kr, nr,
          ((static_cast<int64_t>(i) + 1) * (nj + 2) + (j + 1)) * (nr + 1) + kr, c};
}

template <bool SLAB, bool KSLAB>
__device__ __forceinline__ R1Index sweep_index(int i, int j, int k, int ni, int nj,
                                               int nk) {
  if constexpr (SLAB) {
    return ring_index<KSLAB>(i, j, k, ni, nj, nk);
  } else {
    return r1_index(i, j, k, ni, nj, nk);
  }
}

// What a stencil reads from device memory: rhs, its half's kdinv and
// (var7) the six faces of its cell, high then low along i, j, k
template <typename T, bool VAR7>
struct Operands {
  T rhs, kd;
  T face[VAR7 ? 6 : 1];
};

// A x of the var7 body from X(di, dj, dk) and the faces in `o`, in
// r1_ax's order; alpha (a*alpha*x) read here, off the benchmark's path
template <typename T, typename S, typename FX>
__device__ __forceinline__ T ax7(const FX& X, const Operands<T, true>& o, const S* alpha,
                                 int64_t ca, T b_h2inv, T a_coef) {
  const T xc = X(0, 0, 0);
  const T lap = o.face[0] * (X(1, 0, 0) - xc) + o.face[1] * (X(-1, 0, 0) - xc) +
                o.face[2] * (X(0, 1, 0) - xc) + o.face[3] * (X(0, -1, 0) - xc) +
                o.face[4] * (X(0, 0, 1) - xc) + o.face[5] * (X(0, 0, -1) - xc);
  T ax = -b_h2inv * lap;
  if (alpha != nullptr) ax = a_coef * ld(alpha + ca) * xc + ax;
  return ax;
}

// One block: the SJ x SK column (blockIdx.x) over the i-planes of chunk
// blockIdx.y. S: the storage type of the fields, T = Wide<S> the x ring's,
// the red planes' and the arithmetic's.
template <typename S, bool VAR7, bool SLAB, bool KSLAB, typename T = Wide<S>>
__global__ void __launch_bounds__(kSwThreads, kSwBlocks<T>)
    r1_gsrb2_kernel(const SweepArgs<S> p, int chunk) {
  static_assert(SLAB || !KSLAB, "k slabs come with the i/j slabs");
  __shared__ __align__(16) T xr[kSwRing * SXPLANE];
  __shared__ __align__(16) T rr[2 * SRPLANE];

  const int ni = p.ni, nj = p.nj, nk = p.nk;
  const T t1 = p.t1, t2 = p.t2;
  const bool gil = p.edges & 1, gih = p.edges & 2, gjl = p.edges & 4, gjh = p.edges & 8;
  const int tiles_k = (nk + SK - 1) / SK;
  const int j0 = static_cast<int>(blockIdx.x / tiles_k) * SJ;
  const int k0 = static_cast<int>(blockIdx.x % tiles_k) * SK;
  const int ia = blockIdx.y * chunk;
  const int ib = min(ia + chunk, ni);
  // red is computed at i in [ilo, ihi), j in [jlo, jhi): the block and
  // its ring on the sides that are not domain faces; this chunk's red
  // planes are ra .. rb, its x planes xa .. xb
  const int ilo = gil ? 0 : -1, ihi = gih ? ni : ni + 1;
  const int jlo = gjl ? 0 : -1, jhi = gjh ? nj : nj + 1;
  // and k in [klo, khi): KSLAB, the block and its ring on the sides that
  // are not domain faces; else the block (its k sides are domain faces)
  const bool gkl = !KSLAB || (p.edges & 16), gkh = !KSLAB || (p.edges & 32);
  const int klo = gkl ? 0 : -1, khi = gkh ? nk : nk + 1;
  const int ra = max(ia - 1, ilo), rb = min(ib, ihi - 1);
  // x planes and rows: K6's cells; K8d's and their slab cells (i/j ghosts
  // at a domain face included)
  const int halo = SLAB ? 2 : 0;
  const int xa = -halo, xb = min(ni - 1 + halo, rb + 1);

  // this thread's copies of an x plane: halo positions t (row t / SXP,
  // column t % SXP of the slot), their offsets in their source (a k ghost,
  // and K6's i/j ghosts, are made where they are read; positions beyond
  // the block's ragged edge are read only by discarded results)
  unsigned goff[kSwXE];
#pragma unroll
  for (int e = 0; e < kSwXE; ++e) {
    const int t = threadIdx.x + e * kSwThreads;
    const int j = j0 - 2 + t / SXP, k = k0 - 2 + t % SXP;
    unsigned g = kSwNoCopy;
    if (KSLAB && t < SXPLANE && (k < 0 || k >= nk) && k < nk + 2 && j < nj + 2) {
      g = ((k < 0 ? 3u : 4u) << kSrcShift) |
          static_cast<unsigned>((j + 2) * 2 + (k < 0 ? k + 2 : k - nk));
    } else if (t < SXPLANE && k >= 0 && k < nk && j >= -halo && j < nj + halo) {
      if (j < 0) {
        g = (1u << kSrcShift) | static_cast<unsigned>((j + 2) * nk + k);
      } else if (j >= nj) {
        g = (2u << kSrcShift) | static_cast<unsigned>((j - nj) * nk + k);
      } else {
        g = static_cast<unsigned>(j * nk + k);
      }
    }
    goff[e] = g;
  }
  const int64_t plane = static_cast<int64_t>(nj) * nk;
  // x plane P into ring slot s; a commit group whether or not it copies
  // anything, so that every iteration waits for the same count. A bf16 x
  // lands as its values' words (cp_async_value), which widen_plane turns
  // into floats once this thread's copies of the plane have arrived, before
  // the barrier that publishes it; K8d's slabs are in the ring's type.
  const S* const xend = p.x + static_cast<int64_t>(ni) * plane;
  // K8d: the slab cells of a copy of x plane P from source src (1, 2: the
  // strips jlo, jhi; 3, 4: the k slabs klo, khi; 0: the slab ilo or ihi
  // of a plane P < 0 or P >= ni), offset 0
  auto slab_at = [&](unsigned src, int P) -> const T* {
    if (src == 0) return P < 0 ? p.ilo + (P + 2) * plane : p.ihi + (P - ni) * plane;
    if (src <= 2) return (src == 1 ? p.jlo : p.jhi) + static_cast<int64_t>(P + 2) * 2 * nk;
    return (src == 3 ? p.klo : p.khi) + static_cast<int64_t>(P + 2) * (nj + 4) * 2;
  };
  auto load_plane = [&](int P, int s) {
    if (P >= xa && P <= xb) {
      T* dst = xr + s * SXPLANE + threadIdx.x;
      const bool inx = P >= 0 && P < ni;
      const S* xp = p.x + P * plane;
#pragma unroll
      for (int e = 0; e < kSwXE; ++e) {
        const unsigned g = goff[e];
        if (g == kSwNoCopy) continue;
        const unsigned src = g >> kSrcShift;
        if (!SLAB || (src == 0 && inx)) {
          cp_async_value(dst + e * kSwThreads, xp + (g & kOffMask), xend);
        } else {
          cp_async(dst + e * kSwThreads, slab_at(src, P) + (g & kOffMask));
        }
      }
    }
    cp_async_commit();
  };
  auto widen_plane = [&](int P, int s) {
    if constexpr (!SLAB) {
      if (P >= xa && P <= xb)
        widen_ring_plane<kSwXE, kSwThreads>(xr + s * SXPLANE + threadIdx.x, p.x + P * plane,
                                            goff, kSwNoCopy);
    } else if constexpr (!std::is_same_v<S, T>) {
      // K8d: the copies from x (the slabs' are in the ring's type)
      if (P >= 0 && P < ni && P <= xb) {
        T* dst = xr + s * SXPLANE + threadIdx.x;
#pragma unroll
        for (int e = 0; e < kSwXE; ++e) {
          const unsigned g = goff[e];
          if (g != kSwNoCopy && (g >> kSrcShift) == 0)
            widen_value(dst + e * kSwThreads, p.x + P * plane + g);
        }
      }
    }
  };

  // a stencil's operands at cell (i, j, k), read when `ok`: red's
  // (kdinv0, indexed as rhs) or black's (kdinv1, on the block)
  using Ops = Operands<T, VAR7>;
  auto fetch = [&](bool ok, int i, int j, int k, bool red_half, Ops& o) {
    if (!ok) return;
    const R1Index ix = sweep_index<SLAB, KSLAB>(i, j, k, ni, nj, nk);
    o.rhs = ld(p.rhs + ix.ca);
    o.kd = red_half ? ld(p.kdinv0 + ix.ca)
                    : ld(p.kdinv1 + (static_cast<int64_t>(i) * nj + j) * nk + k);
    if constexpr (VAR7) {
      o.face[0] = ld(p.beta_i + ix.ci + ix.si);
      o.face[1] = ld(p.beta_i + ix.ci);
      o.face[2] = ld(p.beta_j + ix.cj + ix.sj);
      o.face[3] = ld(p.beta_j + ix.cj);
      o.face[4] = ld(p.beta_k + ix.ck + 1);
      o.face[5] = ld(p.beta_k + ix.ck);
    }
  };
  // A x at cell (i, j, k) from X and its operands
  auto ax_at = [&](const auto& X, const Ops& o, int i, int j, int k) -> T {
    if constexpr (VAR7) {
      return ax7(X, o, p.alpha,
                 p.alpha != nullptr ? sweep_index<SLAB, KSLAB>(i, j, k, ni, nj, nk).ca : 0,
                 p.b_h2inv, p.a_coef);
    } else {
      return r1_ax<T, false>(nullptr, nullptr, nullptr, nullptr, p.b_h2inv, p.a_coef, X,
                             R1Index{});
    }
  };

  // ring pair (r, pp) of plane i: the cells (j0-1+r, k0-1+2pp) and the next
  // along k; its red cell is kp + d
  struct Pair {
    int j, kp, d;
  };
  auto ring_pair = [&](int i, int r, int pp) {
    const int j = j0 - 1 + r, kp = k0 - 1 + 2 * pp;
    return Pair{j, kp, (i + j + kp) & 1};
  };
  // whether red computes the red cell of the pair at plane i
  auto red_ok = [&](int i, const Pair& c) {
    const int k = c.kp + c.d;
    return i <= rb && c.j >= jlo && c.j < jhi && k >= klo && k < khi;
  };
  // red at ring pair (r, pp) of plane i from the x slots of planes i-1, i,
  // i+1 and its operands, into the red plane rq, and a copy of x at the
  // pair's black cell
  auto red = [&](int i, int r, int pp, const Pair& c, bool ok, const Ops& o, const T* xm,
                 const T* xq, const T* xp, T* rq) {
    const int j = c.j, d = c.d;
    if (j < jlo || j >= jhi) return;
    const int k = c.kp + d, kc = c.kp + 1 - d;
    const int at = (r + 1) * SXP + 2 * pp + 1 + d;  // x slot index of the red cell
    T* dst = rq + r * SRP + 2 * pp;
    // the black cell's x, rounded to S as the red half-sweep's stored
    // output holds it (a no-op but for a K8d slab cell, which is float)
    if (kc >= klo && kc < khi) dst[1 - d] = rounded<S>(xq[at + 1 - 2 * d]);
    if (!ok) return;
    // the ghosts red makes: K6's on every face; K8d's i/j ghosts are slab
    // cells
    const bool fil = !SLAB && i == 0, fih = !SLAB && i == ni - 1;
    const bool fjl = !SLAB && j == 0, fjh = !SLAB && j == nj - 1;
    const bool fkl = gkl && k == 0, fkh = gkh && k == nk - 1;
    T xc, ax;
    if constexpr (VAR7) {
      xc = xq[at];
      T xw = xq[at - 1], xe = xq[at + 1], xn = xq[at - SXP], xs = xq[at + SXP];
      T xd = xm[at], xu = xp[at];
      if (fkl) xw = t1 * xc + t2 * xe;
      if (fkh) xe = t1 * xc + t2 * xw;
      if (fjl) xn = t1 * xc + t2 * xs;
      if (fjh) xs = t1 * xc + t2 * xn;
      if (fil) xd = t1 * xc + t2 * xu;
      if (fih) xu = t1 * xc + t2 * xd;
      auto X = [&](int di, int dj, int dk) -> T {
        return di < 0 ? xd : di > 0 ? xu : dj < 0 ? xn : dj > 0 ? xs : dk < 0 ? xw
                                                                              : dk > 0 ? xe : xc;
      };
      ax = ax_at(X, o, i, j, k);
    } else {
      T w[3][3][3];
      const T* src[3] = {xm, xq, xp};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
#pragma unroll
          for (int e = 0; e < 3; ++e) w[a][b][e] = src[a][at + (b - 1) * SXP + e - 1];
        }
      }
      if (fil || fih || fjl || fjh || fkl || fkh) {
        // the ghosts of the window: rows, then columns, then planes
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            if (fjl) w[a][0][e] = t1 * w[a][1][e] + t2 * w[a][2][e];
            if (fjh) w[a][2][e] = t1 * w[a][1][e] + t2 * w[a][0][e];
          }
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            if (fkl) w[a][b][0] = t1 * w[a][b][1] + t2 * w[a][b][2];
            if (fkh) w[a][b][2] = t1 * w[a][b][1] + t2 * w[a][b][0];
          }
        }
#pragma unroll
        for (int b = 0; b < 3; ++b) {
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            if (fil) w[0][b][e] = t1 * w[1][b][e] + t2 * w[2][b][e];
            if (fih) w[2][b][e] = t1 * w[1][b][e] + t2 * w[0][b][e];
          }
        }
      }
      xc = w[1][1][1];
      auto X = [&](int di, int dj, int dk) -> T { return w[di + 1][dj + 1][dk + 1]; };
      ax = ax_at(X, o, i, j, k);
    }
    // rounded to S as the red half-sweep's output is stored (two K5 gsrb
    // launches), so black reads what a stored red iterate holds
    dst[d] = rounded<S>(xc + o.kd * (o.rhs - ax));
  };

  // thread: black's row jl and pair pl (cells kb = k0 + 2 pl and kb + 1),
  // red's ring row jl + 1, pair pl; a warp holds rows j and j+2, whose
  // cells of one colour lie at the same place of their pairs. Warps 0
  // and 1 also take red's other pairs: warp 0 the ring row 0 and the
  // last pair of the even ring rows, warp 1 the ring row SJ+1 and the
  // last pair of the odd ones
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int jl = 4 * (wp >> 1) + (wp & 1) + 2 * (lane >> 4);
  const int pl = lane & (SK / 2 - 1);
  int r2 = -1, p2 = 0;
  if (wp < 2 && lane < 25) {
    if (lane < SRP / 2) {
      r2 = wp == 0 ? 0 : SJ + 1;
      p2 = lane;
    } else {
      r2 = 2 * (lane - SRP / 2) + 2 - wp;
      p2 = SK / 2;
    }
  }
  const int j = j0 + jl, kb = k0 + 2 * pl;
  const bool pair_in = j < nj && kb < nk;
  const bool vec = (nk & 1) == 0;
  const bool has_hi = kb + 1 < nk;
  const Faces f{gjl && j == 0, gjh && j == nj - 1, gkl && kb == 0,
                !gkh ? -1 : (kb == nk - 2 ? 3 : (kb == nk - 1 ? 2 : -1))};
  const bool face = f.jlo || f.jhi || f.klo || f.khi >= 0;
  // the window's rows j-1 .. j+1, columns kb-1 .. kb+2 of a red plane
  auto read = [&](Rows<T>& w, const T* rq) {
    const T* src = rq + jl * SRP + 2 * pl;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      lds2(src + r * SRP, w[r][0], w[r][1]);
      lds2(src + r * SRP + 2, w[r][2], w[r][3]);
    }
    if (face) ghost_rows_cols(w, f, t1, t2);
  };

  // the window: three red planes, each in turn b-1, b and b+1 (the
  // iterations rotate their roles, so that no value moves)
  T w[3][3][4];
#pragma unroll
  for (int s = 0; s < kSwRing - 1; ++s) load_plane(ra - 1 + s, s);
  int xs = 0;  // x slot of plane q-1

  // iteration q: red at plane q, black at plane q-2; w[A], w[B], w[C] hold
  // (or take) the red planes q-3, q-2, q-1
  auto iteration = [&](int q, auto A, auto B, auto C) {
    constexpr int a = decltype(A)::value, b = decltype(B)::value, c = decltype(C)::value;
    // every operand this iteration reads from device memory, in flight
    // through the barrier
    const Pair c1 = ring_pair(q, jl + 1, pl);
    const bool ok1 = red_ok(q, c1);
    Ops o1{}, o2{}, ob{};
    fetch(ok1, q, c1.j, c1.kp + c1.d, true, o1);
    Pair c2{0, 0, 0};
    bool ok2 = false;
    if (r2 >= 0) {
      c2 = ring_pair(q, r2, p2);
      ok2 = red_ok(q, c2);
      fetch(ok2, q, c2.j, c2.kp + c2.d, true, o2);
    }
    const int i = q - 2;
    const int qq = (i + j + 1) & 1;  // the black cell of plane i: kb + qq
    const bool okb = i >= ia && i < ib && pair_in && kb + qq < nk;
    fetch(okb, i, j, kb + qq, false, ob);
    // x plane q+1 has arrived (kSwRing - 4 newer groups may be in flight);
    // every thread is done with red plane q-2 and x plane q-2; this
    // thread's words of a bf16 x widened (the first iteration's planes
    // q-1, q too)
    cp_async_wait<kSwRing - 4>();
    if constexpr (!std::is_same_v<S, T>) {
      if (q == ra) {
        widen_plane(q - 1, xs);
        widen_plane(q, ring_add(xs, 1, kSwRing));
      }
      widen_plane(q + 1, ring_add(xs, 2, kSwRing));
    }
    __syncthreads();
    load_plane(q - 2 + kSwRing, xs == 0 ? kSwRing - 1 : xs - 1);
    if (q <= rb) {
      const T* xm = xr + xs * SXPLANE;
      const T* xq = xr + ring_add(xs, 1, kSwRing) * SXPLANE;
      const T* xp = xr + ring_add(xs, 2, kSwRing) * SXPLANE;
      T* rq = rr + (q & 1) * SRPLANE;
      red(q, jl + 1, pl, c1, ok1, o1, xm, xq, xp, rq);
      if (r2 >= 0) red(q, r2, p2, c2, ok2, o2, xm, xq, xp, rq);
    }
    xs = ring_add(xs, 1, kSwRing);
    // red plane q-1, complete since the barrier, enters the window
    if (q - 1 >= ra && q - 1 <= rb) read(w[c], rr + ((q - 1) & 1) * SRPLANE);
    if (i < ia || i >= ib) return;
    // black at plane i; the ghost planes i = -1 and i = ni of a domain face
    if (gih && i == ni - 1) ghost_plane(w[c], w[b], w[a], t1, t2);
    if (gil && i == 0) ghost_plane(w[a], w[b], w[c], t1, t2);
    if (!pair_in) return;
    const int k = kb + qq;
    const int64_t row = (static_cast<int64_t>(i) * nj + j) * nk;
    auto X0 = [&](int di, int dj, int dk) -> T {
      return w[di < 0 ? a : (di == 0 ? b : c)][dj + 1][dk + 1];
    };
    auto X1 = [&](int di, int dj, int dk) -> T {
      return w[di < 0 ? a : (di == 0 ? b : c)][dj + 1][dk + 2];
    };
    T v = T(0);
    if (okb) {
      v = qq ? w[b][1][2] + ob.kd * (ob.rhs - ax_at(X1, ob, i, j, k))
             : w[b][1][1] + ob.kd * (ob.rhs - ax_at(X0, ob, i, j, k));
    }
    if (qq) {
      store_pair(p.out, row + kb, w[b][1][1], v, vec, has_hi);
    } else {
      store_pair(p.out, row + kb, v, w[b][1][2], vec, has_hi);
    }
  };
  using I0 = std::integral_constant<int, 0>;
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  // red plane q-1's role in iteration q is (q - ra) mod 3
  for (int q = ra; q <= ib + 1; q += 3) {
    iteration(q, I1{}, I2{}, I0{});
    if (q + 1 <= ib + 1) iteration(q + 1, I2{}, I0{}, I1{});
    if (q + 2 <= ib + 1) iteration(q + 2, I0{}, I1{}, I2{});
  }
}

template <typename S, bool VAR7, bool SLAB, bool KSLAB = false>
int launch_body(const SweepArgs<S>& p, int chunk, cudaStream_t s) {
  auto kernel = r1_gsrb2_kernel<S, VAR7, SLAB, KSLAB>;
  const int64_t tiles =
      static_cast<int64_t>((p.nj + SJ - 1) / SJ) * ((p.nk + SK - 1) / SK);
  if (chunk <= 0) {
    // co-resident blocks on the card (queried once)
    static const int64_t slots = [&]() -> int64_t {
      int dev = 0, sms = 0, per_sm = 0;
      if (cudaGetDevice(&dev) != cudaSuccess ||
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSwThreads, 0) !=
              cudaSuccess)
        return 0;
      return static_cast<int64_t>(sms) * per_sm;
    }();
    if (slots <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    // the chunk whose waves of co-resident blocks times the iterations a
    // block takes is least (the largest of equals: fewer blocks); a
    // partial wave costs a whole one
    int64_t best = INT64_MAX;
    for (int c = p.ni; c >= 1; --c) {
      const int64_t blocks = tiles * ((p.ni + c - 1) / c);
      const int64_t cost = (blocks + slots - 1) / slots * (c + kSwFill);
      if (cost < best) {
        best = cost;
        chunk = c;
      }
    }
  }
  if (chunk > p.ni) chunk = p.ni;
  const int chunks = (p.ni + chunk - 1) / chunk;
  if (tiles > INT_MAX || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(static_cast<unsigned>(tiles), chunks), kSwThreads, 0, s>>>(p, chunk);
  return static_cast<int>(cudaGetLastError());
}

// S: the storage type (K6 and K8d alike)
template <typename S>
int launch_sweep(const void* x, const void* ilo, const void* ihi, const void* jlo,
                 const void* jhi, const void* klo, const void* khi, const void* beta_i,
                 const void* beta_j, const void* beta_k, const void* alpha, const void* rhs,
                 const void* kdinv0, const void* kdinv1, void* out, int ni, int nj, int nk,
                 int edges, int var7, int chunk, double b_h2inv, double a_coef, double t1,
                 double t2, void* stream) {
  const bool slab = ilo != nullptr, kslab = klo != nullptr;
  // a block whole along k has both k sides on domain faces
  if (ni < 2 || nj < 2 || nk < 2 || chunk < 0 || edges < 0 || edges > 63 ||
      (slab && (ni % 2 || nj % 2)) || (!slab && edges != 63) ||
      (!kslab && (edges & 48) != 48) ||
      (kslab && (!slab || khi == nullptr || nk % 2 || nk < 4)) ||
      static_cast<int64_t>(nj + 4) * (nk + 4) > static_cast<int64_t>(kOffMask) ||
      x == nullptr || rhs == nullptr || kdinv0 == nullptr || kdinv1 == nullptr ||
      out == nullptr || (slab && (ihi == nullptr || jlo == nullptr || jhi == nullptr)) ||
      (var7 && (beta_i == nullptr || beta_j == nullptr || beta_k == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using T = Wide<S>;
  SweepArgs<S> p{};
  p.x = static_cast<const S*>(x);
  p.ilo = static_cast<const T*>(ilo);
  p.ihi = static_cast<const T*>(ihi);
  p.jlo = static_cast<const T*>(jlo);
  p.jhi = static_cast<const T*>(jhi);
  p.klo = static_cast<const T*>(klo);
  p.khi = static_cast<const T*>(khi);
  p.beta_i = static_cast<const S*>(beta_i);
  p.beta_j = static_cast<const S*>(beta_j);
  p.beta_k = static_cast<const S*>(beta_k);
  p.alpha = static_cast<const S*>(alpha);
  p.rhs = static_cast<const S*>(rhs);
  p.kdinv0 = static_cast<const S*>(kdinv0);
  p.kdinv1 = static_cast<const S*>(kdinv1);
  p.out = static_cast<S*>(out);
  p.ni = ni;
  p.nj = nj;
  p.nk = nk;
  p.b_h2inv = static_cast<T>(b_h2inv);
  p.a_coef = static_cast<T>(a_coef);
  p.t1 = static_cast<T>(t1);
  p.t2 = static_cast<T>(t2);
  p.edges = edges;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kslab) {
    return var7 ? launch_body<S, true, true, true>(p, chunk, s)
                : launch_body<S, false, true, true>(p, chunk, s);
  }
  if (slab) {
    return var7 ? launch_body<S, true, true>(p, chunk, s)
                : launch_body<S, false, true>(p, chunk, s);
  }
  return var7 ? launch_body<S, true, false>(p, chunk, s)
              : launch_body<S, false, false>(p, chunk, s);
}

}  // namespace

// K6. kdinv0 / kdinv1: the red / black parity-folded dinv; var7 != 0: the
// 7-point body (beta_* read; alpha may be null), else the 27pt body (a_coef
// the constant a); chunk: i-planes per block (0: the launcher's rule)
extern "C" int hpgmg_r1_gsrb2_chunk_f32(const void* x, const void* beta_i,
                                        const void* beta_j, const void* beta_k,
                                        const void* alpha, const void* rhs,
                                        const void* kdinv0, const void* kdinv1, void* out,
                                        int n, int var7, int chunk, double b_h2inv,
                                        double a_coef, double t1, double t2, void* stream) {
  return launch_sweep<float>(x, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, beta_i,
                             beta_j, beta_k, alpha, rhs, kdinv0, kdinv1, out, n, n, n, 63,
                             var7, chunk, b_h2inv, a_coef, t1, t2, stream);
}

extern "C" int hpgmg_r1_gsrb2_chunk_f64(const void* x, const void* beta_i,
                                        const void* beta_j, const void* beta_k,
                                        const void* alpha, const void* rhs,
                                        const void* kdinv0, const void* kdinv1, void* out,
                                        int n, int var7, int chunk, double b_h2inv,
                                        double a_coef, double t1, double t2, void* stream) {
  return launch_sweep<double>(x, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                              beta_i, beta_j, beta_k, alpha, rhs, kdinv0, kdinv1, out, n, n,
                              n, 63, var7, chunk, b_h2inv, a_coef, t1, t2, stream);
}

// bf16 storage, float arithmetic (red rounded to bf16 before black reads
// it): a bfloat16 solve's K6
extern "C" int hpgmg_r1_gsrb2_chunk_bf16(const void* x, const void* beta_i,
                                         const void* beta_j, const void* beta_k,
                                         const void* alpha, const void* rhs,
                                         const void* kdinv0, const void* kdinv1, void* out,
                                         int n, int var7, int chunk, double b_h2inv,
                                         double a_coef, double t1, double t2, void* stream) {
  return launch_sweep<bf16>(x, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, beta_i,
                            beta_j, beta_k, alpha, rhs, kdinv0, kdinv1, out, n, n, n, 63,
                            var7, chunk, b_h2inv, a_coef, t1, t2, stream);
}

// K6 with the launcher's chunk rule
extern "C" int hpgmg_r1_gsrb2_f32(const void* x, const void* beta_i, const void* beta_j,
                                  const void* beta_k, const void* alpha, const void* rhs,
                                  const void* kdinv0, const void* kdinv1, void* out, int n,
                                  int var7, double b_h2inv, double a_coef, double t1,
                                  double t2, void* stream) {
  return hpgmg_r1_gsrb2_chunk_f32(x, beta_i, beta_j, beta_k, alpha, rhs, kdinv0, kdinv1,
                                  out, n, var7, 0, b_h2inv, a_coef, t1, t2, stream);
}

extern "C" int hpgmg_r1_gsrb2_f64(const void* x, const void* beta_i, const void* beta_j,
                                  const void* beta_k, const void* alpha, const void* rhs,
                                  const void* kdinv0, const void* kdinv1, void* out, int n,
                                  int var7, double b_h2inv, double a_coef, double t1,
                                  double t2, void* stream) {
  return hpgmg_r1_gsrb2_chunk_f64(x, beta_i, beta_j, beta_k, alpha, rhs, kdinv0, kdinv1,
                                  out, n, var7, 0, b_h2inv, a_coef, t1, t2, stream);
}

extern "C" int hpgmg_r1_gsrb2_bf16(const void* x, const void* beta_i, const void* beta_j,
                                   const void* beta_k, const void* alpha, const void* rhs,
                                   const void* kdinv0, const void* kdinv1, void* out, int n,
                                   int var7, double b_h2inv, double a_coef, double t1,
                                   double t2, void* stream) {
  return hpgmg_r1_gsrb2_chunk_bf16(x, beta_i, beta_j, beta_k, alpha, rhs, kdinv0, kdinv1,
                                   out, n, var7, 0, b_h2inv, a_coef, t1, t2, stream);
}

// K8d. The r* operands are the ring views; klo, khi: the k slabs of a
// block split along k (null on a block whole along k); edges: bit e set
// where side e (i low, i high, j low, j high, k low, k high) is a domain
// face; chunk as K6's
extern "C" int hpgmg_r1_gsrb2_slab_chunk_f32(
    const void* x, const void* ilo, const void* ihi, const void* jlo, const void* jhi,
    const void* klo, const void* khi, const void* rbeta_i, const void* rbeta_j,
    const void* rbeta_k, const void* ralpha, const void* rrhs, const void* rkdinv0,
    const void* kdinv1, void* out, int ni, int nj, int nk, int edges, int var7, int chunk,
    double b_h2inv, double a_coef, double t1, double t2, void* stream) {
  if (ilo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_sweep<float>(x, ilo, ihi, jlo, jhi, klo, khi, rbeta_i, rbeta_j, rbeta_k,
                             ralpha, rrhs, rkdinv0, kdinv1, out, ni, nj, nk, edges, var7,
                             chunk, b_h2inv, a_coef, t1, t2, stream);
}

extern "C" int hpgmg_r1_gsrb2_slab_chunk_f64(
    const void* x, const void* ilo, const void* ihi, const void* jlo, const void* jhi,
    const void* klo, const void* khi, const void* rbeta_i, const void* rbeta_j,
    const void* rbeta_k, const void* ralpha, const void* rrhs, const void* rkdinv0,
    const void* kdinv1, void* out, int ni, int nj, int nk, int edges, int var7, int chunk,
    double b_h2inv, double a_coef, double t1, double t2, void* stream) {
  if (ilo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_sweep<double>(x, ilo, ihi, jlo, jhi, klo, khi, rbeta_i, rbeta_j, rbeta_k,
                              ralpha, rrhs, rkdinv0, kdinv1, out, ni, nj, nk, edges, var7,
                              chunk, b_h2inv, a_coef, t1, t2, stream);
}

// bf16 storage (the fields and the ring views; the slabs float), float
// arithmetic, red rounded to bf16 before black reads it: a bfloat16
// solve's K8d
extern "C" int hpgmg_r1_gsrb2_slab_chunk_bf16(
    const void* x, const void* ilo, const void* ihi, const void* jlo, const void* jhi,
    const void* klo, const void* khi, const void* rbeta_i, const void* rbeta_j,
    const void* rbeta_k, const void* ralpha, const void* rrhs, const void* rkdinv0,
    const void* kdinv1, void* out, int ni, int nj, int nk, int edges, int var7, int chunk,
    double b_h2inv, double a_coef, double t1, double t2, void* stream) {
  if (ilo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_sweep<bf16>(x, ilo, ihi, jlo, jhi, klo, khi, rbeta_i, rbeta_j, rbeta_k,
                            ralpha, rrhs, rkdinv0, kdinv1, out, ni, nj, nk, edges, var7,
                            chunk, b_h2inv, a_coef, t1, t2, stream);
}

// K8d with the launcher's chunk rule
extern "C" int hpgmg_r1_gsrb2_slab_f32(const void* x, const void* ilo, const void* ihi,
                                       const void* jlo, const void* jhi, const void* klo,
                                       const void* khi, const void* rbeta_i,
                                       const void* rbeta_j, const void* rbeta_k,
                                       const void* ralpha, const void* rrhs,
                                       const void* rkdinv0, const void* kdinv1, void* out,
                                       int ni, int nj, int nk, int edges, int var7,
                                       double b_h2inv, double a_coef, double t1, double t2,
                                       void* stream) {
  return hpgmg_r1_gsrb2_slab_chunk_f32(x, ilo, ihi, jlo, jhi, klo, khi, rbeta_i, rbeta_j,
                                       rbeta_k, ralpha, rrhs, rkdinv0, kdinv1, out, ni, nj,
                                       nk, edges, var7, 0, b_h2inv, a_coef, t1, t2, stream);
}

extern "C" int hpgmg_r1_gsrb2_slab_f64(const void* x, const void* ilo, const void* ihi,
                                       const void* jlo, const void* jhi, const void* klo,
                                       const void* khi, const void* rbeta_i,
                                       const void* rbeta_j, const void* rbeta_k,
                                       const void* ralpha, const void* rrhs,
                                       const void* rkdinv0, const void* kdinv1, void* out,
                                       int ni, int nj, int nk, int edges, int var7,
                                       double b_h2inv, double a_coef, double t1, double t2,
                                       void* stream) {
  return hpgmg_r1_gsrb2_slab_chunk_f64(x, ilo, ihi, jlo, jhi, klo, khi, rbeta_i, rbeta_j,
                                       rbeta_k, ralpha, rrhs, rkdinv0, kdinv1, out, ni, nj,
                                       nk, edges, var7, 0, b_h2inv, a_coef, t1, t2, stream);
}

extern "C" int hpgmg_r1_gsrb2_slab_bf16(const void* x, const void* ilo, const void* ihi,
                                        const void* jlo, const void* jhi, const void* klo,
                                        const void* khi, const void* rbeta_i,
                                        const void* rbeta_j, const void* rbeta_k,
                                        const void* ralpha, const void* rrhs,
                                        const void* rkdinv0, const void* kdinv1, void* out,
                                        int ni, int nj, int nk, int edges, int var7,
                                        double b_h2inv, double a_coef, double t1, double t2,
                                        void* stream) {
  return hpgmg_r1_gsrb2_slab_chunk_bf16(x, ilo, ihi, jlo, jhi, klo, khi, rbeta_i, rbeta_j,
                                        rbeta_k, ralpha, rrhs, rkdinv0, kdinv1, out, ni, nj,
                                        nk, edges, var7, 0, b_h2inv, a_coef, t1, t2, stream);
}
