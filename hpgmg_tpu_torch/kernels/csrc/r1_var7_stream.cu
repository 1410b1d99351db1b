// K5 and K7b for the var7 body, and K8c for both bodies: the radius-1
// stencils of the fv7pt and fv2 suites (the 7-point variable-coefficient
// flux, operators.7pt.c:52-76 and operators.fv2.c:55-92) on a whole level
// with 2-tap Dirichlet ghosts (K5) or periodic ghosts (K7b, `periodic`),
// and the radius-1 stencil of the fv7pt, fv2 and 27pt suites on one rank's
// local block of a level decomposed over a process grid (K8c, SLAB), its i
// and j ghosts read from four 1-deep halo slabs (and on a block split
// along k its k ghosts from two more, KSLAB), in four modes, one launch a
// call:
//
//   apply     out = A x
//   residual  out = rhs - A x
//   gsrb      out = x + kdinv * (rhs - A x) at the cells of the sweep's
//             colour ((i+j+k) % 2 == parity; kdinv carries the same mask,
//             and local parity is global: K8c's block offsets are even),
//             out = x at the others
//   fres      out = restrict_cell(rhs - A x), an (n/2)^3 field
//
// where, for var7, A x = -b/h^2 * sum over the six faces of beta_f *
// (x_nb - x_c) [+ a * alpha * x_c], summed in r1_ax's order (r1_common.cuh);
// K8c's 27pt body is r1_ax's 27pt one.
//
// Replaces hpgmg_tpu/kernels/stencils_r1.py:_r1_kernel (:364) for the var7
// body, entered through _r1_call (:1041 -> pallas_call :1107) on Dirichlet
// levels and through r1_call_ext (:517 -> :562, its ext mode with
// kperiodic) on periodic ones; and r1_call_slab (:574 -> :645, the same
// body with slab=True, both bodies: K8c). That kernel worked on (bi, bj,
// n) VMEM tiles and read j-padded, split-k coefficient views built for the
// TPU's (8, 128) tiling, and its slab form pl.Element windows; none of
// that is carried over: the face coefficients are the natural face arrays
// (of the level, or of the rank's block). The 27pt body on a whole level
// runs on r1_stream.cu, whose instantiations this source leaves as they
// are.
//
// Layouts (k fastest), for a level or block of ni x nj x nk cells (a whole
// level: ni = nj = nk = n):
//   x, alpha, rhs, kdinv, out   (ni, nj, nk)
//   beta_i (ni+1, nj, nk), beta_j (ni, nj+1, nk), beta_k (ni, nj, nk+1)
//   K8c: ilo, ihi (1, nj, nk): the cells i = -1 and i = ni;
//        jlo, jhi (ni+2, 1, nk): the cells j = -1 and j = nj at i = -1 ..
//        ni (the i-extended strips: the (i, j) edge ghosts arrive with
//        them, in the i-then-j order of the separable fills);
//        KSLAB: klo, khi (ni+2, nj+2, 1): the cells k = -1 and k = nk at
//        i = -1 .. ni, j = -1 .. nj (cut from the i- and j-extended block)
// On a block whole along k, a K8c k ghost is the 2-tap Dirichlet one over
// the two nearest ij values, or the wrapped cell (periodic); on a block
// split along k (KSLAB) it is the k slab's cell (the neighbour's, the wrap
// or the Dirichlet fill).
//
// What bounds it on an H100: device-memory bandwidth. A var7 gsrb reads x,
// three face arrays, rhs and kdinv and writes out: 7 values, 28 B a cell
// in f32, against ~21 flops at half the cells, far below the card's f32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/B). The tile kernel this
// replaced (8 x 8 x 32 tiles in shared memory) filled its tile with a
// div/mod pair, three range tests and a branchy ghost a value, read x
// 1.66x over, overlapped no load with its barrier, read the six faces one
// dependent load after another, and computed a gsrb at every cell.
//
// Design: r1_stream.cu's column. A block owns a TJ x TK column of (j, k) (k
// fastest) and marches a chunk of i-planes. Each x plane arrives with its
// 1-cell (j, k) halo by cp.async in a ring of kV7Ring slots, one commit
// group and one __syncthreads a plane, kV7Ring - 2 planes in flight while
// a plane computes; a thread's copies of a plane are fixed for the block.
// Each thread owns two neighbouring k cells of a row and keeps a register
// window over planes i-1, i, i+1: var7 reads only the face neighbours, so
// a plane step reads 8 values of the newest plane (the cross: row j at
// kb-1 .. kb+2, rows j-1 and j+1 at kb, kb+1) into the role of the plane
// it drops (the 27pt body: its 12). What a stencil reads from device memory
// (var7: the faces beta_k at kb .. kb+2, beta_j at rows j, j+1, beta_i at
// plane i+1; alpha; rhs; kdinv) is read into registers a plane ahead, at
// the top of the plane step before its barrier, so the loads overlap the
// barrier and the previous plane's stencils; beta_i at plane i+1 stays in
// registers as the next plane's low face, so each beta_i value is read
// once. Ghosts: periodic ones are the wrapped ring copies; Dirichlet ones
// are made in the window from the cells nearest the face (ghost_rows_cols,
// ghost_plane in r1_common.cuh: var7 reads only the face neighbours, for
// which the tensor product of the taps is the single tap); the ring never
// holds a Dirichlet ghost. gsrb computes A x only at the cell of its pair
// with the sweep's colour (a warp holds rows j and j+2, so its threads take
// the same cell and one branch), reads that cell's faces, rhs and kdinv
// only, and copies x at the other cell, which equals x + 0 * r. apply,
// residual and fres compute both cells. fres sums each coarse cell's 8
// residuals (the partner row's pair by a warp shuffle, the next plane's in
// the same register) and writes (n/2)^3. Levels too small to fill the card
// with columns split i into chunks; the launcher picks the chunk of at
// most kV7MaxChunk planes whose waves of co-resident blocks times a
// block's plane steps is least (r1_gsrb2.cu's rule), so a small level's
// blocks fit one wave. Any chunk gives the same bits. In float64 a block
// holds one SM's registers, which costs it up to 7% against the tile
// kernel it replaced on levels of 256^3 cells and more (PERF.md).
//
// K8c is the same kernel (SLAB): an x plane with i < 0 or i >= ni is the
// slab ilo or ihi, a halo row with j < 0 or j >= nj a row of the strip jlo
// or jhi (a copy's source in the top bits of its offset), the coefficients
// the rank's natural face arrays; only k ghosts are made (Dirichlet) or
// copied (periodic), or with KSLAB copied from the k slabs: a halo column
// k = -1 or nk of x plane q is klo's or khi's cell ((q+1) (nj+2) + j+1),
// so the window holds no made ghost at all.
// bfloat16 (a bf16 solve: K5 and K7b on a whole level, K8c on a rank's
// block): the ring holds float, so the window, the ghosts and the
// arithmetic are the float kernel's. K8c's slabs are float (the exchange
// widens them, and a Dirichlet domain face's ghost is kept as float, as a
// whole level's is made), copied as they are. cp.async cannot widen, so
// each bf16 x value's aligned 32-bit word lands in the value's float slot,
// and the thread that copied it widens the slot in place, taking the half
// its source index names (wrapped or not), once its copies of the plane
// have arrived and before the barrier that publishes the plane
// (stream.cuh: cp_async_value, widen_ring_plane; K8c's x copies only,
// widen_value); staging x through registers instead would have left
// each plane's load latency in the open. The faces, rhs, kdinv and alpha are
// read a plane ahead by 16-bit loads, or 32-bit ones for an aligned pair
// (ldv, load2), widened as they are read; each output is rounded to bf16
// once (narrow, store2). Half the bytes, but not faster: on an H100 80GB
// HBM3 at 700 W the 512^3 gsrb ran 1.46 ms against 1.34 ms in float32 in
// turns, its apply 2.34 against 1.11 (bench/stencil_times.py --r1). The
// widening as read makes each plane step wait for its loads before the
// barrier: a build that kept the operands as loaded and widened them
// where the stencil uses them ran the apply 0.96 ms and the gsrb 1.04
// (PERF.md; not taken here).
// Plain versions: hpgmg_tpu_torch/kernels/stencils_r1.py:r1_stencil_plain,
// r1_slab_plain.

#include "r1_common.cuh"
#include "stream.cuh"

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kV7Threads = 256;
// column tile (j, k) per block: TK / 2 pairs a row, two rows a warp
constexpr int V7TJ = 16;
constexpr int V7TK = 32;
static_assert(V7TJ * V7TK / 2 == kV7Threads && V7TK == 32, "two rows a warp");
// ring slots of x planes: the plane read next and kV7Ring - 2 in flight
// behind the one a plane step waits for
constexpr int kV7Ring = 5;
// blocks an SM must hold (the register cap of __launch_bounds__): the var7
// body's two operand sets and 3-plane window need 102-118 registers in f32
// and 158-200 in f64; at 3 and 2 blocks an SM they spilled 8-292 bytes and
// ran up to 1.8x slower (PERF.md)
template <typename T, bool VAR7>
constexpr int kV7Blocks = sizeof(T) == 4 ? (VAR7 ? 2 : 3) : (VAR7 ? 1 : 2);
// the plane steps a chunk of c i-planes costs beyond c: its two halo
// planes (the launcher's chunk rule), and the longest chunk the rule takes
// (at 512^3, one 512-plane chunk ran 2-4% behind chunks of 64)
constexpr int kV7Fill = 2;
constexpr int kV7MaxChunk = 64;

constexpr int VXP = V7TK + 2;             // x plane pitch (even: paired reads)
constexpr int VXPLANE = (V7TJ + 2) * VXP;  // the tile and its 1-cell halo
constexpr int kVXE = (VXPLANE + kV7Threads - 1) / kV7Threads;  // copies a thread
constexpr unsigned kVNoCopy = ~0u;
// K8c: a copy's source (x or a slab plane, the jlo strip, the jhi strip,
// the klo slab, the khi slab) in the top bits of its offset
constexpr int kSrcShift = 29;
constexpr unsigned kOffMask = (1u << kSrcShift) - 1;

// S: the storage type of every field, T = Wide<S> the arithmetic's and
// the slabs'
template <typename S, typename T = Wide<S>>
struct V7Args {
  const S* x;
  const T* ilo;  // K8c: the slabs; a whole level: null
  const T* ihi;
  const T* jlo;
  const T* jhi;
  const T* klo;  // K8c on a block split along k (KSLAB); null otherwise
  const T* khi;
  const S* beta_i;  // var7 only
  const S* beta_j;
  const S* beta_k;
  const S* alpha;   // var7 with a*alpha*x; nullptr otherwise
  const S* rhs;
  const S* kdinv;   // gsrb: the half's parity-folded dinv
  S* out;
  int ni, nj, nk;
  T b_h2inv;  // b / h^2
  T a_coef;   // var7: a (with alpha); 27pt: the constant a of a*x
  T t1, t2;   // Dirichlet ghost taps
  int periodic;  // ghosts wrap (K8c: k only; i and j come in the slabs)
  int vec;    // nk even and every array pair-aligned: paired loads and stores
};

// What the stencils of a thread's pair read from device memory at one
// plane. apply, residual, fres: both cells (bi: beta_i at plane i+1, the
// high faces; bj rows j and j+1; bk at kb, kb+1, kb+2; r: rhs). gsrb: the
// colour's cell c only (bi: beta_i at planes i and i+1; bj[0] rows j,
// j+1; bk at c, c+1; r: rhs, kdinv).
template <typename T, bool VAR7>
struct V7Ops {
  T bi[VAR7 ? 2 : 1];
  T bj[VAR7 ? 2 : 1][2];
  T bk[VAR7 ? 3 : 1];
  T al[VAR7 ? 2 : 1];
  T r[2];
};

// A x of the var7 body at a cell from its centre, its six neighbours (i+1,
// i-1, j+1, j-1, k+1, k-1) and its faces (high then low along i, j, k), in
// r1_ax's order
template <typename T>
__device__ __forceinline__ T ax7(T xc, T xu, T xd, T xs, T xn, T xe, T xw, T bih, T bil,
                                 T bjh, T bjl, T bkh, T bkl, T b_h2inv) {
  const T lap = bih * (xu - xc) + bil * (xd - xc) + bjh * (xs - xc) + bjl * (xn - xc) +
                bkh * (xe - xc) + bkl * (xw - xc);
  return -b_h2inv * lap;
}

// One block: the TJ x TK column (blockIdx.x) over the i-planes of chunk
// blockIdx.y. S: the storage type of the fields, T = Wide<S> the ring's
// and the arithmetic's.
template <typename S, int MODE, bool VAR7, bool SLAB, bool KSLAB, typename T = Wide<S>>
__global__ void __launch_bounds__(kV7Threads, kV7Blocks<T, VAR7>)
    r1_v7_kernel(const V7Args<S> p, int parity, int chunk) {
  static_assert(SLAB || !KSLAB, "k slabs come with the i/j slabs");
  __shared__ __align__(16) T ring[kV7Ring * VXPLANE];

  const int ni = p.ni, nj = p.nj, nk = p.nk;
  const bool periodic = p.periodic != 0;
  const T t1 = p.t1, t2 = p.t2;
  const int tiles_k = (nk + V7TK - 1) / V7TK;
  const int j0 = static_cast<int>(blockIdx.x / tiles_k) * V7TJ;
  const int k0 = static_cast<int>(blockIdx.x % tiles_k) * V7TK;
  const int ia = blockIdx.y * chunk;
  const int ib = min(ia + chunk, ni);
  const int64_t plane = static_cast<int64_t>(nj) * nk;

  // this thread's copies of a plane: halo positions t (row t / VXP, column
  // t % VXP of the slot), their offsets in their source. A whole periodic
  // level: the cells mod n; K8c: k mod nk (periodic) and the strips for
  // the rows j < 0, j >= nj, or with KSLAB the k slabs for the columns
  // k = -1, nk; Dirichlet: cells only (k ghosts, and a whole level's j
  // ghosts, are made in the window). Positions beyond the ragged edge are
  // read only by discarded results and are not copied.
  unsigned goff[kVXE];
#pragma unroll
  for (int e = 0; e < kVXE; ++e) {
    const int t = threadIdx.x + e * kV7Threads;
    const int j = j0 - 1 + t / VXP, k = k0 - 1 + t % VXP;
    const int kw = k < 0 ? k + nk : (k == nk ? 0 : k);
    unsigned g = kVNoCopy;
    if (KSLAB && t < VXPLANE && (k < 0 || k == nk) && j <= nj) {
      g = ((k < 0 ? 3u : 4u) << kSrcShift) | static_cast<unsigned>(j + 1);
    } else if (t < VXPLANE && k <= nk && (periodic || kw == k)) {
      if constexpr (SLAB) {
        if (j < 0) {
          g = (1u << kSrcShift) | static_cast<unsigned>(kw);
        } else if (j == nj) {
          g = (2u << kSrcShift) | static_cast<unsigned>(kw);
        } else if (j < nj) {
          g = static_cast<unsigned>(j * nk + kw);
        }
      } else if (j <= nj && (periodic || (j >= 0 && j < nj))) {
        g = static_cast<unsigned>(j < 0 ? j + nj : (j == nj ? 0 : j)) * nk + kw;
      }
    }
    goff[e] = g;
  }
  // x plane q (the chunk reads planes ia-1 .. ib) into ring slot s; a
  // commit group whether or not it copies anything, so that every plane
  // step waits for the same count. A bf16 x lands as its values' words
  // (cp_async_value), which widen_plane turns into floats once this
  // thread's copies of the plane have arrived, before the barrier that
  // publishes it; K8c's slabs are in the ring's type.
  const S* const xend = p.x + static_cast<int64_t>(ni) * plane;
  // K8c: the slab cells of a copy of plane q from source src (1, 2: the
  // strips jlo, jhi; 3, 4: the k slabs klo, khi; 0: the slab ilo or ihi
  // of a plane q < 0 or q >= ni), offset 0
  auto slab_at = [&](unsigned src, int q) -> const T* {
    if (src == 0) return q < 0 ? p.ilo : p.ihi;
    if (src <= 2) return (src == 1 ? p.jlo : p.jhi) + static_cast<int64_t>(q + 1) * nk;
    return (src == 3 ? p.klo : p.khi) + static_cast<int64_t>(q + 1) * (nj + 2);
  };
  auto load_plane = [&](int q, int s) {
    if (q <= ib) {
      T* dst = ring + s * VXPLANE + threadIdx.x;
      if constexpr (SLAB) {
        const bool inx = q >= 0 && q < ni;
        const S* xq = p.x + q * plane;
#pragma unroll
        for (int e = 0; e < kVXE; ++e) {
          const unsigned g = goff[e];
          if (g == kVNoCopy) continue;
          const unsigned src = g >> kSrcShift;
          if (src == 0 && inx) {
            cp_async_value(dst + e * kV7Threads, xq + (g & kOffMask), xend);
          } else {
            cp_async(dst + e * kV7Threads, slab_at(src, q) + (g & kOffMask));
          }
        }
      } else {
        const int pq = q < 0 ? q + ni : (q >= ni ? q - ni : q);
        if (periodic || pq == q) {
#pragma unroll
          for (int e = 0; e < kVXE; ++e) {
            if (goff[e] != kVNoCopy)
              cp_async_value(dst + e * kV7Threads, p.x + pq * plane + goff[e], xend);
          }
        }
      }
    }
    cp_async_commit();
  };
  auto widen_plane = [&](int q, int s) {
    if constexpr (!SLAB) {
      const int pq = q < 0 ? q + ni : (q >= ni ? q - ni : q);
      if (q <= ib && (periodic || pq == q))
        widen_ring_plane<kVXE, kV7Threads>(ring + s * VXPLANE + threadIdx.x, p.x + pq * plane,
                                           goff, kVNoCopy);
    } else if constexpr (!std::is_same_v<S, T>) {
      // K8c: the copies from x (the slabs' are in the ring's type)
      if (q >= 0 && q < ni && q <= ib) {
        T* dst = ring + s * VXPLANE + threadIdx.x;
#pragma unroll
        for (int e = 0; e < kVXE; ++e) {
          const unsigned g = goff[e];
          if (g != kVNoCopy && (g >> kSrcShift) == 0)
            widen_value(dst + e * kV7Threads, p.x + q * plane + g);
        }
      }
    }
  };

  // thread: row jl, pair pl (cells kb = k0 + 2 pl and kb + 1). A warp
  // holds two rows: j and j+1 (fres pairs them by shuffle), or in a gsrb j
  // and j+2, whose cells of the sweep's colour lie at the same place of
  // their pairs, so that the warp takes one branch
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int jl = MODE == kGsrb ? 4 * (wp >> 1) + (wp & 1) + 2 * (lane >> 4)
                               : threadIdx.x / (V7TK / 2);
  const int pl = lane & (V7TK / 2 - 1);
  const int j = j0 + jl, kb = k0 + 2 * pl;
  const bool pair_in = j < nj && kb < nk;
  const bool vec = p.vec != 0;
  const bool has_hi = kb + 1 < nk;
  // Dirichlet ghosts made in the window: a whole level's j and k ghosts,
  // K8c's k ghosts (its i/j ghosts are slab cells; KSLAB: its k ghosts too)
  Faces f{false, false, false, -1};
  if (!periodic && !KSLAB) {
    f = {!SLAB && j == 0, !SLAB && j == nj - 1, kb == 0,
         kb == nk - 2 ? 3 : (kb == nk - 1 ? 2 : -1)};
  }
  const bool face = f.jlo || f.jhi || f.klo || f.khi >= 0;
  // a whole Dirichlet level makes its ghost planes i = -1 and i = n
  const bool ghost_planes = !SLAB && !periodic;
  auto read = [&](Rows<T>& w, int s) {
    const T* src = ring + s * VXPLANE + jl * VXP + 2 * pl;
    if constexpr (VAR7) {
      w[0][1] = src[1];
      w[0][2] = src[2];
      lds2(src + VXP, w[1][0], w[1][1]);
      lds2(src + VXP + 2, w[1][2], w[1][3]);
      w[2][1] = src[2 * VXP + 1];
      w[2][2] = src[2 * VXP + 2];
    } else {
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        lds2(src + r * VXP, w[r][0], w[r][1]);
        lds2(src + r * VXP + 2, w[r][2], w[r][3]);
      }
    }
    if (face) ghost_rows_cols(w, f, t1, t2);
  };

  // this thread's operands at plane i (see V7Ops), when its pair is in
  using Ops = V7Ops<T, VAR7>;
  const bool has_alpha = VAR7 && p.alpha != nullptr;
  auto fetch = [&](int i, Ops& o) {
    if (!pair_in) return;
    const int64_t c = (static_cast<int64_t>(i) * nj + j) * nk + kb;
    const int64_t cj = (static_cast<int64_t>(i) * (nj + 1) + j) * nk + kb;
    const int64_t ck = (static_cast<int64_t>(i) * nj + j) * (nk + 1) + kb;
    if constexpr (MODE == kGsrb) {
      const int q = (parity + i + j) & 1;
      if (kb + q >= nk) return;
      o.r[0] = ldv<T>(p.rhs + c + q);
      o.r[1] = ldv<T>(p.kdinv + c + q);
      if constexpr (VAR7) {
        o.bi[0] = ldv<T>(p.beta_i + c + q);
        o.bi[1] = ldv<T>(p.beta_i + c + plane + q);
        o.bj[0][0] = ldv<T>(p.beta_j + cj + q);
        o.bj[0][1] = ldv<T>(p.beta_j + cj + nk + q);
        o.bk[0] = ldv<T>(p.beta_k + ck + q);
        o.bk[1] = ldv<T>(p.beta_k + ck + q + 1);
        if (has_alpha) o.al[0] = ldv<T>(p.alpha + c + q);
      }
    } else {
      // two neighbouring values at c + d of a (ni, nj, nk)-shaped or face
      // array: one paired load where vec, else each one in the domain
      auto pair = [&](const S* a, int64_t d, T& lo, T& hi) {
        if (vec) {
          load2(a + d, lo, hi);
        } else {
          lo = ldv<T>(a + d);
          if (has_hi) hi = ldv<T>(a + d + 1);
        }
      };
      if (MODE != kApply) pair(p.rhs, c, o.r[0], o.r[1]);
      if constexpr (VAR7) {
        pair(p.beta_i, c + plane, o.bi[0], o.bi[1]);
        pair(p.beta_j, cj, o.bj[0][0], o.bj[0][1]);
        pair(p.beta_j, cj + nk, o.bj[1][0], o.bj[1][1]);
        o.bk[0] = ldv<T>(p.beta_k + ck);
        o.bk[1] = ldv<T>(p.beta_k + ck + 1);
        if (has_hi) o.bk[2] = ldv<T>(p.beta_k + ck + 2);
        if (has_alpha) pair(p.alpha, c, o.al[0], o.al[1]);
      }
    }
  };

  // the window: three planes, each in turn i-1, i and i+1 (the plane
  // steps rotate their roles, so that no value moves); the operands by the
  // same roles (plane i+1's arrive during plane i)
  T w[3][3][4];
  Ops ops[3];
  // ring slots: plane ia-1+s in slot s for the first kV7Ring planes, then
  // plane q in the slot plane q - kV7Ring left
#pragma unroll
  for (int s = 0; s < kV7Ring; ++s) load_plane(ia - 1 + s, s);
  fetch(ia, ops[1]);
  // the low i faces of plane ia's pair (each later plane's are the high
  // faces of the plane before it)
  T bil[2] = {};
  if (VAR7 && MODE != kGsrb && pair_in) {
    const int64_t c = (static_cast<int64_t>(ia) * nj + j) * nk + kb;
    if (vec) {
      load2(p.beta_i + c, bil[0], bil[1]);
    } else {
      bil[0] = ldv<T>(p.beta_i + c);
      if (has_hi) bil[1] = ldv<T>(p.beta_i + c + 1);
    }
  }
  cp_async_wait<kV7Ring - 2>();  // planes ia-1 and ia
  widen_plane(ia - 1, 0);
  widen_plane(ia, 1);
  __syncthreads();
  // plane -1 of a whole Dirichlet level is a ghost, made once plane 1 is
  // read
  if (!ghost_planes || ia > 0) read(w[0], 0);
  read(w[1], 1);
  int slot = 2;  // of plane i+1
  T sum = T(0);  // fres: the coarse cell's running sum (even rows)

  // plane i, with w[A], w[B], w[C] holding planes i-1, i, i+1 (C is read
  // here) and ops[B] plane i's operands (ops[C] takes plane i+1's)
  auto step = [&](int i, auto A, auto B, auto C) {
    constexpr int a = decltype(A)::value, b = decltype(B)::value, c = decltype(C)::value;
    if (i + 1 < ib) fetch(i + 1, ops[c]);
    // plane i+1 has arrived (kV7Ring - 3 newer groups may be in flight)
    cp_async_wait<kV7Ring - 3>();
    widen_plane(i + 1, slot);
    __syncthreads();
    if (ghost_planes && i + 1 == ni) {
      ghost_plane(w[c], w[b], w[a], t1, t2);
    } else {
      read(w[c], slot);
    }
    // every thread has read the slot of plane i-1 (before this barrier):
    // plane i-1+kV7Ring takes it
    load_plane(i - 1 + kV7Ring, slot == 0 ? kV7Ring - 2 : (slot == 1 ? kV7Ring - 1 : slot - 2));
    slot = ring_add(slot, 1, kV7Ring);
    if (ghost_planes && i == 0) ghost_plane(w[a], w[b], w[c], t1, t2);
    const Ops& o = ops[b];

    // A x at cell kb + D of the pair
    auto ax = [&](auto Dc) -> T {
      constexpr int D = decltype(Dc)::value;
      const T xc = w[b][1][1 + D];
      if constexpr (VAR7) {
        T v;
        if constexpr (MODE == kGsrb) {
          v = ax7(xc, w[c][1][1 + D], w[a][1][1 + D], w[b][2][1 + D], w[b][0][1 + D],
                  w[b][1][2 + D], w[b][1][D], o.bi[1], o.bi[0], o.bj[0][1], o.bj[0][0],
                  o.bk[1], o.bk[0], p.b_h2inv);
          if (has_alpha) v = p.a_coef * o.al[0] * xc + v;
        } else {
          v = ax7(xc, w[c][1][1 + D], w[a][1][1 + D], w[b][2][1 + D], w[b][0][1 + D],
                  w[b][1][2 + D], w[b][1][D], o.bi[D], bil[D], o.bj[1][D], o.bj[0][D],
                  o.bk[D + 1], o.bk[D], p.b_h2inv);
          if (has_alpha) v = p.a_coef * o.al[D] * xc + v;
        }
        return v;
      } else {
        auto X = [&](int di, int dj, int dk) -> T {
          return w[di < 0 ? a : (di == 0 ? b : c)][dj + 1][dk + 1 + D];
        };
        return r1_ax<T, false>(nullptr, nullptr, nullptr, nullptr, p.b_h2inv, p.a_coef, X,
                               R1Index{});
      }
    };
    using D0 = std::integral_constant<int, 0>;
    using D1 = std::integral_constant<int, 1>;
    const int64_t row = (static_cast<int64_t>(i) * nj + j) * nk;
    if constexpr (MODE == kGsrb) {
      if (pair_in) {
        // the sweep's colour: cell kb + q, the same q across the warp
        const int q = (parity + i + j) & 1;
        if (q) {
          const T v = w[b][1][2] + o.r[1] * (o.r[0] - ax(D1{}));
          store_pair(p.out, row + kb, w[b][1][1], v, vec, has_hi);
        } else {
          const T v = w[b][1][1] + o.r[1] * (o.r[0] - ax(D0{}));
          store_pair(p.out, row + kb, v, w[b][1][2], vec, has_hi);
        }
      }
    } else {
      const T ax0 = ax(D0{});
      const T ax1 = ax(D1{});
      if constexpr (VAR7) {
        bil[0] = o.bi[0];
        bil[1] = o.bi[1];
      }
      T lo, hi;
      if constexpr (MODE == kApply) {
        lo = ax0;
        hi = ax1;
      } else {
        lo = o.r[0] - ax0;
        hi = o.r[1] - ax1;
      }
      if constexpr (MODE == kFres) {
        // ni, nj, nk even: rows j, j+1 (lanes l, l+16) and the pair are in
        // or out together; every lane takes part in the shuffles
        const T plo = __shfl_down_sync(0xffffffffu, lo, 16);
        const T phi = __shfl_down_sync(0xffffffffu, hi, 16);
        if ((i & 1) == 0) sum = T(0);
        sum += lo;
        sum += hi;
        sum += plo;
        sum += phi;
        if ((i & 1) && (jl & 1) == 0 && pair_in) {
          p.out[(static_cast<int64_t>(i / 2) * (nj / 2) + j / 2) * (nk / 2) + kb / 2] =
              narrow<S>(T(0.125) * sum);
        }
      } else if (pair_in) {
        store_pair(p.out, row + kb, lo, hi, vec, has_hi);
      }
    }
  };
  using I0 = std::integral_constant<int, 0>;
  using I1 = std::integral_constant<int, 1>;
  using I2 = std::integral_constant<int, 2>;
  for (int i = ia; i < ib; i += 3) {
    step(i, I0{}, I1{}, I2{});
    if (i + 1 < ib) step(i + 1, I1{}, I2{}, I0{});
    if (i + 2 < ib) step(i + 2, I2{}, I0{}, I1{});
  }
}

template <typename S, int MODE, bool VAR7, bool SLAB, bool KSLAB>
int launch_mode(const V7Args<S>& p, int parity, int chunk, cudaStream_t s) {
  auto kernel = r1_v7_kernel<S, MODE, VAR7, SLAB, KSLAB>;
  const int64_t tiles =
      static_cast<int64_t>((p.nj + V7TJ - 1) / V7TJ) * ((p.nk + V7TK - 1) / V7TK);
  // fres: a coarse cell's two planes in one chunk
  const int step = MODE == kFres ? 2 : 1;
  if (chunk <= 0) {
    // co-resident blocks on the card (queried once)
    static const int64_t slots = [&]() -> int64_t {
      int dev = 0, sms = 0, per_sm = 0;
      if (cudaGetDevice(&dev) != cudaSuccess ||
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kV7Threads, 0) !=
              cudaSuccess)
        return 0;
      return static_cast<int64_t>(sms) * per_sm;
    }();
    if (slots <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    // the chunk whose waves of co-resident blocks times the plane steps a
    // block takes is least (the largest of equals: fewer blocks); a
    // partial wave costs a whole one
    int64_t best = INT64_MAX;
    for (int c = min(p.ni + step - 1, kV7MaxChunk) / step * step; c >= step; c -= step) {
      const int64_t blocks = tiles * ((p.ni + c - 1) / c);
      const int64_t cost = (blocks + slots - 1) / slots * (c + kV7Fill);
      if (cost < best) {
        best = cost;
        chunk = c;
      }
    }
  }
  if (chunk > p.ni) chunk = p.ni;
  if (chunk % step) chunk += step - chunk % step;
  const int chunks = (p.ni + chunk - 1) / chunk;
  if (tiles > INT_MAX || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(static_cast<unsigned>(tiles), chunks), kV7Threads, 0, s>>>(p, parity,
                                                                          chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, bool VAR7, bool SLAB, bool KSLAB = false>
int launch_body(const V7Args<S>& p, int mode, int parity, int chunk, cudaStream_t s) {
  switch (mode) {
    case kApply: return launch_mode<S, kApply, VAR7, SLAB, KSLAB>(p, parity, chunk, s);
    case kResidual: return launch_mode<S, kResidual, VAR7, SLAB, KSLAB>(p, parity, chunk, s);
    case kGsrb: return launch_mode<S, kGsrb, VAR7, SLAB, KSLAB>(p, parity, chunk, s);
    default: return launch_mode<S, kFres, VAR7, SLAB, KSLAB>(p, parity, chunk, s);
  }
}

template <typename T>
bool pair_ok(const void* a) {
  return a == nullptr || (reinterpret_cast<uintptr_t>(a) & (2 * sizeof(T) - 1)) == 0;
}

// S: the storage type (a whole level or K8c's block alike)
template <typename S>
int launch_v7(const void* x, const void* ilo, const void* ihi, const void* jlo,
              const void* jhi, const void* klo, const void* khi, const void* beta_i,
              const void* beta_j, const void* beta_k, const void* alpha, const void* rhs,
              const void* kdinv, void* out, int ni, int nj, int nk, int mode, int var7,
              int periodic, int parity, int chunk, double b_h2inv, double a_coef, double t1,
              double t2, void* stream) {
  const bool slab = ilo != nullptr, kslab = klo != nullptr;
  if (ni < 2 || nj < 2 || nk < 2 || mode < kApply || mode > kFres ||
      (kslab && (!slab || khi == nullptr)) ||
      (mode == kFres && (ni % 2 || nj % 2 || nk % 2)) || parity < 0 || parity > 1 ||
      chunk < 0 || (!slab && (!var7 || ni != nj || ni != nk)) ||
      static_cast<int64_t>(nj) * nk > static_cast<int64_t>(kOffMask) || x == nullptr ||
      out == nullptr || (mode != kApply && rhs == nullptr) ||
      (mode == kGsrb && kdinv == nullptr) ||
      (slab && (ihi == nullptr || jlo == nullptr || jhi == nullptr)) ||
      (var7 && (beta_i == nullptr || beta_j == nullptr || beta_k == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using T = Wide<S>;
  V7Args<S> p{};
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
  p.kdinv = static_cast<const S*>(kdinv);
  p.out = static_cast<S*>(out);
  p.ni = ni;
  p.nj = nj;
  p.nk = nk;
  p.b_h2inv = static_cast<T>(b_h2inv);
  p.a_coef = static_cast<T>(a_coef);
  p.t1 = static_cast<T>(t1);
  p.t2 = static_cast<T>(t2);
  p.periodic = periodic != 0;
  p.vec = nk % 2 == 0 && pair_ok<S>(x) && pair_ok<S>(beta_i) && pair_ok<S>(beta_j) &&
          pair_ok<S>(alpha) && pair_ok<S>(rhs) && pair_ok<S>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!slab) return launch_body<S, true, false>(p, mode, parity, chunk, s);
  if (kslab) {
    return var7 ? launch_body<S, true, true, true>(p, mode, parity, chunk, s)
                : launch_body<S, false, true, true>(p, mode, parity, chunk, s);
  }
  return var7 ? launch_body<S, true, true>(p, mode, parity, chunk, s)
              : launch_body<S, false, true>(p, mode, parity, chunk, s);
}

}  // namespace

// K5 / K7b, the var7 body on a whole n^3 level: beta_* read, alpha may be
// null (no a*alpha*x); mode 0 apply, 1 residual, 2 gsrb, 3 fres; periodic
// != 0: wrapped ghosts (t1, t2 unused); parity: the colour gsrb updates;
// chunk: i-planes per block (0: the launcher's rule)
extern "C" int hpgmg_r1_var7_f32(const void* x, const void* beta_i, const void* beta_j,
                                 const void* beta_k, const void* alpha, const void* rhs,
                                 const void* kdinv, void* out, int n, int mode, int periodic,
                                 int parity, int chunk, double b_h2inv, double a_coef,
                                 double t1, double t2, void* stream) {
  return launch_v7<float>(x, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, beta_i,
                          beta_j, beta_k, alpha, rhs, kdinv, out, n, n, n, mode, 1, periodic,
                          parity, chunk, b_h2inv, a_coef, t1, t2, stream);
}

extern "C" int hpgmg_r1_var7_f64(const void* x, const void* beta_i, const void* beta_j,
                                 const void* beta_k, const void* alpha, const void* rhs,
                                 const void* kdinv, void* out, int n, int mode, int periodic,
                                 int parity, int chunk, double b_h2inv, double a_coef,
                                 double t1, double t2, void* stream) {
  return launch_v7<double>(x, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, beta_i,
                           beta_j, beta_k, alpha, rhs, kdinv, out, n, n, n, mode, 1, periodic,
                           parity, chunk, b_h2inv, a_coef, t1, t2, stream);
}

// bf16 storage, float arithmetic: a bfloat16 solve's var7 body
extern "C" int hpgmg_r1_var7_bf16(const void* x, const void* beta_i, const void* beta_j,
                                  const void* beta_k, const void* alpha, const void* rhs,
                                  const void* kdinv, void* out, int n, int mode, int periodic,
                                  int parity, int chunk, double b_h2inv, double a_coef,
                                  double t1, double t2, void* stream) {
  return launch_v7<bf16>(x, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, beta_i,
                         beta_j, beta_k, alpha, rhs, kdinv, out, n, n, n, mode, 1, periodic,
                         parity, chunk, b_h2inv, a_coef, t1, t2, stream);
}

// K8c. var7 != 0: the 7-point body (beta_* read; alpha may be null); else
// the 27pt body (a_coef the constant a). klo, khi: the k slabs of a block
// split along k (null: k ghosts made, or wrapped where periodic != 0);
// parity and chunk as above
extern "C" int hpgmg_r1_slab_f32(const void* x, const void* ilo, const void* ihi,
                                 const void* jlo, const void* jhi, const void* klo,
                                 const void* khi, const void* beta_i, const void* beta_j,
                                 const void* beta_k, const void* alpha, const void* rhs,
                                 const void* kdinv, void* out, int ni, int nj, int nk,
                                 int mode, int var7, int periodic, int parity, int chunk,
                                 double b_h2inv, double a_coef, double t1, double t2,
                                 void* stream) {
  if (ilo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_v7<float>(x, ilo, ihi, jlo, jhi, klo, khi, beta_i, beta_j, beta_k, alpha,
                          rhs, kdinv, out, ni, nj, nk, mode, var7, periodic, parity, chunk,
                          b_h2inv, a_coef, t1, t2, stream);
}

extern "C" int hpgmg_r1_slab_f64(const void* x, const void* ilo, const void* ihi,
                                 const void* jlo, const void* jhi, const void* klo,
                                 const void* khi, const void* beta_i, const void* beta_j,
                                 const void* beta_k, const void* alpha, const void* rhs,
                                 const void* kdinv, void* out, int ni, int nj, int nk,
                                 int mode, int var7, int periodic, int parity, int chunk,
                                 double b_h2inv, double a_coef, double t1, double t2,
                                 void* stream) {
  if (ilo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_v7<double>(x, ilo, ihi, jlo, jhi, klo, khi, beta_i, beta_j, beta_k, alpha,
                           rhs, kdinv, out, ni, nj, nk, mode, var7, periodic, parity, chunk,
                           b_h2inv, a_coef, t1, t2, stream);
}

// bf16 storage (the fields; the slabs float), float arithmetic: a bfloat16
// solve's K8c
extern "C" int hpgmg_r1_slab_bf16(const void* x, const void* ilo, const void* ihi,
                                  const void* jlo, const void* jhi, const void* klo,
                                  const void* khi, const void* beta_i, const void* beta_j,
                                  const void* beta_k, const void* alpha, const void* rhs,
                                  const void* kdinv, void* out, int ni, int nj, int nk,
                                  int mode, int var7, int periodic, int parity, int chunk,
                                  double b_h2inv, double a_coef, double t1, double t2,
                                  void* stream) {
  if (ilo == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_v7<bf16>(x, ilo, ihi, jlo, jhi, klo, khi, beta_i, beta_j, beta_k, alpha,
                         rhs, kdinv, out, ni, nj, nk, mode, var7, periodic, parity, chunk,
                         b_h2inv, a_coef, t1, t2, stream);
}
