// K1 and K7a: the 4th-order variable-coefficient finite-volume operator
// (fv4, operators.fv4.c:87-114) with quartic volume-averaged Dirichlet
// ghosts (K1) or periodic ghosts (K7a), in four modes, one launch a call:
//
//   apply     out = A x
//   residual  out = rhs - A x
//   gsrb      out = x + kdinv * (rhs - A x) at the cells of the sweep's
//             colour ((i+j+k) % 2 == parity; kdinv carries the same mask),
//             out = x at the others
//   fres      out = restrict_cell(rhs - A x), an (n/2)^3 field
//
// where A x = scale * (main/12 + mixed/48) [+ a * alpha * x], scale = -b/h^2.
//
// Replaces hpgmg_tpu/kernels/stencils.py:_fv4_kernel (:594), entered
// through _fv4_call (:762) on Dirichlet levels and through fv4_call_ext
// (:1106, its ext mode with kperiodic) on periodic ones. That kernel
// worked on (bi, bj, n) VMEM tiles with j-padded, lane-aligned coefficient
// views and rebuilt the k ghosts in lanes; none of that layout is carried
// over. This kernel reads the port's tangentially-extended beta arrays:
// beta_i (n+1, n+2, n+2), beta_j (n+2, n+1, n+2), beta_k (n+2, n+2, n+1),
// indexed as hpgmg_tpu/ops/fv4.py:127-138 slices them; on a periodic level
// they carry their tangential wrap from build time
// (ops/bc_fv.py:extend_beta_tangential) and beta_i's face n is face 0.
//
// What bounds it on an H100: device-memory bandwidth. gsrb reads x, the
// three beta arrays, rhs and kdinv and writes out: 7 values a cell, 28 B
// in f32, against ~113 flops (~4 flop/B, below the card's f32 ridge of
// 20 flop/B). The two-pass design it replaces (a ghost or wrap pass into
// an (n+4)^3 buffer, then a stencil reading x and beta through L1 at ~57
// loads a cell and computing A x at every cell) moved x three more times
// and threw half of a gsrb's A x away.
//
// Design: a block owns a TJ x TK column of (j, k) (k fastest) and marches
// a chunk of i-planes, one __syncthreads a plane. A ring in shared memory
// holds the planes the stencil of plane i reads (5 x planes with a 2-cell
// (j, k) halo, beta_i faces i and i+1, beta_j and beta_k planes i-1 .. i+1)
// and two planes more in flight: cp.async copies, one commit group a
// plane, so that a plane's copies have a whole plane's compute to land.
// So each x and beta value comes from device memory about once per column
// (plus its halo and the chunk's halo planes), and the stencil's 25 x and
// 30 beta reads a cell come from shared memory. A thread's share of a
// plane's copies is fixed for the block (Pairs): two neighbouring k values
// a copy where aligned, their offsets computed once, so a plane costs an
// add and a cp.async a pair; the first version, which recomputed each
// copy's indices and wrapped them every plane, spent most of its time
// issuing copies. cp.async and not TMA: beta's rows of n+1 or n+2 values
// break TMA's 16-byte stride rule, TMA zero-fills and cannot wrap, and the
// Dirichlet ghosts need patching in shared memory either way.
// Ghosts: periodic ones are copies of the cells mod n. A Dirichlet ghost
// (ghost_value's tensor product of the quartic taps, edges included) is
// made from cells of the ring once they have arrived (patch_x), while the
// block computes a plane that does not read it: the (j, k) ghosts of a
// plane two ahead, a ghost plane i >= n three ahead (from planes
// n-4 .. n-1); planes -2, -1 at the chunk's start. The tile's halo frame
// comes first in the pairs' order (x_pair_at), so only the first warps of
// a tile at the domain's edge hold ghosts and call patch_x (out of line:
// inlined, its registers spilled the main loop; one warp making all of a
// plane's ghosts was slower). Tiles too thin for the taps, and ghost
// planes whose taps left the ring, read them from device memory.
// Each thread owns two neighbouring k cells of a row, so exactly one of
// them has the sweep's colour: gsrb computes A x there only (rhs and kdinv
// read there only, a plane ahead into registers) and copies x at the other
// cell, which equals K1's x + 0 * r. Rows j and j+1 of a warp take
// opposite cells of their pairs, so the even plane pitch keeps the shared
// reads free of bank conflicts; apply, residual and fres compute both
// cells in the same two steps. fres sums each coarse cell's 8 residuals in
// K1's order (the partner row's pair by a warp shuffle, the next plane's
// in the same register) and writes (n/2)^3. The arithmetic is
// fv4_combination (fv4_common.cuh) with K1's ghost formula, so on Dirichlet
// levels the result equals K1s (fv4_subtile.cu) bit for bit.
// Levels too small to fill the card with columns split i into chunks (the
// launcher's rule, or the caller's chunk), each reloading its halo planes.
// Float: 128 registers a thread, two blocks an SM (a cap of three spilled
// and ran slower). Double: ~210 registers, one block an SM (at 128 it
// spilled ~400 bytes and ran 1.4x slower).
// bfloat16 (a bf16 solve: every field; BF16C: the face arrays and kdinv of
// a float32 gsrb, the JAX package's kernel_views_bf16 streams): the ring
// holds float, so the arithmetic and the ghosts are the float kernel's;
// cp.async cannot widen, so each bf16 value's 32-bit word lands in its
// float slot and the thread that copied it widens the slot in place once
// its copies have arrived (stream.cuh: cp_async_word, widen_word), before
// the barrier that publishes the plane; rhs and kdinv are widened as they
// are read, each output rounded to bf16 once. Half the bytes, but not
// faster: on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 18) the
// 512^3 gsrb ran 3.02 ms with BF16C and 3.22 ms in bf16 against 2.03 ms
// in float32, the widening in the plane loop the larger part of the gap.
// On a periodic level (K7a in bf16) a wrapped ghost's word is that of the
// cell it copies, and widen_word takes the half that cell's index names
// (not the one the ghost's own position would); its 512^3 gsrb ran
// 2.85 ms against 1.75 ms in float32 in turns (chip_smoke.py phase 19a).
// Plain version: hpgmg_tpu_torch/kernels/stencils.py:fv4_stencil_plain.

#include "fv4_stream.cuh"

namespace {

// Column tile (j, k) per block: TK / 2 pairs a row, so a warp holds two
// rows (fres pairs them by shuffle), kStreamThreads = TJ * TK / 2.
constexpr int kStreamThreads = 256;
constexpr int TJ = 16, TK = 32;
static_assert(TJ * TK / 2 == kStreamThreads && TK == 32, "two rows a warp");
constexpr int XP = TK + 4;            // x plane pitch (even)
constexpr int BP = TK + 2;            // beta plane pitch (even)
constexpr int XPLANE = (TJ + 4) * XP;  // x with its 2-cell halo
constexpr int BIPLANE = (TJ + 2) * BP;
constexpr int BJPLANE = (TJ + 1) * BP;
constexpr int BKPLANE = (TJ + 2) * BP;
// ring slots: what plane i reads, plus two planes in flight (the next
// one's copies may still land while plane i computes)
constexpr int NX = 7, NBI = 4, NBJ = 5;
constexpr int kRingValues = NX * XPLANE + NBI * BIPLANE + NBJ * (BJPLANE + BKPLANE);

// blocks an SM must hold (the register cap of __launch_bounds__): two in
// float (128 registers a thread); one in double, which spilled at 128
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 4 ? 2 : 1;

constexpr int XPAIRS = (TJ + 4) * (XP / 2);
constexpr int kXE = (XPAIRS + kStreamThreads - 1) / kStreamThreads;
constexpr int kBE = ((TJ + 2) * (BP / 2) + kStreamThreads - 1) / kStreamThreads;
// a thread's pair slots: x, then beta_i, beta_j, beta_k
constexpr int kPairSlots = kXE + 3 * kBE;

// Pairs for float in shared memory after the ring (in registers they sat
// idle through the stencil and made it spill), for double in registers
// (its ring leaves no room for them and two blocks an SM)
template <typename T, int E, int FIRST>
using Pairs = std::conditional_t<sizeof(T) == 4,
                                 SmemPairs<E, FIRST, kStreamThreads, kPairSlots>,
                                 RegPairs<E, FIRST>>;
template <typename T>
using XPairs = Pairs<T, kXE, 0>;
// values of shared memory the pairs take after the ring
template <typename T>
constexpr int kPairValues = sizeof(T) == 4 ? 2 * kPairSlots * kStreamThreads : 0;

struct Column {
  int n, j0, k0;
  bool periodic;
  // the tile's halo reaches past the domain in j or k
  bool edge;
  // Dirichlet tile whose ghosts are made from the ring's cells once their
  // planes have arrived (patch_x, patch_jk): a ghost's taps lie in the
  // tile where it holds >= 2 cells a side; other tiles make them at load
  // time
  bool patch;
};

// Position (row a, column b) in the x tile of pair t: first the frame (the
// 2-row halo above and below, then the 2-column halo left and right of the
// tile's rows), then the tile's own TJ x TK cells, so that the (j, k)
// ghosts of a tile inside a large domain's edge lie in the first warps.
constexpr int kFrameRows = 4 * (XP / 2), kFrame = kFrameRows + 2 * TJ;
static_assert(kFrame + TJ * (TK / 2) == XPAIRS, "the frame and the tile");

__device__ __forceinline__ void x_pair_at(int t, int& a, int& b) {
  if (t < kFrameRows) {
    const int r = t / (XP / 2);
    a = r < 2 ? r : TJ + r;
    b = 2 * (t - r * (XP / 2));
  } else if (t < kFrame) {
    const int u = t - kFrameRows;
    a = 2 + u / 2;
    b = (u & 1) ? XP - 2 : 0;
  } else {
    const int u = t - kFrame;
    a = 2 + u / (TK / 2);
    b = 2 + 2 * (u % (TK / 2));
  }
}

// The x pairs of this thread: the tile and its 2-cell halo, two k cells a
// pair (k even). Periodic: the cells mod n. Dirichlet: cells, or (j, k)
// ghosts. Cells beyond n+1 (ragged tiles) are not loaded: only cells
// outside the domain read them.
template <typename T, typename F>
__device__ __forceinline__ void x_pairs(XPairs<T>& P, const F* x, const Column& c) {
  const int n = c.n;
  auto inside = [n](int v) { return v >= 0 && v < n; };
  auto wrap = [n](int v) { return v < 0 ? v + n : (v >= n ? v - n : v); };
#pragma unroll
  for (int e = 0; e < kXE; ++e) {
    const int t = threadIdx.x + e * kStreamThreads;
    int a, b;
    x_pair_at(t, a, b);
    const int j = c.j0 - 2 + a, k = c.k0 - 2 + b;
    unsigned f = 0, g = 0;
    if (t < XPAIRS && j < n + 2 && k < n + 2) {
      f = kE0 | (k + 1 < n + 2 ? kE1 : 0u);
      if (c.periodic) {
        g = static_cast<unsigned>(wrap(j)) * n + wrap(k);
        if (k + 1 == n) f |= kW1;
      } else {
        g = static_cast<unsigned>(inside(j) ? j : 0) * n + (inside(k) ? k : 0);
        if (!(inside(j) && inside(k))) f |= kG0;
        if (!(inside(j) && inside(k + 1))) f |= kG1;
      }
      if ((n & 1) == 0 && (f & (kE1 | kG0 | kG1 | kW1)) == kE1 && pair_aligned(x + g))
        f |= kPair;
    }
    P.set(e, g, static_cast<unsigned>(a * XP + b) << kMetaShift | f);
  }
}

// x plane i (in [-2, n+2)) into the ring plane dst: pairs copied by
// cp.async (a bf16 x as its values' words, stream.cuh: cp_async_word, which
// widen_x turns into floats once this thread's copies have arrived),
// periodic ghosts copied from the cells mod n; Dirichlet ghosts synthesized
// from device memory in a tile that patch_x does not serve (or with
// mem_ghosts), else left to it.
template <typename T, typename F>
__device__ __forceinline__ void load_x(T* dst, const F* __restrict__ x, const Column& c,
                                       const XPairs<T>& P, int i, bool mem_ghosts) {
  constexpr bool same = std::is_same_v<T, F>;
  const int n = c.n;
  const bool in_i = c.periodic || (i >= 0 && i < n);
  const int pi = c.periodic ? (i < 0 ? i + n : (i >= n ? i - n : i)) : i;
  const F* base = x + static_cast<int64_t>(pi) * n * n;
#pragma unroll
  for (int e = 0; e < kXE; ++e) {
    const unsigned m = P.meta(e);
    T* d = dst + (m >> kMetaShift);
    if ((m & kPair) && in_i) {
      if constexpr (same) {
        cp_async2(d, base + P.goff(e));
      } else {
        cp_async_pair(d, base + P.goff(e));
      }
      continue;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!(m & (kE0 << q))) continue;
      if (in_i && !(m & (kG0 << q))) {
        const F* src = base + P.goff(e) + q - ((q && (m & kW1)) ? n : 0);
        if constexpr (same) {
          cp_async(d + q, src);
        } else {
          cp_async_word(d + q, src, x + static_cast<int64_t>(n) * n * n);
        }
      } else if (!c.patch || mem_ghosts) {
        const int off = static_cast<int>(m >> kMetaShift) + q;
        d[q] = ghost_from_memory(x, n, i, c.j0 - 2 + off / XP, c.k0 - 2 + off % XP);
      }
    }
  }
}

// The words load_x copied into the ring plane dst for x plane i, widened
// in place (nothing where x is stored in the ring's type); call once this
// thread's copies of the plane have arrived.
template <typename T, typename F>
__device__ __forceinline__ void widen_x(T* dst, const F* __restrict__ x, const Column& c,
                                        const XPairs<T>& P, int i) {
  if constexpr (!std::is_same_v<T, F>) {
    const int n = c.n;
    if (!(c.periodic || (i >= 0 && i < n))) return;
    const int pi = c.periodic ? (i < 0 ? i + n : (i >= n ? i - n : i)) : i;
    const F* base = x + static_cast<int64_t>(pi) * n * n;
#pragma unroll
    for (int e = 0; e < kXE; ++e) {
      const unsigned m = P.meta(e);
      T* d = dst + (m >> kMetaShift);
      if (m & kPair) {
        widen_pair(d);
        continue;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if ((m & (kE0 << q)) && !(m & (kG0 << q)))
          widen_word(d + q, base + P.goff(e) + q - ((q && (m & kW1)) ? n : 0));
      }
    }
  }
}

// The Dirichlet ghost plane i (outside the domain) of a patched tile, all
// its cells, from the cells of the ring (taps in planes 0..3 or
// n-4..n-1; x plane q lies in slot ring_add(s0, q - q0, NX) for q in
// [q0, q0 + NX)); call once the planes of the taps have arrived and are
// visible to the block. Out of line, so that the registers of the tiles
// that never call it stay the main loop's.
template <typename T>
__device__ __noinline__ void patch_x(T* ring, const Column c, const XPairs<T> P, int i,
                                     int q0, int s0) {
  auto at = [&](int ii, int jj, int kk) -> T {
    return ring[ring_add(s0, ii - q0, NX) * XPLANE + (jj - c.j0 + 2) * XP +
                (kk - c.k0 + 2)];
  };
  T* plane = ring + ring_add(s0, i - q0, NX) * XPLANE;
#pragma unroll
  for (int e = 0; e < kXE; ++e) {
    const unsigned m = P.meta(e);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (m & (kE0 << q)) {
        const int off = static_cast<int>(m >> kMetaShift) + q;
        plane[off] = ghost_taps<T>(at, c.n, i, c.j0 - 2 + off / XP, c.k0 - 2 + off % XP);
      }
    }
  }
}

// The (j, k) ghosts of interior x plane i of a patched tile (at `plane`
// in the ring), held by this thread's pairs: ghost_taps with i inside the
// domain, whose i tap is the cell itself with weight 1, written over j and
// k alone (the same products and sums, so the same bits) so that the call
// stays small. Out of line, as patch_x; call once the plane's copies have
// arrived and are visible to the block.
template <typename T>
__device__ __noinline__ void patch_jk(T* plane, const Column c, const XPairs<T> P) {
#pragma unroll
  for (int e = 0; e < kXE; ++e) {
    const unsigned m = P.meta(e);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!(m & (kE0 << q)) || !(m & (kG0 << q))) continue;
      const int off = static_cast<int>(m >> kMetaShift) + q;
      int jj[4], kk[4];
      T wj[4], wk[4];
      const int nj = axis_taps(c.j0 - 2 + off / XP, c.n, jj, wj);
      const int nk = axis_taps(c.k0 - 2 + off % XP, c.n, kk, wk);
      T s = T(0);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (b >= nj) break;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          if (d >= nk) break;
          s += wj[b] * wk[d] * plane[(jj[b] - c.j0 + 2) * XP + (kk[d] - c.k0 + 2)];
        }
      }
      plane[off] = s;
    }
  }
}

// Ring offsets (in values) of slot s of each field's planes.
constexpr int BI0 = NX * XPLANE, BJ0 = BI0 + NBI * BIPLANE, BK0 = BJ0 + NBJ * BJPLANE;

// Everything a block streams: the sources, its pairs of each, and the
// slots of its ring.
template <typename T, typename F, typename C>
struct Stream {
  const Args<T, F, C>& p;
  Column c;
  XPairs<T> px;
  Pairs<T, kBE, kXE> pi;
  Pairs<T, kBE, kXE + kBE> pj;
  Pairs<T, kBE, kXE + 2 * kBE> pk;

  // x plane q, beta_i face q, beta_j and beta_k array plane q into their
  // slots sx, sb, sj (the ring's float slots hold a bf16 field's words until
  // widen turns them into values)
  __device__ __forceinline__ void x(T* ring, int sx, int q, bool mem_ghosts = false) const {
    load_x(ring + sx * XPLANE, p.xp, c, px, q, mem_ghosts);
  }
  __device__ __forceinline__ void bi(T* ring, int sb, int q) const {
    load_beta(ring + BI0 + sb * BIPLANE, p.bie, pi, q, c.n + 2, c.n + 2, c.n + 1);
  }
  __device__ __forceinline__ void bjk(T* ring, int sj, int q) const {
    load_beta(ring + BJ0 + sj * BJPLANE, p.bje, pj, q, c.n + 1, c.n + 2, c.n + 2);
    load_beta(ring + BK0 + sj * BKPLANE, p.bke, pk, q, c.n + 2, c.n + 1, c.n + 2);
  }
  // the planes x q, beta_i face qb and beta_j/k qj in slots sx, sb, sj, whose
  // copies this thread has seen arrive, widened where stored in bf16
  __device__ __forceinline__ void widen(T* ring, int sx, int q, int sb, int qb, int sj,
                                        int qj) const {
    widen_x(ring + sx * XPLANE, p.xp, c, px, q);
    widen_beta(ring + BI0 + sb * BIPLANE, p.bie, pi, qb, c.n + 2, c.n + 2);
    widen_beta(ring + BJ0 + sj * BJPLANE, p.bje, pj, qj, c.n + 1, c.n + 2);
    widen_beta(ring + BK0 + sj * BKPLANE, p.bke, pk, qj, c.n + 2, c.n + 1);
  }
};

// The ring offsets of what the stencil of plane i reads.
struct Planes {
  int x[5];   // x planes i-2 .. i+2
  int bi[2];  // beta_i faces i, i+1
  int bj[3];  // beta_j array planes i .. i+2 (di = -1, 0, 1)
  int bk[3];
};

// A x at cell (jl, kl) of the tile on plane i (its x center returned in x0)
template <typename T, typename F, typename C>
__device__ __forceinline__ T stream_ax(const Args<T, F, C>& p, const T* ring,
                                       const Planes& P, int jl, int kl,
                                       int64_t c, T& x0) {
  const int xo = (jl + 2) * XP + (kl + 2);
  auto X = [&](int di, int dj, int dk) -> T {
    return ring[P.x[di + 2] + xo + dj * XP + dk];
  };
  // face f (0 low, 1 high) of the cell, shifted tangentially
  auto BI = [&](int f, int dj, int dk) -> T {
    return ring[P.bi[f] + (jl + 1 + dj) * BP + (kl + 1 + dk)];
  };
  auto BJ = [&](int f, int di, int dk) -> T {
    return ring[P.bj[di + 1] + (jl + f) * BP + (kl + 1 + dk)];
  };
  auto BK = [&](int f, int di, int dj) -> T {
    return ring[P.bk[di + 1] + (jl + 1 + dj) * BP + (kl + f)];
  };
  x0 = X(0, 0, 0);
  T ax = p.scale * fv4_combination<T>(X, BI, BJ, BK);
  if (p.alpha != nullptr) ax = p.a_coef * ldv<T>(p.alpha + c) * x0 + ax;
  return ax;
}

// One block: the TJ x TK column (blockIdx.x) over the i-planes of chunk
// blockIdx.y. Dynamic shared memory: the ring (kRingValues values of T),
// then the threads' pairs. F: the storage type of x, alpha, rhs and out;
// C: of the face coefficients and kdinv; T = Wide<F>, the ring's and the
// arithmetic's type.
template <typename F, typename C, int MODE, typename T = Wide<F>>
__global__ void __launch_bounds__(kStreamThreads, kMinBlocks<T>)
    fv4_stream_kernel(const Args<T, F, C> p, int periodic, int parity, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int n = p.n;
  const int tiles_k = (n + TK - 1) / TK;
  const int j0 = static_cast<int>(blockIdx.x / tiles_k) * TJ;
  const int k0 = static_cast<int>(blockIdx.x % tiles_k) * TK;
  const Column col{n, j0, k0, periodic != 0,
                   j0 < 2 || k0 < 2 || j0 + TJ + 2 > n || k0 + TK + 2 > n,
                   !periodic && n - j0 >= 2 && n - k0 >= 2};
  Stream<T, F, C> S{p, col};
  if constexpr (kPairValues<T> > 0) {
    unsigned* pairs = reinterpret_cast<unsigned*>(ring + kRingValues) + threadIdx.x;
    S.px.b = S.pi.b = S.pj.b = S.pk.b = pairs;
  }
  x_pairs<T>(S.px, p.xp, col);
  beta_pairs<BP, kStreamThreads>(S.pi, p.bie, n + 2, n + 2, j0, k0, TJ + 2, TK + 2);
  beta_pairs<BP, kStreamThreads>(S.pj, p.bje, n + 1, n + 2, j0, k0, TJ + 1, TK + 2);
  beta_pairs<BP, kStreamThreads>(S.pk, p.bke, n + 2, n + 1, j0, k0, TJ + 2, TK + 1);
  const int ia = blockIdx.y * chunk;
  const int ib = min(ia + chunk, n);
  auto inside = [n](int v) { return v >= 0 && v < n; };
  // whether this thread holds (j, k) ghosts of x (the first warps, or a
  // ragged tile's)
  bool has_ghost = false;
#pragma unroll
  for (int e = 0; e < kXE; ++e) has_ghost |= (S.px.meta(e) & (kG0 | kG1)) != 0;

  // ring slots of x plane i-2, beta_i face i, beta_j/k plane i (plane q in
  // slot q mod the ring's size); the planes in flight go to the slots just
  // before them
  int sx = (ia - 2 + NX) % NX, sb = ia % NBI, sj = ia % NBJ;
  // group 0: the planes of ia's stencil (x ia-2 .. ia+2, beta_i ia, ia+1,
  // beta_j/k ia .. ia+2); group 1: those plane ia+1 adds (x plane ia+3). A
  // ghost plane q < 0 or q >= n is made from planes 0 .. 3 or n-4 .. n-1,
  // where the ring holds them (x planes ia-2 .. last), else from memory.
  const int last = ia + 1 < ib ? ia + 3 : ia + 2;
  auto mem_ghosts = [&](int q) { return (q >= n && ia > n - 2) || (q < 0 && last < 3); };
#pragma unroll
  for (int d = 0; d < 5; ++d)
    S.x(ring, ring_add(sx, d, NX), ia - 2 + d, mem_ghosts(ia - 2 + d));
#pragma unroll
  for (int d = 0; d < 2; ++d) S.bi(ring, ring_add(sb, d, NBI), ia + d);
#pragma unroll
  for (int d = 0; d < 3; ++d) S.bjk(ring, ring_add(sj, d, NBJ), ia + d);
  cp_async_commit();
  if (ia + 1 < ib) {
    S.x(ring, ring_add(sx, 5, NX), ia + 3);
    S.bi(ring, ring_add(sb, 2, NBI), ia + 2);
    S.bjk(ring, ring_add(sj, 3, NBJ), ia + 3);
  }
  cp_async_commit();
  // a patched tile waits for both (planes -2 and -1 are made from 0 .. 3)
  // and makes the ghosts of x planes ia-2 .. ia+3; a bf16 field's words of
  // the arrived groups are widened before the barrier (group 1's, where it
  // is not waited for here, at the end of plane ia)
  if (col.patch) {
    cp_async_wait<0>();
  } else {
    cp_async_wait<1>();
  }
  if constexpr (!std::is_same_v<F, T> || !std::is_same_v<C, T>) {
#pragma unroll
    for (int d = 0; d < 5; ++d) widen_x(ring + ring_add(sx, d, NX) * XPLANE, p.xp, col, S.px,
                                        ia - 2 + d);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if (d < 2) widen_beta(ring + BI0 + ring_add(sb, d, NBI) * BIPLANE, p.bie, S.pi, ia + d,
                            n + 2, n + 2);
      widen_beta(ring + BJ0 + ring_add(sj, d, NBJ) * BJPLANE, p.bje, S.pj, ia + d, n + 1,
                 n + 2);
      widen_beta(ring + BK0 + ring_add(sj, d, NBJ) * BKPLANE, p.bke, S.pk, ia + d, n + 2,
                 n + 1);
    }
    if (col.patch && ia + 1 < ib)
      S.widen(ring, ring_add(sx, 5, NX), ia + 3, ring_add(sb, 2, NBI), ia + 2,
              ring_add(sj, 3, NBJ), ia + 3);
  }
  __syncthreads();
  if (col.patch && (col.edge || ia < 2 || ia + 3 >= n)) {
    for (int q = ia - 2; q <= last; ++q) {
      if (!inside(q) && !mem_ghosts(q)) patch_x(ring, col, S.px, q, ia - 2, sx);
      if (inside(q) && col.edge && has_ghost)
        patch_jk(ring + ring_add(sx, q - ia + 2, NX) * XPLANE, col, S.px);
    }
    __syncthreads();
  }

  // thread: row jl, pair pl (cells k0 + 2 pl, k0 + 2 pl + 1)
  const int jl = threadIdx.x / (TK / 2), pl = threadIdx.x % (TK / 2);
  const int j = j0 + jl, kb = k0 + 2 * pl;
  const bool pair_in = j < n && kb < n;
  const bool vec = (n & 1) == 0;
  const bool has_hi = kb + 1 < n;
  const int m = n / 2;
  T sum = T(0);  // fres: the coarse cell's running sum (even rows)

  // rhs (and kdinv) at this thread's cells of plane i, read a plane ahead
  // into registers: gsrb the colour's cell, residual and fres the pair
  const bool rhs_vec = vec && pair_aligned(p.rhs);
  auto fetch = [&](int i, T& r0, T& r1, T& kd) {
    if (MODE == kApply || !pair_in) return;
    const int64_t c = (static_cast<int64_t>(i) * n + j) * n + kb;
    if (MODE == kGsrb) {
      const int q = (parity + i + j) & 1;
      if (kb + q < n) {
        r0 = ldv<T>(p.rhs + c + q);
        kd = ldv<T>(p.kdinv + c + q);
      }
    } else if (rhs_vec) {
      load2(p.rhs + c, r0, r1);
    } else {
      r0 = ldv<T>(p.rhs + c);
      if (has_hi) r1 = ldv<T>(p.rhs + c + 1);
    }
  };
  T nr0 = T(0), nr1 = T(0), nkd = T(0);
  fetch(ia, nr0, nr1, nkd);

  for (int i = ia; i < ib; ++i) {
    // the copies plane i+2 adds: x plane i+4, beta_i face i+3, beta_j/k
    // plane i+4, each into the slot before the first one plane i reads
    if (i + 2 < ib) {
      S.x(ring, ring_add(sx, NX - 1, NX), i + 4);
      S.bi(ring, ring_add(sb, NBI - 1, NBI), i + 3);
      S.bjk(ring, ring_add(sj, NBJ - 1, NBJ), i + 4);
    }
    cp_async_commit();
    const T r0 = nr0, r1 = nr1, kd = nkd;
    if (i + 1 < ib) fetch(i + 1, nr0, nr1, nkd);

    Planes P;
#pragma unroll
    for (int d = 0; d < 5; ++d) P.x[d] = ring_add(sx, d, NX) * XPLANE;
#pragma unroll
    for (int d = 0; d < 2; ++d) P.bi[d] = BI0 + ring_add(sb, d, NBI) * BIPLANE;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      P.bj[d] = BJ0 + ring_add(sj, d, NBJ) * BJPLANE;
      P.bk[d] = BK0 + ring_add(sj, d, NBJ) * BKPLANE;
    }
    const int64_t row = (static_cast<int64_t>(i) * n + j) * n;
    // the cell of this pair with parity (i + j + k) % 2 == 0 comes first
    const int q0 = (i + j) & 1;

    if constexpr (MODE == kGsrb) {
      if (pair_in) {
        const int q = (parity + i + j) & 1;  // the sweep's colour
        T x0;
        T v = T(0);
        if (kb + q < n) {
          const T ax = stream_ax(p, ring, P, jl, 2 * pl + q, row + kb + q, x0);
          v = x0 + kd * (r0 - ax);
        }
        const T other = ring[P.x[2] + (jl + 2) * XP + (2 * pl + (q ^ 1) + 2)];
        store_pair(p.out, row + kb, q ? other : v, q ? v : other, vec, has_hi);
      }
    } else {
      T r[2] = {T(0), T(0)};  // by q: cell kb + (q0 ^ q)
      if (pair_in) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int dk = q0 ^ q;
          if (kb + dk < n) {
            T x0;
            const T ax = stream_ax(p, ring, P, jl, 2 * pl + dk, row + kb + dk, x0);
            if constexpr (MODE == kApply) {
              r[q] = ax;
            } else {
              r[q] = (dk ? r1 : r0) - ax;
            }
          }
        }
      }
      const T lo = q0 ? r[1] : r[0], hi = q0 ? r[0] : r[1];
      if constexpr (MODE == kFres) {
        // n even: rows j, j+1 (lanes l, l+16) and the pair are in or out
        // together; every lane takes part in the shuffles
        const T plo = __shfl_down_sync(0xffffffffu, lo, 16);
        const T phi = __shfl_down_sync(0xffffffffu, hi, 16);
        if ((i & 1) == 0) sum = T(0);
        sum += lo;
        sum += hi;
        sum += plo;
        sum += phi;
        if ((i & 1) && (jl & 1) == 0 && pair_in) {
          p.out[(static_cast<int64_t>(i / 2) * m + j / 2) * m + kb / 2] =
              narrow<F>(T(0.125) * sum);
        }
      } else if (pair_in) {
        store_pair(p.out, row + kb, lo, hi, vec, has_hi);
      }
    }

    // ghosts made during plane i, which reads neither: the (j, k) ghosts of
    // x plane i+2, whose copies have arrived, and a ghost plane i+3 >= n,
    // from planes n-4 .. n-1; plane i+1 reads both first
    if (col.patch && i + 1 < ib) {
      if (col.edge && has_ghost && i >= ia + 2 && inside(i + 2))
        patch_jk(ring + ring_add(sx, 4, NX) * XPLANE, col, S.px);
      if (i >= ia + 1 && i + 3 >= n) patch_x(ring, col, S.px, i + 3, i - 2, sx);
    }
    // the copies of plane i+1 (group i+1) have arrived, those of i+2 may not;
    // a bf16 field's words among them (x plane i+3, beta_i face i+2,
    // beta_j/k plane i+3, which plane i+1 reads first) widened by the
    // thread that copied them (a patched tile widened plane ia's in the
    // prologue)
    cp_async_wait<1>();
    if constexpr (!std::is_same_v<F, T> || !std::is_same_v<C, T>) {
      if (i + 1 < ib && !(col.patch && i == ia))
        S.widen(ring, ring_add(sx, 5, NX), i + 3, ring_add(sb, 2, NBI), i + 2,
                ring_add(sj, 3, NBJ), i + 3);
    }
    __syncthreads();
    sx = ring_add(sx, 1, NX);
    sb = ring_add(sb, 1, NBI);
    sj = ring_add(sj, 1, NBJ);
  }
}

// dynamic shared memory: the ring, then the pairs
template <typename T>
size_t ring_bytes() { return kRingValues * sizeof(T) + kPairValues<T> * sizeof(unsigned); }

// Chunk length along i: the caller's (made even), or so that the columns
// times the chunks give ~8 waves of co-resident blocks, at least
// kMinChunk planes a chunk.
constexpr int kMinChunk = 16;
constexpr int kWaves = 8;

template <typename T, typename F, typename C, int MODE>
int launch_mode(const Args<T, F, C>& p, int periodic, int parity, int chunk,
                cudaStream_t s) {
  auto kernel = fv4_stream_kernel<F, C, MODE>;
  const size_t smem = ring_bytes<T>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n = p.n;
  const int64_t tiles =
      static_cast<int64_t>((n + TJ - 1) / TJ) * ((n + TK - 1) / TK);
  if (chunk <= 0) {
    // co-resident blocks on the card (queried once)
    static const int64_t slots = [&]() -> int64_t {
      int dev = 0, sms = 0, per_sm = 0;
      if (cudaGetDevice(&dev) != cudaSuccess ||
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kStreamThreads,
                                                        smem) != cudaSuccess)
        return 0;
      return static_cast<int64_t>(sms) * per_sm;
    }();
    if (slots <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int64_t chunks = (kWaves * slots + tiles - 1) / tiles;
    chunk = static_cast<int>((n + chunks - 1) / chunks);
    if (chunk < kMinChunk) chunk = kMinChunk;
  }
  if (chunk > n) chunk = n;
  if (MODE == kFres && (chunk & 1)) ++chunk;  // a coarse cell's planes together
  const int chunks = (n + chunk - 1) / chunk;
  kernel<<<dim3(static_cast<unsigned>(tiles), chunks), kStreamThreads, smem, s>>>(
      p, periodic, parity, chunk);
  return static_cast<int>(cudaGetLastError());
}

// F, C: the storage types (see fv4_stream_kernel); a mixed instantiation
// (BF16C: float x, bf16 coefficients) takes the gsrb mode only
template <typename F, typename C>
int launch_stream(const void* x, const void* bie, const void* bje,
                  const void* bke, const void* alpha, const void* rhs,
                  const void* kdinv, void* out, int n, int mode, int periodic,
                  int parity, int chunk, double scale, double a_coef,
                  void* stream) {
  using T = Wide<F>;
  constexpr bool mixed = !std::is_same_v<F, C>;
  if (n < 4 || n > 65535 || mode < kApply || mode > kFres ||
      (mode == kFres && n % 2 != 0) || parity < 0 || parity > 1 || chunk < 0 ||
      (mixed && mode != kGsrb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args<T, F, C> p{static_cast<const F*>(x),     static_cast<const C*>(bie),
                        static_cast<const C*>(bje),   static_cast<const C*>(bke),
                        static_cast<const F*>(alpha), static_cast<const F*>(rhs),
                        static_cast<const C*>(kdinv), static_cast<F*>(out),
                        n,                            static_cast<T>(scale),
                        static_cast<T>(a_coef)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (mixed) {
    return launch_mode<T, F, C, kGsrb>(p, periodic, parity, chunk, s);
  } else {
    switch (mode) {
      case kApply: return launch_mode<T, F, C, kApply>(p, periodic, parity, chunk, s);
      case kResidual: return launch_mode<T, F, C, kResidual>(p, periodic, parity, chunk, s);
      case kGsrb: return launch_mode<T, F, C, kGsrb>(p, periodic, parity, chunk, s);
      default: return launch_mode<T, F, C, kFres>(p, periodic, parity, chunk, s);
    }
  }
}

}  // namespace

// x: the n^3 cell field (no ghosts); mode 0 apply, 1 residual, 2 gsrb,
// 3 fres; periodic 0 (quartic Dirichlet ghosts) or 1 (wrapped); parity:
// the colour gsrb updates; chunk: i-planes per block (0: the launcher's
// rule)
extern "C" int hpgmg_fv4_stream_f32(const void* x, const void* bie,
                                    const void* bje, const void* bke,
                                    const void* alpha, const void* rhs,
                                    const void* kdinv, void* out, int n,
                                    int mode, int periodic, int parity,
                                    int chunk, double scale, double a_coef,
                                    void* stream) {
  return launch_stream<float, float>(x, bie, bje, bke, alpha, rhs, kdinv, out, n, mode,
                                     periodic, parity, chunk, scale, a_coef, stream);
}

extern "C" int hpgmg_fv4_stream_f64(const void* x, const void* bie,
                                    const void* bje, const void* bke,
                                    const void* alpha, const void* rhs,
                                    const void* kdinv, void* out, int n,
                                    int mode, int periodic, int parity,
                                    int chunk, double scale, double a_coef,
                                    void* stream) {
  return launch_stream<double, double>(x, bie, bje, bke, alpha, rhs, kdinv, out, n,
                                       mode, periodic, parity, chunk, scale, a_coef,
                                       stream);
}

// bf16 storage throughout, float arithmetic: a bfloat16 solve's K1
extern "C" int hpgmg_fv4_stream_bf16(const void* x, const void* bie,
                                     const void* bje, const void* bke,
                                     const void* alpha, const void* rhs,
                                     const void* kdinv, void* out, int n,
                                     int mode, int periodic, int parity,
                                     int chunk, double scale, double a_coef,
                                     void* stream) {
  return launch_stream<bf16, bf16>(x, bie, bje, bke, alpha, rhs, kdinv, out, n, mode,
                                   periodic, parity, chunk, scale, a_coef, stream);
}

// BF16C: float x, alpha, rhs and out, bf16 face coefficients and kdinv;
// mode 2 (gsrb) only
extern "C" int hpgmg_fv4_stream_f32_bf16(const void* x, const void* bie,
                                         const void* bje, const void* bke,
                                         const void* alpha, const void* rhs,
                                         const void* kdinv, void* out, int n,
                                         int mode, int periodic, int parity,
                                         int chunk, double scale, double a_coef,
                                         void* stream) {
  return launch_stream<float, bf16>(x, bie, bje, bke, alpha, rhs, kdinv, out, n, mode,
                                    periodic, parity, chunk, scale, a_coef, stream);
}
