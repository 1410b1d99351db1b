// K2: one full fv4 GSRB sweep (red half-sweep, then black) in ONE ordinary
// launch:
//
//   y   = x + kd0 * (rhs - A x)     at the red cells ((i+j+k) % 2 == 0),
//                                   y = x at the black ones
//   out = y + kd1 * (rhs - A y)     at the black cells, out = y at the red
//
// with the quartic volume-averaged Dirichlet ghosts of x for the first line
// and those of y for the second (gsrb.c:24-41 refills the ghosts between
// the halves). kd0 and kd1, the level's parity-folded dinv pair, are read
// at their colour's cells only.
//
// Replaces hpgmg_tpu/kernels/stencils.py:_fv4_gsrb2_kernel (reached through
// fv4_gsrb2_pallas). That kernel held a radius-4 window of x per VMEM tile,
// applied red on the tile's 2-cell ring, re-made the quartic ghosts of the
// red iterate in the kernel, then applied black on the tile, so that the
// coefficients and rhs streamed from HBM once a full sweep instead of twice.
// This kernel keeps that dataflow and streams it along i instead of tiling
// it in VMEM.
//
// Its bound on an H100: device-memory bandwidth. A sweep must read x, the
// three beta arrays, rhs and the kdinv pair and write out: 8 values a cell,
// against two half-sweeps' 14, and ~226 flops at one red and
// one black cell per pair of cells (~7 flop/B in f32, below the card's f32
// ridge of 20 flop/B).
//
// Design (fv4_stream.cu's machinery, in fv4_stream.cuh): a block owns a
// TJ x TK = 16 x 32 column of (j, k) and marches a chunk of i-planes.
// Iteration q:
//   A. red update of plane q on the column and its 2-cell (j, k) ring (R),
//      at red cells (black cells of R copy x), from a ring of x planes with
//      a 4-cell halo, into a ring of y planes; a y ghost plane n or n+1 is
//      made instead once planes n-4 .. n-1 are there;
//   B. after a barrier: the (j, k) Dirichlet ghosts of y plane q and of x
//      plane q+3 on a tile at the domain's edge (ghost_value's arithmetic
//      from the ring, the cells dealt round all threads), the ghost planes
//      -2, -1 of y once planes 0 .. 3 are there (one barrier more in that
//      iteration), and the black update of plane q-3 on the column from y
//      planes q-5 .. q-1, written to out once;
//   then a barrier. Black runs three planes behind red, so that plane 0's
//   black finds the ghost planes of y made from red planes 0 .. 3, and no
//   barrier separates a plane's ghosts from its readers.
// Copies: cp.async, issued one iteration ahead (x plane q+4, beta_i face
// q+2, beta_j/k plane q+3) and waited for at its end; each thread's pairs
// of copies are fixed for the block and kept as 16-bit ring offsets with
// flags (the source offset recomputed), so that the float ring and pairs
// (111 KB) leave room for two blocks an SM; x's ghost planes come from
// device memory. The beta planes of R serve both halves (black reads their
// inner part). rhs, kd0/kd1 and alpha are read an iteration ahead into
// registers, at the column pair's red cell (red), its black cell (black,
// three planes later: an L2 hit) and the frame's red cells.
// Each thread owns a pair of neighbouring k cells of the column, so exactly
// one of them is red; rows j and j+1 of a warp take opposite cells, and the
// even plane pitches keep the shared reads free of bank conflicts. R's ring
// ((TJ+4)(TK+4)/(TJ TK) = 1.41 of the column's red work) is done by the
// first threads, one pair each. A tile whose last row or column would hold
// one cell moves back by two, so that y's ghost taps (4 cells from the
// face) lie in R; the overlapping cells are computed twice, to the same
// bits. Float: two blocks an SM, 128 registers; double: one block an SM
// (212 KB of ring).
// Measured on an H100 (chip_smoke.py, bench/stencil_times.py; PERF.md): a
// 512^3 f32 sweep takes 4.48-4.52 ms against 4.41-4.42 for two K1 gsrb
// launches in turns and 1.29 ms of bound; at 128^3-256^3 it is 4-11%
// behind them. It is not bound by its bytes but by each plane's latency
// (the copies' wait and two barriers) and by 1.41x the red stencils: an
// earlier version took 4.1 of its 5.8 ms with its stencils switched off.
// What cut that version's time: the rhs/dinv loads a plane ahead, the
// ring slots stepped without a modulo, the edge tiles' ghosts dealt round
// all threads and scanned only in their band (5.8 -> 4.5 ms). Tried
// without gain: a 32 x 32 column (512 threads, ring factor 1.27, one block
// an SM), two planes of copies in flight on it, the level's dinv in place
// of the kdinv pair (5.70 against 5.76 ms).
// The arithmetic is fv4_combination with K1's ghost formula (ghost_taps),
// so the result equals two K1 gsrb launches bit for bit.
// Plain version: hpgmg_tpu_torch/kernels/stencils.py:fv4_gsrb2_plain.

#include "fv4_stream.cuh"

namespace {

template <int TJ_, int TK_, int BLOCKS_>
struct Geo {
  static constexpr int TJ = TJ_, TK = TK_;
  // blocks an SM holds
  static constexpr int BLOCKS = BLOCKS_;
  // a thread a pair of the column
  static constexpr int THREADS = TJ * TK / 2;
  // R, the column with its 2-cell ring: the y planes
  static constexpr int YJ = TJ + 4, YP = TK + 4, YPLANE = YJ * YP;
  // R with its 2-cell halo: the x planes
  static constexpr int XJ = TJ + 8, XP = TK + 8, XPLANE = XJ * XP;
  // the beta planes of R: beta_i and beta_k (TJ+6) rows, beta_j (TJ+5)
  static constexpr int BP = TK + 6;
  static constexpr int BIPLANE = (TJ + 6) * BP, BJPLANE = (TJ + 5) * BP,
                       BKPLANE = (TJ + 6) * BP;
  // ring slots: x planes q-2 .. q+4, y planes q-5 .. q, beta_i faces
  // q-3 .. q+2, beta_j/k planes q-3 .. q+3
  static constexpr int NX = 7, NY = 6, NBI = 6, NBJ = 7;
  static constexpr int Y0 = NX * XPLANE, BI0 = Y0 + NY * YPLANE,
                       BJ0 = BI0 + NBI * BIPLANE, BK0 = BJ0 + NBJ * BJPLANE;
  static constexpr int kRingValues = BK0 + NBJ * BKPLANE;
  // R's pairs outside the column (its frame)
  static constexpr int kFrameRows = 4 * (YP / 2), RING = kFrameRows + 2 * TJ;
  // a thread's pair slots: x, then beta_i, beta_j, beta_k
  static constexpr int kXE = (XJ * (XP / 2) + THREADS - 1) / THREADS;
  static constexpr int kBE = ((TJ + 6) * (BP / 2) + THREADS - 1) / THREADS;
  static constexpr int kPairSlots = kXE + 3 * kBE;
  static_assert(TK % 2 == 0 && TJ % 2 == 0 && RING <= THREADS, "one frame pair a thread");
  static_assert((XPLANE << kMetaShift) < 65536 && (BIPLANE << kMetaShift) < 65536,
                "a pair's ring offset and flags in 16 bits");
};

template <typename T>
struct Tile;
template <>
struct Tile<float> {
  using G = Geo<16, 32, 2>;
};
template <>
struct Tile<double> {
  using G = Geo<16, 32, 1>;
};

// A thread's pairs of one field as their ring offsets and flags (meta)
// alone, in shared memory after the ring at a stride of the block's
// threads (b points at the thread's slot 0); the source offset is
// recomputed from the ring offset: base + (off / PITCH) * ncol + off % PITCH.
// (With the offsets stored too, two float blocks would not fit an SM.)
template <typename G, int E, int FIRST, int PITCH>
struct MetaPairs {
  static constexpr int count = E;
  unsigned short* b;
  int base, ncol;
  __device__ __forceinline__ unsigned meta(int e) const {
    return b[(FIRST + e) * G::THREADS];
  }
  __device__ __forceinline__ unsigned goff(int e) const {
    const int off = static_cast<int>(meta(e) >> kMetaShift);
    const int a = off / PITCH;
    return static_cast<unsigned>(base + a * ncol + (off - a * PITCH));
  }
  __device__ __forceinline__ void set(int e, unsigned, unsigned m) {
    b[(FIRST + e) * G::THREADS] = static_cast<unsigned short>(m);
  }
};
template <typename T>
constexpr int kPairValues = Tile<T>::G::kPairSlots * Tile<T>::G::THREADS;

template <typename T>
struct Gsrb2Args {
  const T* x;
  const T* bie;
  const T* bje;
  const T* bke;
  const T* alpha;  // nullptr: no a*alpha*x term
  const T* rhs;
  const T* kd0;  // read at red cells
  const T* kd1;  // read at black cells
  T* out;
  int n;
  T scale;   // -b / h^2
  T a_coef;  // a
};

// Origin of tile t of size T on an axis of n cells: t*T, two less where
// the tile would hold one cell
__device__ __forceinline__ int tile_origin(int t, int T, int n) {
  const int o = t * T;
  return (o == n - 1 && n > T) ? o - 2 : o;
}

// Position (row a, column b) in R of frame pair u: the 2-row halo above
// and below, then the 2-column halo left and right of the column's rows
template <typename G>
__device__ __forceinline__ void frame_pair_at(int u, int& a, int& b) {
  if (u < G::kFrameRows) {
    const int r = u / (G::YP / 2);
    a = r < 2 ? r : G::TJ + r;
    b = 2 * (u - r * (G::YP / 2));
  } else {
    const int v = u - G::kFrameRows;
    a = 2 + v / 2;
    b = (v & 1) ? G::YP - 2 : 0;
  }
}

// The x pairs of this thread: R and its 2-cell halo, two k cells a pair
// (k even); cells outside [-2, n+2) are not loaded (no red cell reads
// them), (j, k) ghosts are flagged.
template <typename G, typename T, typename XPT>
__device__ __forceinline__ void x_pairs(XPT& P, const T* x, int n, int j0, int k0) {
  auto inside = [n](int v) { return v >= 0 && v < n; };
  auto kept = [n](int v) { return v >= -2 && v < n + 2; };
#pragma unroll
  for (int e = 0; e < G::kXE; ++e) {
    const int t = threadIdx.x + e * G::THREADS;
    const int a = t / (G::XP / 2), b = 2 * (t - a * (G::XP / 2));
    const int j = j0 - 4 + a, k = k0 - 4 + b;
    unsigned f = 0, g = 0;
    if (t < G::XJ * (G::XP / 2) && kept(j)) {
      f = (kept(k) ? kE0 : 0u) | (kept(k + 1) ? kE1 : 0u);
      g = static_cast<unsigned>(inside(j) ? j : 0) * n + (inside(k) ? k : 0);
      if (!(inside(j) && inside(k))) f |= kG0;
      if (!(inside(j) && inside(k + 1))) f |= kG1;
      if ((n & 1) == 0 && (f & (kE0 | kE1 | kG0 | kG1)) == (kE0 | kE1) &&
          pair_aligned(x + g))
        f |= kPair;
    }
    P.set(e, g, static_cast<unsigned>(a * G::XP + b) << kMetaShift | f);
  }
}

// x plane i (in [-2, n+2)) into the ring plane dst: cells copied; a ghost
// plane synthesized from device memory; the (j, k) ghosts of a plane in
// the domain are left to patch_x
template <typename G, typename T, typename XPT>
__device__ __forceinline__ void load_x(T* dst, const T* __restrict__ x, const XPT& P,
                                       int n, int i, int j0, int k0) {
  const bool in_i = i >= 0 && i < n;
  const T* base = x + static_cast<int64_t>(in_i ? i : 0) * n * n;
#pragma unroll
  for (int e = 0; e < G::kXE; ++e) {
    const unsigned m = P.meta(e);
    T* d = dst + (m >> kMetaShift);
    if ((m & kPair) && in_i) {
      cp_async2(d, base + P.goff(e));
      continue;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!(m & (kE0 << q))) continue;
      if (!in_i) {
        const int off = static_cast<int>(m >> kMetaShift) + q;
        d[q] = ghost_from_memory(x, n, i, j0 - 4 + off / G::XP, k0 - 4 + off % G::XP);
      } else if (!(m & (kG0 << q))) {
        cp_async(d + q, base + P.goff(e) + q);
      }
    }
  }
}

// The Dirichlet ghosts of one plane i of a field (at `plane`: ROWS rows
// of pitch PITCH from cell (j0 - H, k0 - H)) from the accessor `at` of
// its cells (ghost_taps, so the bits of K1's ghosts): the (j, k) ghosts of
// a plane in the domain, every cell of a ghost plane, within [-2, n+2).
// The candidate cells are dealt round the block's threads; on a plane in
// the domain of a tile whose domain faces meet its halo at its first or
// last two rows and columns (`band`), only those rows and columns are
// candidates, so that each thread makes about one ghost (a scan of the
// whole plane made each warp wait for a ghost in every step). Call once
// the cells of the taps are visible to the block.
template <int ROWS, int PITCH, int H, int THREADS, typename T, typename XA>
__device__ __forceinline__ void make_ghosts(T* plane, const XA& at, int n, int i, int j0,
                                            int k0, bool band) {
  const bool ghost_plane = i < 0 || i >= n;
  constexpr int kRows = 4 * PITCH, kBand = kRows + 4 * (ROWS - 4);
  const int count = band && !ghost_plane ? kBand : ROWS * PITCH;
  for (int u = threadIdx.x; u < count; u += THREADS) {
    int a, b;
    if (count == ROWS * PITCH) {
      a = u / PITCH;
      b = u - a * PITCH;
    } else if (u < kRows) {
      const int r = u / PITCH;
      a = r < 2 ? H - 2 + r : ROWS - H + r - 2;
      b = u - r * PITCH;
    } else {  // columns H-2, H-1, PITCH-H, PITCH-H+1 of the other rows
      const int v = u - kRows, c = v & 3, r = v / 4;
      a = r < H - 2 ? r : (r < ROWS - H - 2 ? r + 2 : r + 4);
      b = c < 2 ? H - 2 + c : PITCH - H + c - 2;
    }
    const int jj = j0 - H + a, kk = k0 - H + b;
    if (jj < -2 || jj >= n + 2 || kk < -2 || kk >= n + 2) continue;
    if (!ghost_plane && jj >= 0 && jj < n && kk >= 0 && kk < n) continue;
    plane[a * PITCH + b] = ghost_taps<T>(at, n, i, jj, kk);
  }
}

// ring slot of plane p (p >= -5)
template <int N>
__device__ __forceinline__ int slot(int p) {
  return (p + 8 * N) % N;
}

// The ring offsets of what the stencil of plane i reads: the field's
// planes i-2 .. i+2, beta_i faces i, i+1, beta_j/k array planes i .. i+2.
struct Planes {
  int f[5];
  int bi[2];
  int bj[3];
  int bk[3];
};

// ... from the slots of the field's plane i-2 (sf, in a ring of nf), of
// beta_i face i (sb) and of beta_j/k plane i (sj)
template <typename G>
__device__ __forceinline__ Planes planes_at(int field0, int fplane, int nf, int sf, int sb,
                                            int sj) {
  Planes P;
#pragma unroll
  for (int d = 0; d < 5; ++d) P.f[d] = field0 + ring_add(sf, d, nf) * fplane;
#pragma unroll
  for (int d = 0; d < 2; ++d) P.bi[d] = G::BI0 + ring_add(sb, d, G::NBI) * G::BIPLANE;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    P.bj[d] = G::BJ0 + ring_add(sj, d, G::NBJ) * G::BJPLANE;
    P.bk[d] = G::BK0 + ring_add(sj, d, G::NBJ) * G::BKPLANE;
  }
  return P;
}

// scale * (main/12 + mixed/48) at R's cell (ra, rb), the field (x or y)
// read at (ra + h, rb + h) of planes of pitch FP; its center into f0
template <typename G, int FP, int h, typename T>
__device__ __forceinline__ T ring_ax(const T* ring, const Planes& P, int ra, int rb,
                                     T scale, T& f0) {
  const int fo = (ra + h) * FP + (rb + h);
  auto X = [&](int di, int dj, int dk) -> T { return ring[P.f[di + 2] + fo + dj * FP + dk]; };
  // face f (0 low, 1 high) of the cell, shifted tangentially
  auto BI = [&](int f, int dj, int dk) -> T {
    return ring[P.bi[f] + (ra + 1 + dj) * G::BP + (rb + 1 + dk)];
  };
  auto BJ = [&](int f, int di, int dk) -> T {
    return ring[P.bj[di + 1] + (ra + f) * G::BP + (rb + 1 + dk)];
  };
  auto BK = [&](int f, int di, int dj) -> T {
    return ring[P.bk[di + 1] + (ra + 1 + dj) * G::BP + (rb + f)];
  };
  f0 = X(0, 0, 0);
  return scale * fv4_combination<T>(X, BI, BJ, BK);
}

// One block: a TJ x TK column (blockIdx.x) over the i-planes of chunk
// blockIdx.y. Dynamic shared memory: the ring, then the threads' pairs.
template <typename T, int THREADS, int BLOCKS>
__global__ void __launch_bounds__(THREADS, BLOCKS)
    fv4_gsrb2_kernel(const Gsrb2Args<T> p, int chunk) {
  using G = typename Tile<T>::G;
  static_assert(G::THREADS == THREADS && G::BLOCKS == BLOCKS, "the tile's threads");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int n = p.n;
  const int tiles_k = (n + G::TK - 1) / G::TK;
  const int j0 = tile_origin(static_cast<int>(blockIdx.x) / tiles_k, G::TJ, n);
  const int k0 = tile_origin(static_cast<int>(blockIdx.x) % tiles_k, G::TK, n);
  const bool edge = j0 < 2 || k0 < 2 || j0 + G::TJ + 2 > n || k0 + G::TK + 2 > n;
  // whether the domain's faces meet the halo of x (4 cells) or of y (2)
  // at its first or last two rows and columns (make_ghosts' band): not on
  // ragged tiles
  auto band = [&](int h) {
    return (j0 + G::TJ == n || j0 + G::TJ + h <= n) && (k0 + G::TK == n || k0 + G::TK + h <= n);
  };
  const bool band_x = band(4), band_y = band(2);
  auto inside = [n](int v) { return v >= 0 && v < n; };

  unsigned short* pairs =
      reinterpret_cast<unsigned short*>(ring + G::kRingValues) + threadIdx.x;
  MetaPairs<G, G::kXE, 0, G::XP> px{pairs, (j0 - 4) * n + (k0 - 4), n};
  MetaPairs<G, G::kBE, G::kXE, G::BP> pbi{pairs, (j0 - 2) * (n + 2) + (k0 - 2), n + 2};
  MetaPairs<G, G::kBE, G::kXE + G::kBE, G::BP> pbj{pairs, (j0 - 2) * (n + 2) + (k0 - 2),
                                                   n + 2};
  MetaPairs<G, G::kBE, G::kXE + 2 * G::kBE, G::BP> pbk{pairs, (j0 - 2) * (n + 1) + (k0 - 2),
                                                       n + 1};
  x_pairs<G>(px, p.x, n, j0, k0);
  beta_pairs<G::BP, G::THREADS>(pbi, p.bie, n + 2, n + 2, j0 - 2, k0 - 2, G::TJ + 6, G::TK + 6);
  beta_pairs<G::BP, G::THREADS>(pbj, p.bje, n + 1, n + 2, j0 - 2, k0 - 2, G::TJ + 5, G::TK + 6);
  beta_pairs<G::BP, G::THREADS>(pbk, p.bke, n + 2, n + 1, j0 - 2, k0 - 2, G::TJ + 6, G::TK + 5);

  // black planes [ia, ib); red planes [qs, red_end), from 4 planes below
  // n where the chunk reads y's ghost planes n, n+1; those planes in
  // [n, ghost_end); the last x plane, beta_i face and beta_j/k plane read
  const int ia = static_cast<int>(blockIdx.y) * chunk;
  const int ib = min(ia + chunk, n);
  const int qs = ib + 1 >= n ? max(min(ia - 2, n - 4), 0) : max(ia - 2, 0);
  const int red_end = min(ib + 2, n), ghost_end = min(ib + 2, n + 2);
  const int x_last = red_end + 1, bi_last = max(red_end, ib), bj_last = bi_last + 1;

  // plane q of a field into ring slot s
  auto copy_x = [&](int q, int s) {
    load_x<G>(ring + s * G::XPLANE, p.x, px, n, q, j0, k0);
  };
  auto copy_bi = [&](int q, int s) {
    load_beta(ring + G::BI0 + s * G::BIPLANE, p.bie, pbi, q, n + 2, n + 2);
  };
  auto copy_bjk = [&](int q, int s) {
    load_beta(ring + G::BJ0 + s * G::BJPLANE, p.bje, pbj, q, n + 1, n + 2);
    load_beta(ring + G::BK0 + s * G::BKPLANE, p.bke, pbk, q, n + 2, n + 1);
  };
  // the (j, k) ghosts of x plane q (in ring slot s) of a tile at the
  // domain's edge, from the plane's cells
  auto patch = [&](int q, int s) {
    if (!edge || !inside(q)) return;
    T* plane = ring + s * G::XPLANE;
    auto at = [&](int, int jj, int kk) -> T {
      return plane[(jj - j0 + 4) * G::XP + (kk - k0 + 4)];
    };
    make_ghosts<G::XJ, G::XP, 4, G::THREADS>(plane, at, n, q, j0, k0, band_x);
  };
  for (int d = -2; d <= 3; ++d) {
    if (qs + d <= x_last) copy_x(qs + d, slot<G::NX>(qs + d));
  }
  for (int d = 0; d <= 1; ++d) {
    if (qs + d <= bi_last) copy_bi(qs + d, slot<G::NBI>(qs + d));
  }
  for (int d = 0; d <= 2; ++d) {
    if (qs + d <= bj_last) copy_bjk(qs + d, slot<G::NBJ>(qs + d));
  }
  cp_async_commit();

  // this thread's column pair: row jl, pair pl (cells kb, kb + 1), at
  // (jl + 2, 2 pl + 2) in R
  const int jl = threadIdx.x / (G::TK / 2), pl = threadIdx.x % (G::TK / 2);
  const int j = j0 + jl, kb = k0 + 2 * pl;
  const bool pair_in = j < n && kb < n;
  const bool has_hi = kb + 1 < n;
  const bool vec = (n & 1) == 0;
  // this thread's frame pair of R, if any
  const bool has_frame = threadIdx.x < G::RING;
  int fa = 0, fb = 0;
  if (has_frame) frame_pair_at<G>(threadIdx.x, fa, fb);
  const int fj = j0 - 2 + fa, fk = k0 - 2 + fb;

  // y at (ii, jj, kk) from its ring, whose slot sy holds plane q5 = q-5
  // in iteration q
  int sy = 0, q5 = 0;
  auto Y = [&](int ii, int jj, int kk) -> T {
    return ring[G::Y0 + ring_add(sy, ii - q5, G::NY) * G::YPLANE + (jj - j0 + 2) * G::YP +
                (kk - k0 + 2)];
  };
  // the Dirichlet ghosts of y plane i (in [q-5, q])
  auto y_ghosts = [&](int i) {
    make_ghosts<G::YJ, G::YP, 2, G::THREADS>(
        ring + G::Y0 + ring_add(sy, i - q5, G::NY) * G::YPLANE, Y, n, i, j0, k0, band_y);
  };

  // rhs, dinv and alpha at one cell, read an iteration ahead: the column
  // pair's red cell and the frame pair's (red of plane q+1), the column
  // pair's black cell (black of plane q-2)
  struct Ops {
    T r, d, a;
  };
  auto ops_at = [&](int i, int jj, int kk, const T* kd) -> Ops {
    const int64_t c = (static_cast<int64_t>(i) * n + jj) * n + kk;
    return {__ldg(p.rhs + c), __ldg(kd + c), p.alpha != nullptr ? __ldg(p.alpha + c) : T(0)};
  };
  // the red cell of the column pair and of the frame pair on plane i (k
  // offset in the pair), and whether it lies in the domain
  auto red_col = [&](int i) { return (i + j) & 1; };
  auto red_frame = [&](int i) { return (i + fj) & 1; };
  auto col_red_in = [&](int i) { return i < red_end && pair_in && kb + red_col(i) < n; };
  auto frame_red_in = [&](int i) {
    return i < red_end && has_frame && inside(fj) && inside(fk + red_frame(i));
  };
  auto col_black_in = [&](int i) {
    return i >= ia && i < ib && pair_in && kb + (red_col(i) ^ 1) < n;
  };
  Ops nc{}, nf{}, nb{};
  if (col_red_in(qs)) nc = ops_at(qs, j, kb + red_col(qs), p.kd0);
  if (frame_red_in(qs)) nf = ops_at(qs, fj, fk + red_frame(qs), p.kd0);
  if (col_black_in(qs - 3)) nb = ops_at(qs - 3, j, kb + (red_col(qs - 3) ^ 1), p.kd1);

  cp_async_wait<0>();
  __syncthreads();
  for (int d = -2; d <= 2; ++d) patch(qs + d, slot<G::NX>(qs + d));
  __syncthreads();

  for (int q = qs; q < ib + 3; ++q) {
    // the ring slots of x plane q-2, of y plane q-5, of beta_i face q-3
    // and of beta_j/k plane q-3
    const int sx = slot<G::NX>(q - 2), sb = slot<G::NBI>(q - 3), sj = slot<G::NBJ>(q - 3);
    sy = slot<G::NY>(q - 5);
    q5 = q - 5;
    // the copies of the next iteration: x plane q+4, beta_i face q+2,
    // beta_j/k plane q+3, each into the slot its ring frees now
    if (q + 4 <= x_last) copy_x(q + 4, ring_add(sx, 6, G::NX));
    if (q + 2 <= bi_last) copy_bi(q + 2, ring_add(sb, 5, G::NBI));
    if (q + 3 <= bj_last) copy_bjk(q + 3, ring_add(sj, 6, G::NBJ));
    cp_async_commit();
    const Ops oc = nc, of = nf, ob = nb;
    if (col_red_in(q + 1)) nc = ops_at(q + 1, j, kb + red_col(q + 1), p.kd0);
    if (frame_red_in(q + 1)) nf = ops_at(q + 1, fj, fk + red_frame(q + 1), p.kd0);
    if (col_black_in(q - 2)) nb = ops_at(q - 2, j, kb + (red_col(q - 2) ^ 1), p.kd1);

    // A. red update of plane q on R, or a ghost plane of y
    if (q < red_end) {
      const Planes P = planes_at<G>(0, G::XPLANE, G::NX, sx, ring_add(sb, 3, G::NBI),
                                    ring_add(sj, 3, G::NBJ));
      T* yq = ring + G::Y0 + ring_add(sy, 5, G::NY) * G::YPLANE;
      if (pair_in) {
        const int qr = red_col(q), a = jl + 2, b = 2 * pl + 2;
        if (kb + qr < n) {
          T x0;
          T ax = ring_ax<G, G::XP, 2>(ring, P, a, b + qr, p.scale, x0);
          if (p.alpha != nullptr) ax = p.a_coef * oc.a * x0 + ax;
          yq[a * G::YP + b + qr] = x0 + oc.d * (oc.r - ax);
        }
        if (kb + (qr ^ 1) < n) {
          const int o = b + (qr ^ 1);
          yq[a * G::YP + o] = ring[P.f[2] + (a + 2) * G::XP + o + 2];
        }
      }
      if (has_frame && inside(fj)) {
        const int qr = red_frame(q);
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          if (!inside(fk + cc)) continue;
          if (cc == qr) {
            T x0;
            T ax = ring_ax<G, G::XP, 2>(ring, P, fa, fb + cc, p.scale, x0);
            if (p.alpha != nullptr) ax = p.a_coef * of.a * x0 + ax;
            yq[fa * G::YP + fb + cc] = x0 + of.d * (of.r - ax);
          } else {
            yq[fa * G::YP + fb + cc] = ring[P.f[2] + (fa + 2) * G::XP + fb + cc + 2];
          }
        }
      }
    } else if (q < ghost_end) {
      y_ghosts(q);
    }
    __syncthreads();

    // B. the (j, k) ghosts of y plane q and of x plane q+3 (whose copies
    // arrived last iteration), then black on plane q-3
    if (q < red_end && edge) y_ghosts(q);
    patch(q + 3, ring_add(sx, 5, G::NX));
    if (q == 3 && qs == 0) {
      y_ghosts(-2);
      y_ghosts(-1);
      __syncthreads();
    }
    const int b = q - 3;
    if (b >= ia && pair_in) {
      const Planes P = planes_at<G>(G::Y0, G::YPLANE, G::NY, sy, sb, sj);
      const int qb = red_col(b) ^ 1;  // the black cell of the pair
      const int a = jl + 2, rb = 2 * pl + 2;
      T v = T(0);
      if (kb + qb < n) {
        T y0;
        T ax = ring_ax<G, G::YP, 0>(ring, P, a, rb + qb, p.scale, y0);
        if (p.alpha != nullptr) ax = p.a_coef * ob.a * y0 + ax;
        v = y0 + ob.d * (ob.r - ax);
      }
      const T other = ring[P.f[2] + a * G::YP + rb + (qb ^ 1)];
      store_pair(p.out, (static_cast<int64_t>(b) * n + j) * n + kb, qb ? other : v,
                 qb ? v : other, vec, has_hi);
    }
    cp_async_wait<0>();
    __syncthreads();
  }
}

template <typename T>
size_t ring_bytes() {
  return Tile<T>::G::kRingValues * sizeof(T) + kPairValues<T> * sizeof(unsigned short);
}

// Chunk length along i: the caller's, or so that the columns times the
// chunks give ~kWaves waves of co-resident blocks, at least 16 planes (a
// chunk recomputes the red of 4 planes below it and runs 3 planes of red
// ahead), 4 on levels of 64 planes or fewer, whose few columns leave the
// card idle otherwise; never below 4 planes (the ghost planes -2, -1 wait
// for red planes 0 .. 3 in the first chunk). Measured on an H100, f32 ms a
// sweep by chunk (an earlier version of the kernel): 64^3 0.064 (4), 0.087
// (8), 0.130 (16); 128^3 0.243 (4), 0.201 (8), 0.162 (16); this version at
// 512^3: 4.64 (32), 4.47 (48), 4.48 (57), 4.35 (96).
constexpr int kWaves = 8;

template <typename T>
int launch_gsrb2(const Gsrb2Args<T>& p, int chunk, cudaStream_t s) {
  using G = typename Tile<T>::G;
  auto kernel = fv4_gsrb2_kernel<T, G::THREADS, G::BLOCKS>;
  const size_t smem = ring_bytes<T>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n = p.n;
  const int64_t tiles = static_cast<int64_t>((n + G::TJ - 1) / G::TJ) * ((n + G::TK - 1) / G::TK);
  if (chunk <= 0) {
    static const int64_t slots = [&]() -> int64_t {
      int dev = 0, sms = 0, per_sm = 0;
      if (cudaGetDevice(&dev) != cudaSuccess ||
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G::THREADS, smem) !=
              cudaSuccess)
        return 0;
      return static_cast<int64_t>(sms) * per_sm;
    }();
    if (slots <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int64_t chunks = (kWaves * slots + tiles - 1) / tiles;
    chunk = static_cast<int>((n + chunks - 1) / chunks);
    const int min_chunk = n <= 64 ? 4 : 16;
    if (chunk < min_chunk) chunk = min_chunk;
  }
  if (chunk < 4) chunk = 4;
  if (chunk > n) chunk = n;
  const int chunks = (n + chunk - 1) / chunk;
  kernel<<<dim3(static_cast<unsigned>(tiles), chunks), G::THREADS, smem, s>>>(p, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* bie, const void* bje, const void* bke,
           const void* alpha, const void* rhs, const void* kd0, const void* kd1, void* out,
           int n, int chunk, double scale, double a_coef, void* stream) {
  if (n < 4 || n > 65535 || chunk < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Gsrb2Args<T> p{static_cast<const T*>(x),     static_cast<const T*>(bie),
                       static_cast<const T*>(bje),   static_cast<const T*>(bke),
                       static_cast<const T*>(alpha), static_cast<const T*>(rhs),
                       static_cast<const T*>(kd0),   static_cast<const T*>(kd1),
                       static_cast<T*>(out),         n,
                       static_cast<T>(scale),        static_cast<T>(a_coef)};
  return launch_gsrb2<T>(p, chunk, static_cast<cudaStream_t>(stream));
}

}  // namespace

// x, rhs, kd0, kd1, alpha, out: n^3 cell fields; chunk: i-planes per
// block (0: the launcher's rule)
extern "C" int hpgmg_fv4_gsrb2_f32(const void* x, const void* bie, const void* bje,
                                   const void* bke, const void* alpha, const void* rhs,
                                   const void* kd0, const void* kd1, void* out, int n,
                                   int chunk, double scale, double a_coef, void* stream) {
  return launch<float>(x, bie, bje, bke, alpha, rhs, kd0, kd1, out, n, chunk, scale, a_coef,
                       stream);
}

extern "C" int hpgmg_fv4_gsrb2_f64(const void* x, const void* bie, const void* bje,
                                   const void* bke, const void* alpha, const void* rhs,
                                   const void* kd0, const void* kd1, void* out, int n,
                                   int chunk, double scale, double a_coef, void* stream) {
  return launch<double>(x, bie, bje, bke, alpha, rhs, kd0, kd1, out, n, chunk, scale, a_coef,
                        stream);
}
