// K8a and K8b: the fv4 stencil of K1 (operators.fv4.c:87-114) on one rank's
// local block of a level decomposed over a process grid, its 2-deep i and
// j ghosts read from four thin halo slabs that the exchange
// (parallel/shard_kernels.py) filled, and on a block split along k its k
// ghosts from two more (KSLAB), in three modes:
//
//   apply     out = A x
//   residual  out = rhs - A x
//   gsrb      out = x + kdinv * (rhs - A x) at the cells of the sweep's
//             colour ((i+j+k) % 2 == parity; kdinv carries the same mask,
//             and local parity is global: block offsets are even),
//             out = x at the others
//
// where A x = scale * (main/12 + mixed/48) [+ a * alpha * x], scale = -b/h^2.
//
// K8a replaces hpgmg_tpu/kernels/stencils.py:fv4_call_slab (:1194, the
// pallas_call at :1268, body _fv4_kernel with slab=True). K8b replaces
// fv4_call_overlap (:1292): its interior pass (:1370), which reads no slab
// and so may run while the exchange is in flight, and its edge pass
// (:1421) over the rest of the block into the same output. Neither the
// pl.Element windows nor the j padding to 8 rows nor kbk_top is carried
// over: the slabs hold exactly their ghost rows, the face coefficients
// are cuts of the port's tangentially-extended arrays.
//
// Layouts (k fastest), for a local block of ni x nj x nk cells (ni, nj, nk
// even):
//   x, alpha, rhs, kdinv, out   (ni, nj, nk)
//   ilo, ihi   (2, nj, nk): the cells i = -2, -1 and i = ni, ni+1
//   jlo, jhi   (ni+4, 2, nk): the cells j = -2, -1 and j = nj, nj+1 at
//              i = -2 .. ni+1 (the i-extended strips, so the (i, j) edge
//              ghosts arrive with them, in the i-then-j order of the
//              separable fill)
//   klo, khi   (ni+4, nj+4, 2), a block split along k only: the cells
//              k = -2, -1 and k = nk, nk+1 at i = -2 .. ni+1, j = -2 ..
//              nj+1 (cut from the i- and j-extended block, so the edge and
//              corner ghosts arrive with them)
//   bie (ni+1, nj+2, nk+2), bje (ni+2, nj+1, nk+2), bke (ni+2, nj+2, nk+1):
//              the rank's cut of the tangentially-extended face arrays;
//              their tangential margins hold the true neighbour faces
//              (or the extrapolated ghosts at a domain face)
// A block whole along k makes its k ghosts: the quartic Dirichlet ones,
// from the four cells nearest the face of the same (i, j) row (slab rows
// included), or the periodic wrap. A block split along k (KSLAB) copies
// them from klo and khi, which hold the neighbour's cells, the wrap or the
// Dirichlet fill. i and j never wrap here: on the grid the periodic wrap
// and the Dirichlet fill of a domain face arrive in the slabs.
//
// What bounds it on an H100: device-memory bandwidth, as K1: gsrb reads x,
// the three beta arrays, rhs and kdinv at its colour and writes out, ~6
// values a cell against ~113 flops at half the cells; the slabs add
// 2 (ni + nj + 4) nk values.
//
// Design: K1's (fv4_stream.cu), on a copy of its column (below). A block
// owns a TJ x TK column of (j, k) and marches a chunk of i-planes; x and
// the three face arrays stream through a cp.async ring in shared memory,
// rhs and kdinv are read a plane ahead into registers, and the stencil's
// 25 x and 30 beta reads a cell come from the ring. What differs from K1:
// the three extents (the x plane pitch nj nk, the face arrays' rows of
// the block's width); x plane i < 0 or >= ni is a plane of ilo or ihi,
// the same pairs from another base pointer, so a chunk at the block's i
// face reads its halo planes from the slabs and an inner chunk from x; a
// pair of a j halo row (j < 0 or >= nj) copies from the strip jlo or jhi
// at ((i+2) 2 + r) nk + k (kStrip: only the first and last column tiles
// in j hold such rows, and the frame-first order of the pairs keeps them
// in the first warps); k ghosts: periodic ones are copies of the cells
// mod nk, Dirichlet ones are made in the ring over the row's four nearest
// k cells once the plane's copies have landed (patch_k: a plane two
// ahead, or the chunk's first planes), so a j halo row's ghost follows
// its strip cells and no value is made as a product over (j, k). With nk
// even and >= 4 the taps of a k ghost lie in the tile's halo whatever its
// width, so no ghost is read from device memory. Each thread owns two
// neighbouring k cells of a row, one of each colour: gsrb computes A x and
// reads rhs and kdinv at its colour's cell only and copies x at the other
// (which equals x + 0 r bit for bit). K8b launches the same kernel twice
// into one output: the interior pass over the column tiles 1 .. ntj-2 in j
// (and on a block split along k, 1 .. ntk-2 in k) and i-planes [2, ni-2),
// whose stencils read x alone (slab pointers null); the edge pass over the
// other columns (0 and ntj-1 in j; KSLAB: 0 and ntk-1 in k too) at every
// plane and the inner ones at planes 0, 1, ni-2, ni-1. KSLAB: a pair of a
// k ghost (k < 0 or k >= nk; two cells of one slab, k even) copies from
// klo or khi at ((i+2) (nj+4) + j+2) 2 + r, its x plane's and row's
// entries of the slab (kG0 | kG1 mark it, and kStrip which slab); only
// the first and last column tiles in k hold such pairs. Every cell is
// computed from the same ring values in the same order either way, so K8b
// equals K8a bit for bit, and any chunk of i-planes gives the same bits.
// bfloat16 (a bf16 solve's decomposed levels: x, the slabs, the faces,
// rhs, kdinv, alpha and out all bf16): K1's bf16 scheme (fv4_stream.cu).
// The ring holds float, so the arithmetic and the made k ghosts are the
// float kernel's; each bf16 value's aligned 32-bit word lands in its float
// slot by cp.async (an aligned pair as one word) and the thread that copied
// it widens the slot in place once its copies have arrived, before the
// barrier that publishes the plane (stream.cuh: cp_async_value,
// cp_async_pair, widen_value, widen_pair; fv4_stream.cuh: widen_beta);
// rhs, kdinv and alpha are widened as they are read (ldv, load2), each
// output rounded to bf16 once (store_pair). The slabs are float (the
// exchange widens the neighbours' cells, exactly, and keeps a Dirichlet
// domain face's ghost as float, as a whole level's kernel makes it) and
// are copied as they are.
// The C entries: fv4_slab.cu (float, double) and fv4_slab_bf16.cu
// (bfloat16), each its own translation unit, so that nvcc builds them in
// parallel. Plain version: hpgmg_tpu_torch/kernels/stencils.py:fv4_slab_plain.

#pragma once

#include "fv4_stream.cuh"

#include <cstdint>
#include <type_traits>

namespace {

// The column, as K1's (fv4_stream.cu): the tile and its ring, each
// thread's pairs of copies and the frame-first order of the x pairs, the
// ring offsets of what a plane's stencil reads and the stencil over them,
// the ring's bytes and the chunk rule. A copy: shared through a header, it
// moved K1's registers (f64 +1 to +7) and its f32 residual and fres time
// (+2-4%, in turns on the card), so K1's source stays as it was.

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

// Ring offsets (in values) of slot s of each field's planes.
constexpr int BI0 = NX * XPLANE, BJ0 = BI0 + NBI * BIPLANE, BK0 = BJ0 + NBJ * BJPLANE;

// The ring offsets of what the stencil of plane i reads.
struct Planes {
  int x[5];   // x planes i-2 .. i+2
  int bi[2];  // beta_i faces i, i+1
  int bj[3];  // beta_j array planes i .. i+2 (di = -1, 0, 1)
  int bk[3];
};

// ... from the slots of x plane i-2 (sx), beta_i face i (sb) and beta_j/k
// array plane i (sj)
__device__ __forceinline__ Planes ring_planes(int sx, int sb, int sj) {
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
  return P;
}

// A x at cell (jl, kl) of the tile on plane i (its x center returned in
// x0); p: the kernel's arguments (scale, alpha, a_coef), c: the cell's
// index in alpha
template <typename T, typename A>
__device__ __forceinline__ T stream_ax(const A& p, const T* ring, const Planes& P, int jl,
                                       int kl, int64_t c, T& x0) {
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

// dynamic shared memory: the ring, then the pairs
template <typename T>
size_t ring_bytes() { return kRingValues * sizeof(T) + kPairValues<T> * sizeof(unsigned); }

// Co-resident blocks of `kernel` on the card (sms times blocks an SM at
// `smem` bytes of dynamic shared memory), 0 where they cannot be read; a
// launcher keeps it in a static of its own instantiation.
template <typename K>
int64_t co_resident(K kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kStreamThreads, smem) !=
          cudaSuccess)
    return 0;
  return static_cast<int64_t>(sms) * per_sm;
}

// Chunk length along i: the caller's, or K1's rule (the columns times the
// chunks give ~kWaves waves of the card's `slots` co-resident blocks, at
// least kMinChunk planes a chunk) but never fewer blocks than one wave
// (the small blocks of the decomposed levels: at 16 planes a chunk a
// (32, 32, 64) block ran 4 blocks, 0.031 ms a gsrb in f32, at 1 plane
// 0.007); at most the planes there are; 0 where slots is 0.
constexpr int kMinChunk = 16;
constexpr int kWaves = 8;

inline int slab_chunk(int64_t slots, int64_t tiles, int planes, int chunk) {
  if (chunk <= 0) {
    if (slots <= 0) return 0;
    const int64_t chunks = (kWaves * slots + tiles - 1) / tiles;
    const int64_t wave = (planes * tiles + slots - 1) / slots;
    chunk = static_cast<int>((planes + chunks - 1) / chunks);
    if (chunk < kMinChunk) chunk = kMinChunk;
    if (chunk > wave) chunk = static_cast<int>(wave);
  }
  return chunk > planes ? planes : chunk;
}

// S: the storage type of every field; the arithmetic's, and the slabs',
// is Wide<S>
template <typename S>
struct SlabArgs {
  const S* x;
  const Wide<S>* ilo;
  const Wide<S>* ihi;
  const Wide<S>* jlo;
  const Wide<S>* jhi;
  const Wide<S>* klo;  // KSLAB only
  const Wide<S>* khi;
  const S* bie;
  const S* bje;
  const S* bke;
  const S* alpha;  // nullptr: no a*alpha*x term
  const S* rhs;
  const S* kdinv;
  S* out;
  int ni, nj, nk;
  Wide<S> scale;  // -b / h^2
  Wide<S> a_coef;
};

// x pair flag: the pair lies in a j halo row, copied from jlo (ring row
// < 2) or jhi (kW1's bit: K8a wraps no pair, nk being even); on a k-slab
// pair (KSLAB, kG0 set), that it copies from khi, not klo
constexpr unsigned kStrip = kW1;

struct SlabColumn {
  int j0, k0;
  bool periodic;  // k ghosts are wrapped cells
  // Dirichlet tile whose halo holds k ghosts, made in the ring (patch_k)
  bool patch;
};

// The x pairs of this thread: the tile and its 2-cell halo, two k cells a
// pair (k even). Rows j in [0, nj) from x (or ilo, ihi), j halo rows from
// the strips; k ghosts from the k slabs (KSLAB), wrapped (periodic) or
// left to patch_k (kG0, kG1). Rows beyond nj+1 and columns beyond nk+1
// (ragged tiles) are not loaded: only cells outside the block read them.
template <typename T, typename S, bool KSLAB>
__device__ __forceinline__ void slab_x_pairs(XPairs<T>& P, const SlabArgs<S>& p,
                                             const SlabColumn& c) {
  const int nj = p.nj, nk = p.nk;
  auto inside = [nk](int v) { return v >= 0 && v < nk; };
  // every plane keeps a pair's alignment: the plane pitches nj nk and 2 nk
  // are even, as is a pair's first k
  const bool mid = pair_aligned(p.x) && pair_aligned(p.ilo) && pair_aligned(p.ihi);
  const bool lo = pair_aligned(p.jlo), hi = pair_aligned(p.jhi);
#pragma unroll
  for (int e = 0; e < kXE; ++e) {
    const int t = threadIdx.x + e * kStreamThreads;
    int a, b;
    x_pair_at(t, a, b);
    const int j = c.j0 - 2 + a, k = c.k0 - 2 + b;
    unsigned f = 0, g = 0;
    if (t < XPAIRS && j < nj + 2 && k < nk + 2) {
      f = kE0 | (k + 1 < nk + 2 ? kE1 : 0u);
      int kk = k;
      if (KSLAB && !inside(k)) {
        kk = 0;  // the pair's row in the k slab (below)
      } else if (c.periodic) {
        kk = k < 0 ? k + nk : (k >= nk ? k - nk : k);
      } else {
        kk = inside(k) ? k : 0;
        if (!inside(k)) f |= kG0;
        if (!inside(k + 1)) f |= kG1;
      }
      bool aligned = mid;
      if (j < 0) {
        g = static_cast<unsigned>(j + 2) * nk + kk;
        f |= kStrip;
        aligned = lo;
      } else if (j >= nj) {
        g = static_cast<unsigned>(j - nj) * nk + kk;
        f |= kStrip;
        aligned = hi;
      } else {
        g = static_cast<unsigned>(j) * nk + kk;
      }
      if (KSLAB && !inside(k)) {
        g = static_cast<unsigned>(j + 2) * 2;
        f = (f & ~kStrip) | kG0 | kG1 | (k >= nk ? kStrip : 0u);
      }
      if ((f & (kE1 | kG0 | kG1)) == kE1 && aligned) f |= kPair;
    }
    P.set(e, g, static_cast<unsigned>(a * XP + b) << kMetaShift | f);
  }
}

// x plane i (in [-2, ni+2)) into the ring plane dst: rows in [0, nj) from
// x plane i, or from ilo / ihi where i lies outside the block; j halo rows
// from the strips; k ghosts from the k slabs (KSLAB), or Dirichlet ones
// left to patch_k. The slabs are in the ring's type; a bf16 x lands as its
// values' words (stream.cuh: cp_async_value, cp_async_pair; an aligned
// pair as one word), which slab_widen_x turns into floats once this
// thread's copies have arrived.
template <typename T, typename S, bool KSLAB>
__device__ __forceinline__ void slab_load_x(T* dst, const SlabArgs<S>& p, const XPairs<T>& P,
                                            int i) {
  const int64_t pitch = static_cast<int64_t>(p.nj) * p.nk;
  const bool inx = i >= 0 && i < p.ni;
  const S* const xplane = p.x + i * pitch;
  const S* const xend = p.x + p.ni * pitch;
  const T* const splane = i < 0 ? p.ilo + (i + 2) * pitch : p.ihi + (i - p.ni) * pitch;
  const int64_t strip = static_cast<int64_t>(i + 2) * 2 * p.nk;
#pragma unroll
  for (int e = 0; e < kXE; ++e) {
    const unsigned m = P.meta(e);
    T* d = dst + (m >> kMetaShift);
    if constexpr (KSLAB) {
      if (m & kG0) {
        const T* k = ((m & kStrip) ? p.khi : p.klo) +
                     static_cast<int64_t>(i + 2) * (p.nj + 4) * 2 + P.goff(e);
        cp_async(d, k);
        if (m & kE1) cp_async(d + 1, k + 1);
        continue;
      }
    }
    if ((m & kStrip) || !inx) {
      const T* src = ((m & kStrip) ? ((m >> kMetaShift) < 2 * XP ? p.jlo : p.jhi) + strip
                                   : splane) +
                     P.goff(e);
      if (m & kPair) {
        cp_async2(d, src);
        continue;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if ((m & (kE0 << q)) && !(m & (kG0 << q))) cp_async(d + q, src + q);
      }
      continue;
    }
    const S* src = xplane + P.goff(e);
    if (m & kPair) {
      if constexpr (std::is_same_v<T, S>) {
        cp_async2(d, src);
      } else {
        cp_async_pair(d, src);
      }
      continue;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if ((m & (kE0 << q)) && !(m & (kG0 << q))) cp_async_value(d + q, src + q, xend);
    }
  }
}

// The words slab_load_x copied into the ring plane dst from x plane i,
// widened in place (nothing where x is stored in the ring's type, and
// nothing from the slabs); call once this thread's copies of the plane
// have arrived.
template <typename T, typename S, bool KSLAB>
__device__ __forceinline__ void slab_widen_x(T* dst, const SlabArgs<S>& p, const XPairs<T>& P,
                                             int i) {
  if constexpr (!std::is_same_v<T, S>) {
    if (i < 0 || i >= p.ni) return;
    const S* const xplane = p.x + i * static_cast<int64_t>(p.nj) * p.nk;
#pragma unroll
    for (int e = 0; e < kXE; ++e) {
      const unsigned m = P.meta(e);
      if ((KSLAB && (m & kG0)) || (m & kStrip)) continue;
      T* d = dst + (m >> kMetaShift);
      if (m & kPair) {
        widen_pair(d);
        continue;
      }
      const S* src = xplane + P.goff(e);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if ((m & (kE0 << q)) && !(m & (kG0 << q))) widen_value(d + q, src + q);
      }
    }
  }
}

// The Dirichlet k ghosts of one x plane of a patched tile (at `plane` in
// the ring) held by this thread's pairs: the quartic taps over the four
// nearest k cells of the same row, summed in slab_value's order. Call once
// the plane's copies have arrived and are visible to the block. Out of
// line, so that the registers of the threads that never call it stay the
// main loop's.
template <typename T>
__device__ __noinline__ void patch_k(T* plane, const SlabColumn c, int nk,
                                     const XPairs<T> P) {
#pragma unroll
  for (int e = 0; e < kXE; ++e) {
    const unsigned m = P.meta(e);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (!(m & (kE0 << q)) || !(m & (kG0 << q))) continue;
      const int off = static_cast<int>(m >> kMetaShift) + q;
      const int row = off - off % XP;
      int kk[4];
      T wk[4];
      axis_taps(c.k0 - 2 + off % XP, nk, kk, wk);
      T s = T(0);
#pragma unroll
      for (int d = 0; d < 4; ++d) s += wk[d] * plane[row + (kk[d] - c.k0 + 2)];
      plane[off] = s;
    }
  }
}

// Everything a block streams: the sources, its pairs of each, and the
// slots of its ring.
template <typename S, bool KSLAB, typename T = Wide<S>>
struct SlabStream {
  const SlabArgs<S>& p;
  XPairs<T> px;
  Pairs<T, kBE, kXE> pi;
  Pairs<T, kBE, kXE + kBE> pj;
  Pairs<T, kBE, kXE + 2 * kBE> pk;

  // x plane q, beta_i face q, beta_j and beta_k array plane q into their
  // slots sx, sb, sj (the ring's float slots hold a bf16 field's words
  // until widen turns them into values)
  __device__ __forceinline__ void x(T* ring, int sx, int q) const {
    slab_load_x<T, S, KSLAB>(ring + sx * XPLANE, p, px, q);
  }
  __device__ __forceinline__ void bi(T* ring, int sb, int q) const {
    load_beta(ring + BI0 + sb * BIPLANE, p.bie, pi, q, p.nj + 2, p.nk + 2, p.ni + 1);
  }
  __device__ __forceinline__ void bjk(T* ring, int sj, int q) const {
    load_beta(ring + BJ0 + sj * BJPLANE, p.bje, pj, q, p.nj + 1, p.nk + 2, p.ni + 2);
    load_beta(ring + BK0 + sj * BKPLANE, p.bke, pk, q, p.nj + 2, p.nk + 1, p.ni + 2);
  }
  // the planes x q, beta_i face qb and beta_j/k qj in slots sx, sb, sj, whose
  // copies this thread has seen arrive, widened where stored in bf16
  __device__ __forceinline__ void widen(T* ring, int sx, int q, int sb, int qb, int sj,
                                        int qj) const {
    slab_widen_x<T, S, KSLAB>(ring + sx * XPLANE, p, px, q);
    widen_beta(ring + BI0 + sb * BIPLANE, p.bie, pi, qb, p.nj + 2, p.nk + 2);
    widen_beta(ring + BJ0 + sj * BJPLANE, p.bje, pj, qj, p.nj + 1, p.nk + 2);
    widen_beta(ring + BK0 + sj * BKPLANE, p.bke, pk, qj, p.nj + 2, p.nk + 1);
  }
};

// What block b computes: column tile (tj, tk) over i-planes [ia, ib).
// PASS 0 (K8a): every column, grid (tiles, chunks of [0, ni)). PASS 1
// (K8b's interior): the inner columns, grid (their tiles, chunks of [2,
// ni-2)). PASS 2 (K8b's edge): grid (edge chunks_a + 2 inner, 1), first
// the edge columns by chunks of [0, ni), then each inner column at planes
// [0, 2) and [ni-2, ni). The edge columns are 0 and ntj-1 in j (and
// KSLAB: the others' 0 and ntk-1 in k), the inner ones the rest.
template <int PASS, bool KSLAB>
__device__ __forceinline__ void slab_work(int ni, int nj, int nk, int chunk, int& tj,
                                          int& tk, int& ia, int& ib) {
  const int tiles_k = (nk + TK - 1) / TK;
  // the inner columns' tiles along k, from tk_lo
  const int tk_in = KSLAB ? tiles_k - 2 : tiles_k, tk_lo = KSLAB ? 1 : 0;
  if constexpr (PASS == 0) {
    tj = static_cast<int>(blockIdx.x) / tiles_k;
    tk = static_cast<int>(blockIdx.x) % tiles_k;
    ia = blockIdx.y * chunk;
    ib = min(ia + chunk, ni);
  } else if constexpr (PASS == 1) {
    tj = 1 + static_cast<int>(blockIdx.x) / tk_in;
    tk = tk_lo + static_cast<int>(blockIdx.x) % tk_in;
    ia = 2 + blockIdx.y * chunk;
    ib = min(ia + chunk, ni - 2);
  } else {
    const int ntj = (nj + TJ - 1) / TJ;
    const int edge = 2 * tiles_k + (KSLAB ? 2 * (ntj - 2) : 0);
    const int run = edge * ((ni + chunk - 1) / chunk);
    const int b = blockIdx.x;
    if (b < run) {
      const int t = b % edge;
      if (t < 2 * tiles_k) {
        tj = t < tiles_k ? 0 : ntj - 1;
        tk = t % tiles_k;
      } else {
        const int u = t - 2 * tiles_k;
        tj = 1 + u / 2;
        tk = (u & 1) ? tiles_k - 1 : 0;
      }
      ia = (b / edge) * chunk;
      ib = min(ia + chunk, ni);
    } else {
      const int u = b - run, t = u >> 1;
      tj = 1 + t / tk_in;
      tk = tk_lo + t % tk_in;
      ia = (u & 1) ? ni - 2 : 0;
      ib = ia + 2;
    }
  }
}

// One block: the TJ x TK column and i-planes of slab_work. Dynamic shared
// memory: the ring (kRingValues values of Wide<S>), then the threads'
// pairs. S: the storage type of the fields; Wide<S> the ring's and the
// arithmetic's.
template <typename S, int MODE, int PASS, bool KSLAB>
__global__ void __launch_bounds__(kStreamThreads, kMinBlocks<Wide<S>>)
    fv4_slab_kernel(const SlabArgs<S> p, int periodic, int parity, int chunk) {
  using T = Wide<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int ni = p.ni, nj = p.nj, nk = p.nk;
  int tj, tk, ia, ib;
  slab_work<PASS, KSLAB>(ni, nj, nk, chunk, tj, tk, ia, ib);
  const int j0 = tj * TJ, k0 = tk * TK;
  // KSLAB: no k ghost is made or wrapped (the k slabs hold them)
  const SlabColumn col{j0, k0, !KSLAB && periodic != 0,
                       !KSLAB && !periodic && (k0 < 2 || k0 + TK + 2 > nk)};
  SlabStream<S, KSLAB> St{p};
  if constexpr (kPairValues<T> > 0) {
    unsigned* pairs = reinterpret_cast<unsigned*>(ring + kRingValues) + threadIdx.x;
    St.px.b = St.pi.b = St.pj.b = St.pk.b = pairs;
  }
  slab_x_pairs<T, S, KSLAB>(St.px, p, col);
  beta_pairs<BP, kStreamThreads>(St.pi, p.bie, nj + 2, nk + 2, j0, k0, TJ + 2, TK + 2);
  beta_pairs<BP, kStreamThreads>(St.pj, p.bje, nj + 1, nk + 2, j0, k0, TJ + 1, TK + 2);
  beta_pairs<BP, kStreamThreads>(St.pk, p.bke, nj + 2, nk + 1, j0, k0, TJ + 2, TK + 1);
  // whether this thread holds k ghosts of x (the first warps, or a ragged
  // tile's)
  bool has_ghost = false;
#pragma unroll
  for (int e = 0; e < kXE; ++e) has_ghost |= (St.px.meta(e) & (kG0 | kG1)) != 0;
  has_ghost = has_ghost && col.patch;

  // ring slots of x plane i-2, beta_i face i, beta_j/k plane i (plane q in
  // slot q mod the ring's size); the planes in flight go to the slots just
  // before them. Group 0: the planes of ia's stencil (x ia-2 .. ia+2,
  // beta_i ia, ia+1, beta_j/k ia .. ia+2); group 1: those plane ia+1 adds.
  int sx = (ia - 2 + NX) % NX, sb = ia % NBI, sj = ia % NBJ;
  const int last = ia + 1 < ib ? ia + 3 : ia + 2;
#pragma unroll
  for (int d = 0; d < 5; ++d) St.x(ring, ring_add(sx, d, NX), ia - 2 + d);
#pragma unroll
  for (int d = 0; d < 2; ++d) St.bi(ring, ring_add(sb, d, NBI), ia + d);
#pragma unroll
  for (int d = 0; d < 3; ++d) St.bjk(ring, ring_add(sj, d, NBJ), ia + d);
  cp_async_commit();
  if (ia + 1 < ib) {
    St.x(ring, ring_add(sx, 5, NX), ia + 3);
    St.bi(ring, ring_add(sb, 2, NBI), ia + 2);
    St.bjk(ring, ring_add(sj, 3, NBJ), ia + 3);
  }
  cp_async_commit();
  // a patched tile waits for both and makes the k ghosts of x planes
  // ia-2 .. last; a bf16 field's words of the arrived groups are widened
  // before the barrier (group 1's, where it is not waited for here, at the
  // end of plane ia)
  if (col.patch) {
    cp_async_wait<0>();
  } else {
    cp_async_wait<1>();
  }
  if constexpr (!std::is_same_v<S, T>) {
#pragma unroll
    for (int d = 0; d < 5; ++d)
      slab_widen_x<T, S, KSLAB>(ring + ring_add(sx, d, NX) * XPLANE, p, St.px, ia - 2 + d);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if (d < 2) widen_beta(ring + BI0 + ring_add(sb, d, NBI) * BIPLANE, p.bie, St.pi, ia + d,
                            nj + 2, nk + 2);
      widen_beta(ring + BJ0 + ring_add(sj, d, NBJ) * BJPLANE, p.bje, St.pj, ia + d, nj + 1,
                 nk + 2);
      widen_beta(ring + BK0 + ring_add(sj, d, NBJ) * BKPLANE, p.bke, St.pk, ia + d, nj + 2,
                 nk + 1);
    }
    if (col.patch && ia + 1 < ib)
      St.widen(ring, ring_add(sx, 5, NX), ia + 3, ring_add(sb, 2, NBI), ia + 2,
               ring_add(sj, 3, NBJ), ia + 3);
  }
  __syncthreads();
  if (col.patch) {
    if (has_ghost) {
      for (int q = ia - 2; q <= last; ++q)
        patch_k(ring + ring_add(sx, q - ia + 2, NX) * XPLANE, col, nk, St.px);
    }
    __syncthreads();
  }

  // thread: row jl, pair pl (cells k0 + 2 pl, k0 + 2 pl + 1; nk even, so
  // both lie in the block or neither)
  const int jl = threadIdx.x / (TK / 2), pl = threadIdx.x % (TK / 2);
  const int j = j0 + jl, kb = k0 + 2 * pl;
  const bool pair_in = j < nj && kb < nk;
  const bool out_vec = pair_aligned(p.out);

  // rhs (and kdinv) at this thread's cells of plane i, read a plane ahead
  // into registers: gsrb the colour's cell, residual the pair
  const bool rhs_vec = pair_aligned(p.rhs);
  auto fetch = [&](int i, T& r0, T& r1, T& kd) {
    if (MODE == kApply || !pair_in) return;
    const int64_t c = (static_cast<int64_t>(i) * nj + j) * nk + kb;
    if (MODE == kGsrb) {
      const int q = (parity + i + j) & 1;
      r0 = ldv<T>(p.rhs + c + q);
      kd = ldv<T>(p.kdinv + c + q);
    } else if (rhs_vec) {
      load2(p.rhs + c, r0, r1);
    } else {
      r0 = ldv<T>(p.rhs + c);
      r1 = ldv<T>(p.rhs + c + 1);
    }
  };
  T nr0 = T(0), nr1 = T(0), nkd = T(0);
  fetch(ia, nr0, nr1, nkd);

  for (int i = ia; i < ib; ++i) {
    // the copies plane i+2 adds: x plane i+4, beta_i face i+3, beta_j/k
    // plane i+4, each into the slot before the first one plane i reads
    if (i + 2 < ib) {
      St.x(ring, ring_add(sx, NX - 1, NX), i + 4);
      St.bi(ring, ring_add(sb, NBI - 1, NBI), i + 3);
      St.bjk(ring, ring_add(sj, NBJ - 1, NBJ), i + 4);
    }
    cp_async_commit();
    const T r0 = nr0, r1 = nr1, kd = nkd;
    if (i + 1 < ib) fetch(i + 1, nr0, nr1, nkd);

    const Planes P = ring_planes(sx, sb, sj);
    const int64_t row = (static_cast<int64_t>(i) * nj + j) * nk;
    // the cell of this pair with parity (i + j + k) % 2 == 0 comes first
    const int q0 = (i + j) & 1;

    if constexpr (MODE == kGsrb) {
      if (pair_in) {
        const int q = (parity + i + j) & 1;  // the sweep's colour
        T x0;
        const T ax = stream_ax(p, ring, P, jl, 2 * pl + q, row + kb + q, x0);
        const T v = x0 + kd * (r0 - ax);
        const T other = ring[P.x[2] + (jl + 2) * XP + (2 * pl + (q ^ 1) + 2)];
        store_pair(p.out, row + kb, q ? other : v, q ? v : other, out_vec, true);
      }
    } else if (pair_in) {
      T r[2];  // by q: cell kb + (q0 ^ q)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int dk = q0 ^ q;
        T x0;
        const T ax = stream_ax(p, ring, P, jl, 2 * pl + dk, row + kb + dk, x0);
        if constexpr (MODE == kApply) {
          r[q] = ax;
        } else {
          r[q] = (dk ? r1 : r0) - ax;
        }
      }
      store_pair(p.out, row + kb, q0 ? r[1] : r[0], q0 ? r[0] : r[1], out_vec, true);
    }

    // the k ghosts of x plane i+2, whose copies have arrived, made during
    // plane i, which reads only its tile cells; plane i+1 reads them first
    if (has_ghost && i + 1 < ib && i >= ia + 2)
      patch_k(ring + ring_add(sx, 4, NX) * XPLANE, col, nk, St.px);
    // the copies of plane i+1 (group i+1) have arrived, those of i+2 may not;
    // a bf16 field's words among them (x plane i+3, beta_i face i+2,
    // beta_j/k plane i+3, which plane i+1 reads first) widened by the
    // thread that copied them (a patched tile widened plane ia's in the
    // prologue)
    cp_async_wait<1>();
    if constexpr (!std::is_same_v<S, T>) {
      if (i + 1 < ib && !(col.patch && i == ia))
        St.widen(ring, ring_add(sx, 5, NX), i + 3, ring_add(sb, 2, NBI), i + 2,
                 ring_add(sj, 3, NBJ), i + 3);
    }
    __syncthreads();
    sx = ring_add(sx, 1, NX);
    sb = ring_add(sb, 1, NBI);
    sj = ring_add(sj, 1, NBJ);
  }
}

template <typename S, int MODE, int PASS, bool KSLAB>
int launch_pass(const SlabArgs<S>& p, int periodic, int parity, int chunk, cudaStream_t s) {
  auto kernel = fv4_slab_kernel<S, MODE, PASS, KSLAB>;
  const size_t smem = ring_bytes<Wide<S>>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t tiles_k = (p.nk + TK - 1) / TK, ntj = (p.nj + TJ - 1) / TJ;
  const int64_t tk_in = KSLAB ? tiles_k - 2 : tiles_k;
  // the columns and i-planes the chunk rule spreads: every column (K8a),
  // the inner ones over [2, ni-2) (K8b's interior), the edge ones (K8b's
  // edge; its inner columns' four planes are one block each side)
  const int64_t edge = 2 * tiles_k + (KSLAB ? 2 * (ntj - 2) : 0);
  const int64_t tiles = PASS == 0 ? tiles_k * ntj : (PASS == 1 ? tk_in * (ntj - 2) : edge);
  const int planes = PASS == 1 ? p.ni - 4 : p.ni;
  static const int64_t slots = co_resident(kernel, smem);
  chunk = slab_chunk(slots, tiles, planes, chunk);
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t chunks = (planes + chunk - 1) / chunk;
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(chunks));
  if (PASS == 2) grid = dim3(static_cast<unsigned>(tiles * chunks + 2 * tk_in * (ntj - 2)), 1);
  kernel<<<grid, kStreamThreads, smem, s>>>(p, periodic, parity, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PASS, bool KSLAB>
int launch_mode(const SlabArgs<T>& p, int mode, int periodic, int parity, int chunk,
                cudaStream_t s) {
  switch (mode) {
    case kApply: return launch_pass<T, kApply, PASS, KSLAB>(p, periodic, parity, chunk, s);
    case kResidual:
      return launch_pass<T, kResidual, PASS, KSLAB>(p, periodic, parity, chunk, s);
    default: return launch_pass<T, kGsrb, PASS, KSLAB>(p, periodic, parity, chunk, s);
  }
}

template <typename T, bool KSLAB>
int launch_split(const SlabArgs<T>& p, int mode, int periodic, int parity, int chunk,
                 int pass, cudaStream_t s) {
  if (pass == 0) return launch_mode<T, 0, KSLAB>(p, mode, periodic, parity, chunk, s);
  if (pass == 1) return launch_mode<T, 1, KSLAB>(p, mode, periodic, parity, chunk, s);
  return launch_mode<T, 2, KSLAB>(p, mode, periodic, parity, chunk, s);
}

template <typename T>
int launch_slab(const void* x, const void* ilo, const void* ihi, const void* jlo,
                const void* jhi, const void* klo, const void* khi, const void* bie,
                const void* bje, const void* bke, const void* alpha, const void* rhs,
                const void* kdinv, void* out, int ni, int nj, int nk, int mode, int periodic,
                int ksplit, int parity, int chunk, double scale, double a_coef, int pass,
                void* stream) {
  const int64_t ntj = (nj + TJ - 1) / TJ, tiles_k = (nk + TK - 1) / TK;
  if (ni < 4 || nj < 4 || nk < 4 || ni % 2 || nj % 2 || nk % 2 || ni > 65535 ||
      static_cast<int64_t>(nj + 4) * nk >= (int64_t(1) << 31) ||
      ntj * tiles_k * (ni + 4) >= (int64_t(1) << 31) || mode < kApply || mode > kGsrb ||
      parity < 0 || parity > 1 || chunk < 0 || pass < 0 || pass > 2 || ksplit < 0 ||
      ksplit > 1 || (pass != 0 && (ntj < 3 || ni < 6 || (ksplit && tiles_k < 3))) ||
      (ksplit && pass != 1 && (klo == nullptr || khi == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using W = Wide<T>;
  const SlabArgs<T> p{static_cast<const T*>(x),     static_cast<const W*>(ilo),
                      static_cast<const W*>(ihi),   static_cast<const W*>(jlo),
                      static_cast<const W*>(jhi),   static_cast<const W*>(klo),
                      static_cast<const W*>(khi),   static_cast<const T*>(bie),
                      static_cast<const T*>(bje),   static_cast<const T*>(bke),
                      static_cast<const T*>(alpha), static_cast<const T*>(rhs),
                      static_cast<const T*>(kdinv), static_cast<T*>(out),
                      ni, nj, nk,
                      static_cast<Wide<T>>(scale),  static_cast<Wide<T>>(a_coef)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ksplit) return launch_split<T, true>(p, mode, periodic, parity, chunk, pass, s);
  return launch_split<T, false>(p, mode, periodic, parity, chunk, pass, s);
}

}  // namespace
