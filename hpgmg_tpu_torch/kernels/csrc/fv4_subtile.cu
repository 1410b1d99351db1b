// K1s: the fv4 stencil of K1 (operators.fv4.c:87-114) in one pass over a
// Dirichlet level, for the small levels, with the quartic volume-averaged
// Dirichlet ghosts of x made inside the kernel, in three modes:
//
//   apply     out = A x
//   residual  out = rhs - A x
//   gsrb      out = x + kdinv * (rhs - A x) at the cells of the sweep's
//             colour ((i+j+k) % 2 == parity; kdinv carries the same mask),
//             out = x at the others
//
// where A x = scale * (main/12 + mixed/48) [+ a * alpha * x], scale = -b/h^2.
//
// Replaces hpgmg_tpu/kernels/stencils.py:_fv4_kernel_subtile (:918), reached
// through _fv4_call_subtile (:1028) when SUBTILE is set. That kernel fetched
// one large (bi, bj) window of x and beta once per launch and ran the stencil
// body over short sub-tiles along i, so that its VMEM temporaries stayed
// sub-tile sized; the Dirichlet ghosts were built in the kernel from the
// window. What is kept is the computation (K1's apply, residual and gsrb in
// one launch, the ghosts made in the kernel, no fres mode); none of its
// layout (pl.Element windows, the j padding, kbk_top, the PREDIFF operands):
// this kernel reads the port's tangentially-extended beta arrays as K1 does
// (fv4_common.cuh). The sub-tile becomes a short tile along i.
//
// What bounds it on an H100: on the levels it is for (64^3 and below, the
// whole level in L2), latency. A 64^3 gsrb moves 7.3 MB (x, the three face
// arrays, rhs and kdinv read once, out written once: 2.2 us at 3.35 TB/s),
// less than a launch and a round trip to memory cost. K1 marches columns of
// at least 16 i-planes there (32 blocks at 64^3, one barrier a plane), and
// the tile kernel this one replaces had 64 blocks at 64^3, each thread
// walking 16 cells along i with 30 beta reads a cell through L1, one round
// trip after another.
//
// Design: one pass, no march. A block of 256 threads owns a TI x 8 x 32
// tile of (i, j, k) cells (k fastest); TI, the tile length along i, is the
// launcher's (below) or the caller's. It stages everything it reads into
// shared memory in one batch of cp.async copies: x on the tile with its
// 2-cell halo, the tile's beta_i, beta_j and beta_k faces (with their
// tangential rows), and the rhs, kdinv and alpha values of its own cells;
// two neighbouring values a copy where the pair is aligned, one otherwise.
// cp.async and not TMA: beta's rows of n+1 or n+2 values break TMA's
// 16-byte stride rule. Then one barrier: the time is one round trip to L2
// or memory, not one a cell. A tile whose halo leaves the domain then makes
// its Dirichlet ghosts in shared memory from the staged cells (ghost_taps:
// the tensor product of the per-axis quartic taps, edges included, which
// the mixed terms read; K1's formula, so the same bits), and meets a second
// barrier; a tile with fewer than 2 cells along an axis (its halo then does
// not hold the taps) reads them from device memory, as K1 does. Its
// threads take one ghost each from the three boxes that hold them (a first
// version ran over the whole x box, each warp waiting on its few ghost
// lanes). Each thread
// owns a k-pair of cells on every second i-plane of the tile (the 128 pairs
// of a plane, two planes at a time), so exactly one cell of a pair has the
// sweep's colour: gsrb computes A x there only (rhs and kdinv staged there
// only) and copies x at the other cell, which equals K1's x + 0 * r. Rows j
// and j+1 of a warp take opposite cells of their pairs, so the even pitches
// keep the shared reads free of bank conflicts; apply and residual compute
// both cells in the same two steps. The stencil's 25 x and 30 beta reads a
// cell come from shared memory, each at a constant offset from the cell's
// four base addresses. The arithmetic is fv4_combination (fv4_common.cuh)
// with K1's ghost formula, so on Dirichlet levels the result equals K1
// (fv4_stream.cu) bit for bit.
//
// Tile length: a block's time is taken as ceil(TI/2) cells a thread plus a
// fill of kFill planes (its halo, its two barriers, the round trip), and
// the launcher takes the TI <= kMaxTI whose waves of co-resident blocks
// (queried once for each TI) times that time is least: at 64^3, TI = 4,
// 256 blocks for 132 SMs. Any TI gives the same bits.
// Float: 107-108 registers a thread, double 128, two blocks an SM, no
// spill. Measured on an H100 (bench/stencil_times.py --subtile, device ms,
// f32 gsrb; PERF.md): 0.0081 at 16^3, 0.0124 at 64^3 (the tile kernel it
// replaces: 0.0391; K1 0.0500), 0.3222 at 256^3 (K1 0.3310-0.3351), 2.450
// at 512^3 (K1 2.203), where K1's stream of planes wins; the rule is within
// 1% of the best forced TI in f32.
// bfloat16: the boxes hold float; each bf16 value's 32-bit word is staged
// into its float slot by the same cp.async batch, and a second walk over
// the boxes widens the slots this thread copied (stream.cuh) before the
// barrier; each output rounded to bf16 once.
// Plain version: hpgmg_tpu_torch/kernels/stencils.py:fv4_subtile_plain.

#include "fv4_stream.cuh"

#include <climits>

namespace {

constexpr int kSubThreads = 256;
// tile (j, k) extent; a plane of it is kPairs k-pairs, a thread's pairs lie
// on every second plane
constexpr int SJ = 8, SK = 32;
constexpr int kPairs = SJ * SK / 2;
static_assert(kSubThreads == 2 * kPairs && SK == 32, "two rows of pairs a warp");
constexpr int XJ = SJ + 4, XK = SK + 4;  // x box rows, pitch (even)
constexpr int BP = SK + 2;               // face box pitch (even)
constexpr int kMaxTI = 8;
constexpr int kFill = 6;

// blocks an SM must hold (the register cap of __launch_bounds__: 128
// registers a thread; a cap of three blocks spilled 44 bytes in float)
constexpr int kSubMinBlocks = 2;

// Offsets (in values) of a block's boxes in shared memory for tiles of ti
// planes, and their total with nops operand values a cell pair: x with its
// 2-cell halo, beta_i faces i0 .. i0+ti, beta_j and beta_k planes
// i0-1 .. i0+ti, then the cells' operands. Every offset is even.
struct Boxes {
  int bi, bj, bk, ops, total;
};
__host__ __device__ __forceinline__ Boxes boxes(int ti, int nops) {
  Boxes b;
  b.bi = (ti + 4) * XJ * XK;
  b.bj = b.bi + (ti + 1) * (SJ + 2) * BP;
  b.bk = b.bj + (ti + 2) * (SJ + 1) * BP;
  b.ops = b.bk + (ti + 2) * (SJ + 2) * BP;
  b.total = b.ops + ti * kPairs * nops;
  return b;
}

// Operand values a cell pair: rhs (residual: the pair; gsrb: rhs and kdinv
// at the colour's cell), then alpha (apply, residual: the pair; gsrb: at
// the colour's cell, the second value unused).
__host__ __device__ __forceinline__ int operand_values(int mode, bool alpha) {
  return (mode == kApply ? 0 : 2) + (alpha ? 2 : 0);
}

// One value of src (stored in S, a field ending before `end`) into dst (of
// T) by cp.async; with WIDEN, the bf16 word a first pass copied turned into
// its value (stream.cuh: cp_async_word, widen_word; nothing where S is T).
template <bool WIDEN, typename T, typename S>
__device__ __forceinline__ void stage_one(T* d, const S* src, const S* end) {
  if constexpr (std::is_same_v<T, S>) {
    if (!WIDEN) cp_async(d, src);
  } else if constexpr (WIDEN) {
    widen_word(d, src);
  } else {
    cp_async_word(d, src, end);
  }
}

// two neighbouring values (an aligned pair) of src into d[0], d[1]; with
// WIDEN, likewise
template <bool WIDEN, typename T, typename S>
__device__ __forceinline__ void stage_two(T* d, const S* src) {
  if constexpr (std::is_same_v<T, S>) {
    if (!WIDEN) cp_async2(d, src);
  } else if constexpr (WIDEN) {
    widen_pair(d);
  } else {
    cp_async_pair(d, src);
  }
}

// The box of src, an array of np_src x nr_src x nc_src values (k fastest),
// of planes [p0, p0+np), rows [r0, r0+NR) and columns [c0, c0+nc) into dst
// (NR rows of pitch PITCH a plane) by cp.async (stage_one, stage_two): two
// neighbouring values a copy where both lie in src and the pair is
// aligned; values outside src are not copied. With WIDEN: the same walk
// over the box, each bf16 word this thread copied turned into its value.
template <int NR, int PITCH, bool WIDEN, typename T, typename S>
__device__ __forceinline__ void stage_box(T* dst, const S* __restrict__ src, int np,
                                          int p0, int r0, int c0, int nc, int np_src,
                                          int nr_src, int nc_src, bool src_aligned) {
  constexpr int HP = PITCH / 2;  // pairs a row
  const int total = np * NR * HP;
  const S* end = src + static_cast<int64_t>(np_src) * nr_src * nc_src;
  for (int t = threadIdx.x; t < total; t += kSubThreads) {
    const int pr = t / HP, b = 2 * (t - pr * HP);
    const int a = pr / NR;
    const int pl = p0 + a, row = r0 + pr - a * NR, col = c0 + b;
    if (b >= nc || pl < 0 || pl >= np_src || row < 0 || row >= nr_src) continue;
    T* d = dst + pr * PITCH + b;
    const int64_t g = (static_cast<int64_t>(pl) * nr_src + row) * nc_src + col;
    const bool in0 = col >= 0 && col < nc_src;
    const bool in1 = b + 1 < nc && col + 1 >= 0 && col + 1 < nc_src;
    if (in0 && in1 && src_aligned && (g & 1) == 0) {
      stage_two<WIDEN>(d, src + g);
    } else {
      if (in0) stage_one<WIDEN>(d, src + g, end);
      if (in1) stage_one<WIDEN>(d + 1, src + g + 1, end);
    }
  }
}

// Box ax (0 i, 1 j, 2 k) of the positions of a tile's x box that lie
// within 2 of the domain and outside it: along ax outside the domain (its
// low side, then its high side), along the earlier axes inside it, along
// the later ones anywhere within 2 of it (so the three boxes are
// disjoint). lo, len: the x box's first position and extent along i, j, k.
// Returns the box's size and, for 0 <= u < it, the u-th position in g.
__device__ __forceinline__ int ghost_box(int ax, int n, const int (&lo)[3],
                                         const int (&len)[3], int u, int (&g)[3]) {
  int first[3], ext[3], low = 0, high = 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int in0 = max(lo[d], 0), in1 = min(lo[d] + len[d], n);
    const int near0 = max(lo[d], -2), near1 = min(lo[d] + len[d], n + 2);
    if (d < ax) {
      first[d] = in0;
      ext[d] = in1 - in0;
    } else if (d == ax) {
      first[d] = near0;
      low = in0 - near0;
      high = in1;
      ext[d] = low + near1 - in1;
    } else {
      first[d] = near0;
      ext[d] = near1 - near0;
    }
  }
  const int size = ext[0] * ext[1] * ext[2];
  if (u >= 0 && u < size) {
    int v[3];
    v[2] = u % ext[2];
    v[1] = u / ext[2] % ext[1];
    v[0] = u / ext[2] / ext[1];
#pragma unroll
    for (int d = 0; d < 3; ++d)
      g[d] = d == ax && v[d] >= low ? high + v[d] - low : first[d] + v[d];
  }
  return size;
}

// src[0], src[1] (the second where has_hi) into d[0], d[1]; with WIDEN,
// likewise
template <bool WIDEN, typename T, typename S>
__device__ __forceinline__ void stage_pair(T* d, const S* src, const S* end, bool vec,
                                           bool has_hi) {
  if (vec) {
    stage_two<WIDEN>(d, src);
  } else {
    stage_one<WIDEN>(d, src, end);
    if (has_hi) stage_one<WIDEN>(d + 1, src + 1, end);
  }
}

// One block: the ti x SJ x SK tile (blockIdx.y along i, blockIdx.x the
// (j, k) column). Dynamic shared memory: boxes(ti, operand_values(...)).
// p.xp holds the cell field x itself (n^3), not a ghost-filled buffer.
// S: the operands' storage type; T = Wide<S>, the boxes' and the
// arithmetic's type.
template <typename S, int MODE, typename T = Wide<S>>
__global__ void __launch_bounds__(kSubThreads, kSubMinBlocks)
    fv4_subtile_kernel(const Args<T, S> p, int parity, int ti) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  const int n = p.n;
  const int tiles_k = (n + SK - 1) / SK;
  const int j0 = static_cast<int>(blockIdx.x / tiles_k) * SJ;
  const int k0 = static_cast<int>(blockIdx.x % tiles_k) * SK;
  const int i0 = static_cast<int>(blockIdx.y) * ti;
  const bool has_alpha = p.alpha != nullptr;
  const Boxes L = boxes(ti, operand_values(MODE, has_alpha));
  T* const bi = xs + L.bi;
  T* const bj = xs + L.bj;
  T* const bk = xs + L.bk;
  T* const ops = xs + L.ops;
  T* const aops = ops + (MODE == kApply ? 0 : 2 * ti * kPairs);

  // thread: pair pl (cells k0 + 2 pl, k0 + 2 pl + 1) of row jl on the
  // planes ilo, ilo + 2, ... of the tile; slot: its place among the
  // tile's pairs
  const int pl = threadIdx.x % (SK / 2), jl = threadIdx.x / (SK / 2) % SJ;
  const int ilo = threadIdx.x / kPairs;
  const int j = j0 + jl, kb = k0 + 2 * pl;
  const bool pair_in = j < n && kb < n;
  const bool has_hi = kb + 1 < n;
  const bool vec = (n & 1) == 0;
  auto slot = [&](int il) { return il * kPairs + static_cast<int>(threadIdx.x % kPairs); };
  const int64_t cells = static_cast<int64_t>(n) * n * n;  // of a cell field
  // every box and the cells' operands by cp.async; with WIDEN, the same walk
  // turning a bf16 field's words into values (the thread that copied them)
  auto stage = [&](auto widen) {
    constexpr bool W = decltype(widen)::value;
    stage_box<XJ, XK, W>(xs, p.xp, ti + 4, i0 - 2, j0 - 2, k0 - 2, XK, n, n, n,
                         pair_aligned(p.xp));
    stage_box<SJ + 2, BP, W>(bi, p.bie, ti + 1, i0, j0, k0, SK + 2, n + 1, n + 2, n + 2,
                             pair_aligned(p.bie));
    stage_box<SJ + 1, BP, W>(bj, p.bje, ti + 2, i0, j0, k0, SK + 2, n + 2, n + 1, n + 2,
                             pair_aligned(p.bje));
    stage_box<SJ + 2, BP, W>(bk, p.bke, ti + 2, i0, j0, k0, SK + 1, n + 2, n + 2, n + 1,
                             pair_aligned(p.bke));
    if (!pair_in) return;
    for (int il = ilo; il < ti && i0 + il < n; il += 2) {
      const int64_t c = (static_cast<int64_t>(i0 + il) * n + j) * n + kb;
      T* d = ops + 2 * slot(il);
      T* a = aops + 2 * slot(il);
      if constexpr (MODE == kGsrb) {
        const int q = (parity + i0 + il + j) & 1;  // the sweep's colour
        if (kb + q < n) {
          stage_one<W>(d, p.rhs + c + q, p.rhs + cells);
          stage_one<W>(d + 1, p.kdinv + c + q, p.kdinv + cells);
          if (has_alpha) stage_one<W>(a, p.alpha + c + q, p.alpha + cells);
        }
      } else {
        if (MODE == kResidual)
          stage_pair<W>(d, p.rhs + c, p.rhs + cells, vec && pair_aligned(p.rhs), has_hi);
        if (has_alpha)
          stage_pair<W>(a, p.alpha + c, p.alpha + cells, vec && pair_aligned(p.alpha),
                        has_hi);
      }
    }
  };
  stage(std::false_type{});
  cp_async_commit();
  cp_async_wait<0>();
  if constexpr (!std::is_same_v<T, S>) stage(std::true_type{});
  __syncthreads();
  // Dirichlet ghosts of the x box (within 2 of the domain; positions
  // further out, in ragged tiles, are read only by cells outside the
  // domain), one a thread over the three boxes that hold them (ghost_box):
  // from the staged cells where the tile holds >= 2 cells along every axis
  // (its halo then holds every tap), else from device memory
  if (i0 < 2 || j0 < 2 || k0 < 2 || i0 + ti + 2 > n || j0 + SJ + 2 > n || k0 + SK + 2 > n) {
    const int lo[3] = {i0 - 2, j0 - 2, k0 - 2}, len[3] = {ti + 4, XJ, XK};
    int g[3] = {0, 0, 0};
    int total = 0;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) total += ghost_box(ax, n, lo, len, -1, g);
    const bool taps = min(ti, n - i0) >= 2 && min(SJ, n - j0) >= 2 && min(SK, n - k0) >= 2;
    auto at = [&](int a, int b, int c) -> T {
      return xs[((a - lo[0]) * XJ + (b - lo[1])) * XK + (c - lo[2])];
    };
    for (int t = threadIdx.x; t < total; t += kSubThreads) {
      int u = t;
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) u -= ghost_box(ax, n, lo, len, u, g);
      xs[((g[0] - lo[0]) * XJ + g[1] - lo[1]) * XK + g[2] - lo[2]] =
          taps ? ghost_taps<T>(at, n, g[0], g[1], g[2])
               : ghost_from_memory(p.xp, n, g[0], g[1], g[2]);
    }
    __syncthreads();
  }

  // A x at cell (il, jl, kl) of the tile (its x center returned in x0)
  auto ax_at = [&](int il, int kl, T& x0) -> T {
    const T* xc = xs + ((il + 2) * XJ + jl + 2) * XK + kl + 2;
    const T* bic = bi + (il * (SJ + 2) + jl + 1) * BP + kl + 1;
    const T* bjc = bj + ((il + 1) * (SJ + 1) + jl) * BP + kl + 1;
    const T* bkc = bk + ((il + 1) * (SJ + 2) + jl + 1) * BP + kl;
    auto X = [&](int di, int dj, int dk) -> T { return xc[(di * XJ + dj) * XK + dk]; };
    // face f (0 low, 1 high) of the cell, shifted tangentially
    auto BI = [&](int f, int dj, int dk) -> T { return bic[(f * (SJ + 2) + dj) * BP + dk]; };
    auto BJ = [&](int f, int di, int dk) -> T { return bjc[(di * (SJ + 1) + f) * BP + dk]; };
    auto BK = [&](int f, int di, int dj) -> T { return bkc[(di * (SJ + 2) + dj) * BP + f]; };
    x0 = X(0, 0, 0);
    return p.scale * fv4_combination<T>(X, BI, BJ, BK);
  };

  if (!pair_in) return;
  for (int il = ilo; il < ti && i0 + il < n; il += 2) {
    const int i = i0 + il;
    const int64_t row = (static_cast<int64_t>(i) * n + j) * n;
    const T* d = ops + 2 * slot(il);
    const T* a = aops + 2 * slot(il);
    if constexpr (MODE == kGsrb) {
      const int q = (parity + i + j) & 1;
      T v = T(0);
      if (kb + q < n) {
        T x0;
        T ax = ax_at(il, 2 * pl + q, x0);
        if (has_alpha) ax = p.a_coef * a[0] * x0 + ax;
        v = x0 + d[1] * (d[0] - ax);
      }
      const T other = xs[((il + 2) * XJ + jl + 2) * XK + 2 * pl + (q ^ 1) + 2];
      store_pair(p.out, row + kb, q ? other : v, q ? v : other, vec, has_hi);
    } else {
      // the cell of this pair with parity (i + j + k) % 2 == 0 comes first
      const int q0 = (i + j) & 1;
      T r[2] = {T(0), T(0)};  // by s: cell kb + (q0 ^ s)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int dk = q0 ^ s;
        if (kb + dk < n) {
          T x0;
          T ax = ax_at(il, 2 * pl + dk, x0);
          if (has_alpha) ax = p.a_coef * a[dk] * x0 + ax;
          if constexpr (MODE == kApply) {
            r[s] = ax;
          } else {
            r[s] = d[dk] - ax;
          }
        }
      }
      store_pair(p.out, row + kb, q0 ? r[1] : r[0], q0 ? r[0] : r[1], vec, has_hi);
    }
  }
}

template <typename T>
size_t box_bytes(int ti, int nops) { return boxes(ti, nops).total * sizeof(T); }

template <typename T, typename S, int MODE>
int launch_mode(const Args<T, S>& p, int parity, int ti, cudaStream_t s) {
  auto kernel = fv4_subtile_kernel<S, MODE>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(box_bytes<T>(kMaxTI, 4)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n = p.n;
  const int nops = operand_values(MODE, p.alpha != nullptr);
  const int64_t cols = static_cast<int64_t>((n + SJ - 1) / SJ) * ((n + SK - 1) / SK);
  if (ti <= 0) {
    static const int sms = [] {
      int dev = 0, v = 0;
      if (cudaGetDevice(&dev) != cudaSuccess ||
          cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 0;
      return v;
    }();
    // co-resident blocks an SM by tile length and operand count (queried
    // once each)
    static int per_sm[kMaxTI + 1][3] = {};
    if (sms <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    // the tile length whose waves of co-resident blocks times a block's
    // time is least (the largest of equals: fewer blocks); a partial wave
    // costs a whole one
    int64_t best = INT64_MAX;
    for (int c = n < kMaxTI ? n : kMaxTI; c >= 1; --c) {
      int& occ = per_sm[c][nops / 2];
      if (occ <= 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                          &occ, kernel, kSubThreads, box_bytes<T>(c, nops)) != cudaSuccess)
        return static_cast<int>(cudaErrorInvalidConfiguration);
      if (occ <= 0) continue;
      const int64_t slots = static_cast<int64_t>(sms) * occ;
      const int64_t blocks = cols * ((n + c - 1) / c);
      const int64_t cost = (blocks + slots - 1) / slots * (2 * ((c + 1) / 2) + kFill);
      if (cost < best) {
        best = cost;
        ti = c;
      }
    }
    if (ti <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (ti > n) ti = n;
  if (ti > kMaxTI || cols > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(cols), (n + ti - 1) / ti);
  kernel<<<grid, kSubThreads, box_bytes<T>(ti, nops), s>>>(p, parity, ti);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_subtile(const void* x, const void* bie, const void* bje,
                   const void* bke, const void* alpha, const void* rhs,
                   const void* kdinv, void* out, int n, int mode, int parity,
                   int ti, double scale, double a_coef, void* stream) {
  using T = Wide<S>;
  if (n < 4 || n > 65535 || mode < kApply || mode > kGsrb || parity < 0 || parity > 1 ||
      ti < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args<T, S> p{static_cast<const S*>(x),     static_cast<const S*>(bie),
                     static_cast<const S*>(bje),   static_cast<const S*>(bke),
                     static_cast<const S*>(alpha), static_cast<const S*>(rhs),
                     static_cast<const S*>(kdinv), static_cast<S*>(out),
                     n,                            static_cast<T>(scale),
                     static_cast<T>(a_coef)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kApply: return launch_mode<T, S, kApply>(p, parity, ti, s);
    case kResidual: return launch_mode<T, S, kResidual>(p, parity, ti, s);
    default: return launch_mode<T, S, kGsrb>(p, parity, ti, s);
  }
}

}  // namespace

// x: the n^3 cell field (no ghosts); mode 0 apply, 1 residual, 2 gsrb;
// parity: the colour gsrb updates; ti: the tile length along i, 1 .. 8
// (0: the launcher's rule)
extern "C" int hpgmg_fv4_subtile_f32(const void* x, const void* bie,
                                     const void* bje, const void* bke,
                                     const void* alpha, const void* rhs,
                                     const void* kdinv, void* out, int n,
                                     int mode, int parity, int ti, double scale,
                                     double a_coef, void* stream) {
  return launch_subtile<float>(x, bie, bje, bke, alpha, rhs, kdinv, out, n, mode,
                               parity, ti, scale, a_coef, stream);
}

extern "C" int hpgmg_fv4_subtile_f64(const void* x, const void* bie,
                                     const void* bje, const void* bke,
                                     const void* alpha, const void* rhs,
                                     const void* kdinv, void* out, int n,
                                     int mode, int parity, int ti, double scale,
                                     double a_coef, void* stream) {
  return launch_subtile<double>(x, bie, bje, bke, alpha, rhs, kdinv, out, n, mode,
                                parity, ti, scale, a_coef, stream);
}

// bf16 storage, float arithmetic (each output rounded to bf16 once)
extern "C" int hpgmg_fv4_subtile_bf16(const void* x, const void* bie,
                                      const void* bje, const void* bke,
                                      const void* alpha, const void* rhs,
                                      const void* kdinv, void* out, int n,
                                      int mode, int parity, int ti, double scale,
                                      double a_coef, void* stream) {
  return launch_subtile<bf16>(x, bie, bje, bke, alpha, rhs, kdinv, out, n, mode,
                              parity, ti, scale, a_coef, stream);
}
