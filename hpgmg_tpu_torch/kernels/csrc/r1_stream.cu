// K5 and K7b for the 27pt body: the constant-coefficient Mehrstellen
// stencil (operators.27pt.c:48-92) with 2-tap Dirichlet ghosts (K5) or
// periodic ghosts (K7b, `periodic`), in four modes, one launch a call:
//
//   apply     out = A x
//   residual  out = rhs - A x
//   gsrb      out = x + kdinv * (rhs - A x) at the cells of the sweep's
//             colour ((i+j+k) % 2 == parity; kdinv carries the same mask),
//             out = x at the others
//   fres      out = restrict_cell(rhs - A x), an (n/2)^3 field
//
// where A x = a * x - b/h^2 * (C1 sum(faces - x) + C2 sum(edges - x) +
// C3 sum(corners - x)), (C1, C2, C3) = (14, 3, 1) / 30 (r1_ax in
// r1_common.cuh, summed in its order).
//
// Replaces hpgmg_tpu/kernels/stencils_r1.py:_r1_kernel (:364) for the 27pt
// body, entered through _r1_call (:1041 -> pallas_call :1107) on Dirichlet
// levels and through r1_call_ext (:517 -> :562, its ext mode with
// kperiodic) on periodic ones. That kernel worked on (bi, bj, n) VMEM
// tiles of j-padded, split-k views laid out for the TPU's (8, 128) tiling;
// none of that is carried over. The var7 body (fv7pt, fv2) and K8c run on
// r1_var7_stream.cu, this column with their own window.
//
// What bounds it on an H100: device-memory bandwidth. apply reads x and
// writes out, 8 B a cell in f32, against ~60 flops; gsrb reads x, rhs and
// kdinv and writes out. The tile kernel it replaced (8 x 8 x 32 tiles) ran
// 27pt apply at ~4.5x its byte bound and a gsrb no faster than apply: it
// filled a shared tile with two div/mod pairs and three range tests a value,
// read 27 shared values a cell, and computed A x at every cell of a gsrb.
//
// Design: a block owns a TJ x TK column of (j, k) (k fastest) and marches
// a chunk of i-planes. Each x plane arrives with its 1-cell (j, k) halo by
// cp.async in a ring of kR1Ring slots in shared memory, one commit group
// and one __syncthreads a plane, kR1Ring - 2 planes in flight while a plane
// computes; a thread's copies of a plane are fixed for the block (their
// offsets computed once). The halo's first column, k0 - 1, is odd, so a
// copy is one value; the thread's reads of a plane are then aligned pairs.
// Each thread owns two neighbouring k cells of a row and keeps a register
// window: rows j-1 .. j+1 and columns kb-1 .. kb+2 of planes i-1, i, i+1
// (36 values). A plane step reads 12 values of the newest plane from
// shared memory (six paired reads) into the slot of the plane it drops
// (the loop runs three plane steps an iteration, so the roles rotate and
// no value moves); the stencils of both cells read only registers.
// Ghosts: periodic ones are copies of the cells mod n (the ring loads the
// wrapped cells and planes). Dirichlet ghosts are made in the window, not
// read: a thread at a domain face holds the two cells nearest it, so its
// ghost row (j) and column (k) are t1 * x1 + t2 * x2 of its own registers,
// the row first, so that an edge is the per-axis taps' tensor product as
// the separable fills make it; the ghost planes i = -1 and i = n are the
// same combination of the window's planes 0, 1 and n-1, n-2, (j, k) ghosts
// included. The ring never holds a Dirichlet ghost.
// gsrb computes A x only at the cell of its pair with the sweep's colour
// (a warp holds rows j and j+2, so its threads take the same cell and one
// branch), reads rhs and kdinv only there, a plane ahead into registers,
// and copies x at the other cell, which equals x + 0 * r. apply, residual
// and fres compute both cells. fres sums each coarse cell's 8 residuals in
// K1's order (the partner row's pair by a warp shuffle, the next plane's
// in the same register) and writes (n/2)^3. Levels too small to fill the card with columns split i into
// chunks (K1's launcher rule, at least kR1MinChunk planes), each reloading
// its two halo planes.
// Plain version: hpgmg_tpu_torch/kernels/stencils_r1.py:r1_stencil_plain.

#include "r1_common.cuh"
#include "stream.cuh"

#include <type_traits>

namespace {

constexpr int kR1Threads = 256;
// column tile (j, k) per block: TK / 2 pairs a row, two rows a warp
constexpr int R1TJ = 16;
constexpr int R1TK = 32;
static_assert(R1TJ * R1TK / 2 == kR1Threads && R1TK == 32, "two rows a warp");
// ring slots of x planes: the plane read next and kR1Ring - 2 in flight
// behind the one a plane step waits for
constexpr int kR1Ring = 5;
// blocks an SM must hold (the register cap of __launch_bounds__)
constexpr int kR1Blocks32 = 4;
constexpr int kR1Blocks64 = 2;
template <typename T>
constexpr int kR1Blocks = sizeof(T) == 4 ? kR1Blocks32 : kR1Blocks64;
// chunks of i-planes: ~kR1Waves waves of co-resident blocks, at least
// kR1MinChunk planes a chunk (a chunk reloads 2 halo planes)
constexpr int kR1MinChunk = 4;
constexpr int kR1Waves = 8;

constexpr int XP = R1TK + 2;           // x plane pitch (even: paired reads)
constexpr int XPLANE = (R1TJ + 2) * XP;  // the tile and its 1-cell halo
constexpr int kXE = (XPLANE + kR1Threads - 1) / kR1Threads;  // copies a thread
constexpr unsigned kNoCopy = ~0u;

// A x at a cell from X(di, dj, dk), its neighbourhood in the window
template <typename T, typename FX>
__device__ __forceinline__ T ax27(const FX& X, T b_h2inv, T a_coef) {
  return r1_ax<T, false>(nullptr, nullptr, nullptr, nullptr, b_h2inv, a_coef, X,
                         R1Index{});
}

// One block: the TJ x TK column (blockIdx.x) over the i-planes of chunk
// blockIdx.y.
template <typename T, int MODE>
__global__ void __launch_bounds__(kR1Threads, kR1Blocks<T>)
    r1_stream_kernel(const R1Args<T> p, int parity, int chunk) {
  __shared__ __align__(16) T ring[kR1Ring * XPLANE];

  const int n = p.n;
  const bool periodic = p.periodic != 0;
  const T t1 = p.t1, t2 = p.t2;
  const int tiles_k = (n + R1TK - 1) / R1TK;
  const int j0 = static_cast<int>(blockIdx.x / tiles_k) * R1TJ;
  const int k0 = static_cast<int>(blockIdx.x % tiles_k) * R1TK;
  const int ia = blockIdx.y * chunk;
  const int ib = min(ia + chunk, n);

  // this thread's copies of a plane: halo positions t (row t / XP, column
  // t % XP of the slot), their offsets in an x plane; periodic: the cells
  // mod n; Dirichlet: cells only; positions beyond n (ragged tiles) are
  // read only by results outside the domain and are not copied
  unsigned goff[kXE];
#pragma unroll
  for (int e = 0; e < kXE; ++e) {
    const int t = threadIdx.x + e * kR1Threads;
    const int j = j0 - 1 + t / XP, k = k0 - 1 + t % XP;
    unsigned g = kNoCopy;
    if (t < XPLANE) {
      if (periodic) {
        if (j <= n && k <= n)
          g = static_cast<unsigned>(j < 0 ? j + n : (j == n ? 0 : j)) * n +
              (k < 0 ? k + n : (k == n ? 0 : k));
      } else if (j >= 0 && j < n && k >= 0 && k < n) {
        g = static_cast<unsigned>(j) * n + k;
      }
    }
    goff[e] = g;
  }
  // x plane q (the chunk reads planes ia-1 .. ib) into ring slot s; a
  // commit group whether or not it copies anything, so that every plane
  // step waits for the same count
  auto load_plane = [&](int q, int s) {
    const int pq = q < 0 ? q + n : (q >= n ? q - n : q);
    if (q <= ib && (periodic || pq == q)) {
      const T* base = p.x + static_cast<int64_t>(pq) * n * n;
      T* dst = ring + s * XPLANE + threadIdx.x;
#pragma unroll
      for (int e = 0; e < kXE; ++e) {
        if (goff[e] != kNoCopy) cp_async(dst + e * kR1Threads, base + goff[e]);
      }
    }
    cp_async_commit();
  };

  // thread: row jl, pair pl (cells kb = k0 + 2 pl and kb + 1). A warp
  // holds two rows: j and j+1 (fres pairs them by shuffle), or in a gsrb j
  // and j+2, whose cells of the sweep's colour lie at the same place of
  // their pairs, so that the warp takes one branch
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int jl = MODE == kGsrb ? 4 * (wp >> 1) + (wp & 1) + 2 * (lane >> 4)
                               : threadIdx.x / (R1TK / 2);
  const int pl = lane & (R1TK / 2 - 1);
  const int j = j0 + jl, kb = k0 + 2 * pl;
  const bool pair_in = j < n && kb < n;
  const bool vec = (n & 1) == 0;
  const bool has_hi = kb + 1 < n;
  const int m = n / 2;
  Faces f{false, false, false, -1};
  if (!periodic) {
    f = {j == 0, j == n - 1, kb == 0, kb == n - 2 ? 3 : (kb == n - 1 ? 2 : -1)};
  }
  // whether this thread's window holds (j, k) ghosts (the tile's edge
  // rows and columns of a tile at a domain face)
  const bool face = f.jlo || f.jhi || f.klo || f.khi >= 0;
  auto read = [&](Rows<T>& w, int s) {
    const T* src = ring + s * XPLANE + jl * XP + 2 * pl;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      lds2(src + r * XP, w[r][0], w[r][1]);
      lds2(src + r * XP + 2, w[r][2], w[r][3]);
    }
    if (face) ghost_rows_cols(w, f, t1, t2);
  };

  // the window: three planes, each in turn i-1, i and i+1 (the plane
  // steps rotate their roles, so that no value moves)
  T w[3][3][4];
  // ring slots: plane ia-1+s in slot s for the first kR1Ring planes, then
  // plane q in the slot plane q - kR1Ring left
#pragma unroll
  for (int s = 0; s < kR1Ring; ++s) load_plane(ia - 1 + s, s);
  cp_async_wait<kR1Ring - 2>();  // planes ia-1 and ia
  __syncthreads();
  // plane -1 of a Dirichlet level is a ghost, made once plane 1 is read
  if (periodic || ia > 0) read(w[0], 0);
  read(w[1], 1);
  int slot = 2;  // of plane i+1

  // rhs at this thread's cells of plane i (gsrb: rhs and kdinv at the
  // colour's cell; residual and fres: rhs at the pair), read two planes
  // ahead into registers whose roles rotate with the window's (one plane
  // ahead left the loads of residual and fres exposed)
  const bool rhs_vec = vec && pair_aligned(p.rhs);
  auto fetch = [&](int i, T (&r)[2]) {
    if (MODE == kApply || !pair_in) return;
    const int64_t c = (static_cast<int64_t>(i) * n + j) * n + kb;
    if (MODE == kGsrb) {
      const int q = (parity + i + j) & 1;
      if (kb + q < n) {
        r[0] = __ldg(p.rhs + c + q);
        r[1] = __ldg(p.kdinv + c + q);
      }
    } else if (rhs_vec) {
      load2(p.rhs + c, r[0], r[1]);
    } else {
      r[0] = __ldg(p.rhs + c);
      if (has_hi) r[1] = __ldg(p.rhs + c + 1);
    }
  };
  T rr[3][2] = {};  // by the window's roles: planes i-1 (free), i, i+1
  fetch(ia, rr[1]);
  if (ia + 1 < ib) fetch(ia + 1, rr[2]);
  T sum = T(0);  // fres: the coarse cell's running sum (even rows)

  // plane i, with w[A], w[B], w[C] holding planes i-1, i, i+1 (C is read
  // here)
  auto step = [&](int i, auto A, auto B, auto C) {
    constexpr int a = decltype(A)::value, b = decltype(B)::value, c = decltype(C)::value;
    // plane i+1 has arrived (kR1Ring - 3 newer groups may be in flight)
    cp_async_wait<kR1Ring - 3>();
    __syncthreads();
    if (!periodic && i + 1 == n) {
      ghost_plane(w[c], w[b], w[a], t1, t2);
    } else {
      read(w[c], slot);
    }
    // every thread has read the slot of plane i-1 (before this barrier):
    // plane i-1+kR1Ring takes it
    load_plane(i - 1 + kR1Ring, slot == 0 ? kR1Ring - 2 : (slot == 1 ? kR1Ring - 1 : slot - 2));
    slot = ring_add(slot, 1, kR1Ring);
    if (i + 2 < ib) fetch(i + 2, rr[a]);  // plane i+2 takes role a there
    if (!periodic && i == 0) ghost_plane(w[a], w[b], w[c], t1, t2);
    const T r0 = rr[b][0], r1 = rr[b][1], kd = rr[b][1];

    // x at (i + di, j + dj, kb + D + dk)
    auto X0 = [&](int di, int dj, int dk) -> T {
      return w[di < 0 ? a : (di == 0 ? b : c)][dj + 1][dk + 1];
    };
    auto X1 = [&](int di, int dj, int dk) -> T {
      return w[di < 0 ? a : (di == 0 ? b : c)][dj + 1][dk + 2];
    };
    const int64_t row = (static_cast<int64_t>(i) * n + j) * n;
    if constexpr (MODE == kGsrb) {
      if (pair_in) {
        // the sweep's colour: cell kb + q, the same q across the warp
        const int q = (parity + i + j) & 1;
        T v, other;
        if (q) {
          v = w[b][1][2] + kd * (r0 - ax27<T>(X1, p.b_h2inv, p.a_coef));
          other = w[b][1][1];
          store_pair(p.out, row + kb, other, v, vec, has_hi);
        } else {
          v = w[b][1][1] + kd * (r0 - ax27<T>(X0, p.b_h2inv, p.a_coef));
          other = w[b][1][2];
          store_pair(p.out, row + kb, v, other, vec, has_hi);
        }
      }
    } else {
      const T ax0 = ax27<T>(X0, p.b_h2inv, p.a_coef);
      const T ax1 = ax27<T>(X1, p.b_h2inv, p.a_coef);
      T lo, hi;
      if constexpr (MODE == kApply) {
        lo = ax0;
        hi = ax1;
      } else {
        lo = r0 - ax0;
        hi = r1 - ax1;
      }
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
          p.out[(static_cast<int64_t>(i / 2) * m + j / 2) * m + kb / 2] = T(0.125) * sum;
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

template <typename T, int MODE>
int launch_mode(const R1Args<T>& p, int parity, int chunk, cudaStream_t s) {
  auto kernel = r1_stream_kernel<T, MODE>;
  const int n = p.n;
  const int64_t tiles =
      static_cast<int64_t>((n + R1TJ - 1) / R1TJ) * ((n + R1TK - 1) / R1TK);
  if (chunk <= 0) {
    // co-resident blocks on the card (queried once)
    static const int64_t slots = [&]() -> int64_t {
      int dev = 0, sms = 0, per_sm = 0;
      if (cudaGetDevice(&dev) != cudaSuccess ||
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kR1Threads, 0) !=
              cudaSuccess)
        return 0;
      return static_cast<int64_t>(sms) * per_sm;
    }();
    if (slots <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int64_t chunks = (kR1Waves * slots + tiles - 1) / tiles;
    chunk = static_cast<int>((n + chunks - 1) / chunks);
    if (chunk < kR1MinChunk) chunk = kR1MinChunk;
  }
  if (chunk > n) chunk = n;
  if (MODE == kFres && (chunk & 1)) ++chunk;  // a coarse cell's planes together
  const int chunks = (n + chunk - 1) / chunk;
  kernel<<<dim3(static_cast<unsigned>(tiles), chunks), kR1Threads, 0, s>>>(p, parity,
                                                                          chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stream(const void* x, const void* rhs, const void* kdinv, void* out, int n,
                  int mode, int periodic, int parity, int chunk, double b_h2inv,
                  double a_coef, double t1, double t2, void* stream) {
  if (n < 2 || n > 65535 || mode < kApply || mode > kFres ||
      (mode == kFres && n % 2 != 0) || parity < 0 || parity > 1 || chunk < 0 ||
      x == nullptr || out == nullptr || (mode != kApply && rhs == nullptr) ||
      (mode == kGsrb && kdinv == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const R1Args<T> p{static_cast<const T*>(x), nullptr,  nullptr,
                    nullptr,                  nullptr,  static_cast<const T*>(rhs),
                    static_cast<const T*>(kdinv), static_cast<T*>(out),
                    n,                        static_cast<T>(b_h2inv),
                    static_cast<T>(a_coef),   static_cast<T>(t1),
                    static_cast<T>(t2),       periodic != 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kApply: return launch_mode<T, kApply>(p, parity, chunk, s);
    case kResidual: return launch_mode<T, kResidual>(p, parity, chunk, s);
    case kGsrb: return launch_mode<T, kGsrb>(p, parity, chunk, s);
    default: return launch_mode<T, kFres>(p, parity, chunk, s);
  }
}

}  // namespace

// x: the n^3 cell field (no ghosts); mode 0 apply, 1 residual, 2 gsrb,
// 3 fres; periodic 0 (2-tap Dirichlet ghosts t1, t2) or 1 (wrapped);
// parity: the colour gsrb updates; chunk: i-planes per block (0: the
// launcher's rule); b_h2inv = b / h^2, a_coef the constant a of a * x
extern "C" int hpgmg_r1_stream_f32(const void* x, const void* rhs, const void* kdinv,
                                   void* out, int n, int mode, int periodic, int parity,
                                   int chunk, double b_h2inv, double a_coef, double t1,
                                   double t2, void* stream) {
  return launch_stream<float>(x, rhs, kdinv, out, n, mode, periodic, parity, chunk,
                              b_h2inv, a_coef, t1, t2, stream);
}

extern "C" int hpgmg_r1_stream_f64(const void* x, const void* rhs, const void* kdinv,
                                   void* out, int n, int mode, int periodic, int parity,
                                   int chunk, double b_h2inv, double a_coef, double t1,
                                   double t2, void* stream) {
  return launch_stream<double>(x, rhs, kdinv, out, n, mode, periodic, parity, chunk,
                               b_h2inv, a_coef, t1, t2, stream);
}
