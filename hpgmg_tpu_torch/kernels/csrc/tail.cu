// K4: the coarse-ladder ("tail") of an fv4 V-cycle over all the tail
// levels (dims <= 32 above the bottom), each part in ONE launch:
//
//   K4a down, per level from the finest tail level:
//       x <- nsweeps GSRB half-sweeps from x (x = 0 below the first level)
//       e[l] <- x;  rhs[l+1] = res[l] <- restrict_cell(rhs[l] - A x)
//   K4b up, per level from the coarsest tail level, u = the solution below:
//       x <- e[l] + interp_v2(u);  u = res[l] <- nsweeps half-sweeps from x
//   K4c v, when the level right below the tail is the DIRECT bottom: K4a's
//       descent, u_bot = A^-1 res[last] (the dense inverse built with the
//       hierarchy, a 512 x 512 matvec at 8^3), then K4b's climb, writing
//       each level's solution over its e[l]
//
// (mg.c:1135-1164: the descent and the climb of MGVCycle; K4a and K4b leave
// the bottom solve between them outside). The arithmetic per level is K1's gsrb and
// fres modes (fv4_stencil.cu) and the v2 interpolation of
// ops/transfer_fv.py:interp_v2, whose coarse quadratic Dirichlet ghosts
// (g = -5/2 c0 + 1/2 c1) and 3-tap children (1/8, 1, -1/8) are computed
// in the kernel body as per-axis taps, their tensor product being the
// separable operator.
//
// Replaces hpgmg_tpu/kernels/tail.py:_down_kernel (tail_down_call),
// _up_kernel (tail_up_call) and _v_kernel (tail_v_call, with its in-kernel
// DIRECT bottom _bottom_direct). Those held every tail level whole in VMEM and
// chained the phases in registers, the transfers as per-slice MXU dots.
// Here one cooperative launch of co-resident blocks runs the phases as
// grid-stride loops over global memory (a 32^3 level is 128 KiB in f32,
// L2-resident), separated by grid-wide barriers (cg::this_grid().sync()):
// per level and half-sweep a ghost fill of the iterate into the (n+4)^3
// scratch xp, then the update into the other of two ping-pong buffers.
//
// What bounds it on an H100: barrier latency and the serial chain of
// phases (2 per half-sweep, ~14 per level), not bandwidth or flops: the
// levels are tiny. It replaces ~20 launches per level, each costing more
// host time than device time. Design: kCoopThreads-thread blocks, as many
// as are co-resident and the finest level's ghost fill can use. K4c's
// bottom phase gives each row of the inverse to one warp (lanes stride the
// row, coalesced; a shuffle reduction), grid-stride over the rows, reading
// the inverse (1 MB in f32) through L2 and not staging it in shared memory;
// a grid barrier on either side of it.
// Plain version: hpgmg_tpu_torch/kernels/tail.py:tail_down_plain and
// tail_up_plain and tail_v_plain.

#include "fv4_common.cuh"

namespace {

constexpr int kMaxTail = 6;
constexpr int kTailPtrs = 9;  // pointers per level in the C interface

// One tail level. Down: e is written (the pre-smoothed iterate) and res
// (the restricted residual, the next level's rhs). Up: e is read (the
// pre-smoothed iterate) and res written (the post-smoothed solution).
template <typename T>
struct TailLevel {
  const T* bie;
  const T* bje;
  const T* bke;
  const T* alpha;  // nullptr: no a*alpha*x term
  const T* kd0;
  const T* kd1;
  const T* rhs;
  T* e;
  T* res;
  int n;
  T scale;  // -b / h^2
};

template <typename T>
struct TailArgs {
  TailLevel<T> lv[kMaxTail];
  const T* x_in;   // down, v: the first level's starting iterate
  const T* u_bot;  // up: the solution below the coarsest tail level
  const T* ainv;   // v: the bottom's dense inverse, (db^3, db^3) row-major
  T* u_out;        // v: the bottom solution, db^3
  T* xp;           // (n0+4)^3 scratch
  T* tmp;          // n0^3 scratch
  int nlev;
  int nsweeps;  // even: the last half-sweep lands in the level's buffer
  T a_coef;
};

template <typename T>
__device__ __forceinline__ Args<T> level_args(const TailArgs<T>& a,
                                              const TailLevel<T>& L) {
  return Args<T>{a.xp,  L.bie, L.bje, L.bke, L.alpha, L.rhs, nullptr,
                 L.res, L.n,   L.scale, a.a_coef};
}

// nsweeps half-sweeps from `start` (nullptr: zeros), ping-ponging between
// a.tmp and `last`, which receives the final iterate.
template <typename T>
__device__ void sweeps(const TailArgs<T>& a, const TailLevel<T>& L,
                       const T* start, T* last, cg::grid_group& grid) {
  const Args<T> p = level_args(a, L);
  for (int s = 0; s < a.nsweeps; ++s) {
    const T* in = s == 0 ? start : ((s & 1) ? a.tmp : last);
    T* dst = (s & 1) ? last : a.tmp;
    ghost_fill_phase(CellView<T>{in, 0, L.n}, a.xp, L.n, false);
    grid.sync();
    gsrb_phase(p, (s & 1) ? L.kd1 : L.kd0, dst, 0, L.n);
    grid.sync();
  }
}

// The descent: per level, sweeps into e, then the restricted residual into
// res; ends on a grid barrier.
template <typename T>
__device__ void descend(const TailArgs<T>& a, cg::grid_group& grid) {
  const T* start = a.x_in;
  for (int l = 0; l < a.nlev; ++l) {
    const TailLevel<T>& L = a.lv[l];
    sweeps(a, L, start, L.e, grid);
    ghost_fill_phase(CellView<T>{L.e, 0, L.n}, a.xp, L.n, false);
    grid.sync();
    fres_phase(level_args(a, L));
    grid.sync();
    start = nullptr;
  }
}

// The climb from u, the solution below the coarsest level: per level, the
// interpolation added to e, then sweeps; the level's solution goes to res,
// or over e (in_place: K4c, whose res holds the next level's rhs).
template <typename T>
__device__ void climb(const TailArgs<T>& a, const T* u, bool in_place,
                      cg::grid_group& grid) {
  for (int l = a.nlev - 1; l >= 0; --l) {
    const TailLevel<T>& L = a.lv[l];
    T* out = in_place ? L.e : L.res;
    const int n = L.n, dc = n / 2;
    const int64_t total = static_cast<int64_t>(n) * n * n;
    for (int64_t c = gtid(); c < total; c += gstride()) {
      const unsigned uc = static_cast<unsigned>(c), un = n;
      const unsigned r = uc / un;
      const int i = static_cast<int>(r / un), j = static_cast<int>(r % un),
                k = static_cast<int>(uc % un);
      int ii[5], jj[5], kk[5];
      T wi[5], wj[5], wk[5];
      const int ni = interp_v2_taps(i, dc, ii, wi);
      const int nj = interp_v2_taps(j, dc, jj, wj);
      const int nk = interp_v2_taps(k, dc, kk, wk);
      T up = T(0);
      for (int x = 0; x < ni; ++x) {
        for (int y = 0; y < nj; ++y) {
          const T* row = u + (static_cast<int64_t>(ii[x]) * dc + jj[y]) * dc;
          T sk = T(0);
          for (int z = 0; z < nk; ++z) sk += wk[z] * row[kk[z]];
          up += wi[x] * wj[y] * sk;
        }
      }
      out[c] = L.e[c] + up;
    }
    grid.sync();
    sweeps(a, L, out, out, grid);
    u = out;
  }
}

// u_out = ainv . r, r the coarsest level's restricted residual: one warp per
// row (kCoopThreads is a multiple of 32, so warps are whole).
template <typename T>
__device__ void bottom_phase(const TailArgs<T>& a) {
  const TailLevel<T>& L = a.lv[a.nlev - 1];
  const int db = L.n / 2, m = db * db * db, lane = threadIdx.x & 31;
  const T* r = L.res;
  for (int64_t row = gtid() >> 5; row < m; row += gstride() >> 5) {
    const T* arow = a.ainv + row * m;
    T s = T(0);
    for (int c = lane; c < m; c += 32) s += arow[c] * r[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) a.u_out[row] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCoopThreads)
    tail_down_kernel(const TailArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  descend(a, grid);
}

template <typename T>
__global__ void __launch_bounds__(kCoopThreads)
    tail_up_kernel(const TailArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  climb(a, a.u_bot, false, grid);
}

template <typename T>
__global__ void __launch_bounds__(kCoopThreads)
    tail_v_kernel(const TailArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  descend(a, grid);
  bottom_phase(a);
  grid.sync();
  climb(a, a.u_out, true, grid);
}

enum class TailKind { kDown, kUp, kV };

template <typename T>
int launch_tail(TailKind kind, const void* const* ptrs, const int* dims,
                const double* scales, int nlev, int nsweeps, double a_coef,
                const void* x_in, const void* u_bot, const void* ainv,
                void* u_out, void* xp, void* tmp, void* stream) {
  if (nlev < 1 || nlev > kMaxTail || nsweeps < 2 || nsweeps % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TailArgs<T> a{};
  for (int l = 0; l < nlev; ++l) {
    const int n = dims[l];
    // even, >= 4 cells for the quartic ghosts (>= 8 so the coarse grid of
    // the v2 interpolation has 2), each level half the one above
    if (n < 8 || n % 2 != 0 || n > 1024 || (l > 0 && n * 2 != dims[l - 1])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const void* const* q = ptrs + kTailPtrs * l;
    a.lv[l] = TailLevel<T>{
        static_cast<const T*>(q[0]), static_cast<const T*>(q[1]),
        static_cast<const T*>(q[2]), static_cast<const T*>(q[3]),
        static_cast<const T*>(q[4]), static_cast<const T*>(q[5]),
        static_cast<const T*>(q[6]), static_cast<T*>(const_cast<void*>(q[7])),
        static_cast<T*>(const_cast<void*>(q[8])), n, static_cast<T>(scales[l])};
  }
  a.x_in = static_cast<const T*>(x_in);
  a.u_bot = static_cast<const T*>(u_bot);
  a.ainv = static_cast<const T*>(ainv);
  a.u_out = static_cast<T*>(u_out);
  a.xp = static_cast<T*>(xp);
  a.tmp = static_cast<T*>(tmp);
  a.nlev = nlev;
  a.nsweeps = nsweeps;
  a.a_coef = static_cast<T>(a_coef);
  int64_t work = static_cast<int64_t>(dims[0] + 4) * (dims[0] + 4) * (dims[0] + 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kind == TailKind::kV) {
    const int64_t db = dims[nlev - 1] / 2, rows = db * db * db;
    if (ainv == nullptr || u_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (32 * rows > work) work = 32 * rows;  // a warp per row of the inverse
    err = coop_launch(tail_v_kernel<T>, a, work, s);
  } else if (kind == TailKind::kDown) {
    err = coop_launch(tail_down_kernel<T>, a, work, s);
  } else {
    err = coop_launch(tail_up_kernel<T>, a, work, s);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // namespace

// ptrs: nlev * 9 device pointers, per level (beta_i, beta_j, beta_k, alpha
// or null, kdinv0, kdinv1, rhs, e, res); dims, scales: nlev each (finest
// tail level first). xp: (dims[0]+4)^3 scratch, tmp: dims[0]^3 scratch.
extern "C" int hpgmg_tail_down_f32(const void* const* ptrs, const int* dims,
                                   const double* scales, int nlev, int nsweeps,
                                   double a_coef, const void* x_in, void* xp,
                                   void* tmp, void* stream) {
  return launch_tail<float>(TailKind::kDown, ptrs, dims, scales, nlev, nsweeps,
                            a_coef, x_in, nullptr, nullptr, nullptr, xp, tmp,
                            stream);
}

extern "C" int hpgmg_tail_down_f64(const void* const* ptrs, const int* dims,
                                   const double* scales, int nlev, int nsweeps,
                                   double a_coef, const void* x_in, void* xp,
                                   void* tmp, void* stream) {
  return launch_tail<double>(TailKind::kDown, ptrs, dims, scales, nlev, nsweeps,
                             a_coef, x_in, nullptr, nullptr, nullptr, xp, tmp,
                             stream);
}

extern "C" int hpgmg_tail_up_f32(const void* const* ptrs, const int* dims,
                                 const double* scales, int nlev, int nsweeps,
                                 double a_coef, const void* u_bot, void* xp,
                                 void* tmp, void* stream) {
  return launch_tail<float>(TailKind::kUp, ptrs, dims, scales, nlev, nsweeps,
                            a_coef, nullptr, u_bot, nullptr, nullptr, xp, tmp,
                            stream);
}

extern "C" int hpgmg_tail_up_f64(const void* const* ptrs, const int* dims,
                                 const double* scales, int nlev, int nsweeps,
                                 double a_coef, const void* u_bot, void* xp,
                                 void* tmp, void* stream) {
  return launch_tail<double>(TailKind::kUp, ptrs, dims, scales, nlev, nsweeps,
                             a_coef, nullptr, u_bot, nullptr, nullptr, xp, tmp,
                             stream);
}

// K4c: the down entry's operands, plus ainv ((db^3)^2, db = dims[nlev-1]/2)
// and u_bot (db^3 scratch); the result is the first level's e (ptrs[7]).
extern "C" int hpgmg_tail_v_f32(const void* const* ptrs, const int* dims,
                                const double* scales, int nlev, int nsweeps,
                                double a_coef, const void* x_in,
                                const void* ainv, void* u_bot, void* xp,
                                void* tmp, void* stream) {
  return launch_tail<float>(TailKind::kV, ptrs, dims, scales, nlev, nsweeps,
                            a_coef, x_in, nullptr, ainv, u_bot, xp, tmp, stream);
}

extern "C" int hpgmg_tail_v_f64(const void* const* ptrs, const int* dims,
                                const double* scales, int nlev, int nsweeps,
                                double a_coef, const void* x_in,
                                const void* ainv, void* u_bot, void* xp,
                                void* tmp, void* stream) {
  return launch_tail<double>(TailKind::kV, ptrs, dims, scales, nlev, nsweeps,
                             a_coef, x_in, nullptr, ainv, u_bot, xp, tmp, stream);
}
