// K4: the coarse-ladder ("tail") of an fv4 V-cycle over all the tail
// levels (dims <= 32 above the bottom), each part in ONE launch of one
// thread-block cluster:
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
// the bottom solve between them outside). The arithmetic per level is K1's
// gsrb and fres modes (fv4_stream.cu: K1's ghosts, the colour's cells
// computed, the others copied) and the v2 interpolation of
// ops/transfer_fv.py:interp_v2, whose coarse quadratic Dirichlet ghosts
// (g = -5/2 c0 + 1/2 c1) and 3-tap children (1/8, 1, -1/8) are computed
// in the kernel body as per-axis taps, their tensor product being the
// separable operator.
//
// Replaces hpgmg_tpu/kernels/tail.py:_down_kernel (tail_down_call),
// _up_kernel (tail_up_call) and _v_kernel (tail_v_call, with its in-kernel
// DIRECT bottom _bottom_direct). Those held every tail level whole in VMEM
// and chained the phases in registers, the transfers as per-slice MXU dots.
// Here one cluster of C blocks holds the level being smoothed in its
// distributed shared memory: block b owns a slab of P i-planes of every
// level (P = ceil(n/C) rounded up to even, so that a coarse cell's two fine
// planes are one block's), and keeps two buffers, the iterate and its
// ping-pong partner, each its slab's planes with their (j, k) ghost frames
// and two halo planes on either side. A half-sweep is
//
//   1. halo: the halo planes in the domain copied whole with their frames
//      (16-byte vectors, eight in flight a thread) from the blocks that own
//      them; on the first and the last block, which then hold the four
//      planes next to their face, the ghost planes outside the domain
//      (K1's tensor product of quartic taps);
//   2. the update of the slab's planes into the other buffer, then their
//      (j, k) ghost frames;
//   3. one cluster barrier (cg::this_cluster().sync()).
//
// A block copies halos only from planes that no block writes in that
// half-sweep, so one barrier a half-sweep orders everything. The two
// buffers are sized for the first level and reused by every level below
// it: a level's pre-smoothed iterate (e), its restricted residual (res)
// and the bottom's solution go to device memory, where the climb's
// interpolation and the next level read them (past L1: another SM wrote
// them). The face coefficients, kdinv and rhs are read through L1/L2
// (a 32^3 block slab of them is ~100 KB in f32). K4c's bottom gives each
// row of the inverse to one warp of the cluster (lanes stride the row; a
// shuffle reduction), reading the inverse (1 MB in f32) through L2.
//
// What bounds it on an H100: the serial chain of phases (14 half-sweeps,
// fres and the interpolation a level, each a cluster barrier apart) and
// each phase's latency on C SMs; the levels are tiny (a 32^3 level is 128
// KB in f32), so neither bytes nor flops.
// Cluster size: kTailCluster = 16 blocks of 384 threads (non-portable;
// measured on an H100 80GB HBM3 at 700 W on the 32-16 tail in f32, device
// time from torch.profiler in turns by chip_smoke.py: K4a 0.0836-0.0837 ms
// with 16 blocks against 0.1148 with the portable 8, K4c 0.1791-0.1792
// against 0.2459). Shared memory a block: 2 (P+4) (n+4)^2 values of the
// first level, at 32^3 62 KB in f32 and 124 KB in f64 (bf16 levels: as
// f32, their buffers hold float).
// bfloat16 (K4a, K4b; K4c's DIRECT bottom has no bf16 build): the buffers
// hold float; each half-sweep's result, e, res and the climb's e +
// interp_v2(u) are rounded to bf16 where a level-by-level cycle of bf16
// launches would store them.
// Plain version: hpgmg_tpu_torch/kernels/tail.py:tail_down_plain and
// tail_up_plain and tail_v_plain.

#include "cluster.cuh"

namespace {

constexpr int kMaxTail = 6;
constexpr int kTailCluster = 16;  // blocks in the cluster (see above)
static_assert(kTailCluster <= kMaxCluster, "K4's cluster size");
constexpr int kTailPtrs = 9;  // pointers per level in the C interface
// 384 threads a block: at 512 (128 registers) K4c spilled ~600 bytes and
// ran 4% (f32) and 15% (f64) slower on an H100; at 256 the half-sweeps'
// chains grew longer than the spills cost.
constexpr int kTailThreads = 384;

// One tail level. Down: e is written (the pre-smoothed iterate) and res
// (the restricted residual, the next level's rhs). Up: e is read (the
// pre-smoothed iterate) and res written (the post-smoothed solution).
// (stored in V, computed in T = Wide<V>)
template <typename T, typename V = T>
struct TailLevel {
  Fv4Coefs<T, V> c;
  const V* kd0;
  const V* kd1;
  V* e;
  V* res;
};

template <typename T, typename V = T>
struct TailArgs {
  TailLevel<T, V> lv[kMaxTail];
  const V* x_in;   // down, v: the first level's starting iterate
  const V* u_bot;  // up: the solution below the coarsest tail level
  const V* ainv;   // v: the bottom's dense inverse, (db^3, db^3) row-major
  V* u_out;        // v: the bottom solution, db^3
  int nlev;
  int nsweeps;  // even: the last half-sweep lands in the first buffer
  int buf;      // values of one buffer
};

// planes a block owns of an n-plane level: ceil(n / C), even
__host__ __device__ __forceinline__ int slab_planes(int n, int C) {
  const int P = (n + C - 1) / C;
  return P + (P & 1);
}

// A block's slab of one level: planes [p0, p1) (none when p0 == p1); slot
// s of a buffer holds plane p0 - 2 + s.
struct Slab {
  int n, np, ps, P, p0, p1;
  __device__ Slab(int n_, int C, int rank) : n(n_), np(n_ + 4), ps(plane_pitch(n_)) {
    P = slab_planes(n, C);
    p0 = rank * P < n ? rank * P : n;
    p1 = p0 + P < n ? p0 + P : n;
  }
  __device__ int own() const { return p1 - p0; }
  // the block that owns plane p, and the plane's slot there
  __device__ int owner(int p) const { return p / P; }
  __device__ int slot(int p) const { return p - owner(p) * P + 2; }
};

// Fill the halo slots of `buf` (planes p0-2, p0-1, p1, p1+1): the planes
// in the domain copied whole, with their frames, from the blocks that hold
// them in the same buffer; on the first and the last block, which then
// hold the four planes next to their face with their frames (P >= 2), the
// ghost planes outside the domain, frames included, each value K1's
// quartic combination of the same value of those planes (ghost_planes).
// Ends on a block barrier.
template <typename T>
__device__ void fill_halo(T* buf, const Slab& S, cg::cluster_group& cl) {
  const int n = S.n, own = S.own();
  const int lo = S.p0 - 2 > 0 ? S.p0 - 2 : 0, nlo = S.p0 - lo;
  const int nhi = (S.p1 + 2 < n ? S.p1 + 2 : n) - S.p1;
  auto plane = [&](int i) { return i < nlo ? lo + i : S.p1 + i - nlo; };
  copy_planes<T>(
      nlo + nhi, S.ps,
      [&](int i) -> const T* {
        const int p = plane(i);
        return cl.map_shared_rank(buf + S.slot(p) * S.ps, S.owner(p));
      },
      [&](int i) -> T* { return buf + (plane(i) - S.p0 + 2) * S.ps; });
  __syncthreads();
  if (S.p0 == 0) {  // planes -1, -2 in slots 1, 0 from planes 0..3 in 2..5
    const T* src[4] = {buf + 2 * S.ps, buf + 3 * S.ps, buf + 4 * S.ps, buf + 5 * S.ps};
    ghost_planes(buf + S.ps, buf, src, n, true);
  }
  if (S.p1 == n) {  // planes n, n+1 in slots own+2, own+3
    const T* src[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) src[a] = buf + (own + 1 - a) * S.ps;
    ghost_planes(buf + (own + 2) * S.ps, buf + (own + 3) * S.ps, src, n, true);
  }
  if (S.p0 == 0 || S.p1 == n) __syncthreads();
}

// nsweeps half-sweeps of level L from the iterate in buf[0] (its slab's
// frames made, the cluster past a barrier since); the result lands in
// buf[0] again, the cluster past a barrier.
template <typename T, typename V>
__device__ void sweeps(const TailArgs<T, V>& a, const TailLevel<T, V>& L, const Slab& S,
                       T* const* buf, cg::cluster_group& cl) {
  for (int s = 0; s < a.nsweeps; ++s) {
    T* src = buf[s & 1];
    T* dst = buf[(s & 1) ^ 1];
    if (S.own() > 0) {
      fill_halo(src, S, cl);
      T* first = dst + 2 * S.ps;
      // each half-sweep's result rounded to V, as its own launch would
      // store it
      auto put = [&](int il, int j, int k, T v) {
        first[il * S.ps + (j + 2) * S.np + (k + 2)] = rounded<V>(v);
      };
      half_sweep(L.c, src + 2 * S.ps, S.ps, S.p0, S.own(), s & 1, (s & 1) ? L.kd1 : L.kd0,
                 put);
      __syncthreads();
      make_frames(first, S.own(), S.ps, S.n);
    }
    cl.sync();
  }
}

// The slab's cells of buf[0] to the level field dst in device memory
// (already rounded to V where V is narrower: the stores are exact).
template <typename T, typename V>
__device__ void store_slab(V* dst, const T* buf, const Slab& S) {
  const int n = S.n, per = n * n;
  for (int t = threadIdx.x; t < S.own() * per; t += blockDim.x) {
    const int il = t / per, r = t - il * per, j = r / n;
    dst[static_cast<int64_t>(S.p0) * per + t] =
        narrow<V>(buf[(il + 2) * S.ps + (j + 2) * S.np + (r - j * n) + 2]);
  }
}

// res = restrict_cell(rhs - A x) at the coarse cells whose fine planes are
// the slab's (x in buf with its halo): the residual at every fine cell of
// the slab into `r` (a free buffer), then each coarse cell's eight summed
// in K1's order. Ends on a block barrier.
template <typename T, typename V>
__device__ void fres(const TailLevel<T, V>& L, const Slab& S, const T* buf, T* r) {
  const int n = S.n, m = n / 2, per = n * n, cper = m * m;
  for (int t = threadIdx.x; t < S.own() * per; t += blockDim.x) {
    const int il = t / per, q = t - il * per, j = q / n, k = q - j * n, i = S.p0 + il;
    const int64_t c = static_cast<int64_t>(S.p0) * per + t;
    r[t] = ldcgv<T>(L.c.rhs + c) -
           plane_ax(L.c, buf + (il + 2) * S.ps + (j + 2) * S.np + (k + 2), S.ps, i, j, k, c);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < S.own() / 2 * cper; t += blockDim.x) {
    const int Il = t / cper, q = t - Il * cper, J = q / m, K = q - J * m;
    T sum = T(0);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      sum += r[((2 * Il + (d >> 2)) * n + 2 * J + ((d >> 1) & 1)) * n + 2 * K + (d & 1)];
    }
    L.res[static_cast<int64_t>(S.p0 / 2) * cper + t] = narrow<V>(T(0.125) * sum);
  }
  __syncthreads();
}

// The descent: per level, its start (x_in on the first level, zeros
// below), sweeps, e and the restricted residual to device memory; ends
// on a cluster barrier.
template <typename T, typename V>
__device__ void descend(const TailArgs<T, V>& a, T* const* buf, cg::cluster_group& cl) {
  const int C = static_cast<int>(cl.num_blocks()), rank = static_cast<int>(cl.block_rank());
  for (int l = 0; l < a.nlev; ++l) {
    const TailLevel<T, V>& L = a.lv[l];
    const Slab S(L.c.n, C, rank);
    if (S.own() > 0) {
      const int n = S.n, per = n * n;
      T* first = buf[0] + 2 * S.ps;
      if (l == 0) {
        load_planes_async(first, S.ps, a.x_in + static_cast<int64_t>(S.p0) * n * n, S.own(),
                          n);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        make_frames(first, S.own(), S.ps, n);
      } else {
        for (int t = threadIdx.x; t < S.own() * S.ps; t += blockDim.x) first[t] = T(0);
      }
    }
    cl.sync();
    sweeps(a, L, S, buf, cl);
    if (S.own() > 0) {
      store_slab(L.e, buf[0], S);
      fill_halo(buf[0], S, cl);
      fres(L, S, buf[0], buf[1]);
    }
    cl.sync();
  }
}

// The climb from u, the solution below the coarsest level: per level, the
// interpolation added to e, then sweeps; the level's solution goes to res,
// or over e (in_place: K4c, whose res holds the next level's rhs).
template <typename T, typename V>
__device__ void climb(const TailArgs<T, V>& a, const V* u, bool in_place, T* const* buf,
                      cg::cluster_group& cl) {
  const int C = static_cast<int>(cl.num_blocks()), rank = static_cast<int>(cl.block_rank());
  for (int l = a.nlev - 1; l >= 0; --l) {
    const TailLevel<T, V>& L = a.lv[l];
    const Slab S(L.c.n, C, rank);
    V* out = in_place ? L.e : L.res;
    if (S.own() > 0) {
      // e's slab into buf[0]; the coarse planes [c0, c1] its interpolation
      // reads into buf[1] (free until the first half-sweep)
      const int n = S.n, dc = n / 2, per = n * n;
      const int c0 = S.p0 / 2 - 1 > 0 ? S.p0 / 2 - 1 : 0;
      const int c1 = (S.p1 - 1) / 2 + 1 < dc - 1 ? (S.p1 - 1) / 2 + 1 : dc - 1;
      T* first = buf[0] + 2 * S.ps;
      const T* uc = buf[1];
      load_planes_async(first, S.ps, L.e + static_cast<int64_t>(S.p0) * per, S.own(), n);
      stage_l2(buf[1], u + static_cast<int64_t>(c0) * dc * dc, (c1 - c0 + 1) * dc * dc);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int t = threadIdx.x; t < S.own() * per; t += blockDim.x) {
        const int il = t / per, r = t - il * per, j = r / n, k = r - j * n;
        int ii[5], jj[5], kk[5];
        T wi[5], wj[5], wk[5];
        const int ni = interp_v2_taps(S.p0 + il, dc, ii, wi);
        const int nj = interp_v2_taps(j, dc, jj, wj);
        const int nk = interp_v2_taps(k, dc, kk, wk);
        T up = T(0);
#pragma unroll
        for (int x = 0; x < 5; ++x) {
          if (x >= ni) break;
#pragma unroll
          for (int y = 0; y < 5; ++y) {
            if (y >= nj) break;
            const T* row = uc + ((ii[x] - c0) * dc + jj[y]) * dc;
            T sk = T(0);
#pragma unroll
            for (int z = 0; z < 5; ++z) {
              if (z >= nk) break;
              sk += wk[z] * row[kk[z]];
            }
            up += wi[x] * wj[y] * sk;
          }
        }
        T& xe = first[il * S.ps + (j + 2) * S.np + k + 2];
        xe = rounded<V>(xe + up);  // e + interp_v2(u), one rounding
      }
      __syncthreads();
      make_frames(first, S.own(), S.ps, n);
    }
    cl.sync();
    sweeps(a, L, S, buf, cl);
    if (S.own() > 0) store_slab(out, buf[0], S);
    if (l > 0) cl.sync();  // the next level's interpolation reads out
    u = out;
  }
}

// u_out = ainv . r, r the coarsest level's restricted residual (staged in
// `stage`): one warp of the cluster per row, its lanes reading the row in
// 16-byte vectors where the rows allow, four loads in flight.
template <typename T, typename V>
__device__ void bottom(const TailArgs<T, V>& a, T* stage, cg::cluster_group& cl) {
  constexpr int W = 16 / static_cast<int>(sizeof(T));  // values a vector
  const TailLevel<T, V>& L = a.lv[a.nlev - 1];
  const int db = L.c.n / 2, m = db * db * db, lane = threadIdx.x & 31;
  for (int t = threadIdx.x; t < m; t += blockDim.x) stage[t] = ldcgv<T>(L.res + t);
  __syncthreads();
  const int warps = blockDim.x >> 5;
  const int nwarps = static_cast<int>(cl.num_blocks()) * warps;
  for (int row = static_cast<int>(cl.block_rank()) * warps + (threadIdx.x >> 5); row < m;
       row += nwarps) {
    const T* arow = a.ainv + static_cast<int64_t>(row) * m;
    T s = T(0);
    if (m % W == 0) {
      const int4* vrow = reinterpret_cast<const int4*>(arow);
#pragma unroll 4
      for (int v = lane; v < m / W; v += 32) {
        const int4 raw = __ldg(vrow + v);
        const T* w = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < W; ++e) s += w[e] * stage[v * W + e];
      }
    } else {
#pragma unroll 4
      for (int c = lane; c < m; c += 32) s += __ldg(arow + c) * stage[c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) a.u_out[row] = narrow<V>(s);
  }
}

template <typename T>
__device__ __forceinline__ void buffers(T* (&buf)[2], int values) {
  extern __shared__ __align__(16) unsigned char smem[];
  buf[0] = reinterpret_cast<T*>(smem);
  buf[1] = buf[0] + values;
}

template <typename V, typename T = Wide<V>>
__global__ void __launch_bounds__(kTailThreads, 1) tail_down_kernel(const TailArgs<T, V> a) {
  cg::cluster_group cl = cg::this_cluster();
  T* buf[2];
  buffers(buf, a.buf);
  descend(a, buf, cl);
}

template <typename V, typename T = Wide<V>>
__global__ void __launch_bounds__(kTailThreads, 1) tail_up_kernel(const TailArgs<T, V> a) {
  cg::cluster_group cl = cg::this_cluster();
  T* buf[2];
  buffers(buf, a.buf);
  climb(a, a.u_bot, false, buf, cl);
}

template <typename V, typename T = Wide<V>>
__global__ void __launch_bounds__(kTailThreads, 1) tail_v_kernel(const TailArgs<T, V> a) {
  cg::cluster_group cl = cg::this_cluster();
  T* buf[2];
  buffers(buf, a.buf);
  descend(a, buf, cl);
  bottom(a, buf[1], cl);
  cl.sync();
  climb(a, a.u_out, true, buf, cl);
}

enum class TailKind { kDown = 0, kUp = 1, kV = 2 };

// bytes of shared memory a block needs for a tail whose first level is n0^3
__host__ __forceinline__ size_t tail_smem(int n0, size_t value) {
  return 2 * static_cast<size_t>(slab_planes(n0, kTailCluster) + 4) * plane_pitch(n0) * value;
}

// V: the levels' storage type (float, double; bf16 for K4a and K4b: K4c's
// DIRECT bottom has no bf16 build)
template <typename V>
int launch_tail(TailKind kind, const void* const* ptrs, const int* dims,
                const double* scales, int nlev, int nsweeps, double a_coef,
                const void* x_in, const void* u_bot, const void* ainv, void* u_out,
                void* stream) {
  using T = Wide<V>;
  constexpr bool narrow_storage = !std::is_same_v<T, V>;
  if (nlev < 1 || nlev > kMaxTail || nsweeps < 2 || nsweeps % 2 != 0 ||
      (narrow_storage && kind == TailKind::kV)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TailArgs<T, V> a{};
  for (int l = 0; l < nlev; ++l) {
    const int n = dims[l];
    // even, >= 4 cells for the quartic ghosts (>= 8 so the coarse grid of
    // the v2 interpolation has 2), each level half the one above
    if (n < 8 || n % 2 != 0 || (l > 0 && n * 2 != dims[l - 1])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const void* const* q = ptrs + kTailPtrs * l;
    a.lv[l] = TailLevel<T, V>{
        Fv4Coefs<T, V>{static_cast<const V*>(q[0]), static_cast<const V*>(q[1]),
                       static_cast<const V*>(q[2]), static_cast<const V*>(q[3]),
                       static_cast<const V*>(q[6]), n, static_cast<T>(scales[l]),
                       static_cast<T>(a_coef)},
        static_cast<const V*>(q[4]), static_cast<const V*>(q[5]),
        static_cast<V*>(const_cast<void*>(q[7])), static_cast<V*>(const_cast<void*>(q[8]))};
  }
  a.x_in = static_cast<const V*>(x_in);
  a.u_bot = static_cast<const V*>(u_bot);
  a.ainv = static_cast<const V*>(ainv);
  a.u_out = static_cast<V*>(u_out);
  a.nlev = nlev;
  a.nsweeps = nsweeps;
  a.buf = (slab_planes(dims[0], kTailCluster) + 4) * plane_pitch(dims[0]);
  const size_t smem = tail_smem(dims[0], sizeof(T));
  if (smem > kMaxClusterSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int db = dims[nlev - 1] / 2;
  if (kind == TailKind::kV && (ainv == nullptr || u_out == nullptr || db * db * db > a.buf)) {
    return static_cast<int>(cudaErrorInvalidValue);  // the bottom's r is staged in buffer 1
  }
  static ClusterKernel state[3];
  void (*kernel)(TailArgs<T, V>) = kind == TailKind::kDown ? tail_down_kernel<V>
                                                            : tail_up_kernel<V>;
  if constexpr (!narrow_storage) {
    if (kind == TailKind::kV) kernel = tail_v_kernel<V>;
  }
  return cluster_launch(state[static_cast<int>(kind)], kernel, a, 1, kTailCluster,
                        kTailThreads, smem, static_cast<cudaStream_t>(stream));
}

}  // namespace

// ptrs: nlev * 9 device pointers, per level (beta_i, beta_j, beta_k, alpha
// or null, kdinv0, kdinv1, rhs, e, res); dims, scales: nlev each (finest
// tail level first).
extern "C" int hpgmg_tail_down_f32(const void* const* ptrs, const int* dims,
                                   const double* scales, int nlev, int nsweeps,
                                   double a_coef, const void* x_in,
                                   void* stream) {
  return launch_tail<float>(TailKind::kDown, ptrs, dims, scales, nlev, nsweeps, a_coef,
                            x_in, nullptr, nullptr, nullptr, stream);
}

extern "C" int hpgmg_tail_down_f64(const void* const* ptrs, const int* dims,
                                   const double* scales, int nlev, int nsweeps,
                                   double a_coef, const void* x_in,
                                   void* stream) {
  return launch_tail<double>(TailKind::kDown, ptrs, dims, scales, nlev, nsweeps, a_coef,
                             x_in, nullptr, nullptr, nullptr, stream);
}

extern "C" int hpgmg_tail_up_f32(const void* const* ptrs, const int* dims,
                                 const double* scales, int nlev, int nsweeps,
                                 double a_coef, const void* u_bot,
                                 void* stream) {
  return launch_tail<float>(TailKind::kUp, ptrs, dims, scales, nlev, nsweeps, a_coef,
                            nullptr, u_bot, nullptr, nullptr, stream);
}

extern "C" int hpgmg_tail_up_f64(const void* const* ptrs, const int* dims,
                                 const double* scales, int nlev, int nsweeps,
                                 double a_coef, const void* u_bot,
                                 void* stream) {
  return launch_tail<double>(TailKind::kUp, ptrs, dims, scales, nlev, nsweeps, a_coef,
                             nullptr, u_bot, nullptr, nullptr, stream);
}

// K4a and K4b on bf16 levels (float arithmetic; each half-sweep's result,
// e, res and the climb's e + interp_v2(u) rounded to bf16 once)
extern "C" int hpgmg_tail_down_bf16(const void* const* ptrs, const int* dims,
                                    const double* scales, int nlev, int nsweeps,
                                    double a_coef, const void* x_in,
                                    void* stream) {
  return launch_tail<bf16>(TailKind::kDown, ptrs, dims, scales, nlev, nsweeps, a_coef,
                           x_in, nullptr, nullptr, nullptr, stream);
}

extern "C" int hpgmg_tail_up_bf16(const void* const* ptrs, const int* dims,
                                  const double* scales, int nlev, int nsweeps,
                                  double a_coef, const void* u_bot,
                                  void* stream) {
  return launch_tail<bf16>(TailKind::kUp, ptrs, dims, scales, nlev, nsweeps, a_coef,
                           nullptr, u_bot, nullptr, nullptr, stream);
}

// K4c: the down entry's operands, plus ainv ((db^3)^2, db = dims[nlev-1]/2)
// and u_bot (db^3 scratch); the result is the first level's e (ptrs[7]).
extern "C" int hpgmg_tail_v_f32(const void* const* ptrs, const int* dims,
                                const double* scales, int nlev, int nsweeps,
                                double a_coef, const void* x_in, const void* ainv,
                                void* u_bot, void* stream) {
  return launch_tail<float>(TailKind::kV, ptrs, dims, scales, nlev, nsweeps, a_coef, x_in,
                            nullptr, ainv, u_bot, stream);
}

extern "C" int hpgmg_tail_v_f64(const void* const* ptrs, const int* dims,
                                const double* scales, int nlev, int nsweeps,
                                double a_coef, const void* x_in, const void* ainv,
                                void* u_bot, void* stream) {
  return launch_tail<double>(TailKind::kV, ptrs, dims, scales, nlev, nsweeps, a_coef,
                             x_in, nullptr, ainv, u_bot, stream);
}
