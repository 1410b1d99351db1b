// K2c: K2's full fv4 GSRB sweep (red half-sweep, then black) on the small
// Dirichlet levels, in ONE ordinary launch of thread-block clusters:
//
//   y   = x + kdinv0 * (rhs - A x)
//   out = y + kdinv1 * (rhs - A y)
//
// with kdinv0/kdinv1 the parity-folded dinv pair (zeros off the parity a
// half-sweep updates) and the quartic Dirichlet ghosts of x and of y
// synthesized before each half, as gsrb.c:24-41 refills the ghosts between
// the two. Each half computes A x at its colour's cells only and copies
// the others, as K1's gsrb mode does, with K1's arithmetic and ghosts, so
// the sweep equals two K1 gsrb launches (fv4_stream.cu) to rounding.
//
// Replaces hpgmg_tpu/kernels/stencils.py:_fv4_gsrb2_kernel (reached through
// fv4_gsrb2_pallas) on those levels. That kernel held a radius-4 window of
// x per VMEM tile, applied the red half on the tile's radius-2 ring and the
// black half on the tile, from one read of x. Here the ring runs along i
// and a cluster of blocks takes the place of the tile: the level is cut
// into slabs of S = C - 4 i-planes, one C-block cluster a slab, and a
// cluster never waits on another. Block b of the cluster of slab
// [i0, i0+S) owns plane q = i0 - 2 + b:
//
//   1. it loads x planes q-2 .. q+2 from device memory into its shared
//      memory (cp.async, all in flight at once), makes the ghost planes
//      outside the domain from the loaded planes (a block at the domain's
//      edge loads the fourth plane its ghosts need into the slot of its
//      far ghost plane), then every plane's (j, k) ghost frame;
//   2. it computes the red half at plane q into its y plane (the cluster's
//      y planes are [i0-2, i0+S+2): the 2-plane ring is computed by the
//      neighbouring clusters too);
//   3. cluster barrier;
//   4. blocks 2 .. C-3 (the slab's planes) copy y planes q-2 .. q+2 from
//      the blocks that own them, whole, in 16-byte vectors, eight in
//      flight a thread (distributed shared memory), make y's ghost planes
//      and frames as in 1, compute the black half at plane q and write out
//      once;
//   5. cluster barrier (no block leaves while another reads its y plane).
//
// The last slab is shifted down to end at plane n (when n >= S), so that
// every cluster holds the y planes its ghosts need; planes computed by two
// clusters get the same bits from both. A block loads its x planes from
// device memory (L2) itself rather than from its neighbours' shared
// memory: a plane costs about the same from either, and it saves a
// barrier. Ghosts: K1's quartic taps; the cells of the ghost planes
// equal K1's bit for bit, their frames (edges and corners) are the same
// tensor product summed in another order.
//
// What bounds it on an H100: at 64^3 the work is ~0.4 MB of operands
// (bound ~0.0026 ms); the launch, the x loads (five planes a block, each
// of the slab's planes read by five blocks through L2), two barriers and
// the latency of each phase set its time, not bytes or flops. Design: C =
// kGsrb2Cluster = 16 blocks of 512 threads a cluster (non-portable: S =
// 12, 6 clusters on 96 SMs at 64^3, which the card holds at once; measured
// on an H100 80GB HBM3 at 700 W, device time a 64^3 f32 sweep in turns
// from torch.profiler by chip_smoke.py: 0.0312 ms, against 0.0596-0.0597
// with the portable 8, whose 16 clusters of one block an SM ran in two
// rounds; 8 and 12 ran alike; C >= 6 so that a slab's edge ghosts read
// only the cluster's planes), six padded planes of shared memory a block
// (64^3: 111 KB in f32, 222 KB in f64), hence kGsrb2ClusterMaxN.
// Plain version: hpgmg_tpu_torch/kernels/stencils.py:fv4_gsrb2_plain.

#include "cluster.cuh"

namespace {

// The largest n the kernel takes: six planes of (n+4)^2 doubles must fit a
// block's shared memory (n = 64: 221,952 of 232,448 bytes).
constexpr int kGsrb2ClusterMaxN = 64;
constexpr int kGsrb2Threads = 512;
constexpr int kGsrb2Cluster = 16;  // blocks a cluster (see above)
static_assert(kGsrb2Cluster >= 6 && kGsrb2Cluster <= kMaxCluster, "K2c's cluster size");

template <typename T>
struct ClusterArgs {
  Fv4Coefs<T> c;
  const T* x;
  const T* kd0;
  const T* kd1;
  T* out;
  int ps;  // plane pitch
};

// The planes q-2 .. q+2 of a field sit in slots 0..4 of xs; an edge
// block's ghost planes need one plane more (3 for q = 0, n-4 for q =
// n-1), fetched into the slot of its far ghost plane, which ghost_planes
// overwrites cell by cell after reading it. Fetch planes [lo, hi] and the
// extra one through fetch(plane, slot).
template <typename F>
__device__ __forceinline__ void fetch_planes(int q, int n, const F& fetch) {
  const int lo = q - 2 > 0 ? q - 2 : 0, hi = q + 2 < n - 1 ? q + 2 : n - 1;
  fetch(lo, hi, lo - q + 2);
  if (q == 0) fetch(3, 3, 0);
  if (q == n - 1) fetch(n - 4, n - 4, 4);
}

// Make the ghost planes among slots 0..4 (planes q-2 .. q+2 outside
// [0, n)) from the fetched planes, then the (j, k) frames of slots 1..3:
// the stencil of plane q reads planes q-2 and q+2 only at its own (j, k).
template <typename T>
__device__ void ghosts_and_frames(T* xs, int ps, int q, int n) {
  if (q <= 1) {  // planes -1 (slot 1-q) and, at q = 0, -2 (slot 0)
    const T* src[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) src[a] = xs + (a + 2 - q <= 4 ? a + 2 - q : 0) * ps;
    ghost_planes(xs + (1 - q) * ps, q == 0 ? xs : nullptr, src, n, false);
  }
  if (q >= n - 2) {  // planes n (slot n-q+2) and, at q = n-1, n+1 (slot 4)
    const T* src[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) src[a] = xs + (n + 1 - a - q >= 0 ? n + 1 - a - q : 4) * ps;
    ghost_planes(xs + (n - q + 2) * ps, q == n - 1 ? xs + 4 * ps : nullptr, src, n, false);
  }
  __syncthreads();
  make_frames(xs + ps, 3, ps, n);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kGsrb2Threads, 1)
    fv4_gsrb2_cluster_kernel(const ClusterArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // 5 planes: x q-2 .. q+2, then y
  T* ys = xs + 5 * a.ps;               // this block's y plane (red half)
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks()), b = static_cast<int>(cl.block_rank());
  const int S = C - 4, n = a.c.n, np = n + 4, ps = a.ps;
  int i0 = static_cast<int>(blockIdx.x) / C * S;
  if (i0 > n - S) i0 = n - S;  // the last slab ends at plane n
  if (i0 < 0) i0 = 0;          // n < S: one slab
  const int q = i0 - 2 + b;
  const bool has_y = q >= 0 && q < n;

  if (has_y) {
    // 1. x planes q-2 .. q+2 with their ghosts
    fetch_planes(q, n, [&](int p0, int p1, int slot) {
      load_planes_async(xs + slot * ps, ps, a.x + static_cast<int64_t>(p0) * n * n,
                        p1 - p0 + 1, n);
    });
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    ghosts_and_frames(xs, ps, q, n);
    // 2. the red half at plane q into ys
    half_sweep(a.c, xs + 2 * ps, ps, q, 1, 0, a.kd0,
               [&](int, int j, int k, T v) { ys[(j + 2) * np + (k + 2)] = v; });
  }
  cl.sync();

  if (has_y && b >= 2 && b < C - 2) {
    // 4. y planes q-2 .. q+2 from the blocks that own them, then the black
    // half
    int first[2], last[2], slot[2], runs = 0;
    fetch_planes(q, n, [&](int p0, int p1, int s) {
      first[runs] = p0;
      last[runs] = p1;
      slot[runs++] = s;
    });
    const int n0 = last[0] - first[0] + 1;
    auto plane = [&](int i) { return i < n0 ? first[0] + i : first[1]; };
    copy_planes<T>(
        runs == 1 ? n0 : n0 + 1, ps,
        [&](int i) -> const T* { return cl.map_shared_rank(ys, plane(i) - i0 + 2); },
        [&](int i) -> T* { return xs + (i < n0 ? slot[0] + i : slot[1]) * ps; });
    __syncthreads();
    ghosts_and_frames(xs, ps, q, n);
    T* out = a.out + static_cast<int64_t>(q) * n * n;
    half_sweep(a.c, xs + 2 * ps, ps, q, 1, 1, a.kd1,
               [&](int, int j, int k, T v) { out[j * n + k] = v; });
  }
  cl.sync();
}

template <typename T>
int launch_gsrb2_cluster(const void* x, const void* bie, const void* bje,
                         const void* bke, const void* alpha, const void* rhs,
                         const void* kd0, const void* kd1, void* out, int n,
                         double scale, double a_coef, void* stream) {
  if (n < 4 || n > kGsrb2ClusterMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ClusterArgs<T> a{
      Fv4Coefs<T>{static_cast<const T*>(bie), static_cast<const T*>(bje),
                  static_cast<const T*>(bke), static_cast<const T*>(alpha),
                  static_cast<const T*>(rhs), n, static_cast<T>(scale),
                  static_cast<T>(a_coef)},
      static_cast<const T*>(x), static_cast<const T*>(kd0), static_cast<const T*>(kd1),
      static_cast<T*>(out), plane_pitch(n)};
  const int S = kGsrb2Cluster - 4, slabs = n > S ? (n + S - 1) / S : 1;
  static ClusterKernel state;
  return cluster_launch(state, fv4_gsrb2_cluster_kernel<T>, a, slabs, kGsrb2Cluster,
                        kGsrb2Threads, 6 * static_cast<size_t>(a.ps) * sizeof(T),
                        static_cast<cudaStream_t>(stream));
}

}  // namespace

// n <= kGsrb2ClusterMaxN; out: n^3
extern "C" int hpgmg_fv4_gsrb2_cluster_f32(const void* x, const void* bie,
                                           const void* bje, const void* bke,
                                           const void* alpha, const void* rhs,
                                           const void* kd0, const void* kd1, void* out,
                                           int n, double scale, double a_coef,
                                           void* stream) {
  return launch_gsrb2_cluster<float>(x, bie, bje, bke, alpha, rhs, kd0, kd1, out, n,
                                     scale, a_coef, stream);
}

extern "C" int hpgmg_fv4_gsrb2_cluster_f64(const void* x, const void* bie,
                                           const void* bje, const void* bke,
                                           const void* alpha, const void* rhs,
                                           const void* kd0, const void* kd1, void* out,
                                           int n, double scale, double a_coef,
                                           void* stream) {
  return launch_gsrb2_cluster<double>(x, bie, bje, bke, alpha, rhs, kd0, kd1, out, n,
                                      scale, a_coef, stream);
}
