// K15 fork_view and K16 fork_summary: the two fork-axis kernels of the
// counterfactual planner, one launch each per counterfactual_run.
//
// Replace the parts of the JAX root kubernetes_tpu/ops/counterfactual.py:148
// counterfactual_run that are not the workloads engine.  The root vmaps over
// the KF forks: fork_cluster_view (:78-100), workloads_run, then the
// per-fork summaries (:249-266 with fork_density, :103-117).  The port runs
// the workloads engine per fork with its existing kernels (K12, K1, K6, K7,
// K8, K11; ops/counterfactual.py) and these two for the rest:
//
// K15 writes every fork's neutralized static planes at once: where a node
// is not alive in fork k (removed, or a clone slot the fork does not add)
//   labels [k, n, :]        -> ABSENT
//   taint key/val/effect    -> PAD
//   dom_ids [k, :, n]       -> -1   (DeviceCluster.dom_ids, the compact
//                                    domain numbering the gang kernels read
//                                    in place of the label values)
//   visit_rank [k, n]       -> -1   (only when the caller passes one)
// and copies the node's row elsewhere, so an absent node is exactly a node
// that was never packed.  Design: source-stationary.  blockIdx.y picks the
// plane (no thread branches over planes) and blockIdx.z a chunk of
// FORK_CHUNK forks; a thread loads one 16-byte vector of the source plane
// once, keeps it in registers and stores one int4 per fork of its chunk,
// masked by the fork's alive bytes: one byte in a node-major plane whose
// width is a multiple of 4 (the vector is one node's columns), a uchar4 in
// a node-minor plane (dom_ids' rows, visit_rank, a one-column taint plane;
// the vector is four consecutive nodes) when N is a multiple of 4.  The
// node index is computed once per vector; the fork loop steps pointers by
// the plane's size, with no div or mod.  A plane of another width, or
// whose pointers are not 16-byte aligned, takes the same loop cell by
// cell.
//
// K16 reduces each fork's outcome after its admission: over the live valid
// pods (valid[p] && fk_pod_live[k, p]) the count placed (chosen >= 0), the
// count left (chosen < 0) and the sum of their first-failure reason counts
// [ND]; over the nodes alive in the fork with cpu and memory capacity the
// utilization (u_cpu 10^6 / a_cpu + u_mem 10^6 / a_mem) / 2, summed and
// divided by their count (all floor divisions of non-negative int64, as
// the reference's).  Design: one block per fork, the threads stride over P
// and then over N, int64 warp-shuffle reductions and one pass through
// shared memory.
//
// Bound on the H100: bytes for both: K15 writes KF copies of the node
// planes; K16 reads the stacked [KF, P, ND] reason counts and the fork's
// cpu and memory lanes once.
#include "ktpu.cuh"

using namespace ktpu;

namespace {

constexpr int VIEW_THREADS = 256;
constexpr int FORK_CHUNK = 8;  // forks per thread
constexpr int MAX_PLANES = 6;
constexpr int SUM_THREADS = 256;
constexpr int MAX_ND = 16;
constexpr long long DENSITY_SCALE = 1000000;

// One source plane of K15: [N, width] node-major (node = cell / width), or,
// with width 0, [rows, N] node-minor (node = cell % N); `cells` source
// cells, each fork's copy `cells` apart in dst.
struct Plane {
  const int* src;
  int* dst;
  int cells, width, fill, vec;  // vec: the 16-byte vector path
};

struct Planes {
  Plane p[MAX_PLANES];
};

__device__ __forceinline__ int4 fill4(int v) { return make_int4(v, v, v, v); }

__global__ void __launch_bounds__(VIEW_THREADS)
    fork_view_kernel(const Planes planes, const unsigned char* __restrict__ alive, int KF, int N) {
  const Plane pl = planes.p[blockIdx.y];
  const int k0 = blockIdx.z * FORK_CHUNK;
  const int nk = min(FORK_CHUNK, KF - k0);
  const int stride = gridDim.x * blockDim.x;
  const unsigned char* const al0 = alive + (long long)k0 * N;
  if (pl.vec) {
    const int nv = pl.cells >> 2;
    const int4* const src = reinterpret_cast<const int4*>(pl.src);
    int4* const dst0 = reinterpret_cast<int4*>(pl.dst) + (long long)k0 * nv;
    const int4 gone = fill4(pl.fill);
    for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < nv; v += stride) {
      const int4 s = src[v];
      int4* d = dst0 + v;
      if (pl.width) {  // one node's columns
        const unsigned char* al = al0 + (v << 2) / pl.width;
        for (int k = 0; k < nk; ++k, al += N, d += nv) *d = *al ? s : gone;
      } else {  // four consecutive nodes
        const uchar4* al = reinterpret_cast<const uchar4*>(al0 + (v << 2) % N);
        const int step = N >> 2;
        for (int k = 0; k < nk; ++k, al += step, d += nv) {
          const uchar4 m = *al;
          *d = make_int4(m.x ? s.x : pl.fill, m.y ? s.y : pl.fill, m.z ? s.z : pl.fill, m.w ? s.w : pl.fill);
        }
      }
    }
  } else {
    int* const dst0 = pl.dst + (long long)k0 * pl.cells;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < pl.cells; i += stride) {
      const int s = pl.src[i];
      const unsigned char* al = al0 + (pl.width ? i / pl.width : i % N);
      int* d = dst0 + i;
      for (int k = 0; k < nk; ++k, al += N, d += pl.cells) *d = *al ? s : pl.fill;
    }
  }
}

// Sum of v over the block; every thread gets the result.  s_warp holds one
// value per warp.
__device__ long long block_sum(long long v, long long* s_warp) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  long long out = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) out += s_warp[w];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(SUM_THREADS)
    fork_summary_kernel(const int* __restrict__ chosen, const long long* __restrict__ reason_counts,
                        const int* __restrict__ requested, const int* __restrict__ alloc,
                        const unsigned char* __restrict__ alive, const unsigned char* __restrict__ valid,
                        const unsigned char* __restrict__ pod_live, long long* admitted, long long* unsched,
                        long long* reasons, long long* density, int P, int N, int Rn, int ND) {
  __shared__ long long s_warp[SUM_THREADS / 32];
  const int k = blockIdx.x;
  long long placed = 0, left = 0, rc[MAX_ND];
  for (int r = 0; r < ND; ++r) rc[r] = 0;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const long long kp = (long long)k * P + p;
    if (!valid[p] || !pod_live[kp]) continue;
    if (chosen[kp] >= 0) placed += 1;
    else left += 1;
    for (int r = 0; r < ND; ++r) rc[r] += reason_counts[kp * ND + r];
  }
  long long util = 0, counted = 0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const long long kn = (long long)k * N + n;
    const long long a_cpu = alloc[kn * Rn + LANE_CPU], a_mem = alloc[kn * Rn + LANE_MEM];
    if (!alive[kn] || a_cpu <= 0 || a_mem <= 0) continue;
    const long long u_cpu = requested[kn * Rn + LANE_CPU], u_mem = requested[kn * Rn + LANE_MEM];
    util += (u_cpu * DENSITY_SCALE / a_cpu + u_mem * DENSITY_SCALE / a_mem) / 2;
    counted += 1;
  }
  placed = block_sum(placed, s_warp);
  left = block_sum(left, s_warp);
  for (int r = 0; r < ND; ++r) rc[r] = block_sum(rc[r], s_warp);
  util = block_sum(util, s_warp);
  counted = block_sum(counted, s_warp);
  if (threadIdx.x == 0) {
    admitted[k] = placed;
    unsched[k] = left;
    for (int r = 0; r < ND; ++r) reasons[(long long)k * ND + r] = rc[r];
    density[k] = util / (counted > 0 ? counted : 1);
  }
}

}  // namespace

namespace {

bool aligned(const void* p, unsigned bytes) { return (reinterpret_cast<unsigned long long>(p) % bytes) == 0; }

// The plane of [N, width] (width > 1) or of `rows` rows of N (width 0).
Plane plane(const int* src, int* dst, int N, int width, int rows, int fill, const unsigned char* alive) {
  Plane p{src, dst, width ? N * width : rows * N, width, fill, 0};
  const bool fits = width ? width % 4 == 0 : (N % 4 == 0 && aligned(alive, 4));
  p.vec = fits && aligned(src, 16) && aligned(dst, 16);
  return p;
}

}  // namespace

// Enqueues K15 on `stream` and returns the launch status.  vrank and
// out_vrank may be null (no visit-rank plane).
extern "C" int ktpu_fork_view(const int* labels, const int* tkey, const int* tval, const int* teff, const int* vrank,
                              const int* dom, const unsigned char* alive, int* out_labels, int* out_tkey,
                              int* out_tval, int* out_teff, int* out_vrank, int* out_dom, int KF, int N, int L, int T,
                              void* stream) {
  if ((long long)N * (L > T ? L : T) >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Planes ps{};
  int n = 0, widest = 0;
  auto add = [&](const Plane& p) {
    if (p.cells == 0) return;
    ps.p[n++] = p;
    const int units = p.vec ? p.cells >> 2 : p.cells;
    if (units > widest) widest = units;
  };
  // a node-major plane [N, W]: one row of N when W is 1, none when W is 0
  auto node_major = [&](const int* src, int* dst, int W, int fill) {
    return plane(src, dst, N, W == 1 ? 0 : W, W == 1 ? 1 : 0, fill, alive);
  };
  add(node_major(labels, out_labels, L, ABSENT));
  add(node_major(tkey, out_tkey, T, PAD));
  add(node_major(tval, out_tval, T, PAD));
  add(node_major(teff, out_teff, T, PAD));
  add(plane(dom, out_dom, N, 0, L, -1, alive));
  if (vrank != nullptr) add(plane(vrank, out_vrank, N, 0, 1, -1, alive));
  if (n == 0 || KF == 0) return 0;
  const dim3 grid((widest + VIEW_THREADS - 1) / VIEW_THREADS, n, (KF + FORK_CHUNK - 1) / FORK_CHUNK);
  fork_view_kernel<<<grid, VIEW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(ps, alive, KF, N);
  return (int)cudaGetLastError();
}

// Enqueues K16 on `stream` and returns the launch status (ND <= 16).
extern "C" int ktpu_fork_summary(const int* chosen, const long long* reason_counts, const int* requested,
                                 const int* alloc, const unsigned char* alive, const unsigned char* valid,
                                 const unsigned char* pod_live, long long* admitted, long long* unsched,
                                 long long* reasons,
                                 long long* density, int KF, int P, int N, int Rn, int ND, void* stream) {
  if (KF == 0) return 0;
  if (ND > MAX_ND || Rn <= LANE_MEM) return (int)cudaErrorInvalidValue;
  fork_summary_kernel<<<KF, SUM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      chosen, reason_counts, requested, alloc, alive, valid, pod_live, admitted, unsched, reasons, density, P, N, Rn,
      ND);
  return (int)cudaGetLastError();
}
