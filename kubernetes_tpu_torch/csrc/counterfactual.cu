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
// that was never packed.  Design: one thread per output cell, grid-stride
// over the four planes in turn; a masked copy, so nothing is reused.
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
constexpr int SUM_THREADS = 256;
constexpr int MAX_ND = 16;
constexpr long long DENSITY_SCALE = 1000000;

__global__ void __launch_bounds__(VIEW_THREADS)
    fork_view_kernel(const int* __restrict__ labels, const int* __restrict__ tkey, const int* __restrict__ tval,
                     const int* __restrict__ teff, const int* __restrict__ vrank, const int* __restrict__ dom,
                     const unsigned char* __restrict__ alive, int* out_labels, int* out_tkey, int* out_tval,
                     int* out_teff, int* out_vrank, int* out_dom, int KF, int N, int L, int T) {
  const long long n_lab = (long long)KF * N * L;
  const long long n_taint = (long long)KF * N * T;
  const long long n_dom = (long long)KF * L * N;
  const long long n_vr = vrank != nullptr ? (long long)KF * N : 0;
  const long long total = n_lab + n_taint + n_dom + n_vr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    long long j = i;
    if (j < n_lab) {  // [k, n, l]
      const long long kn = j / L;
      const int n = (int)(kn % N);
      out_labels[j] = alive[kn] ? labels[(long long)n * L + j % L] : ABSENT;
      continue;
    }
    j -= n_lab;
    if (j < n_taint) {  // [k, n, t]
      const long long kn = j / T;
      const long long src = (kn % N) * T + j % T;
      const bool a = alive[kn];
      out_tkey[j] = a ? tkey[src] : PAD;
      out_tval[j] = a ? tval[src] : PAD;
      out_teff[j] = a ? teff[src] : PAD;
      continue;
    }
    j -= n_taint;
    if (j < n_dom) {  // [k, l, n]
      const int n = (int)(j % N);
      const long long kl = j / N;
      const long long k = kl / L;
      out_dom[j] = alive[k * N + n] ? dom[(kl % L) * N + n] : -1;
      continue;
    }
    j -= n_dom;  // [k, n]
    out_vrank[j] = alive[j] ? vrank[j % N] : -1;
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

// Enqueues K15 on `stream` and returns the launch status.  vrank and
// out_vrank may be null (no visit-rank plane).
extern "C" int ktpu_fork_view(const int* labels, const int* tkey, const int* tval, const int* teff, const int* vrank,
                              const int* dom, const unsigned char* alive, int* out_labels, int* out_tkey,
                              int* out_tval, int* out_teff, int* out_vrank, int* out_dom, int KF, int N, int L, int T,
                              void* stream) {
  const long long total = (long long)KF * N * (2LL * L + T + (vrank != nullptr ? 1 : 0));
  if (total == 0) return 0;
  long long blocks = (total + VIEW_THREADS - 1) / VIEW_THREADS;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  fork_view_kernel<<<(int)blocks, VIEW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      labels, tkey, tval, teff, vrank, dom, alive, out_labels, out_tkey, out_tval, out_teff, out_vrank, out_dom, KF,
      N, L, T);
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
