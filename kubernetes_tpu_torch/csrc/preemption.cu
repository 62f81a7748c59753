// K10: preemption narrowing, the batched front of the PostFilter dry run.
//
// Replaces the JAX root kubernetes_tpu/ops/preemption.py:63
// narrow_candidates: for every pod of a batch that failed to schedule, the
// bool [P, N] mask of nodes worth dry-running.  A node survives for pod p
// when the four static filters pass (NodeName, NodeUnschedulable,
// TaintToleration, NodeAffinity: what no victim removal can fix), the node
// holds at least one victim of strictly lower priority, and p fits once
// every such victim is gone (pod count and every resource lane, no
// scalar-lane exemption).
//
// Design: the failed pods' distinct priorities form G groups, so the
// victim-removal state is per (group, node), not per (pod, node).
//   (a) preempt_kept_kernel: one thread per (group, placed-pod row) and per
//       (group, batch-peer row).  Integer atomicAdd builds kept_req
//       [G, N, R], kept_cnt [G, N] and victims [G, N]: placed pods of
//       priority >= the group's stay (kept), lower ones are victims; the
//       batch's own committed peers are charged asymmetrically (strictly
//       higher kept, equal ignored, strictly lower a victim: the reference's
//       docstring explains why).  Integer sums, so the result does not
//       depend on the order of the atomics.
//   (b) preempt_mask_kernel: one thread per (pod, node) ANDs the static
//       verdicts (ktpu.cuh static_filters, shared with K1) with its group's
//       victim / pod-count / resource planes.
// Pads: victim_node < 0, batch_node < 0 and groups equal to INT32_MIN are
// skipped.  A pad group has no victims in the reference either, so a pod
// pointing at one gets an all-false row both ways.
//
// Bound on the H100: bytes.  (a) reads each placed and peer row once per
// group (G · (E + B2) · (2 + R) ints) and writes G · N · (R + 2) ints;
// (b) reads the static tables per pair and writes P · N bool.
#include <climits>

#include "ktpu.cuh"

using namespace ktpu;

namespace {

constexpr int KEPT_THREADS = 256;
constexpr int MASK_THREADS = 256;

__global__ void __launch_bounds__(KEPT_THREADS) preempt_kept_kernel(const PreemptArgs a) {
  const long long rows = (long long)a.E + a.B2;
  const long long idx = (long long)blockIdx.x * KEPT_THREADS + threadIdx.x;
  if (idx >= (long long)a.G * rows) return;
  const int g = (int)(idx / rows);
  const long long row = idx % rows;
  const int thr = a.groups[g];
  if (thr == INT_MIN) return;  // pad group
  int node, prio;
  const int* req;
  bool keep, victim;
  if (row < a.E) {
    node = a.victim_node[row];
    prio = a.victim_prio[row];
    req = a.victim_req + row * a.R;
    victim = prio < thr;
    keep = !victim;
  } else {
    const long long b = row - a.E;
    node = a.batch_node[b];
    prio = a.batch_prio[b];
    req = a.batch_req + b * a.R;
    keep = prio > thr;
    victim = prio < thr;
  }
  if (node < 0 || node >= a.N) return;  // pad row
  const long long gn = (long long)g * a.N + node;
  if (victim) atomicAdd(a.victims + gn, 1);
  if (keep) {
    atomicAdd(a.kept_cnt + gn, 1);
    for (int r = 0; r < a.R; ++r) atomicAdd(a.kept_req + gn * a.R + r, req[r]);
  }
}

__global__ void __launch_bounds__(MASK_THREADS) preempt_mask_kernel(const StaticEvalArgs s, const PreemptArgs a) {
  const long long idx = (long long)blockIdx.x * MASK_THREADS + threadIdx.x;
  if (idx >= (long long)a.P * a.N) return;
  const int p = (int)(idx / a.N);
  const int n = (int)(idx % a.N);
  bool ok = s.node_valid[n] && s.valid[p];
  if (ok) {
    const StaticVerdict v = static_filters(s, p, n);
    ok = v.name && v.unsched && v.taints && v.affinity;
  }
  if (ok) {
    int g = a.pod_group[p];
    g = g < 0 ? 0 : (g >= a.G ? a.G - 1 : g);
    const long long gn = (long long)g * a.N + n;
    ok = a.victims[gn] > 0 && a.kept_cnt[gn] + 1 <= a.allowed_pods[n];
    if (ok) {
      const int* req = a.requests + (long long)p * a.Rp;
      bool all_zero = true, fits = true;
      for (int r = 0; r < a.R; ++r) {
        all_zero = all_zero && req[r] == 0;
        // int32 like the reference: allocatable minus the kept requests
        const int avail = a.allocatable[(long long)n * a.R + r] - a.kept_req[gn * a.R + r];
        fits = fits && req[r] <= avail;
      }
      ok = fits || all_zero;
    }
  }
  a.mask[idx] = ok;
}

}  // namespace

// Enqueues K10 on `stream`: zero the planes, (a), then (b).  Returns the
// launch status (cudaGetLastError).
extern "C" int ktpu_preempt_narrow(const StaticEvalArgs* static_args, const PreemptArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PreemptArgs a = *args;
  const long long gn = (long long)a.G * a.N;
  cudaMemsetAsync(a.kept_req, 0, gn * a.R * sizeof(int), st);
  cudaMemsetAsync(a.kept_cnt, 0, gn * sizeof(int), st);
  cudaMemsetAsync(a.victims, 0, gn * sizeof(int), st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long kept_threads = (long long)a.G * ((long long)a.E + a.B2);
  if (kept_threads > 0) {
    preempt_kept_kernel<<<(unsigned)((kept_threads + KEPT_THREADS - 1) / KEPT_THREADS), KEPT_THREADS, 0, st>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long pairs = (long long)a.P * a.N;
  if (pairs == 0) return 0;
  preempt_mask_kernel<<<(unsigned)((pairs + MASK_THREADS - 1) / MASK_THREADS), MASK_THREADS, 0, st>>>(
      *static_args, a);
  return (int)cudaGetLastError();
}
