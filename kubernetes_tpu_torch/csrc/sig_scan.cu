// K2: the signature fast path's serial greedy commit, one launch per batch.
//
// Replaces the JAX root kubernetes_tpu/ops/fastpath.py:220 sig_scan (a
// lax.scan of make_sig_step, :117): for each pod of the batch in order —
// resource fit against the carried usage, int64 LeastAllocated +
// BalancedAllocation + ImageLocality score, first-max argmax over the
// feasible nodes, rank-1 commit of the pod's request to the chosen node.
//
// Design: the pods form a serial recurrence (pod p+1 sees pod p's commit),
// so the whole batch runs in ONE persistent block that loops over the P pod
// ids — not one launch per pod.  Per pod, each of the 1024 threads scores its
// strided slice of the N nodes, a warp-shuffle + shared-memory reduction
// finds the first max (ties go to the lower node index, exactly like
// jnp.argmax; no atomics, whose order is not deterministic), one thread
// applies the commit to used / nz0 / nz1 / num_pods in place, and a
// __syncthreads() publishes it to the whole block before the next pod.
//
// Bound on the H100: the recurrence.  The bytes (signature rows, allocatable
// and usage state, each read once) are a few MB; the integer work is ~40
// operations per (pod, node); but P dependent steps each pay a block-wide
// reduction and two barriers, and a single block uses one SM of 132.
//
// The feasibility and score formulas are ktpu.cuh's fits / score_total,
// shared with K4 (resident_run); integer arithmetic is int64 throughout.
#include <climits>

#include "ktpu.cuh"

using namespace ktpu;

namespace {

constexpr int SCAN_THREADS = 1024;  // 32 warps: one per reduction lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void better(long long& v, int& i, long long ov,
                                       int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(long long& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long ov = __shfl_down_sync(FULL, v, off);
    const int oi = __shfl_down_sync(FULL, i, off);
    better(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
    sig_scan_kernel(const SigScanArgs a) {
  __shared__ long long s_val[SCAN_THREADS / 32];
  __shared__ int s_idx[SCAN_THREADS / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = a.R;

  for (int p = 0; p < a.P; ++p) {
    const int s = a.ids[p];  // uniform across the block
    if (s < 0) {  // pad: no choice, no commit
      if (tid == 0) a.choices[p] = -1;
      continue;
    }
    const long long* req = a.sig_req + (long long)s * R;
    const long long snz0 = a.sig_nz[2 * s];
    const long long snz1 = a.sig_nz[2 * s + 1];
    const bool all_zero = a.sig_allzero[s];
    const unsigned char* ok = a.sig_ok + (long long)s * a.N;
    const long long* simg = a.sig_img + (long long)s * a.N;

    // infeasible nodes rank -1 and every feasible total is >= 0, so the
    // running best starts at -1 and only a feasible node can replace it
    long long best = -1;
    int best_n = INT_MAX;
    for (int n = tid; n < a.N; n += SCAN_THREADS) {
      if (!ok[n]) continue;
      const long long* al = a.alloc + (long long)n * R;
      const long long* us = a.used + (long long)n * R;
      if (a.check_fit &&
          !fits(req, all_zero, al, us, nullptr, a.num_pods[n], a.allowed[n], R))
        continue;
      const long long total = score_total(
          al[LANE_CPU], al[LANE_MEM], a.nz0[n] + snz0, a.nz1[n] + snz1,
          us[LANE_CPU] + req[LANE_CPU], us[LANE_MEM] + req[LANE_MEM],
          a.w_img ? simg[n] : 0, a.w_fit, a.w_bal, a.w_img);
      if (total > best) {  // ascending n: strict > keeps the first max
        best = total;
        best_n = n;
      }
    }

    warp_argmax(best, best_n);
    if (lane == 0) {
      s_val[warp] = best;
      s_idx[warp] = best_n;
    }
    __syncthreads();
    if (warp == 0) {
      best = s_val[lane];
      best_n = s_idx[lane];
      warp_argmax(best, best_n);
      if (lane == 0) {
        const int choice = best >= 0 ? best_n : -1;
        a.choices[p] = choice;
        if (choice >= 0) {
          long long* us = a.used + (long long)choice * R;
          for (int r = 0; r < R; ++r) us[r] += req[r];
          a.nz0[choice] += snz0;
          a.nz1[choice] += snz1;
          a.num_pods[choice] += 1;
        }
      }
    }
    __syncthreads();  // the commit is visible to every thread of the block
  }
}

}  // namespace

// Enqueues K2 on `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_sig_scan(const SigScanArgs* args, void* stream) {
  if (args->P == 0) return 0;
  sig_scan_kernel<<<1, SCAN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return (int)cudaGetLastError();
}
