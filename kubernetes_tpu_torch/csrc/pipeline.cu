// K18 pipeline_score: the independent pipeline's scores and selection, one
// launch per batch.
//
// Replaces the score half of the JAX root kubernetes_tpu/ops/pipeline.py:52
// _pipeline: S.all_scores (ops/scores.py:369) over each pod's feasible set,
// then the first-max argmax (:78-85).  Its feasible mask is K17's combined
// row and its raw planes are the gang precompute's (K1, K6, K7); per pod p
// and node n, with every normalization taken over p's feasible nodes:
//
//   TaintToleration   100 - 100 raw / max (100 where the max is 0)
//   NodeAffinity      100 raw / max (raw where the max is 0)
//   PodTopologySpread normalize_spread of the soft constraints' 32.32 sum
//                     of count x log(topology size + 2) + (maxSkew - 1),
//                     rounded half to even; the size is the counted nodes
//                     (feasible, every soft key present) for a hostname
//                     key, else their distinct domains; only counted nodes
//                     are valid
//   InterPodAffinity  100 (raw - min) / (max - min), raw the symmetric
//                     score plus the preferred terms' domain counts
//   NodeResourcesFit, BalancedAllocation, ImageLocality as K1 / K5 compute
//                     them (step::score_total), against the snapshot usage
//
// weighted and summed in int64 (every division a floor division), written
// as `totals` (0 where infeasible), with the feasible count and the first
// node of the highest total (-1 when none is feasible).  No nomination
// charge, no extra score: _pipeline has neither.
//
// Design: one block per pod, three passes over the nodes.  The first
// counts the feasible and counted nodes and takes the taint / node-affinity
// maxima and the inter-pod min / max (block_reduce), and stamps each
// counted node's compact domain per spread constraint in the pod's `seen`
// row (one atomicExch per node and constraint; the first stamp of a domain
// counts it).  The second computes the spread raw per feasible node (kept
// in the node's `totals` slot, which the same thread overwrites in the
// third pass) and its min / max over the valid nodes.  The third sums the
// weighted scores and reduces the first-max argmax.  Bound on the H100:
// bytes (the int64 [P, N] planes are read once and the totals written
// once).
#include "ktpu.cuh"

// Pointers first, then ints: the layout ops/_build.py PipelineArgs
// reproduces.
struct PipelineArgs {
  const unsigned char* feasible;   // [P, N] K17's combined mask
  const int* allocatable;          // [N, Rn]
  const int* requested;            // [N, Rn]
  const int* nonzero;              // [N, 2] the non-zero-defaulted usage
  const long long* log_tab;        // [L] 32.32 log(i + 2)
  const int* requests;             // [P, Rp]
  const int* nonzero_req;          // [P, 2]
  const int* max_skew;             // [P, C]
  const long long* sc_taint;       // [P, N] raw PreferNoSchedule counts
  const long long* sc_nodeaff;     // [P, N] raw preferred node affinity
  const long long* sc_image;       // [P, N] ImageLocality
  const unsigned char* sp_soft;    // [P, C]
  const unsigned char* sp_is_host; // [P, C]
  const unsigned char* sp_all_keys;  // [P, N]
  const int* sp_cdv;               // [P, C, N] compact domain ids (< D; < 0 host / absent)
  const int* sp_node_cnt;          // [P, C, N]
  const int* sp_sc_dom;            // [P, C, N]
  const long long* ip_sym;         // [P, N]
  const int* ip_dv;                // [P, AT, N]
  const int* ip_dom_cnt;           // [P, AT, N]
  const long long* ip_pref_w;      // [P, AT]
  int* seen;                       // [P, C, D] scratch, zero on entry
  long long* totals;               // [P, N] out
  long long* n_feasible;           // [P] out
  int* chosen;                     // [P] out
  int N, P, Rn, Rp, C, AT, L, D;
  int w_taint, w_naff, w_spread, w_ip, w_fit, w_bal, w_img;
};

namespace {

using namespace ktpu;
using namespace ktpu::step;

constexpr int PIPE_THREADS = 256;

__device__ __forceinline__ long long ip_raw_at(const PipelineArgs& a, int p, int n) {
  const long long pn = (long long)p * a.N + n;
  long long raw = a.ip_sym[pn];
  for (int u = 0; u < a.AT; ++u) {
    const long long pu = (long long)p * a.AT + u;
    const long long o = pu * a.N + n;
    if (a.ip_dv[o] >= 0) raw += (long long)a.ip_dom_cnt[o] * a.ip_pref_w[pu];
  }
  return raw;
}

__global__ void __launch_bounds__(PIPE_THREADS) pipeline_kernel(const PipelineArgs a) {
  extern __shared__ long long s_dyn[];  // s_wfx [C] (int64), then s_ndom [C] (int)
  __shared__ long long s_buf[32 * 8];
  __shared__ long long s_best_v[32];
  __shared__ int s_best_i[32];
  long long* s_wfx = s_dyn;
  int* s_ndom = reinterpret_cast<int*>(s_dyn + a.C);
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = a.N, C = a.C;
  for (int c = tid; c < C; c += blockDim.x) s_ndom[c] = 0;
  bool has_soft = false;
  for (int c = 0; c < C; ++c) has_soft = has_soft || a.sp_soft[(long long)p * C + c];
  __syncthreads();

  // ---- pass 1: counts, the default normalizers' maxima, the inter-pod
  // min / max, the counted nodes' distinct domains per constraint
  // 0 n_feas, 1 taint max, 2 naff max, 3 ip min, 4 ip max, 5 counted nodes
  long long red[6] = {0, 0, 0, I64_MAX, -I64_MAX - 1, 0};
  const int red_op[6] = {RED_SUM, RED_MAX, RED_MAX, RED_MIN, RED_MAX, RED_SUM};
  for (int n = tid; n < N; n += blockDim.x) {
    const long long pn = (long long)p * N + n;
    if (!a.feasible[pn]) continue;
    red[0] += 1;
    if (a.sc_taint[pn] > red[1]) red[1] = a.sc_taint[pn];
    if (a.sc_nodeaff[pn] > red[2]) red[2] = a.sc_nodeaff[pn];
    const long long ip = ip_raw_at(a, p, n);
    if (ip < red[3]) red[3] = ip;
    if (ip > red[4]) red[4] = ip;
    if (!a.sp_all_keys[pn]) continue;
    red[5] += 1;
    for (int c = 0; c < C; ++c) {
      const long long pc = (long long)p * C + c;
      const int d = a.sp_cdv[pc * N + n];
      if (a.sp_is_host[pc] || d < 0 || d >= a.D) continue;
      if (atomicExch(a.seen + pc * a.D + d, 1) == 0) atomicAdd(s_ndom + c, 1);
    }
  }
  block_reduce(red, red_op, 6, s_buf);
  const long long n_feas = red[0], taint_mx = red[1], naff_mx = red[2], ip_mn = red[3], ip_mx = red[4];

  // ---- pass 2: the spread raws and their min / max over the valid nodes
  long long sp_mn = I64_MAX, sp_mx = -I64_MAX, n_use = 0;
  if (C && a.w_spread) {
    for (int c = tid; c < C; c += blockDim.x) {
      const long long size = a.sp_is_host[(long long)p * C + c] ? red[5] : s_ndom[c];
      s_wfx[c] = a.log_tab[size < 0 ? 0 : (size >= a.L ? a.L - 1 : size)];
    }
    __syncthreads();
    long long v[3] = {I64_MAX, -I64_MAX - 1, 0};
    const int op[3] = {RED_MIN, RED_MAX, RED_SUM};
    for (int n = tid; n < N; n += blockDim.x) {
      const long long pn = (long long)p * N + n;
      if (!a.feasible[pn]) continue;
      long long raw = 0;
      bool use = true;
      if (has_soft) {
        use = a.sp_all_keys[pn];  // valid & feasible: the counted nodes
        long long total_fx = 0;
        for (int c = 0; c < C; ++c) {
          const long long pc = (long long)p * C + c;
          if (!a.sp_soft[pc]) continue;
          const long long o = pc * N + n;
          const long long cnt = a.sp_is_host[pc] ? a.sp_node_cnt[o] : a.sp_sc_dom[o];
          total_fx += cnt * s_wfx[c] + (long long)(a.max_skew[pc] - 1) * (1LL << FX);
        }
        const long long q = total_fx >> FX;  // arithmetic shift
        const long long frac = total_fx & ((1LL << FX) - 1);
        const long long half = 1LL << (FX - 1);
        raw = q + ((frac > half || (frac == half && (q & 1))) ? 1 : 0);
      }
      a.totals[pn] = raw;  // this thread's node: read back in pass 3
      if (use) {
        if (raw < v[0]) v[0] = raw;
        if (raw > v[1]) v[1] = raw;
        v[2] += 1;
      }
    }
    block_reduce(v, op, 3, s_buf);
    sp_mn = v[0];
    sp_mx = v[1];
    n_use = v[2];
  }

  // ---- pass 3: the weighted total and the first-max argmax
  const int* req = a.requests + (long long)p * a.Rp;
  long long best = -I64_MAX - 1;
  int best_n = I32_MAX;
  for (int n = tid; n < N; n += blockDim.x) {
    const long long pn = (long long)p * N + n;
    if (!a.feasible[pn]) {
      a.totals[pn] = 0;
      continue;
    }
    long long total = 0;
    if (a.w_taint) {
      const long long raw = a.sc_taint[pn];
      total += a.w_taint * (taint_mx > 0 ? MAX_NODE_SCORE - fdiv(MAX_NODE_SCORE * raw, taint_mx) : MAX_NODE_SCORE);
    }
    if (a.w_naff) {
      const long long raw = a.sc_nodeaff[pn];
      total += a.w_naff * (naff_mx > 0 ? fdiv(MAX_NODE_SCORE * raw, naff_mx) : raw);
    }
    if (a.w_spread) {
      long long s = MAX_NODE_SCORE;  // C == 0: every feasible node valid, max 0
      if (C) {
        const bool use = !has_soft || a.sp_all_keys[pn];
        s = 0;
        if (use && n_use > 0)
          s = sp_mx == 0 ? MAX_NODE_SCORE
                         : fdiv(MAX_NODE_SCORE * (sp_mx + sp_mn - a.totals[pn]), sp_mx > 1 ? sp_mx : 1);
      }
      total += a.w_spread * s;
    }
    if (a.w_ip) {
      const long long diff = ip_mx - ip_mn;
      total += a.w_ip * (diff > 0 ? fdiv(MAX_NODE_SCORE * (ip_raw_at(a, p, n) - ip_mn), diff) : 0);
    }
    if (a.w_fit || a.w_bal) {
      const long long a0 = a.allocatable[(long long)n * a.Rn + LANE_CPU];
      const long long a1 = a.allocatable[(long long)n * a.Rn + LANE_MEM];
      total += score_total(a0, a1, (long long)a.nonzero[2 * n] + a.nonzero_req[2 * p],
                           (long long)a.nonzero[2 * n + 1] + a.nonzero_req[2 * p + 1],
                           (long long)a.requested[(long long)n * a.Rn + LANE_CPU] + req[LANE_CPU],
                           (long long)a.requested[(long long)n * a.Rn + LANE_MEM] + req[LANE_MEM], 0, a.w_fit,
                           a.w_bal, 0);
    }
    if (a.w_img) total += a.w_img * a.sc_image[pn];
    a.totals[pn] = total;
    if (total > best) {  // ascending n: strict > keeps the first max
      best = total;
      best_n = n;
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const long long ov = __shfl_down_sync(FULL_MASK, best, off);
    const int oi = __shfl_down_sync(FULL_MASK, best_n, off);
    better(best, best_n, ov, oi);
  }
  if (lane == 0) {
    s_best_v[warp] = best;
    s_best_i[warp] = best_n;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    best = lane < n_warps ? s_best_v[lane] : -I64_MAX - 1;
    best_n = lane < n_warps ? s_best_i[lane] : I32_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const long long ov = __shfl_down_sync(FULL_MASK, best, off);
      const int oi = __shfl_down_sync(FULL_MASK, best_n, off);
      better(best, best_n, ov, oi);
    }
    if (lane == 0) {
      a.chosen[p] = n_feas > 0 ? best_n : ABSENT;
      a.n_feasible[p] = n_feas;
    }
  }
}

}  // namespace

// Enqueues K18 on `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_pipeline_score(const PipelineArgs* args, void* stream) {
  if (args->P == 0 || args->N == 0) return 0;
  const size_t smem = (sizeof(long long) + sizeof(int)) * (args->C > 0 ? args->C : 1);
  pipeline_kernel<<<args->P, PIPE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
