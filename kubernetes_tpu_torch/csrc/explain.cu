// K17 explain_stack: the explain-mode masks, one launch per diagnosed batch.
//
// Replaces the JAX root kubernetes_tpu/ops/explain.py:67 explain_masks,
// the part after its gang precompute (:99-198; the precompute is K1, K6
// and K7): for each (pod, node) pair the pass/fail verdict of every Filter
// plugin on its own, judged against the snapshot with no in-batch peers
// and no nominations, in ops/gang.py DIAG_KERNELS row order, and their AND
// with the valid node slots and pod rows:
//
//   0..5  NodeUnschedulable, NodeName, TaintToleration, NodeAffinity,
//         NodePorts (the static conflicts), HostFilters: copied from the
//         precompute's d_* verdict planes
//   6     NodeResourcesFit against the snapshot's usage: the pod count,
//         then every lane (an extended lane only when requested) unless the
//         request is all zero
//   7     PodTopologySpread's hard constraints: per constraint the minimum
//         of sp_dom_cnt over the nodes where sp_te holds, zero when fewer
//         domains than minDomains exist, then the skew at each node
//   8     InterPodAffinity: no existing pod's anti-affinity, no matching
//         pod in an anti-affinity term's domain, every affinity term
//         matched in its domain or the first-pod escape (the pod matches
//         its own terms and no placed pod does) with every affinity
//         topology key present
//   9     the combined feasibility
//
// Design: one block per pod.  The block first reduces the spread minima
// (step::block_reduce, eight constraints per pass), then its threads walk
// the nodes and write the ten bytes of each, coalesced along the node
// axis.  Bound on the H100: bytes (the [P, N] planes and the [P, C, N] /
// [P, AT, N] statics are read once, the [10, P, N] output written once).
#include "ktpu.cuh"

// Pointers first, then ints: the layout ops/_build.py ExplainArgs
// reproduces.
struct ExplainArgs {
  const unsigned char* node_valid;  // [N]
  const int* num_pods;              // [N]
  const int* allowed_pods;          // [N]
  const int* allocatable;           // [N, Rn]
  const int* requested;             // [N, Rn]
  const unsigned char* valid;       // [P]
  const int* requests;              // [P, Rp]
  const unsigned char* d_unsched;   // [P, N] the precompute's verdict planes
  const unsigned char* d_nodename;
  const unsigned char* d_taints;
  const unsigned char* d_nodeaff;
  const unsigned char* d_ports;
  const unsigned char* d_extra;
  const unsigned char* sp_hard;      // [P, C]
  const int* sp_dv;                  // [P, C, N]
  const unsigned char* sp_te;        // [P, C, N]
  const int* sp_dom_cnt;             // [P, C, N]
  const unsigned char* sp_dom_pres;  // [P, C, N]
  const long long* sp_ndom;          // [P, C]
  const unsigned char* sp_self;      // [P, C]
  const int* min_domains;            // [P, C]
  const int* max_skew;               // [P, C]
  const unsigned char* ip_viol_existing;  // [P, N]
  const int* ip_dv;                       // [P, AT, N]
  const int* ip_dom_cnt;                  // [P, AT, N]
  const unsigned char* ip_is_aff;         // [P, AT]
  const unsigned char* ip_is_anti;        // [P, AT]
  const unsigned char* ip_any_static;     // [P]
  const unsigned char* ip_self_all;       // [P]
  unsigned char* out;                     // [10, P, N]
  int N, P, Rn, Rp, C, AT, check_fit;
};

namespace {

using namespace ktpu;
using namespace ktpu::step;

constexpr int EXPLAIN_THREADS = 256;

__global__ void __launch_bounds__(EXPLAIN_THREADS) explain_kernel(const ExplainArgs a) {
  extern __shared__ int s_min[];  // [C] the min-match per constraint
  __shared__ long long s_buf[32 * RED_CHUNK];
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = a.N, C = a.C, AT = a.AT;
  const long long PN = (long long)a.P * N;

  // ---- spread min-match (filtering.go:313), RED_CHUNK constraints a pass
  for (int c0 = 0; c0 < C; c0 += RED_CHUNK) {
    const int nc = C - c0 < RED_CHUNK ? C - c0 : RED_CHUNK;
    long long v[RED_CHUNK];
    int op[RED_CHUNK];
    for (int i = 0; i < RED_CHUNK; ++i) {
      v[i] = I32_MAX;
      op[i] = RED_MIN;
    }
    for (int n = tid; n < N; n += blockDim.x)
      for (int i = 0; i < nc; ++i) {
        const long long o = ((long long)p * C + c0 + i) * N + n;
        if (a.sp_te[o] && a.sp_dom_cnt[o] < v[i]) v[i] = a.sp_dom_cnt[o];
      }
    block_reduce(v, op, nc, s_buf);
    if (tid < nc) {
      const long long pc = (long long)p * C + c0 + tid;
      const int md = a.min_domains[pc];
      s_min[c0 + tid] = (md > 0 && a.sp_ndom[pc] < md) ? 0 : (int)v[tid];
    }
  }
  __syncthreads();

  // ---- per-pod constants
  const int* req = a.requests + (long long)p * a.Rp;
  bool all_zero = true;
  for (int r = 0; r < a.Rp; ++r) all_zero = all_zero && req[r] == 0;
  bool has_aff = false;
  for (int u = 0; u < AT; ++u) has_aff = has_aff || a.ip_is_aff[(long long)p * AT + u];
  const bool escape = has_aff && !a.ip_any_static[p] && a.ip_self_all[p];
  const bool pod_valid = a.valid[p] != 0;

  for (int n = tid; n < N; n += blockDim.x) {
    const long long pn = (long long)p * N + n;
    bool m_fit = true;
    if (a.check_fit) {
      m_fit = a.num_pods[n] + 1 <= a.allowed_pods[n];
      if (m_fit && !all_zero)
        for (int r = 0; r < a.Rp; ++r) {
          const int v = req[r];
          if (r >= N_FIXED_LANES && v <= 0) continue;  // an extended lane counts only when requested
          const int avail = r < a.Rn ? a.allocatable[(long long)n * a.Rn + r] - a.requested[(long long)n * a.Rn + r]
                                     : 0;
          if (v > avail) {
            m_fit = false;
            break;
          }
        }
    }
    bool m_spread = true;
    for (int c = 0; c < C; ++c) {
      const long long pc = (long long)p * C + c;
      if (!a.sp_hard[pc]) continue;
      const long long o = pc * N + n;
      const long long skew = (long long)a.sp_dom_cnt[o] + (a.sp_self[pc] ? 1 : 0) - s_min[c];
      if (!(a.sp_dv[o] >= 0 && (!a.sp_dom_pres[o] || skew <= a.max_skew[pc]))) {
        m_spread = false;
        break;
      }
    }
    bool m_interpod = !a.ip_viol_existing[pn];
    if (AT) {
      bool viol2 = false, aff_ok = true, topo_all = true;
      for (int u = 0; u < AT; ++u) {
        const long long pu = (long long)p * AT + u;
        const long long o = pu * N + n;
        const bool present = a.ip_dv[o] >= 0;
        const bool hit = present && a.ip_dom_cnt[o] > 0;
        if (a.ip_is_anti[pu] && hit) viol2 = true;
        if (a.ip_is_aff[pu]) {
          aff_ok = aff_ok && hit;
          topo_all = topo_all && present;
        }
      }
      m_interpod = m_interpod && !viol2 && (aff_ok || (escape && topo_all));
    }
    const bool rows[N_DIAG] = {a.d_unsched[pn] != 0, a.d_nodename[pn] != 0, a.d_taints[pn] != 0,
                               a.d_nodeaff[pn] != 0, a.d_ports[pn] != 0,   a.d_extra[pn] != 0,
                               m_fit,                m_spread,             m_interpod};
    bool all = pod_valid && a.node_valid[n];
    for (int r = 0; r < N_DIAG; ++r) {
      a.out[r * PN + pn] = rows[r];
      all = all && rows[r];
    }
    a.out[N_DIAG * PN + pn] = all;
  }
}

}  // namespace

// Enqueues K17 on `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_explain_stack(const ExplainArgs* args, void* stream) {
  if (args->P == 0 || args->N == 0) return 0;
  explain_kernel<<<args->P, EXPLAIN_THREADS, sizeof(int) * (args->C > 0 ? args->C : 1),
                   static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
