// K6 gang_spread_statics and K7 gang_interpod_statics: the state-
// independent halves of the gang precompute.
//
// Replace the spread and inter-pod halves of the JAX root
// kubernetes_tpu/ops/gang.py:268 precompute (XLA: spread_precompute's
// [P, C, E] selector match, per_node_counts' segment sums, two
// domain_stats passes over the whole label-value vocabulary,
// interpod_precompute's [M, P] / [P, AT, E] matches and the int32
// [P, M] x [M, N] dot_general of interpod_weighted_ext, and the pod x pod
// and pod x node host-port compares).
//
// K6, one block per (pod, constraint) pair:
//   1. every placed pod is matched against the constraint's selector
//      (same namespace, valid, not deleting); matches count straight into
//      the per-node row sp_node_cnt with atomics (no [P, C, E] tensor);
//   2. each node folds its count into per-DOMAIN sums under the compact
//      per-key domain ids (DeviceCluster.dom_ids), in a scratch row of the
//      block: the tracked-and-eligible total and presence (the filter's
//      domain_stats) and the all-keys-and-eligible total (the score's);
//   3. each node reads its domain's sums back; the block counts the present
//      domains (sp_ndom); the constraint's own match (sp_self) and the
//      batch-peer matches (sp_bmatch) close the block.
// K7, one block per pod for the existing terms, one per (pod, term) for
// the pod's own terms, one thread per (pod, node) / (pod, peer) for ports:
//   * existing terms: interpod_weighted_ext factored by (topology key,
//     domain): each placed term that matches the pod adds its weights to
//     the (key, domain of its pod's node) cell, and each node sums the
//     cells of its own domains -- O(M + N * K) per pod, exact int32;
//   * the pod's terms: placed pods matching term u count into per-domain
//     sums (ip_dom_cnt), plus the any-match flag, the self match and the
//     batch-peer matches (ip_bmatch);
//   * host ports: d_ports [P, N] against the nodes' used ports, port_b
//     [P, P] between the batch's pods.
//
// Bound on the H100: operations.  The selector evaluations (P x C x E for
// K6, P x (M + AT x E) for K7) are tens of integer compares each over
// small tables that stay in L1; the bytes are the outputs ([P, C, N]
// rows) and one read of the placed pods' label rows per block (from L2).
//
// Semantics are those of the plain versions in kubernetes_tpu_torch/ops/
// gang.py precompute_plain (ops/filters.py, ops/scores.py, ops/common.py
// domain_stats), which the chip check holds these kernels to exactly.  All
// arithmetic is integer; the int32 sums wrap as the reference's int32 dot
// does.
#include "ktpu.cuh"

using namespace ktpu;

namespace {

constexpr int STAT_THREADS = 256;
constexpr int PORT_THREADS = 256;
constexpr int TERM_REQUIRED_AFFINITY = 0;
constexpr int TERM_REQUIRED_ANTI = 1;
constexpr int TERM_PREFERRED_AFFINITY = 2;
constexpr int TERM_PREFERRED_ANTI = 3;

__device__ __forceinline__ int block_sum(int v, int* s_red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? s_red[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_red[0] = v;
  }
  __syncthreads();
  const int out = s_red[0];
  __syncthreads();
  return out;
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(STAT_THREADS) spread_kernel(const GangSpreadArgs a) {
  __shared__ int s_red[32];
  const int pc = blockIdx.x;  // p * C + c
  const int p = pc / a.C;
  const int c = pc % a.C;
  const int N = a.N, K = a.K;
  const int key = a.tsc_topo[pc];
  const bool kvalid = key >= 0 && key < K;
  const int D = kvalid ? a.dom_counts[key] : 0;
  const int* dom = kvalid ? a.dom_ids + (long long)key * N : nullptr;
  int* te_tot = a.acc + (long long)pc * 3 * a.D;
  int* te_pres = te_tot + a.D;
  int* sc_tot = te_pres + a.D;
  int* node_cnt = a.sp_node_cnt + (long long)pc * N;
  const CTable tab{a.tsc_key, a.tsc_op, a.tsc_vals, a.tsc_rhs, a.tsc_tv, a.R, a.V};

  for (int d = threadIdx.x; d < D; d += blockDim.x) te_tot[d] = te_pres[d] = sc_tot[d] = 0;
  for (int n = threadIdx.x; n < N; n += blockDim.x) node_cnt[n] = 0;
  __syncthreads();

  // 1. placed pods matching the constraint's selector, per node
  if (a.tsc_tv[pc]) {
    const int ns = a.ns_id[p];
    for (int e = threadIdx.x; e < a.E; e += blockDim.x) {
      if (!a.epod_valid[e] || a.epod_deleting[e] || a.epod_ns[e] != ns) continue;
      const int node = a.epod_node[e];
      if (node < 0 || node >= N) continue;
      if (eval_row(tab, pc, a.epod_labels + (long long)e * K, K, a.val_ints, a.NVI))
        atomicAdd(node_cnt + node, 1);
    }
  }
  __syncthreads();

  // 2. per-node eligibility, folded into the per-domain sums
  const bool honor_aff = a.honor_aff[pc], honor_taints = a.honor_taints[pc];
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    bool tracked = true, all_keys = true;
    for (int c2 = 0; c2 < a.C; ++c2) {
      const int k2 = a.tsc_topo[p * a.C + c2];
      if (k2 == PAD) continue;  // no constraint in this slot
      const bool present = k2 >= 0 && k2 < K && a.node_labels[(long long)n * K + k2] >= 0;
      if (a.tsc_hard[p * a.C + c2]) tracked = tracked && present;
      else all_keys = all_keys && present;
    }
    const long long pn = (long long)p * N + n;
    const bool eligible = (!honor_aff || a.naff[pn]) && (!honor_taints || a.taints[pn]);
    const bool te = tracked && eligible;
    const bool counting = all_keys && eligible;
    const long long o = (long long)pc * N + n;
    const int dv = kvalid ? a.node_labels[(long long)n * K + key] : ABSENT;
    a.sp_dv[o] = dv;
    a.sp_te[o] = te;
    a.sp_counting[o] = counting;
    if (c == 0) a.sp_all_keys[pn] = all_keys;
    const int d = kvalid ? dom[n] : -1;
    if (d >= 0) {
      const int cnt = node_cnt[n];
      if (te) {
        atomicAdd(te_tot + d, cnt);
        te_pres[d] = 1;
      }
      if (counting) atomicAdd(sc_tot + d, cnt);
    }
  }
  __syncthreads();

  // 3. per-node reads of the domain sums; the present-domain count
  int present = 0;
  for (int d = threadIdx.x; d < D; d += blockDim.x) present += te_pres[d] ? 1 : 0;
  present = block_sum(present, s_red);
  const bool spread_key = kvalid && key != a.hostname_key;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const long long o = (long long)pc * N + n;
    const int d = kvalid ? dom[n] : -1;
    const bool pres = d >= 0 && te_pres[d];
    a.sp_dom_pres[o] = pres;
    a.sp_dom_cnt[o] = pres ? te_tot[d] : 0;
    a.sp_sc_dom[o] = d >= 0 ? sc_tot[d] : 0;
    a.sp_cdv[o] = spread_key ? d : -1;
  }
  if (threadIdx.x == 0) {
    a.sp_ndom[pc] = present;
    a.sp_self[pc] = eval_row(tab, pc, a.labels + (long long)p * K, K, a.val_ints, a.NVI);
  }
  const int ns = a.ns_id[p];
  for (int j = threadIdx.x; j < a.P; j += blockDim.x)
    a.sp_bmatch[(long long)pc * a.P + j] =
        a.valid[j] && a.ns_id[j] == ns &&
        eval_row(tab, pc, a.labels + (long long)j * K, K, a.val_ints, a.NVI);
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

// interpod_symmetric_score's per-kind weight of a placed term (scoring.go)
__device__ __forceinline__ int sym_weight(int kind, int weight, int hard) {
  if (kind == TERM_REQUIRED_AFFINITY) return hard;
  if (kind == TERM_PREFERRED_AFFINITY) return weight;
  if (kind == TERM_PREFERRED_ANTI) return -weight;
  return 0;
}

// One block per pod: the placed pods' terms against the pod.
__global__ void __launch_bounds__(STAT_THREADS) ext_kernel(const GangInterpodArgs a) {
  const int p = blockIdx.x;
  const int N = a.N, K = a.K;
  int* s_anti = a.ext_acc + (long long)p * 2 * a.DSUM;
  int* s_sym = s_anti + a.DSUM;
  for (int i = threadIdx.x; i < 2 * a.DSUM; i += blockDim.x) s_anti[i] = 0;
  __syncthreads();
  const CTable tab{a.tt_key, a.tt_op, a.tt_vals, a.tt_rhs, a.tt_tv, a.TR, a.TV};
  const int* plabels = a.labels + (long long)p * K;
  const int ns = a.ns_id[p];
  for (int m = threadIdx.x; m < a.M; m += blockDim.x) {
    const int kind = a.term_kind[m];
    const int anti = kind == TERM_REQUIRED_ANTI ? 1 : 0;
    const int w = sym_weight(kind, a.term_weight[m], a.hard_weight);
    if (!anti && !w) continue;
    const int tp = a.term_pod[m];
    if (tp < 0 || !a.epod_valid[min(tp, a.E - 1)]) continue;
    const int key = a.term_topo[m];
    if (key < 0 || key >= K) continue;
    const int node = a.epod_node[min(tp, a.E - 1)];
    if (node < 0) continue;
    const int d = a.dom_ids[(long long)key * N + min(node, N - 1)];
    if (d < 0) continue;  // the term's pod's node lacks the topology label
    if (!ns_member(a.term_ns_all[m], a.term_ns_ids + (long long)m * a.TNS, a.TNS, ns)) continue;
    if (!eval_row(tab, m, plabels, K, a.val_ints, a.NVI)) continue;
    const int cell = a.dom_off[key] + d;
    if (anti) atomicAdd(s_anti + cell, 1);
    if (w) atomicAdd(s_sym + cell, w);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    int viol = 0, sym = 0;  // int32 sums, wrapping as the reference's dot
    for (int k = 0; k < K; ++k) {
      if (a.dom_counts[k] == 0) continue;
      const int d = a.dom_ids[(long long)k * N + n];
      if (d < 0) continue;
      viol += s_anti[a.dom_off[k] + d];
      sym += s_sym[a.dom_off[k] + d];
    }
    const long long pn = (long long)p * N + n;
    a.ip_viol_existing[pn] = viol > 0;
    a.ip_sym[pn] = sym;
  }
}

// One block per (pod, term): placed pods against the pod's own term.
__global__ void __launch_bounds__(STAT_THREADS) inc_kernel(const GangInterpodArgs a) {
  __shared__ int s_any;
  const int pu = blockIdx.x;  // p * AT + u
  const int p = pu / a.AT;
  const int N = a.N, K = a.K;
  const int key = a.aff_topo[pu];
  const bool kvalid = key >= 0 && key < K;
  const int D = kvalid ? a.dom_counts[key] : 0;
  const int* dom = kvalid ? a.dom_ids + (long long)key * N : nullptr;
  int* acc = a.inc_acc + (long long)pu * a.D;
  const CTable tab{a.aff_key, a.aff_op, a.aff_vals, a.aff_rhs, a.aff_tv, a.AR, a.AV};
  const unsigned char ns_all = a.aff_ns_all[pu];
  const int* ns_ids = a.aff_ns_ids + (long long)pu * a.NS;
  if (threadIdx.x == 0) s_any = 0;
  for (int d = threadIdx.x; d < D; d += blockDim.x) acc[d] = 0;
  __syncthreads();
  if (a.aff_tv[pu]) {
    int any = 0;
    for (int e = threadIdx.x; e < a.E; e += blockDim.x) {
      if (!a.epod_valid[e] || !ns_member(ns_all, ns_ids, a.NS, a.epod_ns[e])) continue;
      if (!eval_row(tab, pu, a.epod_labels + (long long)e * K, K, a.val_ints, a.NVI)) continue;
      any = 1;
      const int node = a.epod_node[e];
      if (kvalid && node >= 0 && node < N) {
        const int d = dom[node];
        if (d >= 0) atomicAdd(acc + d, 1);
      }
    }
    if (any) s_any = 1;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const long long o = (long long)pu * N + n;
    const int d = kvalid ? dom[n] : -1;
    a.ip_dv[o] = kvalid ? a.node_labels[(long long)n * K + key] : ABSENT;
    a.ip_dom_cnt[o] = d >= 0 ? acc[d] : 0;
  }
  if (threadIdx.x == 0) {
    a.inc_any[pu] = s_any;
    a.self_ok[pu] = ns_member(ns_all, ns_ids, a.NS, a.ns_id[p]) &&
                    eval_row(tab, pu, a.labels + (long long)p * K, K, a.val_ints, a.NVI);
  }
  for (int j = threadIdx.x; j < a.P; j += blockDim.x)
    a.ip_bmatch[(long long)pu * a.P + j] =
        a.valid[j] && ns_member(ns_all, ns_ids, a.NS, a.ns_id[j]) &&
        eval_row(tab, pu, a.labels + (long long)j * K, K, a.val_ints, a.NVI);
}

// Does any wanted port of `w` conflict with any used port of `u` (node_ports.go)
__device__ __forceinline__ bool ports_conflict(const int* wk, const int* wi,
                                               const unsigned char* ww, int W,
                                               const int* uk, const int* ui,
                                               const unsigned char* uw, int U) {
  for (int x = 0; x < W; ++x) {
    if (wk[x] == PAD) continue;
    for (int y = 0; y < U; ++y)
      if (uk[y] != PAD && wk[x] == uk[y] && (wi[x] == ui[y] || ww[x] || uw[y])) return true;
  }
  return false;
}

// One thread per (pod, node) and per (pod, peer).
__global__ void __launch_bounds__(PORT_THREADS) port_kernel(const GangInterpodArgs a) {
  const long long idx = (long long)blockIdx.x * PORT_THREADS + threadIdx.x;
  const long long pn = (long long)a.P * a.N;
  if (idx < pn) {
    const int p = (int)(idx / a.N), n = (int)(idx % a.N);
    const long long w0 = (long long)p * a.W, u0 = (long long)n * a.U;
    a.d_ports[idx] = !ports_conflict(a.want_ppk + w0, a.want_ip + w0, a.want_wild + w0, a.W,
                                     a.used_ppk + u0, a.used_ip + u0, a.used_wild + u0, a.U);
  } else if (idx < pn + (long long)a.P * a.P) {
    const long long k = idx - pn;
    const int p = (int)(k / a.P), j = (int)(k % a.P);
    const long long w0 = (long long)p * a.W, j0 = (long long)j * a.W;
    a.port_b[k] = ports_conflict(a.want_ppk + w0, a.want_ip + w0, a.want_wild + w0, a.W,
                                 a.want_ppk + j0, a.want_ip + j0, a.want_wild + j0, a.W);
  }
}

}  // namespace

// Enqueue K6 on `stream`; returns the launch status (cudaGetLastError).
extern "C" int ktpu_gang_spread_statics(const GangSpreadArgs* args, void* stream) {
  const GangSpreadArgs a = *args;
  if ((long long)a.P * a.C == 0) return 0;
  spread_kernel<<<a.P * a.C, STAT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Enqueue K7 on `stream`: the inter-pod blocks when do_interpod, the port
// masks when do_ports.  Returns the first failing launch's status.
extern "C" int ktpu_gang_interpod_statics(const GangInterpodArgs* args, void* stream) {
  const GangInterpodArgs a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.do_interpod && a.P > 0) {
    ext_kernel<<<a.P, STAT_THREADS, 0, st>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (a.AT > 0) {
      inc_kernel<<<a.P * a.AT, STAT_THREADS, 0, st>>>(a);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  if (a.do_ports) {
    const long long work = (long long)a.P * a.N + (long long)a.P * a.P;
    if (work > 0) {
      port_kernel<<<(unsigned)((work + PORT_THREADS - 1) / PORT_THREADS), PORT_THREADS, 0, st>>>(a);
      return (int)cudaGetLastError();
    }
  }
  return 0;
}
