// Shared constants and argument blocks of the port's CUDA kernels.
//
// The sentinels and codes are the packed schema's (snapshot/interner.py,
// snapshot/selectors.py, snapshot/schema.py); the argument structs are
// mirrored field for field by ctypes.Structure classes in ops/_build.py, so
// any change here is made there too.
#pragma once

#include <cuda_runtime.h>

namespace ktpu {

constexpr int ABSENT = -1;
constexpr int PAD = -2;
constexpr int INT_INVALID = -2147483647;  // -(2**31) + 1

constexpr int OP_IN = 0;
constexpr int OP_NOT_IN = 1;
constexpr int OP_EXISTS = 2;
constexpr int OP_DOES_NOT_EXIST = 3;
constexpr int OP_GT = 4;

constexpr int OP_LT = 5;

constexpr int EFFECT_ALL = -1;
constexpr int EFFECT_NO_SCHEDULE = 0;
constexpr int EFFECT_PREFER_NO_SCHEDULE = 1;
constexpr int EFFECT_NO_EXECUTE = 2;
constexpr int TOL_OP_EXISTS = 1;

constexpr int LANE_CPU = 0;
constexpr int LANE_MEM = 1;
constexpr int N_FIXED_LANES = 3;

constexpr long long MAX_NODE_SCORE = 100;

// enabled-plugin bits of StaticEvalArgs::enabled
constexpr int EN_NODE_NAME = 1;
constexpr int EN_UNSCHEDULABLE = 2;
constexpr int EN_TAINTS = 4;
constexpr int EN_NODE_AFFINITY = 8;

// One conjunction (DNF term) against one label row: AND over its
// requirement slots, labels.Requirement.Matches semantics (the plain
// version is ops/common.py _eval_reqs).  `labels` is the row's [K] value
// ids; NotIn matches absent keys; Gt/Lt need both sides to parse as
// integers (every op code other than the five named ones acts as Lt, as
// the plain version's final where does); a PAD slot passes.  Shared by K1
// (node selectors over node rows) and K6/K7 (pod selectors over pod rows).
__device__ __forceinline__ bool eval_term(const int* key, const int* op,
                                          const int* vals, const int* rhs,
                                          int R, int V, const int* labels,
                                          int K, const int* val_ints,
                                          int NVI) {
  for (int r = 0; r < R; ++r) {
    const int o = op[r];
    if (o == PAD) continue;  // padded requirement slot passes
    const int k = key[r];
    const int val = (k >= 0 && k < K) ? labels[k] : ABSENT;
    const bool present = val >= 0;
    bool res;
    if (o == OP_IN || o == OP_NOT_IN) {
      bool in_any = false;
      if (present) {
        const int* vs = vals + r * V;
        for (int v = 0; v < V; ++v) {
          const int rv = vs[v];
          if (rv >= 0 && rv == val) {
            in_any = true;
            break;
          }
        }
      }
      res = (o == OP_IN) ? in_any : !in_any;  // NotIn matches absent keys
    } else if (o == OP_EXISTS) {
      res = present;
    } else if (o == OP_DOES_NOT_EXIST) {
      res = !present;
    } else {
      // Gt, and Lt for every other code: both sides must parse as integers
      int iv = INT_INVALID;
      if (present) iv = val_ints[min(max(val, 0), NVI - 1)];
      const int rh = rhs[r];
      const bool int_ok = iv != INT_INVALID && rh != INT_INVALID;
      res = int_ok && (o == OP_GT ? iv > rh : iv < rh);
    }
    if (!res) return false;
  }
  return true;
}

// A packed conjunction table [rows, R] / [rows, R, V] with its term_valid
// [rows]: row `t` against one label row, term_valid folded in.
struct CTable {
  const int* key;
  const int* op;
  const int* vals;
  const int* rhs;
  const unsigned char* tv;
  int R, V;
};

__device__ __forceinline__ bool eval_row(const CTable& t, long long row,
                                         const int* labels, int K,
                                         const int* val_ints, int NVI) {
  return t.tv[row] && eval_term(t.key + row * t.R, t.op + row * t.R,
                                t.vals + row * t.R * t.V, t.rhs + row * t.R,
                                t.R, t.V, labels, K, val_ints, NVI);
}

// Namespace-set membership (ops/common.py ns_member): the term selects all
// namespaces, or `ns` is one of its NS ids (negative ids are padding).
__device__ __forceinline__ bool ns_member(bool ns_all, const int* ns_ids,
                                          int NS, int ns) {
  if (ns_all) return true;
  for (int s = 0; s < NS; ++s)
    if (ns_ids[s] >= 0 && ns_ids[s] == ns) return true;
  return false;
}

// The fast path's integer feasibility and score, shared by K2 (sig_scan)
// and K4 (resident_run), as the reference shares _score_keys between
// _sig_node_keys, _upd_keys and make_sig_step.  All arithmetic is int64,
// and every division has a non-negative numerator (LeastAllocated masks
// c > a to 0 first; BalancedAllocation divides 50 * |d| + den - 1 by
// den >= 1), so C++ truncation equals the reference's floor division.

// NodeResourcesFit in integer form: the pod count, then every requested
// lane against allocatable minus used, where `extra` (a request row
// committed on top of `used`, or nullptr) is added to the usage.  An
// unrequested extended lane always fits; an all-zero request skips the
// lanes.
__device__ __forceinline__ bool fits(const long long* req, bool all_zero,
                                     const long long* alloc,
                                     const long long* used,
                                     const long long* extra, int num_pods,
                                     int allowed, int R) {
  if (num_pods + 1 > allowed) return false;
  if (all_zero) return true;
  for (int r = 0; r < R; ++r) {
    const long long v = req[r];
    if (r >= N_FIXED_LANES && v == 0) continue;  // unrequested scalar
    const long long u = used[r] + (extra ? extra[r] : 0);
    if (v > alloc[r] - u) return false;
  }
  return true;
}

// w_fit * LeastAllocated + w_bal * BalancedAllocation + w_img * img for one
// (pod, node) pair: a0/a1 cpu/mem allocatable, c0/c1 the non-zero request
// sums (node + pod), r0/r1 the UNCLAMPED used + request cpu/mem.
__device__ __forceinline__ long long score_total(long long a0, long long a1,
                                                 long long c0, long long c1,
                                                 long long r0, long long r1,
                                                 long long img, int w_fit,
                                                 int w_bal, int w_img) {
  long long total = 0;
  if (w_fit) {
    long long sum = 0;
    int w = 0;
    if (a0 > 0) {
      sum += c0 > a0 ? 0 : (a0 - c0) * MAX_NODE_SCORE / a0;
      ++w;
    }
    if (a1 > 0) {
      sum += c1 > a1 ? 0 : (a1 - c1) * MAX_NODE_SCORE / a1;
      ++w;
    }
    total += w_fit * (w ? sum / w : 0);
  }
  if (w_bal) {
    long long bal = MAX_NODE_SCORE;
    if (a0 > 0 && a1 > 0) {
      if (r0 > a0) r0 = a0;
      if (r1 > a1) r1 = a1;
      long long d = r0 * a1 - r1 * a0;
      if (d < 0) d = -d;
      const long long den = a0 * a1;
      bal = MAX_NODE_SCORE - (50 * d + den - 1) / den;
    }
    total += w_bal * bal;
  }
  if (w_img) total += w_img * img;
  return total;
}

// The seeded tie-break's bits (ops/rng.py): JAX's threefry2x32, 20 rounds
// with rotations (13, 15, 26, 6) / (17, 29, 16, 24) and a key injection
// every 4 rounds.  Under the reference's settings fold_in(k, d) is
// threefry2x32(k, (0, d)) and bits(k, N)[n] is x0 ^ x1 of
// threefry2x32(k, (0, n)).  Used by the shared step and by K19.
namespace rng {

__host__ __device__ __forceinline__ unsigned rotl(unsigned x, int r) { return (x << r) | (x >> (32 - r)); }

__host__ __device__ inline void threefry2x32(unsigned k0, unsigned k1, unsigned& x0, unsigned& x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
}

// bits(k, .)[n] as a non-negative int64
__host__ __device__ __forceinline__ long long bits_at(unsigned k0, unsigned k1, unsigned n) {
  unsigned x0 = 0, x1 = n;
  threefry2x32(k0, k1, x0, x1);
  return (long long)(x0 ^ x1);
}

// fold_in(k, d)
__host__ __device__ __forceinline__ void fold_in(unsigned& k0, unsigned& k1, unsigned d) {
  unsigned x0 = 0, x1 = d;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

}  // namespace rng

}  // namespace ktpu

// Pointers first, then ints: the layout ctypes reproduces.
struct StaticEvalArgs {
  // cluster
  const int* node_labels;         // [N, K]
  const int* val_ints;            // [NVI]
  const int* taint_key;           // [N, T]
  const int* taint_val;           // [N, T]
  const int* taint_eff;           // [N, T]
  const unsigned char* unsched;   // [N]
  const unsigned char* node_valid;  // [N]
  const long long* img_sizes;     // [N, IMG]
  // batch
  const unsigned char* valid;     // [S]
  const int* ns_key;              // [S, NT, NR]
  const int* ns_op;               // [S, NT, NR]
  const int* ns_vals;             // [S, NT, NR, NV]
  const int* ns_rhs;              // [S, NT, NR]
  const unsigned char* ns_tv;     // [S, NT]
  const int* pf_key;              // [S, PT, PR]
  const int* pf_op;               // [S, PT, PR]
  const int* pf_vals;             // [S, PT, PR, PV]
  const int* pf_rhs;              // [S, PT, PR]
  const unsigned char* pf_tv;     // [S, PT]
  const int* pf_weight;           // [S, PT]
  const int* tol_key;             // [S, TL]
  const int* tol_op;              // [S, TL]
  const int* tol_val;             // [S, TL]
  const int* tol_eff;             // [S, TL]
  const int* target_name;         // [S]
  const int* img_ids;             // [S, I]
  const int* n_containers;        // [S]
  long long* spread;              // [IMG] scratch: nodes holding each image
  // outputs [S, N]
  unsigned char* mask;
  unsigned char* m_nodename;
  unsigned char* m_unsched;
  unsigned char* m_taints;
  unsigned char* m_nodeaff;
  long long* taint_raw;
  long long* naff_raw;
  long long* img;
  // optional [S, N] lane ANDed into `mask` (the gang precompute's
  // host-filter lane, K12's volume mask); null: every pair passes
  const unsigned char* extra;
  // sizes and scalars
  int N, K, NVI, T, IMG;
  int S, NT, NR, NV, PT, PR, PV, TL, I;
  int name_key, unsched_key, empty_val, n_valid_nodes;
  // `enabled`: the filters static_filters evaluates (the m_* outputs);
  // `mask_enabled`: those of them `mask` ANDs (a subset)
  int enabled, has_images, mask_enabled;
};

namespace ktpu {

// OR over the DNF terms of row s of a [S, T, R(, V)] selector table
// (term_valid folded in), against one node's label row.
__device__ inline bool any_term(const int* key, const int* op, const int* vals, const int* rhs,
                                const unsigned char* tv, int s, int T, int R, int V, const int* labels, int K,
                                const int* val_ints, int NVI) {
  for (int t = 0; t < T; ++t) {
    const long long st = (long long)s * T + t;
    if (tv[st] && eval_term(key + st * R, op + st * R, vals + st * R * V, rhs + st * R, R, V, labels, K,
                            val_ints, NVI))
      return true;
  }
  return false;
}

// Does any toleration of row s tolerate the taint (key, val, eff)?
// pref_only restricts to tolerations with effect "" or PreferNoSchedule.
__device__ inline bool tolerated(const StaticEvalArgs& a, int s, int tk_taint, int tv_taint, int te_taint,
                                 bool pref_only) {
  for (int l = 0; l < a.TL; ++l) {
    const int i = s * a.TL + l;
    const int to = a.tol_op[i];
    if (to == PAD) continue;
    const int te = a.tol_eff[i];
    if (pref_only && te != EFFECT_ALL && te != EFFECT_PREFER_NO_SCHEDULE) continue;
    const int tk = a.tol_key[i];
    const bool effect_ok = te == EFFECT_ALL || te == te_taint;
    const bool wildcard = tk == ABSENT && to == TOL_OP_EXISTS;
    const bool key_eq = tk == tk_taint;
    const bool val_ok = to == TOL_OP_EXISTS || a.tol_val[i] == tv_taint;
    if (effect_ok && (wildcard || (key_eq && val_ok))) return true;
  }
  return false;
}

// The four static filters of row s at node n, each true where it passes
// (or is not enabled): NodeName, NodeUnschedulable, TaintToleration
// (NoSchedule / NoExecute taints) and required NodeAffinity.  K1 evaluates
// them per signature, K10 per failed pod.
struct StaticVerdict {
  bool name, unsched, taints, affinity;
};

__device__ inline StaticVerdict static_filters(const StaticEvalArgs& a, int s, int n) {
  const int* labels = a.node_labels + (long long)n * a.K;
  StaticVerdict v{true, true, true, true};
  if (a.enabled & EN_NODE_NAME) {
    const int tgt = a.target_name[s];
    const int nv = (a.name_key >= 0 && a.name_key < a.K) ? labels[a.name_key] : ABSENT;
    v.name = tgt == ABSENT || nv == tgt;
  }
  if (a.enabled & EN_UNSCHEDULABLE)
    v.unsched = !a.unsched[n] || tolerated(a, s, a.unsched_key, a.empty_val, EFFECT_NO_SCHEDULE, false);
  if (a.enabled & EN_TAINTS)
    for (int t = 0; t < a.T && v.taints; ++t) {
      const long long nt = (long long)n * a.T + t;
      const int tk = a.taint_key[nt];
      if (tk == PAD) continue;
      const int te = a.taint_eff[nt];
      if ((te == EFFECT_NO_SCHEDULE || te == EFFECT_NO_EXECUTE) && !tolerated(a, s, tk, a.taint_val[nt], te, false))
        v.taints = false;
    }
  if (a.enabled & EN_NODE_AFFINITY)
    v.affinity = any_term(a.ns_key, a.ns_op, a.ns_vals, a.ns_rhs, a.ns_tv, s, a.NT, a.NR, a.NV, labels, a.K,
                          a.val_ints, a.NVI);
  return v;
}

}  // namespace ktpu

struct SigScanArgs {
  const int* ids;                   // [P]  signature id per pod, -1 pads
  const long long* sig_req;         // [S, R]
  const long long* sig_nz;          // [S, 2]
  const unsigned char* sig_allzero; // [S]
  const unsigned char* sig_ok;      // [S, N]
  const long long* sig_img;         // [S, N]
  const long long* alloc;           // [N, R]
  const int* allowed;               // [N]
  long long* used;                  // [N, R]  updated in place
  long long* nz0;                   // [N]     updated in place
  long long* nz1;                   // [N]     updated in place
  int* num_pods;                    // [N]     updated in place
  int* choices;                     // [P]     out: node index or -1
  int P, N, R, S;
  int w_fit, w_bal, w_img, check_fit;
};

struct ResidentArgs {
  const int* ids;                   // [P]  signature id per pod, -1 pads (suffix)
  const long long* sig_req;         // [S, R]
  const long long* sig_nz;          // [S, 2]
  const unsigned char* sig_allzero; // [S]
  const unsigned char* sig_ok;      // [S, N]
  const long long* sig_img;         // [S, N]
  const long long* alloc;           // [N, R]
  const int* allowed;               // [N]
  long long* used;                  // [N, R]  updated in place
  long long* nz0;                   // [N]     updated in place
  long long* nz1;                   // [N]     updated in place
  int* num_pods;                    // [N]     updated in place
  int* choices;                     // [P + W] out: node, -1, or UNRESOLVED (-2)
  long long* ctl;                   // [8]     control block (ops/resident.py CTL_*)
  // scratch, rewritten every round
  long long* keys;                  // [S, N]  packed keys under the round's state
  int* rank;                        // [N]     walk rank, capped at W
  int* order;                       // [W]     the walk's first W nodes
  long long* sufmax;                // [S, W]  best key at or after each walk position
  int* slot_sig;                    // [W]     per window slot: signature (pads: 0)
  int* slot_node;                   // [W]     speculated node
  unsigned char* slot_flags;        // [W]     live / dead / scheduled bits
  long long* slot_ckey;             // [W]     the slot's key at its node
  long long* slot_csuf;             // [W]     its signature's best untouched key
  long long* slot_thr;              // [W]     best post-commit key of earlier slots
  int P, N, R, S, W;
  int w_fit, w_bal, w_img, check_fit;
  int r_cap, min_yield, stop_grace;
};

// K6: the spread half of the gang precompute (csrc/gang_statics.cu).
struct GangSpreadArgs {
  // cluster
  const int* node_labels;           // [N, K]
  const int* val_ints;              // [NVI]
  const int* dom_ids;               // [K, N] compact domain id per key, -1 absent
  const int* dom_counts;            // [K]    distinct domains per key
  const int* epod_node;             // [E]
  const int* epod_ns;               // [E]
  const int* epod_labels;           // [E, K]
  const unsigned char* epod_valid;  // [E]
  const unsigned char* epod_deleting;  // [E]
  // batch
  const unsigned char* valid;       // [P]
  const int* ns_id;                 // [P]
  const int* labels;                // [P, K]
  const int* tsc_key;               // [P, C, R]   the constraints' selectors
  const int* tsc_op;                // [P, C, R]
  const int* tsc_vals;              // [P, C, R, V]
  const int* tsc_rhs;               // [P, C, R]
  const unsigned char* tsc_tv;      // [P, C]
  const int* tsc_topo;              // [P, C]
  const unsigned char* tsc_hard;    // [P, C]
  const unsigned char* honor_aff;   // [P, C]
  const unsigned char* honor_taints;  // [P, C]
  const unsigned char* naff;        // [P, N] node affinity (unconditional)
  const unsigned char* taints;      // [P, N] taint filter (unconditional)
  // outputs
  int* sp_dv;                       // [P, C, N]
  unsigned char* sp_te;             // [P, C, N]
  int* sp_dom_cnt;                  // [P, C, N]
  unsigned char* sp_dom_pres;       // [P, C, N]
  long long* sp_ndom;               // [P, C]
  unsigned char* sp_self;           // [P, C]
  unsigned char* sp_bmatch;         // [P, C, P]
  unsigned char* sp_counting;       // [P, C, N]
  int* sp_node_cnt;                 // [P, C, N]
  int* sp_sc_dom;                   // [P, C, N]
  unsigned char* sp_all_keys;       // [P, N]
  int* sp_cdv;                      // [P, C, N]
  int* acc;                         // [P * C, 3, D] scratch: per-domain sums
  int N, K, NVI, E, P, C, R, V, D, hostname_key;
};

// K7: the inter-pod half of the gang precompute and the host-port masks
// (csrc/gang_statics.cu).
struct GangInterpodArgs {
  // cluster
  const int* node_labels;           // [N, K]
  const int* val_ints;              // [NVI]
  const int* dom_ids;               // [K, N]
  const int* dom_counts;            // [K]
  const int* dom_off;               // [K + 1] prefix sums of dom_counts
  const int* epod_node;             // [E]
  const int* epod_ns;               // [E]
  const int* epod_labels;           // [E, K]
  const unsigned char* epod_valid;  // [E]
  const int* term_pod;              // [M]
  const int* term_kind;             // [M]
  const int* term_topo;             // [M]
  const int* term_weight;           // [M]
  const int* tt_key;                // [M, 1, TR]
  const int* tt_op;                 // [M, 1, TR]
  const int* tt_vals;               // [M, 1, TR, TV]
  const int* tt_rhs;                // [M, 1, TR]
  const unsigned char* tt_tv;       // [M, 1]
  const unsigned char* term_ns_all; // [M]
  const int* term_ns_ids;           // [M, TNS]
  const int* used_ppk;              // [N, U]
  const int* used_ip;               // [N, U]
  const unsigned char* used_wild;   // [N, U]
  // batch
  const unsigned char* valid;       // [P]
  const int* ns_id;                 // [P]
  const int* labels;                // [P, K]
  const int* aff_key;               // [P, AT, AR]
  const int* aff_op;                // [P, AT, AR]
  const int* aff_vals;              // [P, AT, AR, AV]
  const int* aff_rhs;               // [P, AT, AR]
  const unsigned char* aff_tv;      // [P, AT]
  const int* aff_kind;              // [P, AT]
  const int* aff_topo;              // [P, AT]
  const unsigned char* aff_ns_all;  // [P, AT]
  const int* aff_ns_ids;            // [P, AT, NS]
  const int* want_ppk;              // [P, W]
  const int* want_ip;               // [P, W]
  const unsigned char* want_wild;   // [P, W]
  // outputs
  int* ip_dv;                       // [P, AT, N]
  int* ip_dom_cnt;                  // [P, AT, N]
  unsigned char* ip_viol_existing;  // [P, N]
  long long* ip_sym;                // [P, N]
  unsigned char* inc_any;           // [P, AT] some placed pod matches term u
  unsigned char* self_ok;           // [P, AT] term u matches the pod itself
  unsigned char* ip_bmatch;         // [P, AT, P]
  unsigned char* d_ports;           // [P, N]
  unsigned char* port_b;            // [P, P]
  // scratch
  int* ext_acc;                     // [P, 2, DSUM] per (key, domain) sums
  int* inc_acc;                     // [P * AT, D] per-domain matches
  int N, K, NVI, E, M, TR, TV, TNS, U, P, AT, AR, AV, NS, W;
  int DSUM, D, hard_weight, do_interpod, do_ports;
};

// K5: the gang scan (csrc/gang_scan.cu).
struct GangScanArgs {
  // cluster
  const int* allocatable;           // [N, Rn]
  const int* allowed_pods;          // [N]
  const unsigned char* node_valid;  // [N]
  const long long* log_tab;         // [L]
  // carried usage, updated in place
  int* requested;                   // [N, Rn]
  int* nonzero;                     // [N, 2]
  int* num_pods;                    // [N]
  // batch
  const int* requests;              // [P, Rp]
  const int* nonzero_req;           // [P, 2]
  const unsigned char* valid;       // [P]
  const int* max_skew;              // [P, C]
  const int* min_domains;           // [P, C]
  // GangStatics
  const unsigned char* static_mask;  // [P, N]
  const unsigned char* sp_hard;     // [P, C]
  const unsigned char* sp_soft;     // [P, C]
  const unsigned char* sp_te;       // [P, C, N]
  const int* sp_dom_cnt;            // [P, C, N]
  const unsigned char* sp_dom_pres;  // [P, C, N]
  const long long* sp_ndom;         // [P, C]
  const unsigned char* sp_self;     // [P, C]
  const unsigned char* sp_bmatch;   // [P, C, P]
  const unsigned char* sp_is_host;  // [P, C]
  const unsigned char* sp_counting;  // [P, C, N]
  const int* sp_node_cnt;           // [P, C, N]
  const int* sp_sc_dom;             // [P, C, N]
  const unsigned char* sp_all_keys;  // [P, N]
  const int* ip_dom_cnt;            // [P, AT, N]
  const unsigned char* ip_viol_existing;  // [P, N]
  const long long* ip_sym;          // [P, N]
  const unsigned char* ip_any_static;  // [P]
  const unsigned char* ip_self_all;  // [P]
  const unsigned char* ip_bmatch;   // [P, AT, P]
  const unsigned char* ip_is_aff;   // [P, AT]
  const unsigned char* ip_is_anti;  // [P, AT]
  const long long* ip_pref_w;       // [P, AT]
  const long long* ip_sym_w;        // [P, AT]
  const int* ip_key_idx;            // [P, AT]
  const long long* sc_taint;        // [P, N]
  const long long* sc_nodeaff;      // [P, N]
  const long long* sc_image;        // [P, N]
  const unsigned char* port_b;      // [P, JP]
  const unsigned char* d_nodename;  // [P, N]
  const unsigned char* d_unsched;   // [P, N]
  const unsigned char* d_taints;    // [P, N]
  const unsigned char* d_nodeaff;   // [P, N]
  const unsigned char* d_ports;     // [P, N]
  const unsigned char* d_extra;     // [P, N]
  // outputs
  int* chosen;                      // [P]
  long long* n_feas;                // [P]
  long long* reason_counts;         // [P, 9]
  // the batch's topology keys, for the compact domain ids
  const int* dom_ids;               // [K, N]  DeviceCluster.dom_ids
  const int* sp_key;                // [P, C]  key per spread slot (PAD: none)
  const int* ip_key;                // [P, AT] key per inter-pod slot
  const int* kd2_key;               // [KD2]   key per ip_key_idx entry
  // scratch, zeroed by the wrapper
  int* cnt;                         // [(3C + AT + 2 KD2) * D] peer counters
                                    // by compact domain id, unless use_smem
  int* cnt_h;                       // [C, N]   peers per node (score)
  int* port_stamp;                  // [N]
  unsigned char* feas;              // [N]
  long long* ip_raw;                // [N]
  long long* sp_raw;                // [N]
  int* sp_cnt;                      // [C, N]
  // open nominations (preemptors whose victims are still terminating),
  // grouped by node: rows nom_off[n] .. nom_off[n + 1] sit on node n.  A
  // pod's fit charges the rows of priority >= its own.  nom_off null: none.
  const int* priority;              // [P]
  const int* nom_off;               // [N + 1]
  const int* nom_prio;              // [G]
  const int* nom_req;               // [G, Rn]
  // a score added to every node's total (the planner's target bonus), or
  // null: nothing.  The wave's K8 and the workloads' K11 take it.
  const long long* extra_score;     // [P, N]
  // NodeResourcesFit's RequestedToCapacityRatio shape: n_shape (utilization,
  // score) pairs (null unless strat_id is 2)
  const int* fit_shape;             // [n_shape, 2]
  // the sampling window (sample_k > 0): each node's visit rank (-1: pad),
  // the node at each rank, and the rotation cursor, read at each step and,
  // by K5 and K9, advanced after each real pod
  const int* visit_rank;            // [N]
  const int* visit_order;           // [n_valid]
  int* sample_start;                // [1]
  int N, K, Rn, Rp, L, P, C, AT, KD2, D, JP, use_smem;
  int w_taint, w_naff, w_spread, w_ip, w_fit, w_bal, w_img, check_fit;
  // strat_id: 0 LeastAllocated, 1 MostAllocated, 2 RequestedToCapacityRatio,
  // over the cpu and memory lanes with weights w_cpu / w_mem
  int strat_id, n_shape, w_cpu, w_mem;
  // sample_k: the window's size (0: off); n_valid: the real nodes
  int sample_k, n_valid;
  // the seeded tie-break (tie_on): the key's two words (uint32 bit
  // patterns) and the batch's first attempt; pod p draws attempt_base + p
  int tie_on, tie_k0, tie_k1, attempt_base;
};

// K10's inputs beyond the static tables (csrc/preemption.cu): the placed
// pods, the failed pods' priority groups, the batch's committed peers, the
// per-(group, node) planes and the [P, N] mask.
struct PreemptArgs {
  const int* victim_node;   // [E]     placed pod's node (< 0: pad)
  const int* victim_prio;   // [E]
  const int* victim_req;    // [E, R]
  const int* groups;        // [G]     distinct failed-pod priorities (INT32_MIN: pad)
  const int* pod_group;     // [P]     group of each failed pod
  const int* batch_node;    // [B2]    committed batch peer's node (< 0: pad)
  const int* batch_prio;    // [B2]
  const int* batch_req;     // [B2, R]
  const int* allocatable;   // [N, R]
  const int* allowed_pods;  // [N]
  const int* requests;      // [P, Rp]
  int* kept_req;            // [G, N, R] scratch
  int* kept_cnt;            // [G, N]    scratch
  int* victims;             // [G, N]    scratch
  unsigned char* mask;      // [P, N]    out
  int N, R, Rp, E, B2, G, P;
};

// The speculative wave's tables and outputs (csrc/wave.cu): K8 and K9 take
// a GangScanArgs (the statics, the usage state, chosen / n_feas /
// reason_counts and the per-node scratch) and this block.
struct WaveArgs {
  const int* tid_sp;                // [P, C]   distinct spread-term id per slot (-1 empty)
  const int* rep_sp_p;              // [Tsp]    a representative slot per term (-1 pad)
  const int* rep_sp_c;              // [Tsp]
  const int* tid_ip;                // [P, AT]  distinct inter-pod-term id per slot
  const int* rep_ip_p;              // [Tip]
  const int* rep_ip_u;              // [Tip]
  const int* tid_pt;                // [P, W]   distinct port-term id per want slot
  const unsigned char* port_conf;   // [Tpt, Tpt] term-pair conflicts
  const int* c0;                    // [P]      K9: the speculative nodes
  int* kinds;                       // [P]      K9: demote kind
  int* cterms;                      // [P]      K9: conflicting term slot
  int* sums;                        // K8: [P, C, Dsp] domain stamps; K9: the per-pod
                                    // region unless sums_smem (see wave.cu)
  int* carries;                     // K9: [(Tsp + 2 Tip + Tpt) * N] unless carry_smem
  const unsigned char* lane;        // K8: [P, N] the port lane (null: every port free); the
                                    // workloads dispatch's DRA verdict against free0
  int Tsp, Tip, Tpt, W, Dsp, D2, hostname_key, has_ports, sums_smem, carry_smem;
};

// The gang admission's rows and outputs (csrc/workloads.cu): K11 takes a
// GangScanArgs (whose `chosen` receives each step's choice before any
// rollback, the `raw` output), a WaveArgs without ports and this block.  In
// a batch with DRA claims (dra_match not null) it also takes K13's match
// tensor, the request rows of ops/dra.py dra_tables and the two allocation
// carries, updated in place.
struct WorkloadsArgs {
  const int* gang_id;               // [P]      gang slot per pod (-1: none)
  const unsigned char* gang_first;  // [P]      the gang's first member
  const unsigned char* gang_last;   // [P]      the gang's last member
  const int* gang_need;             // [P]      members the gang must place
  int* assigned;                    // [P]      out: the choices after rollback
  int* gang_admit;                  // [g_cap]  out: -1 unjudged, 0 rolled back, 1 admitted
  int* gang_landed;                 // [g_cap]  out: members placed in the batch
  int* ckpt;                        // the checkpoint: requested [N, Rn], nonzero [N, 2],
                                    // num_pods [N], assigned [P], carries [(Tsp + 2 Tip) N],
                                    // then with DRA claim_node [CL] and free's N DD bytes
  const unsigned char* dra_match;   // [P, DQ, N, DD] K13's match (null: no DRA)
  const int* req_count;             // [P, DQ]  ExactCount count
  const unsigned char* req_all;     // [P, DQ]  AllocationMode=All
  const int* req_cl;                // [P, DQ]  owning claim slot (-1 pad)
  const unsigned char* q_valid;     // [P, DQ]
  const unsigned char* req_bad;     // [P, DQ]  device class missing
  const int* ref_cl;                // [P, CQ]  claim slots the pod references
  unsigned char* free;              // [N, DD]  carry: no allocated claim holds the device
  int* claim_node;                  // [CL]     carry: node of a referenced claim (-1 none)
  unsigned char* dra_row;           // [N]      scratch: the step's DRA verdict per node
  unsigned long long* dra_scratch;  // [ADMIT_THREADS, 2 ceil(DD/64)] per-thread verdict words
                                    // past dra::REG_DD slots (null below)
  int g_cap, DQ, DD, CQ, CL;
};

namespace ktpu {
namespace dra {

// ---------------------------------------------------------------------------
// One pod's DRA verdict at one node, shared by K14 (dra_spec_mask,
// csrc/dra.cu: against free0 and claim_node0) and K11's DRA mode (against
// the carries), as the reference shares ops/dra.py node_feasible between
// the speculation and the admission: every referenced claim already
// allocated pins to the node, then each active request slot (its claim
// unallocated) in slot order is met from the node's free devices, a
// slot's take gone for the later slots: ExactCount needs `count` matching
// free devices and takes the lowest slots, All needs every matching device
// free (counted over all matching devices, free or not) and at least one,
// and takes them all.  A node's free set and a slot's match are bit words:
// in registers, W 64-bit words each, while DD <= 64 W <= REG_DD; beyond
// that (W = 0) in the thread's scratch row of 2 ceil(DD / 64) words in
// global memory, which the wrapper allocates.
// ---------------------------------------------------------------------------

constexpr int REG_DD = 256;  // device slots the register words hold

// Pod p's rows: its [DQ, N, DD] match plane, its [DQ] request rows and its
// [CQ] referenced claim slots.
struct PodRows {
  const unsigned char* match;
  const int* count;
  const unsigned char* all;
  const int* cl;
  const unsigned char* qv;
  const unsigned char* bad;
  const int* ref_cl;
  int DQ, CQ, N, DD, CL;
};

__device__ __forceinline__ PodRows pod_rows(const unsigned char* match, const int* count, const unsigned char* all,
                                            const int* cl, const unsigned char* qv, const unsigned char* bad,
                                            const int* ref_cl, int p, int DQ, int CQ, int N, int DD, int CL) {
  const long long q0 = (long long)p * DQ;
  return PodRows{match + q0 * N * DD, count + q0, all + q0, cl + q0, qv + q0, bad + q0, ref_cl + (long long)p * CQ,
                 DQ, CQ, N, DD, CL};
}

// Scratch words one thread needs at DD device slots (0 on the register path).
__host__ __device__ __forceinline__ int scratch_words(int DD) { return DD > REG_DD ? 2 * ((DD + 63) >> 6) : 0; }

// Word w of a row of DD bool bytes (0 / 1) as bits: byte d is bit d - 64 w.
// Eight bytes at a time where the row is 8-byte aligned (each 0 / 1 byte
// gathered into its bit by one multiply), the rest byte by byte, so the
// words are built in a register and stored once.
__device__ __forceinline__ unsigned long long row_word(const unsigned char* row, int w, int DD) {
  const int lo = w << 6, hi = min(DD, lo + 64);
  unsigned long long x = 0;
  int d = lo;
  if ((reinterpret_cast<unsigned long long>(row + lo) & 7ULL) == 0)
    for (; d + 8 <= hi; d += 8) {
      const unsigned long long v = *reinterpret_cast<const unsigned long long*>(row + d) & 0x0101010101010101ULL;
      x |= ((v * 0x0102040810204080ULL) >> 56) << (d - lo);
    }
  for (; d < hi; ++d)
    if (row[d]) x |= 1ULL << (d - lo);
  return x;
}

// node_feasible's ok[n] against `free` [N, DD] and `claim_node` [CL] over
// the words fs (the free set) and m (a slot's match), nw each.  With
// `walk_all` it walks every slot and leaves in fs the node's free set less
// every slot's take; without, it stops at the first failure.
__device__ __forceinline__ bool verdict_words(const PodRows& r, const unsigned char* free, const int* claim_node,
                                              int n, bool walk_all, unsigned long long* fs, unsigned long long* m) {
  bool ok = true;
  for (int c = 0; c < r.CQ; ++c) {
    const int cl = r.ref_cl[c];
    if (cl < 0) continue;
    const int pin = claim_node[min(cl, r.CL - 1)];
    if (pin >= 0 && pin != n) {
      ok = false;
      if (!walk_all) return false;
    }
  }
  const int DD = r.DD;
  const int nw = (DD + 63) >> 6;
  const unsigned char* fr = free + (long long)n * DD;
  for (int w = 0; w < nw; ++w) fs[w] = row_word(fr, w, DD);
  for (int q = 0; q < r.DQ; ++q) {
    const int cl = r.cl[q];
    if (!r.qv[q] || cl < 0 || claim_node[min(cl, r.CL - 1)] >= 0) continue;  // not active: no verdict, no take
    const unsigned char* mrow = r.match + ((long long)q * r.N + n) * DD;
    int total = 0, cnt = 0;
    for (int w = 0; w < nw; ++w) {
      const unsigned long long mw = row_word(mrow, w, DD);
      total += __popcll(mw);
      m[w] = mw & fs[w];
      cnt += __popcll(m[w]);
    }
    const bool all = r.all[q] != 0;
    const bool ok_q = !r.bad[q] && (all ? (total > 0 && cnt == total) : cnt >= r.count[q]);
    if (!ok_q) {
      ok = false;
      if (!walk_all) return false;
    }
    int budget = r.count[q];
    for (int w = 0; w < nw; ++w) {
      unsigned long long t = m[w];
      if (!all) {  // the lowest `budget` free matches
        unsigned long long kept = 0;
        while (t != 0 && budget > 0) {
          const unsigned long long low = t & (~t + 1);
          kept |= low;
          t ^= low;
          --budget;
        }
        t = kept;
      }
      fs[w] &= ~t;
    }
  }
  return ok;
}

// The verdict alone, with W register words (W = 0: the scratch row).
template <int W>
__device__ __forceinline__ bool node_verdict(const PodRows& r, const unsigned char* free, const int* claim_node, int n,
                                             unsigned long long* scratch) {
  if constexpr (W > 0) {
    unsigned long long fs[W], m[W];
    return verdict_words(r, free, claim_node, n, false, fs, m);
  } else {
    return verdict_words(r, free, claim_node, n, false, scratch, scratch + ((r.DD + 63) >> 6));
  }
}

// The verdict with the fewest register words DD allows, else the scratch row.
__device__ __forceinline__ bool node_verdict_any(const PodRows& r, const unsigned char* free, const int* claim_node,
                                                 int n, unsigned long long* scratch) {
  if (r.DD <= 64) return node_verdict<1>(r, free, claim_node, n, scratch);
  if (r.DD <= 128) return node_verdict<2>(r, free, claim_node, n, scratch);
  if (r.DD <= REG_DD) return node_verdict<4>(r, free, claim_node, n, scratch);
  return node_verdict<0>(r, free, claim_node, n, scratch);
}

// dra_commit's take at node n: `free` row n loses every device the pod's
// active slots take (the walk of node_feasible with take_acc).
template <int W>
__device__ __forceinline__ void take_words(const PodRows& r, unsigned char* free, const int* claim_node, int n,
                                           unsigned long long* scratch) {
  const int nw = (r.DD + 63) >> 6;
  unsigned long long fs_r[W > 0 ? W : 1], m_r[W > 0 ? W : 1];
  unsigned long long* fs = W > 0 ? fs_r : scratch;
  unsigned long long* m = W > 0 ? m_r : scratch + nw;
  verdict_words(r, free, claim_node, n, true, fs, m);
  unsigned char* const fr = free + (long long)n * r.DD;
  for (int d = 0; d < r.DD; ++d)
    if (fr[d] && !((fs[d >> 6] >> (d & 63)) & 1ULL)) fr[d] = 0;
}

__device__ __forceinline__ void node_take(const PodRows& r, unsigned char* free, const int* claim_node, int n,
                                          unsigned long long* scratch) {
  if (r.DD <= 64) take_words<1>(r, free, claim_node, n, scratch);
  else if (r.DD <= 128) take_words<2>(r, free, claim_node, n, scratch);
  else if (r.DD <= REG_DD) take_words<4>(r, free, claim_node, n, scratch);
  else take_words<0>(r, free, claim_node, n, scratch);
}

}  // namespace dra
}  // namespace ktpu

namespace ktpu {
namespace step {

// ---------------------------------------------------------------------------
// The gang path's per-pod step, shared by K5 (gang_scan), K8 (wave_speculate)
// and K9 (wave_admit), as the reference shares gang.pod_step,
// spread_constraints and interpod_constraints between the scan, the wave's
// speculation and its admission: the dynamic resource fit, the spread and
// inter-pod verdicts from the batch peers' counts, the first-failure reason
// counts in DIAG_KERNELS order, the seven weighted scores with their
// normalizations over the live feasible set, and the first-max argmax (ties
// to the lower node index).  It carries the reference's optional branches
// too: the NodeResourcesFit strategy (strat_id, fit_score), the sampling
// window (sample_k: the feasible set cut to the first sample_k feasible
// nodes in visit order from the cursor, one block-wide prefix count walking
// visit_order[] in chunks of blockDim; without a tie key, ties go to the
// first node in that order) and the seeded tie-break (tie_on: the argmax of
// total * 2^33 + bits, the bits of fold_in(key, attempt_base + p) at the
// node's slot, ktpu::rng).  Only where the peers' counts come from differs:
// the caller passes a Dyn with
//   f(c, pc, n, d)        filter-side peer count of spread slot c at node n
//   sc(c, pc, n, d, host) score-side peer count (per node for a hostname
//                         constraint, per domain otherwise)
//   ip(u, pc, n, d)       peers matching inter-pod term u in n's domain
//   viol(n), sym(n)       the committed peers' own terms against the pod:
//                         anti-affinity at n, symmetric score at n
//   portb(n)              no committed peer's host port conflicts at n
// where d is n's compact domain id under the slot's topology key (in
// namespace ktpu::step, apart from the fast path's helpers).  Scores are
// int64; every division is a floor division; the spread score's 32.32 fixed
// point uses an arithmetic >> and round-half-to-even, as _spread_raw does.
// ---------------------------------------------------------------------------

constexpr int N_DIAG = 9;
constexpr int RED_CHUNK = 8;  // slots per block-wide min reduction
constexpr int FX = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr long long I64_MAX = 0x7fffffffffffffffLL;
constexpr int I32_MAX = 0x7fffffff;

enum RedOp { RED_SUM = 0, RED_MIN = 1, RED_MAX = 2 };

// floor division for b > 0 (the reference's // on int64)
__device__ __forceinline__ long long fdiv(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ long long combine(long long x, long long y, int op) {
  return op == RED_SUM ? x + y : (op == RED_MIN ? (y < x ? y : x) : (y > x ? y : x));
}

__device__ __forceinline__ long long identity(int op) {
  return op == RED_SUM ? 0 : (op == RED_MIN ? I64_MAX : -I64_MAX - 1);
}

// Block-wide reduction of nv <= NV values under their ops; every thread gets
// the results in v.  s_buf holds 32 * NV entries.
template <int NV>
__device__ void block_reduce(long long (&v)[NV], const int (&op)[NV], int nv, long long* s_buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < nv; ++i)
    for (int off = 16; off > 0; off >>= 1) v[i] = combine(v[i], __shfl_down_sync(FULL_MASK, v[i], off), op[i]);
  if (lane == 0)
    for (int i = 0; i < nv; ++i) s_buf[warp * NV + i] = v[i];
  __syncthreads();
  if (warp == 0) {
    for (int i = 0; i < nv; ++i) {
      long long x = lane < (int)(blockDim.x >> 5) ? s_buf[lane * NV + i] : identity(op[i]);
      for (int off = 16; off > 0; off >>= 1) x = combine(x, __shfl_down_sync(FULL_MASK, x, off), op[i]);
      if (lane == 0) s_buf[i] = x;
    }
  }
  __syncthreads();
  for (int i = 0; i < nv; ++i) v[i] = s_buf[i];
  __syncthreads();
}

__device__ __forceinline__ void better(long long& v, int& i, long long ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// (v, t, i) beats the incumbent on a larger v, then a smaller tie key t
// (the slot, or the visit position in the window's compat first-max)
__device__ __forceinline__ void better(long long& v, int& t, int& i, long long ov, int ot, int oi) {
  if (ov > v || (ov == v && ot < t)) {
    v = ov;
    t = ot;
    i = oi;
  }
}

// Node n's compact domain id under topology key `key` (-1: absent).
__device__ __forceinline__ int dom_at(const GangScanArgs& a, int key, int n) {
  return key >= 0 && key < a.K ? a.dom_ids[(long long)key * a.N + n] : -1;
}

// Per-node scratch of one step (global memory; one set per block).
struct StepScratch {
  unsigned char* feas;  // [N]
  long long* ip_raw;    // [N]
  long long* sp_raw;    // [N]
  int* sp_cnt;          // [C, N] the spread score's per-node counts
  int* seen;            // [C, seen_stride] stamp of the last step that counted
                        // a domain (the spread score's domain counts)
  int seen_stride;
};

// The block's shared memory for a step.
struct StepShared {
  long long* s_buf;     // [32 * 16] block_reduce
  long long* s_wfx;     // [C] topology weights
  int* s_min;           // [C] min-match
  int* s_ndom;          // [C] distinct counted domains
  long long* s_best_v;  // [32]
  int* s_best_i;        // [32]; [0] carries the choice out
  int* s_at;            // [6] at the node `at`: m_portb, m_spread, m_interpod,
                        // m_fit, first violating hard spread slot, first
                        // violated anti-affinity slot
};

struct StepOut {
  int choice;
  long long n_feas;
  long long rc[N_DIAG];
  int processed;  // the nodes the sampling window visited (0 without it)
};

// RequestedToCapacityRatio's BuildBrokenLinearFunction (helper/
// shape_score.go:40) over the shape's (utilization, score) pairs; C's
// truncating division is Go's.
__device__ __forceinline__ long long broken_linear(const int* shape, int S, long long x) {
  long long out = shape[1];
  for (int i = 0; i + 1 < S; ++i) {
    const long long x0 = shape[2 * i], y0 = shape[2 * i + 1], x1 = shape[2 * i + 2], y1 = shape[2 * i + 3];
    if (x > x0 && x <= x1) out = y0 + (y1 - y0) * (x - x0) / (x1 - x0);
  }
  if (x > shape[2 * (S - 1)]) out = shape[2 * (S - 1) + 1];
  return out;
}

// NodeResourcesFit's score under the strategy (resource_allocation.go:
// 37-115) from the cpu / memory allocatable a0 / a1 and the non-zero-
// defaulted request sums c0 / c1: the weighted mean of the lanes with
// allocatable (RequestedToCapacityRatio: of those whose score is positive,
// rounded).
__device__ inline long long fit_score(const GangScanArgs& a, long long a0, long long a1, long long c0, long long c1) {
  const long long alloc[2] = {a0, a1}, nz[2] = {c0, c1}, w[2] = {a.w_cpu, a.w_mem};
  long long total = 0, wsum = 0;
  for (int l = 0; l < 2; ++l) {
    const bool has = alloc[l] > 0;
    const long long den = has ? alloc[l] : 1;
    long long frac;
    if (a.strat_id == 1)
      frac = nz[l] > alloc[l] ? 0 : nz[l] * MAX_NODE_SCORE / den;
    else if (a.strat_id == 2)
      frac = broken_linear(a.fit_shape, a.n_shape, (!has || nz[l] > alloc[l]) ? MAX_NODE_SCORE
                                                                             : nz[l] * MAX_NODE_SCORE / den);
    else
      frac = nz[l] > alloc[l] ? 0 : (alloc[l] - nz[l]) * MAX_NODE_SCORE / den;
    if (has && (a.strat_id != 2 || frac > 0)) {
      total += frac * w[l];
      wsum += w[l];
    }
  }
  if (wsum <= 0) return 0;
  return a.strat_id == 2 ? fdiv(2 * total + wsum, 2 * wsum) : fdiv(total, wsum);
}

// Node n's place in the rotation from the cursor (the walk's position).
__device__ __forceinline__ int visit_pos(const GangScanArgs& a, int n, int start, int nv) {
  int r = (a.visit_rank[n] - start) % nv;
  return r < 0 ? r + nv : r;
}

// The sampling window's walk: the position, in visit order from `start`, of
// the sample_k-th feasible node (sc_feas), or -1 when fewer are feasible.
// Chunks of blockDim positions, one ballot and a per-warp prefix each; it
// stops at the chunk that reaches sample_k.  Every thread gets the result.
__device__ inline int window_stop(const GangScanArgs& a, const unsigned char* sc_feas, int start, int nv) {
  __shared__ int s_cnt[32];
  __shared__ int s_win[2];  // running count, stop position
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  if (tid == 0) {
    s_win[0] = 0;
    s_win[1] = -1;
  }
  __syncthreads();
  for (int base = 0; base < nv; base += blockDim.x) {
    const int i = base + tid;
    bool f = false;
    if (i < nv) {
      int r = start + i;
      if (r >= nv) r -= nv;
      const int n = a.visit_order[r];
      f = n >= 0 && sc_feas[n];
    }
    const unsigned bal = __ballot_sync(FULL_MASK, f);
    if (lane == 0) s_cnt[warp] = __popc(bal);
    __syncthreads();
    int off = s_win[0], total = 0;
    for (int w2 = 0; w2 < n_warps; ++w2) {
      if (w2 < warp) off += s_cnt[w2];
      total += s_cnt[w2];
    }
    if (f && off + __popc(bal & (FULL_MASK >> (31 - lane))) == a.sample_k) s_win[1] = i;
    __syncthreads();
    if (tid == 0) s_win[0] += total;
    __syncthreads();
    if (s_win[1] >= 0) break;
  }
  const int stop = s_win[1];
  __syncthreads();  // s_win is written again by the next step
  return stop;
}

// NodeResourcesFit at node n for the pod with requests `req` and priority
// `prio`: pod count and every requested lane (a scalar lane only when
// requested) against allocatable minus the usage state, and, with `nom`,
// minus the open nominations on n of priority >= prio (each also counts as
// a pod).
__device__ inline bool step_fits(const GangScanArgs& a, int n, const int* req, bool all_zero, int prio, bool nom) {
  int g0 = 0, g1 = 0;
  if (nom) {
    g0 = a.nom_off[n];
    g1 = a.nom_off[n + 1];
  }
  long long n_nom = 0;
  for (int g = g0; g < g1; ++g) n_nom += a.nom_prio[g] >= prio;
  if (a.num_pods[n] + n_nom + 1 > a.allowed_pods[n]) return false;
  if (all_zero) return true;
  for (int r = 0; r < a.Rp; ++r) {
    const long long v = req[r];
    if (r >= N_FIXED_LANES && v == 0) continue;  // unrequested scalar lane
    long long avail = 0;
    if (r < a.Rn) {
      avail = (long long)a.allocatable[(long long)n * a.Rn + r] - a.requested[(long long)n * a.Rn + r];
      for (int g = g0; g < g1; ++g)
        if (a.nom_prio[g] >= prio) avail -= a.nom_req[(long long)g * a.Rn + r];
    }
    if (v > avail) return false;
  }
  return true;
}

// One pod's Filter -> Score -> Select against the usage state in `a`
// (requested / nonzero / num_pods, read only here: the caller commits).
// `at` >= 0 asks for the verdict's pieces at that node (the wave's demotion
// attribution).  Without `diagnose` the reason counts stay 0 and the
// diagnosis masks are not read (a caller that emits only the choice).
// Every thread of the block calls it and gets the result.
template <class Dyn>
__device__ StepOut pod_step_block(const GangScanArgs& a, int p, const Dyn& dyn, bool any_dyn,
                                  const StepScratch& sc, const StepShared& sh, int at, bool diagnose = true) {
  const int tid = threadIdx.x;
  const int N = a.N, C = a.C, AT = a.AT;
  for (int c = tid; c < C; c += blockDim.x) sh.s_ndom[c] = 0;
  __syncthreads();

  // ---- spread min-match per constraint (filtering.go:313 minMatch),
  // RED_CHUNK constraints per block-wide reduction
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
        const long long pc = (long long)p * C + c0 + i;
        const long long o = pc * N + n;
        if (!a.sp_te[o]) continue;
        const int d = dom_at(a, a.sp_key[pc], n);
        const long long total = a.sp_dom_cnt[o] + dyn.f(c0 + i, pc, n, d);
        if (total < v[i]) v[i] = total;
      }
    block_reduce(v, op, nc, sh.s_buf);
    if (tid < nc) {
      const long long pc = (long long)p * C + c0 + tid;
      const int md = a.min_domains[pc];
      sh.s_min[c0 + tid] = (md > 0 && a.sp_ndom[pc] < md) ? 0 : (int)v[tid];
    }
  }
  __syncthreads();

  // ---- filters, diagnosis, and the normalizers' min / max
  bool has_aff = false, has_soft = false;
  for (int u = 0; u < AT; ++u) has_aff = has_aff || a.ip_is_aff[(long long)p * AT + u];
  for (int c = 0; c < C; ++c) has_soft = has_soft || a.sp_soft[(long long)p * C + c];
  const bool any_match = a.ip_any_static[p] || any_dyn;
  const bool escape = has_aff && !any_match && a.ip_self_all[p];
  const int* req = a.requests + (long long)p * a.Rp;
  bool all_zero = true;
  for (int r = 0; r < a.Rp; ++r) all_zero = all_zero && req[r] == 0;
  const int prio = a.priority[p];
  const int stamp = p + 1;
  const bool sampling = a.sample_k > 0;
  const int nv = a.n_valid > 1 ? a.n_valid : 1;
  int start = 0;  // the cursor, in [0, nv) like the reference's (vr - start) % nv
  if (sampling) {
    start = *a.sample_start % nv;
    if (start < 0) start += nv;
  }

  // 0 n_feas, 1..9 reason counts, 10 taint max, 11 naff max, 12 ip min,
  // 13 ip max, 14 counted nodes
  long long red[15];
  const int red_op[15] = {RED_SUM, RED_SUM, RED_SUM, RED_SUM, RED_SUM, RED_SUM, RED_SUM, RED_SUM,
                          RED_SUM, RED_SUM, RED_MAX, RED_MAX, RED_MIN, RED_MAX, RED_SUM};
  for (int i = 0; i < 15; ++i) red[i] = identity(red_op[i]);
  red[10] = red[11] = 0;  // max(where(feas, raw, 0))
  // a feasible node's share of the normalizers
  auto count_feasible = [&](int n, long long pn, long long ip_raw) {
    red[0] += 1;
    if (a.sc_taint[pn] > red[10]) red[10] = a.sc_taint[pn];
    if (a.sc_nodeaff[pn] > red[11]) red[11] = a.sc_nodeaff[pn];
    if (ip_raw < red[12]) red[12] = ip_raw;
    if (ip_raw > red[13]) red[13] = ip_raw;
    if (a.sp_all_keys[pn]) {
      red[14] += 1;
      // distinct domains among the counted nodes, per non-hostname
      // constraint (the hostname's topology size is red[14])
      for (int c = 0; c < C; ++c) {
        const long long pc = (long long)p * C + c;
        if (a.sp_is_host[pc]) continue;
        const int d = dom_at(a, a.sp_key[pc], n);
        if (d < 0) continue;
        if (atomicExch(sc.seen + (long long)c * sc.seen_stride + d, stamp) != stamp) atomicAdd(sh.s_ndom + c, 1);
      }
    }
  };
  for (int n = tid; n < N; n += blockDim.x) {
    const long long pn = (long long)p * N + n;
    const bool m_portb = dyn.portb(n);
    // m_fit: the resource fit with the nominations charged (the filter);
    // fit_own: without them (the wave's demotion attribution, which the
    // reference computes from the usage state alone)
    bool m_fit = true, fit_own = true;
    if (a.check_fit) {
      fit_own = step_fits(a, n, req, all_zero, prio, false);
      m_fit = fit_own;
      if (a.nom_off != nullptr && a.nom_off[n + 1] > a.nom_off[n])
        m_fit = step_fits(a, n, req, all_zero, prio, true);
    }
    bool m_spread = true;
    int sp_term = -1;
    for (int c = 0; c < C; ++c) {
      const long long pc = (long long)p * C + c;
      const long long o = pc * N + n;
      const int d = dom_at(a, a.sp_key[pc], n);
      const bool host = a.sp_is_host[pc];
      const long long total = a.sp_dom_cnt[o] + dyn.f(c, pc, n, d);
      const long long skew = total + (a.sp_self[pc] ? 1 : 0) - sh.s_min[c];
      const bool c_ok = d >= 0 && (!a.sp_dom_pres[o] || skew <= a.max_skew[pc]);
      if (a.sp_hard[pc] && !c_ok) {
        m_spread = false;
        if (sp_term < 0) sp_term = c;
      }
      sc.sp_cnt[(long long)c * N + n] =
          (host ? a.sp_node_cnt[o] : a.sp_sc_dom[o]) + dyn.sc(c, pc, n, d, host);
    }
    bool m_interpod = true;
    long long ip_raw = 0;
    int ip_term = -1;
    if (AT) {
      ip_raw = a.ip_sym[pn];
      bool viol2 = false, aff_ok = true, topo_all = true;
      long long pref = 0;
      for (int u = 0; u < AT; ++u) {
        const long long pu = (long long)p * AT + u;
        const long long o = pu * N + n;
        const int d = dom_at(a, a.ip_key[pu], n);
        const bool present = d >= 0;
        const long long tot = a.ip_dom_cnt[o] + dyn.ip(u, pu, n, d);
        if (a.ip_is_anti[pu] && present && tot > 0) {
          viol2 = true;
          if (ip_term < 0) ip_term = u;
        }
        if (a.ip_is_aff[pu]) {
          aff_ok = aff_ok && present && tot > 0;
          topo_all = topo_all && present;
        }
        if (present) pref += tot * a.ip_pref_w[pu];
      }
      const bool ok3 = aff_ok || (escape && topo_all);
      m_interpod = !a.ip_viol_existing[pn] && !viol2 && ok3 && !dyn.viol(n);
      ip_raw += pref + dyn.sym(n);
    }
    const bool feas = a.static_mask[pn] && m_portb && m_fit && m_spread && m_interpod;
    sc.feas[n] = feas;
    sc.ip_raw[n] = ip_raw;
    if (n == at) {
      sh.s_at[0] = m_portb;
      sh.s_at[1] = m_spread;
      sh.s_at[2] = m_interpod;
      sh.s_at[3] = fit_own;
      sh.s_at[4] = sp_term;
      sh.s_at[5] = ip_term;
    }

    // first failure in the filter chain's order
    if (diagnose && a.node_valid[n]) {
      const bool comp[N_DIAG] = {a.d_unsched[pn] != 0, a.d_nodename[pn] != 0, a.d_taints[pn] != 0,
                                 a.d_nodeaff[pn] != 0, a.d_ports[pn] && m_portb, a.d_extra[pn] != 0,
                                 m_fit, m_spread, m_interpod};
      for (int r = 0; r < N_DIAG; ++r)
        if (!comp[r]) {
          red[1 + r] += 1;
          break;
        }
    }
    if (feas && !sampling) count_feasible(n, pn, ip_raw);
  }
  int processed = 0;
  if (sampling) {
    // the window: keep the feasible nodes up to the sample_k-th in visit
    // order (all of them when fewer are feasible)
    __syncthreads();  // every node's verdict is in sc.feas
    const int stop = window_stop(a, sc.feas, start, nv);
    processed = stop >= 0 ? stop + 1 : nv;
    for (int n = tid; n < N; n += blockDim.x) {
      const bool keep = sc.feas[n] && a.visit_rank[n] >= 0 && (stop < 0 || visit_pos(a, n, start, nv) <= stop);
      sc.feas[n] = keep;
      if (keep) count_feasible(n, (long long)p * N + n, sc.ip_raw[n]);
    }
  }
  block_reduce(red, red_op, 15, sh.s_buf);
  StepOut out;
  out.processed = processed;
  out.n_feas = red[0];
  for (int r = 0; r < N_DIAG; ++r) out.rc[r] = red[1 + r];

  // ---- spread score (_spread_raw): topology weights, then per-node raws
  long long sp_mn = I64_MAX, sp_mx = -I64_MAX, n_use = 0;
  if (C && a.w_spread) {
    for (int c = tid; c < C; c += blockDim.x) {
      const long long pc = (long long)p * C + c;
      const long long size = a.sp_is_host[pc] ? red[14] : sh.s_ndom[c];
      sh.s_wfx[c] = a.log_tab[size < 0 ? 0 : (size >= a.L ? a.L - 1 : size)];
    }
    __syncthreads();
    long long v[3] = {I64_MAX, -I64_MAX - 1, 0};
    const int op[3] = {RED_MIN, RED_MAX, RED_SUM};
    for (int n = tid; n < N; n += blockDim.x) {
      if (!sc.feas[n]) continue;
      const long long pn = (long long)p * N + n;
      long long raw = 0;
      bool use = true;
      if (has_soft) {
        use = a.sp_all_keys[pn];  // valid & feas == counted
        long long total_fx = 0;
        for (int c = 0; c < C; ++c) {
          const long long pc = (long long)p * C + c;
          if (!a.sp_soft[pc]) continue;
          total_fx += (long long)sc.sp_cnt[(long long)c * N + n] * sh.s_wfx[c] +
                      (long long)(a.max_skew[pc] - 1) * (1LL << FX);
        }
        const long long q = total_fx >> FX;  // arithmetic shift
        const long long frac = total_fx & ((1LL << FX) - 1);
        const long long half = 1LL << (FX - 1);
        raw = q + ((frac > half || (frac == half && (q & 1))) ? 1 : 0);
      }
      sc.sp_raw[n] = raw;
      if (use) {
        if (raw < v[0]) v[0] = raw;
        if (raw > v[1]) v[1] = raw;
        v[2] += 1;
      }
    }
    block_reduce(v, op, 3, sh.s_buf);
    sp_mn = v[0];
    sp_mx = v[1];
    n_use = v[2];
  }

  // ---- weighted total and the argmax over the feasible nodes: first max by
  // slot; with a tie key the (total, bits) maximum; in the window without
  // one, the first max in visit order
  long long best = -I64_MAX - 1;
  int best_t = I32_MAX, best_n = I32_MAX;
  const long long taint_mx = red[10], naff_mx = red[11], ip_mn = red[12], ip_mx = red[13];
  unsigned tk0 = (unsigned)a.tie_k0, tk1 = (unsigned)a.tie_k1;
  if (a.tie_on) rng::fold_in(tk0, tk1, (unsigned)a.attempt_base + (unsigned)p);
  for (int n = tid; n < N; n += blockDim.x) {
    if (!sc.feas[n]) continue;
    const long long pn = (long long)p * N + n;
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
      long long s = MAX_NODE_SCORE;  // C == 0: every feasible node is "used", mx == 0
      if (C) {
        const bool use = !has_soft || a.sp_all_keys[pn];
        s = 0;
        if (use && n_use > 0)
          s = sp_mx == 0 ? MAX_NODE_SCORE
                         : fdiv(MAX_NODE_SCORE * (sp_mx + sp_mn - sc.sp_raw[n]), sp_mx > 1 ? sp_mx : 1);
      }
      total += a.w_spread * s;
    }
    if (a.w_ip) {
      const long long diff = ip_mx - ip_mn;
      total += a.w_ip * (diff > 0 ? fdiv(MAX_NODE_SCORE * (sc.ip_raw[n] - ip_mn), diff) : 0);
    }
    if (a.w_fit || a.w_bal) {
      const long long a0 = a.allocatable[(long long)n * a.Rn + LANE_CPU];
      const long long a1 = a.allocatable[(long long)n * a.Rn + LANE_MEM];
      const long long c0 = (long long)a.nonzero[2 * n] + a.nonzero_req[2 * p];
      const long long c1 = (long long)a.nonzero[2 * n + 1] + a.nonzero_req[2 * p + 1];
      if (a.w_fit) total += a.w_fit * fit_score(a, a0, a1, c0, c1);
      total += score_total(a0, a1, c0, c1, (long long)a.requested[(long long)n * a.Rn + LANE_CPU] + req[LANE_CPU],
                           (long long)a.requested[(long long)n * a.Rn + LANE_MEM] + req[LANE_MEM], 0, 0, a.w_bal,
                           0);
    }
    if (a.w_img) total += a.w_img * a.sc_image[pn];
    if (a.extra_score) total += a.extra_score[pn];
    long long key = total;
    int tie = n;
    if (a.tie_on)
      key = total * (1LL << 33) + rng::bits_at(tk0, tk1, (unsigned)n);
    else if (sampling)
      tie = visit_pos(a, n, start, nv);
    better(best, best_t, best_n, key, tie, n);
  }
  __shared__ int s_best_t[32];
  const int lane = tid & 31, warp = tid >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const long long ov = __shfl_down_sync(FULL_MASK, best, off);
    const int ot = __shfl_down_sync(FULL_MASK, best_t, off);
    const int oi = __shfl_down_sync(FULL_MASK, best_n, off);
    better(best, best_t, best_n, ov, ot, oi);
  }
  if (lane == 0) {
    sh.s_best_v[warp] = best;
    s_best_t[warp] = best_t;
    sh.s_best_i[warp] = best_n;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    best = lane < n_warps ? sh.s_best_v[lane] : -I64_MAX - 1;
    best_t = lane < n_warps ? s_best_t[lane] : I32_MAX;
    best_n = lane < n_warps ? sh.s_best_i[lane] : I32_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const long long ov = __shfl_down_sync(FULL_MASK, best, off);
      const int ot = __shfl_down_sync(FULL_MASK, best_t, off);
      const int oi = __shfl_down_sync(FULL_MASK, best_n, off);
      better(best, best_t, best_n, ov, ot, oi);
    }
    __syncwarp();
    if (lane == 0) sh.s_best_i[0] = out.n_feas > 0 ? best_n : ABSENT;
  }
  __syncthreads();
  out.choice = sh.s_best_i[0];
  __syncthreads();  // s_best_i is written again by the next step
  return out;
}

// The usage commit of one placement (usage_carry_update); one thread.
__device__ __forceinline__ void commit_usage(const GangScanArgs& a, int p, int choice) {
  if (choice < 0) return;
  const int* req = a.requests + (long long)p * a.Rp;
  const int rn = a.Rn < a.Rp ? a.Rn : a.Rp;
  for (int r = 0; r < rn; ++r) a.requested[(long long)choice * a.Rn + r] += req[r];
  a.nonzero[2 * choice] += a.nonzero_req[2 * p];
  a.nonzero[2 * choice + 1] += a.nonzero_req[2 * p + 1];
  a.num_pods[choice] += 1;
}

// nextStartNodeIndex (schedule_one.go:625): the window's cursor advances by
// the nodes the step visited, for a real pod; one thread, after the step.
__device__ __forceinline__ void advance_cursor(const GangScanArgs& a, const StepOut& out) {
  if (a.sample_k <= 0) return;
  const int nv = a.n_valid > 1 ? a.n_valid : 1;
  *a.sample_start = (int)(((long long)*a.sample_start + out.processed) % nv);
}

// The step's outputs for pod p; one thread.
__device__ __forceinline__ void write_step(const GangScanArgs& a, int p, const StepOut& out) {
  a.chosen[p] = out.choice;
  a.n_feas[p] = out.n_feas;
  for (int r = 0; r < N_DIAG; ++r) a.reason_counts[(long long)p * N_DIAG + r] = out.rc[r];
}

}  // namespace step
}  // namespace ktpu

namespace ktpu {
namespace wave {

// ---------------------------------------------------------------------------
// The speculative wave's admission recurrence over term-factored carries,
// shared by K9 (wave_admit, csrc/wave.cu) and K11 (workloads_admit,
// csrc/workloads.cu), as the reference shares ops/wave.py's factored_*
// algebra between wave_schedule and workloads_schedule: the carries and
// the per-pod region, the peers' counts a step reads from them (WaveDyn),
// the per-pod sums (pod_tables) and the commit (commit_carries).
// ---------------------------------------------------------------------------

using step::dom_at;

// The regions.  Per pod (sums): g1 [C, Dsp], g2 [C, Dsp], seen [C, Dsp],
// gf [AT, D2], the admitting-term list [Tip] and the conflicting-port-term
// list [Tpt], then two list lengths and the any_dyn flag.  Carries:
// cnt_sp [Tsp, N], cnt_ip [Tip, N], rev_cnt [Tip, N], occ_pt [Tpt, N].
__host__ __device__ inline long long sums_cells(const GangScanArgs& a, const WaveArgs& w) {
  return 3LL * a.C * w.Dsp + (long long)a.AT * w.D2 + w.Tip + w.Tpt + 3;
}

__host__ __device__ inline long long carry_cells(const GangScanArgs& a, const WaveArgs& w) {
  return ((long long)w.Tsp + 2LL * w.Tip + w.Tpt) * a.N;
}

struct Region {
  int *g1, *g2, *seen, *gf, *rev, *conf, *n_rev, *n_conf, *any_dyn;
  int *cnt_sp, *cnt_ip, *rev_cnt, *occ_pt;
};

// The admitted batch peers' counts for pod p's step, from the carries and
// the per-pod sums.
struct WaveDyn {
  const GangScanArgs& a;
  const WaveArgs& w;
  Region r;
  int p;
  const unsigned char* dra_row;  // K11 with claims: pod p's DRA verdict per node (null: none)
  __device__ int f(int c, long long pc, int n, int d) const {
    const int t = w.tid_sp[pc];
    if (t < 0 || d < 0) return 0;
    if (a.sp_is_host[pc]) return a.sp_te[pc * a.N + n] ? r.cnt_sp[(long long)t * a.N + n] : 0;
    return r.g1[(long long)c * w.Dsp + d];
  }
  __device__ int sc(int c, long long pc, int n, int d, bool host) const {
    const int t = w.tid_sp[pc];
    if (t < 0) return 0;
    if (host) return r.cnt_sp[(long long)t * a.N + n];
    return d >= 0 ? r.g2[(long long)c * w.Dsp + d] : 0;
  }
  __device__ int ip(int u, long long pu, int n, int d) const {
    const int t = w.tid_ip[pu];
    if (t < 0 || d < 0) return 0;
    if (a.ip_key[pu] == w.hostname_key) return r.cnt_ip[(long long)t * a.N + n];
    return r.gf[(long long)u * w.D2 + d];
  }
  __device__ bool viol(int n) const {
    for (int i = 0; i < *r.n_rev; ++i) {
      const int t = r.rev[i];
      const long long ru = (long long)w.rep_ip_p[t] * a.AT + w.rep_ip_u[t];
      if (a.ip_is_anti[ru] && r.rev_cnt[(long long)t * a.N + n] > 0) return true;
    }
    return false;
  }
  __device__ long long sym(int n) const {
    long long s = 0;
    for (int i = 0; i < *r.n_rev; ++i) {
      const int t = r.rev[i];
      const long long ru = (long long)w.rep_ip_p[t] * a.AT + w.rep_ip_u[t];
      s += a.ip_sym_w[ru] * (long long)r.rev_cnt[(long long)t * a.N + n];
    }
    return s;
  }
  __device__ bool portb(int n) const {
    if (dra_row != nullptr && !dra_row[n]) return false;
    for (int i = 0; i < *r.n_conf; ++i)
      if (r.occ_pt[(long long)r.conf[i] * a.N + n] > 0) return false;
    return true;
  }
};

// Pod p's per-domain sums, admitting terms and conflicting port terms.
__device__ inline void pod_tables(const GangScanArgs& a, const WaveArgs& w, const Region& r, int p) {
  const int tid = threadIdx.x;
  const int C = a.C, AT = a.AT, N = a.N, P = a.P;
  for (long long i = tid; i < 2LL * C * w.Dsp; i += blockDim.x) r.g1[i] = 0;  // g1 and g2
  for (long long i = tid; i < (long long)AT * w.D2; i += blockDim.x) r.gf[i] = 0;
  if (tid == 0) {
    *r.n_rev = 0;
    *r.n_conf = 0;
    *r.any_dyn = 0;
  }
  __syncthreads();
  // the distinct inter-pod terms whose selector admits p (m_ip_all[:, p])
  for (int t = tid; t < w.Tip; t += blockDim.x) {
    const int rp = w.rep_ip_p[t];
    if (rp >= 0 && a.ip_bmatch[((long long)rp * AT + w.rep_ip_u[t]) * P + p]) r.rev[atomicAdd(r.n_rev, 1)] = t;
  }
  // the port terms p's own ports conflict with
  if (w.has_ports) {
    for (int t = tid; t < w.Tpt; t += blockDim.x) {
      bool conf = false;
      for (int k = 0; k < w.W && !conf; ++k) {
        const int tk = w.tid_pt[(long long)p * w.W + k];
        conf = tk >= 0 && w.port_conf[(long long)tk * w.Tpt + t];
      }
      if (conf) r.conf[atomicAdd(r.n_conf, 1)] = t;
    }
  }
  // the slots' carry rows per domain
  for (int c = 0; c < C; ++c) {
    const long long pc = (long long)p * C + c;
    const int t = w.tid_sp[pc];
    if (t < 0 || a.sp_is_host[pc]) continue;
    const int key = a.sp_key[pc];
    for (int n = tid; n < N; n += blockDim.x) {
      const int v = r.cnt_sp[(long long)t * N + n];
      if (!v) continue;
      const int d = dom_at(a, key, n);
      if (d < 0) continue;
      if (a.sp_te[pc * N + n]) atomicAdd(r.g1 + (long long)c * w.Dsp + d, v);
      if (a.sp_counting[pc * N + n]) atomicAdd(r.g2 + (long long)c * w.Dsp + d, v);
    }
  }
  for (int u = 0; u < AT; ++u) {
    const long long pu = (long long)p * AT + u;
    const int t = w.tid_ip[pu];
    if (t < 0) continue;
    const int key = a.ip_key[pu];
    const bool host = key == w.hostname_key;
    const bool aff = a.ip_is_aff[pu];
    for (int n = tid; n < N; n += blockDim.x) {
      const int v = r.cnt_ip[(long long)t * N + n];
      if (!v) continue;
      if (aff) *r.any_dyn = 1;
      if (host) continue;
      const int d = dom_at(a, key, n);
      if (d >= 0) atomicAdd(r.gf + (long long)u * w.D2 + d, v);
    }
  }
  __syncthreads();
}

// Commit pod p's placement at `choice` into the carries.
__device__ inline void commit_carries(const GangScanArgs& a, const WaveArgs& w, const Region& r, int p, int choice) {
  const int tid = threadIdx.x;
  const int C = a.C, AT = a.AT, N = a.N, P = a.P;
  // one node column per term that p matches (distinct t: no two threads
  // touch one cell)
  for (int t = tid; t < w.Tsp; t += blockDim.x) {
    const int rp = w.rep_sp_p[t];
    if (rp >= 0 && C && a.sp_bmatch[((long long)rp * C + w.rep_sp_c[t]) * P + p])
      r.cnt_sp[(long long)t * N + choice] += 1;
  }
  for (int t = tid; t < w.Tip; t += blockDim.x) {
    const int rp = w.rep_ip_p[t];
    if (rp >= 0 && AT && a.ip_bmatch[((long long)rp * AT + w.rep_ip_u[t]) * P + p])
      r.cnt_ip[(long long)t * N + choice] += 1;
  }
  if (w.has_ports && tid == 0)
    for (int k = 0; k < w.W; ++k) {
      const int t = w.tid_pt[(long long)p * w.W + k];
      if (t >= 0) r.occ_pt[(long long)t * N + choice] += 1;
    }
  // p's own terms over their topology domains (one thread per node)
  for (int n = tid; n < N; n += blockDim.x)
    for (int u = 0; u < AT; ++u) {
      const long long pu = (long long)p * AT + u;
      const int t = w.tid_ip[pu];
      if (t < 0 || a.ip_key_idx[pu] < 0) continue;
      const int key = a.ip_key[pu];
      const int at_dom = dom_at(a, key, choice);
      if (at_dom < 0) continue;
      const bool in = key == w.hostname_key ? n == choice : dom_at(a, key, n) == at_dom;
      if (in) r.rev_cnt[(long long)t * N + n] += 1;
    }
}

// The carries' and the per-pod region's layout over `sums` and `carries`
// (shared or global memory, as the kernel placed them).
__device__ inline Region make_region(const GangScanArgs& a, const WaveArgs& w, int* sums, int* carries) {
  Region r;
  r.g1 = sums;
  r.g2 = r.g1 + (long long)a.C * w.Dsp;
  r.seen = r.g2 + (long long)a.C * w.Dsp;
  r.gf = r.seen + (long long)a.C * w.Dsp;
  r.rev = r.gf + (long long)a.AT * w.D2;
  r.conf = r.rev + w.Tip;
  r.n_rev = r.conf + w.Tpt;
  r.n_conf = r.n_rev + 1;
  r.any_dyn = r.n_conf + 1;
  r.cnt_sp = carries;
  r.cnt_ip = r.cnt_sp + (long long)w.Tsp * a.N;
  r.rev_cnt = r.cnt_ip + (long long)w.Tip * a.N;
  r.occ_pt = r.rev_cnt + (long long)w.Tip * a.N;
  return r;
}

// The dynamic shared memory of an admission kernel (K9, K11): s_wfx [C]
// (int64), s_min [C], s_ndom [C], then the per-pod region when sums_smem
// and the carries when carry_smem.
inline size_t admit_smem(const GangScanArgs& a, const WaveArgs& w) {
  size_t bytes = (size_t)a.C * (sizeof(long long) + 2 * sizeof(int));
  if (w.sums_smem) bytes += (size_t)sums_cells(a, w) * sizeof(int);
  if (w.carry_smem) bytes += (size_t)carry_cells(a, w) * sizeof(int);
  return bytes;
}

// ---------------------------------------------------------------------------
// The admission kernel, one persistent block of ADMIT_THREADS that loops
// over the pods.  admit_kernel<false> is K9 (wave.cu: the demotion stats
// against the speculative node c0); admit_kernel<true> is K11
// (workloads.cu: the gang checkpoint and rollback, no demotion stats).
// Each source instantiates its own mode, so the two never share a symbol.
// ---------------------------------------------------------------------------

constexpr int ADMIT_THREADS = 1024;

enum Demote { DEMOTE_NONE = 0, DEMOTE_SPREAD = 1, DEMOTE_AFFINITY = 2, DEMOTE_SCORE = 3, DEMOTE_FIT = 4,
              DEMOTE_UPGRADE = 5, DEMOTE_PORTS = 6 };

// K11: block-wide copy of the carried state into the checkpoint (save) or
// back out of it.  The carries cnt_sp, cnt_ip and rev_cnt are contiguous
// from r.cnt_sp (make_region), and occ_pt is empty (no ports).  With DRA
// the allocation carries follow: claim_node's CL ints, then free's bytes.
__device__ inline void checkpoint(const GangScanArgs& a, const WaveArgs& w, const WorkloadsArgs& k, const Region& r,
                                  bool save) {
  int* const seg[5] = {a.requested, a.nonzero, a.num_pods, k.assigned, r.cnt_sp};
  const long long len[5] = {(long long)a.N * a.Rn, 2LL * a.N, (long long)a.N, (long long)a.P,
                            ((long long)w.Tsp + 2LL * w.Tip) * a.N};
  long long off = 0;
  for (int s = 0; s < 5; ++s) {
    int* const st = seg[s];
    int* const ck = k.ckpt + off;
    for (long long i = threadIdx.x; i < len[s]; i += blockDim.x) {
      if (save) ck[i] = st[i];
      else st[i] = ck[i];
    }
    off += len[s];
  }
  if (k.dra_match != nullptr) {
    int* const ck = k.ckpt + off;
    for (int i = threadIdx.x; i < k.CL; i += blockDim.x) {
      if (save) ck[i] = k.claim_node[i];
      else k.claim_node[i] = ck[i];
    }
    unsigned char* const ckb = reinterpret_cast<unsigned char*>(ck + k.CL);
    for (long long i = threadIdx.x; i < (long long)a.N * k.DD; i += blockDim.x) {
      if (save) ckb[i] = k.free[i];
      else k.free[i] = ckb[i];
    }
  }
}

// K11 with claims: pod p's rows of WorkloadsArgs.
__device__ __forceinline__ dra::PodRows dra_rows(const WorkloadsArgs& k, int N, int p) {
  return dra::pod_rows(k.dra_match, k.req_count, k.req_all, k.req_cl, k.q_valid, k.req_bad, k.ref_cl, p, k.DQ, k.CQ,
                       N, k.DD, k.CL);
}

// K11 with claims: commit pod p's placement at `choice` into the allocation
// carries (ops/dra.py dra_commit): its take row at the chosen node leaves
// `free`, and every claim it references that is still unallocated pins to
// the node.  One thread.
__device__ inline void dra_commit(const WorkloadsArgs& k, int N, int p, int choice) {
  dra::node_take(dra_rows(k, N, p), k.free, k.claim_node, choice,
                 k.dra_scratch == nullptr ? nullptr : k.dra_scratch + (long long)threadIdx.x * dra::scratch_words(k.DD));
  for (int c = 0; c < k.CQ; ++c) {
    const int cl = k.ref_cl[(long long)p * k.CQ + c];
    if (cl >= 0 && cl < k.CL && k.claim_node[cl] < 0) k.claim_node[cl] = choice;
  }
}

template <bool kGangs>
__global__ void __launch_bounds__(ADMIT_THREADS)
    admit_kernel(const GangScanArgs a, const WaveArgs w, const WorkloadsArgs k) {
  using namespace step;
  // dynamic: s_wfx [C] (int64), s_min [C], s_ndom [C], then the per-pod
  // region when sums_smem and the carries when carry_smem
  extern __shared__ long long s_dyn[];
  __shared__ long long s_buf[32 * 16];
  __shared__ long long s_best_v[32];
  __shared__ int s_best_i[32];
  __shared__ int s_at[6];
  const int tid = threadIdx.x;
  const int C = a.C;
  const StepShared sh{s_buf, s_dyn, reinterpret_cast<int*>(s_dyn + C), reinterpret_cast<int*>(s_dyn + C) + C,
                      s_best_v, s_best_i, s_at};
  int* next = sh.s_ndom + C;
  int* sums = w.sums;
  if (w.sums_smem) {
    sums = next;
    next += sums_cells(a, w);
  }
  int* carries = w.carries;
  if (w.carry_smem) {
    carries = next;
    for (long long i = tid; i < carry_cells(a, w); i += blockDim.x) carries[i] = 0;
  }
  if (w.sums_smem)  // the domain stamps start at 0 (global ones: the wrapper)
    for (long long i = tid; i < (long long)C * w.Dsp; i += blockDim.x) sums[2LL * C * w.Dsp + i] = 0;
  const Region r = make_region(a, w, sums, carries);
  const StepScratch sc{a.feas, a.ip_raw, a.sp_raw, a.sp_cnt, r.seen, w.Dsp};
  if constexpr (kGangs) {
    // the first gang member that saves and the first that may restore: the
    // checkpoint starts as the initial state (the reference's carry), which
    // only a gang whose last member comes before any first member reads;
    // plan_batch never lays one out, so the copy is normally skipped
    __shared__ int s_order[2];
    if (tid == 0) s_order[0] = s_order[1] = a.P;
    for (int i = tid; i < a.P; i += blockDim.x) k.assigned[i] = ABSENT;
    for (int i = tid; i < k.g_cap; i += blockDim.x) {
      k.gang_admit[i] = -1;
      k.gang_landed[i] = 0;
    }
    __syncthreads();
    for (int i = tid; i < a.P; i += blockDim.x)
      if (k.gang_id[i] >= 0) {
        if (k.gang_first[i]) atomicMin(&s_order[0], i);
        if (k.gang_last[i]) atomicMin(&s_order[1], i);
      }
    __syncthreads();
    if (s_order[1] < s_order[0]) checkpoint(a, w, k, r, true);
  }
  __syncthreads();

  int landed = 0;  // K11: the same in every thread, each reads the step's choice
  for (int p = 0; p < a.P; ++p) {
    int gid = -1;
    bool is_first = false;
    if constexpr (kGangs) {
      gid = k.gang_id[p];
      is_first = gid >= 0 && k.gang_first[p];
      if (is_first) {  // the state before the first member's own step
        checkpoint(a, w, k, r, true);
        __syncthreads();
      }
    }
    int choice = ABSENT;
    if (!a.valid[p]) {  // a pad row: nothing feasible, nothing committed
      if (tid == 0) {
        write_step(a, p, StepOut{ABSENT, 0, {0, 0, 0, 0, 0, 0, 0, 0, 0}});
        if constexpr (!kGangs) {
          w.kinds[p] = DEMOTE_NONE;
          w.cterms[p] = -1;
        }
      }
    } else {
      const unsigned char* dra_row = nullptr;
      if constexpr (kGangs) {
        if (k.dra_match != nullptr) {  // the pod's DRA verdict per node, its port lane
          const dra::PodRows dr = dra_rows(k, a.N, p);
          unsigned long long* const words =
              k.dra_scratch == nullptr ? nullptr : k.dra_scratch + (long long)tid * dra::scratch_words(k.DD);
          for (int n = tid; n < a.N; n += blockDim.x)
            k.dra_row[n] = dra::node_verdict_any(dr, k.free, k.claim_node, n, words);
          dra_row = k.dra_row;
          __syncthreads();
        }
      }
      pod_tables(a, w, r, p);
      const int spec = kGangs ? -1 : w.c0[p];
      const StepOut out = pod_step_block(a, p, WaveDyn{a, w, r, p, dra_row}, *r.any_dyn != 0, sc, sh, spec);
      choice = out.choice;
      if (choice >= 0) commit_carries(a, w, r, p, choice);
      if (tid == 0) {
        if constexpr (kGangs) {
          k.assigned[p] = choice;
          if (k.dra_match != nullptr && choice >= 0) dra_commit(k, a.N, p, choice);
        } else {  // the demotion, from the pre-commit verdict at the speculative node
          int kind = DEMOTE_NONE, cterm = -1;
          if (choice != spec) {
            if (spec < 0) kind = DEMOTE_UPGRADE;
            else if (!s_at[0]) kind = DEMOTE_PORTS;
            else if (!s_at[1]) kind = DEMOTE_SPREAD;
            else if (!s_at[2]) kind = DEMOTE_AFFINITY;
            else if (a.check_fit && !s_at[3]) kind = DEMOTE_FIT;
            else kind = DEMOTE_SCORE;
            cterm = kind == DEMOTE_SPREAD ? s_at[4] : (kind == DEMOTE_AFFINITY ? s_at[5] : -1);
          }
          w.kinds[p] = kind;
          w.cterms[p] = cterm;
        }
        write_step(a, p, out);
        commit_usage(a, p, choice);
        advance_cursor(a, out);
      }
    }
    bool fail = false;
    if constexpr (kGangs) {
      landed = (is_first ? 0 : landed) + (gid >= 0 && choice >= 0 ? 1 : 0);
      const bool is_last = gid >= 0 && k.gang_last[p];
      fail = is_last && landed < k.gang_need[p];
      if (is_last && tid == 0 && gid < k.g_cap) {
        k.gang_admit[gid] = fail ? 0 : 1;
        k.gang_landed[gid] = landed;
      }
    }
    __syncthreads();  // the commits are visible to every thread of the block
    if (fail) {  // K11: the gang rolls back whole
      checkpoint(a, w, k, r, false);
      __syncthreads();
    }
  }
}

// The dynamic shared memory one admission block may take on this device:
// the opt-in per-block limit less the kernel's static shared memory.
template <bool kGangs>
int admit_smem_max() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, admit_kernel<kGangs>) != cudaSuccess) return 0;
  return optin - (int)fa.sharedSizeBytes;
}

// Enqueues the admission kernel on `stream` and returns the launch status
// (cudaGetLastError).
template <bool kGangs>
int admit_launch(const GangScanArgs& a, const WaveArgs& w, const WorkloadsArgs& k, void* stream) {
  if (!kGangs && a.P == 0) return 0;
  const size_t smem = admit_smem(a, w);
  cudaError_t e = cudaFuncSetAttribute(admit_kernel<kGangs>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  admit_kernel<kGangs><<<1, ADMIT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a, w, k);
  return (int)cudaGetLastError();
}

}  // namespace wave
}  // namespace ktpu
