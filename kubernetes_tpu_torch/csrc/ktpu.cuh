// Shared constants and argument blocks of the port's CUDA kernels.
//
// The sentinels and codes are the packed schema's (snapshot/interner.py,
// snapshot/selectors.py, snapshot/schema.py); the argument structs are
// mirrored field for field by ctypes.Structure classes in ops/_build.py, so
// any change here is made there too.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>
#include <vector>

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

// NodeResourcesFit's pod count: one more pod fits under `allowed`.
__device__ __forceinline__ bool pods_fit(int num_pods, int allowed) { return num_pods + 1 <= allowed; }

// NodeResourcesFit's rule for lane r of a request: the request v fits in
// `room` (allocatable minus used); an all-zero request skips the lanes, and
// an unrequested extended lane always fits.
__device__ __forceinline__ bool lane_fits(bool all_zero, int r, long long v, long long room) {
  return all_zero || (r >= N_FIXED_LANES && v == 0) || v <= room;
}

// NodeResourcesFit in integer form: the pod count, then every lane of the
// request (lane_fits), where `extra` (a request row committed on top of
// `used`, or nullptr) is added to the usage.
__device__ __forceinline__ bool fits(const long long* req, bool all_zero,
                                     const long long* alloc,
                                     const long long* used,
                                     const long long* extra, int num_pods,
                                     int allowed, int R) {
  if (!pods_fit(num_pods, allowed)) return false;
  for (int r = 0; r < R; ++r)
    if (!lane_fits(all_zero, r, req[r], alloc[r] - used[r] - (extra ? extra[r] : 0))) return false;
  return true;
}

// LeastAllocated's term for one of the cpu and memory lanes, as n / d:
// (al - c) * MAX_NODE_SCORE / al with allocatable al > 0 and the non-zero
// request sum c <= al; else n = 0, d = 1.
__device__ __forceinline__ void least_parts(long long al, long long c, long long& n, long long& d) {
  if (al > 0 && c <= al) {
    n = (al - c) * MAX_NODE_SCORE;
    d = al;
  } else {
    n = 0;
    d = 1;
  }
}

// LeastAllocated from its two terms' sum: their mean over the lanes with
// allocatable > 0 (a lane without is a term of 0).
__device__ __forceinline__ long long least_mean(long long sum, long long a0, long long a1) {
  return a0 > 0 && a1 > 0 ? sum / 2 : sum;
}

// BalancedAllocation's numerator and denominator, its score MAX_NODE_SCORE
// - n / d: with a0, a1 > 0, r0 / r1 clamped to them, n = 50 |r0 a1 - r1 a0|
// + d - 1 and d = a0 a1 (the ceiling of 50 |.| / d); else n = 0, d = 1.
// (K2's key_warp divides it, and least_parts' two, on lanes of their own.)
__device__ __forceinline__ void balanced_parts(long long a0, long long a1, long long r0, long long r1, long long& n,
                                               long long& d) {
  if (a0 > 0 && a1 > 0) {
    if (r0 > a0) r0 = a0;
    if (r1 > a1) r1 = a1;
    long long x = r0 * a1 - r1 * a0;
    if (x < 0) x = -x;
    d = a0 * a1;
    n = 50 * x + d - 1;
  } else {
    n = 0;
    d = 1;
  }
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
    long long n0, d0, n1, d1;
    least_parts(a0, c0, n0, d0);
    least_parts(a1, c1, n1, d1);
    total += w_fit * least_mean(n0 / d0 + n1 / d1, a0, a1);
  }
  if (w_bal) {
    long long n, d;
    balanced_parts(a0, a1, r0, r1, n, d);
    total += w_bal * (MAX_NODE_SCORE - n / d);
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
  // the trees (csrc/sig_scan.cu), scratch allocated by the wrapper: per
  // signature a leaf per node, its n1 = ceil(N / 32) groups and its root
  // (M = n1 + 1 entries a tree: the S n1 groups, then the S roots)
  unsigned char* present;           // [S]     the signature occurs in the batch
  long long* sig_rows;              // [S, R + 3] request, non-zero cpu / memory, all-zero flag
  int* tree_sig;                    // [S]     the present signatures, in order
  long long* leaves;                // [S, N]  each node's key (score, -1 infeasible)
  long long* lv_val;                // [S M]   the groups' and roots' keys
  int* lv_idx;                      // [S M]   their nodes
  long long* info;                  // [5] out: the placed pods, then the cycles (summed over them,
                                    // in the warp that repairs the pod's own tree) of the chosen
                                    // row, the keys, the repairs and the barrier (null: not written)
  int P, N, R, S;
  int w_fit, w_bal, w_img, check_fit;
  int tree_smem;                    // out: the scan's parts in shared memory (0 none, 1 the
                                    // request rows, tree list and roots, 2 and the groups)
  int launches;                     // out: the kernels ktpu_sig_scan enqueued
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
  const int* dom_size;              // [K]    distinct domains per key (DeviceCluster.dom_size)
  const int* dom_off;               // [K + 1] prefix sums of dom_size
  const int* dom_vals;              // [DSUM]  each domain's label value id, at dom_off[key] + domain
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
  // scratch
  int* rep;                         // [P * C] (classes) the first constraint with the same selector and namespace
  unsigned* match;                  // [P * C, EW] bit e: placed pod e matches the (representative) constraint
  unsigned long long* span;         // [span_rows, 2] per kernel and SM: ~first start, last end (globaltimer ns)
  int N, K, NVI, E, P, C, R, V, EW, D, hostname_key, smem_cap, class_ratio, span_rows;
};

// K7: the inter-pod half of the gang precompute and the host-port masks
// (csrc/gang_statics.cu).
struct GangInterpodArgs {
  // cluster
  const int* node_labels;           // [N, K]
  const int* val_ints;              // [NVI]
  const int* dom_ids;               // [K, N]
  const int* dom_size;              // [K]     distinct domains per key
  const int* dom_off;               // [K + 1] prefix sums of dom_size (DeviceCluster.dom_off)
  const int* dom_vals;              // [DSUM]  each domain's label value id, at dom_off[key] + domain
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
  int* ext_term;                    // [M, 4] per placed term: key (-1: never counts), domain, symmetric weight, anti
  int* key_used;                    // [K]    some live placed term uses the key
  int* inc_rep;                     // [P * AT] (classes) the first term with the same selector and namespace set
  unsigned* inc_match;              // [P * AT, EW] bit e: placed pod e matches the (representative) term
  unsigned long long* span;         // [span_rows, 2] per kernel and SM: ~first start, last end (globaltimer ns)
  int N, K, NVI, E, M, TR, TV, TNS, U, P, AT, AR, AV, NS, W, EW;
  int DSUM, D, hard_weight, do_interpod, do_ports, smem_cap, class_ratio, span_rows;
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
  int* cnt_h;                       // [C, N]   K5: peers per node (score)
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
  int N, K, Rn, Rp, L, P, C, AT, KD2, D, JP;
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
  int* sums;                        // K5, K9, K11: [cluster, xch_cells] the CTAs' exchange slabs
                                    // unless sums_smem (see gang_scan.cu, wave.cu)
  int* carries;                     // K9, K11: [(Tsp + 2 Tip + Tpt) * N] unless carry_smem;
                                    // K5: [cluster, (2 C + AT + 2 KD2) * D] the CTAs' peer
                                    // counters unless carry_smem
  const unsigned char* lane;        // K8: [P, N] the port lane (null: every port free); the
                                    // workloads dispatch's DRA verdict against free0
  int* admit_info;                  // K5, K9, K11: [2 + CL_PHASES] out: the cluster's CTAs, its
                                    // exchanges over the batch, the leader's cycles per phase
                                    // (null: not written)
  long long* spec_info;             // K8: [P, 2 + SPEC_PHASES] out: each pod's group's start and
                                    // end (globaltimer ns) and its thread 0's cycles per phase
                                    // (null: not written)
  int Tsp, Tip, Tpt, W, Dsp, D2, hostname_key, has_ports, sums_smem, carry_smem;
  // K5, K9 and K11 (ktpu_gang_scan_plan, admit_plan): the cluster's
  // CTAs, the nodes of each CTA's slice, the slice's usage and step rows in
  // shared memory, the ints of one CTA's exchange slab, and the staging of
  // the slice's node statics and of each pod's planes in shared memory.  K5
  // reads no term tables (tid_sp / tid_ip null, Tsp = Tip = Tpt = 0).
  int cluster, slice, rows_smem, xch_cells, stage;
};

// The gang admission's rows and outputs (csrc/workloads.cu): K11 takes a
// GangScanArgs (whose `chosen` receives each step's choice before any
// rollback, the `raw` output), a WaveArgs without ports, laid out for the
// cluster as K9's, and this block.  In a batch with DRA claims (dra_match
// not null) it also takes K13's match tensor, the request rows of
// ops/dra.py dra_tables and the two allocation carries, updated in place.
// K9 gets an empty one.
struct WorkloadsArgs {
  const int* gang_id;               // [P]      gang slot per pod (-1: none)
  const unsigned char* gang_first;  // [P]      the gang's first member
  const unsigned char* gang_last;   // [P]      the gang's last member
  const int* gang_need;             // [P]      members the gang must place
  int* assigned;                    // [P]      out: the choices after rollback
  int* gang_admit;                  // [g_cap]  out: -1 unjudged, 0 rolled back, 1 admitted
  int* gang_landed;                 // [g_cap]  out: members placed in the batch
  int* choice_log;                  // [cluster, P] scratch: each CTA's copy of the choices (the undo)
  int* undone;                      // [1]      out: placements the rollbacks undid (null: not written)
  const unsigned char* dra_match;   // [P, DQ, N, DD] K13's match (null: no DRA)
  const int* req_count;             // [P, DQ]  ExactCount count
  const unsigned char* req_all;     // [P, DQ]  AllocationMode=All
  const int* req_cl;                // [P, DQ]  owning claim slot (-1 pad)
  const unsigned char* q_valid;     // [P, DQ]
  const unsigned char* req_bad;     // [P, DQ]  device class missing
  const int* ref_cl;                // [P, CQ]  claim slots the pod references
  unsigned char* free;              // [N, DD]  carry: no allocated claim holds the device
  int* claim_node;                  // [CL]     carry: node of a referenced claim (-1 none); in: the
                                    // batch's start, out: its end
  unsigned char* dra_row;           // [N]      scratch: the step's DRA verdict per node
  unsigned long long* dra_scratch;  // [cluster * CLUSTER_THREADS, 2 ceil(DD/64)] per-thread verdict
                                    // words past dra::REG_DD slots (null below)
  unsigned long long* take_log;     // [P, ceil(DD/64)] scratch: the devices each pod took (the undo)
  int* claims;                      // [cluster, 2 CL] scratch: each CTA's copy of claim_node and the
                                    // pinners, unless claims_smem
  int g_cap, DQ, DD, CQ, CL, claims_smem;
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
// active slots take (the walk of node_feasible with take_acc); the cleared
// devices go to `log` as ceil(DD / 64) bit words (K11's undo).
template <int W>
__device__ __forceinline__ void take_words(const PodRows& r, unsigned char* free, const int* claim_node, int n,
                                           unsigned long long* scratch, unsigned long long* log) {
  const int nw = (r.DD + 63) >> 6;
  unsigned long long fs_r[W > 0 ? W : 1], m_r[W > 0 ? W : 1];
  unsigned long long* fs = W > 0 ? fs_r : scratch;
  unsigned long long* m = W > 0 ? m_r : scratch + nw;
  verdict_words(r, free, claim_node, n, true, fs, m);
  unsigned char* const fr = free + (long long)n * r.DD;
  for (int w = 0; w < nw; ++w) log[w] = 0;
  for (int d = 0; d < r.DD; ++d)
    if (fr[d] && !((fs[d >> 6] >> (d & 63)) & 1ULL)) {
      fr[d] = 0;
      log[d >> 6] |= 1ULL << (d & 63);
    }
}

__device__ __forceinline__ void node_take(const PodRows& r, unsigned char* free, const int* claim_node, int n,
                                          unsigned long long* scratch, unsigned long long* log) {
  if (r.DD <= 64) take_words<1>(r, free, claim_node, n, scratch, log);
  else if (r.DD <= 128) take_words<2>(r, free, claim_node, n, scratch, log);
  else if (r.DD <= REG_DD) take_words<4>(r, free, claim_node, n, scratch, log);
  else take_words<0>(r, free, claim_node, n, scratch, log);
}

}  // namespace dra
}  // namespace ktpu

namespace ktpu {
namespace step {

// ---------------------------------------------------------------------------
// The gang path's per-pod step, shared by K5 (gang_scan), K9 (wave_admit)
// and K11 (workloads_admit), as the reference shares gang.pod_step,
// spread_constraints and interpod_constraints between the scan, the wave's
// admission and the workloads' (K8, the speculation, has a body of its own
// in csrc/wave.cu, with no batch peers, over the same per-node helpers:
// step_fits, spread_verdict, interpod_verdict, count_feasible, spread_raw,
// node_total): the dynamic resource fit, the spread and
// inter-pod verdicts from the batch peers' counts, the first-failure reason
// counts in DIAG_KERNELS order, the seven weighted scores with their
// normalizations over the live feasible set, and the first-max argmax (ties
// to the lower node index).  It carries the reference's optional branches
// too: the NodeResourcesFit strategy (strat_id, fit_score), the sampling
// window (sample_k: the feasible set cut to the first sample_k feasible
// nodes in visit order from the cursor, a prefix count walking
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
// Who steps which nodes, and how the cluster-wide parts combine, is the
// caller's policy (ClusterPolicyT below).
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

// The usage state's rows, node n at row n - lo: requested [., Rn], nonzero
// [., 2] and num_pods [.].  All N nodes in global memory (lo = 0), or, in
// K9's cluster, the CTA's slice in its shared memory.
struct UsageRows {
  int* requested;
  int* nonzero;
  int* num_pods;
  int lo;
  __device__ __forceinline__ int& req(int Rn, int n, int r) const { return requested[(long long)(n - lo) * Rn + r]; }
  __device__ __forceinline__ int& nz(int n, int l) const { return nonzero[2LL * (n - lo) + l]; }
  __device__ __forceinline__ int& pods(int n) const { return num_pods[n - lo]; }
};

__device__ __forceinline__ UsageRows usage_rows(const GangScanArgs& a) {
  return UsageRows{a.requested, a.nonzero, a.num_pods, 0};
}

// The cluster's per-node statics, node n at n - lo and dom_ids' rows ld
// wide: all N nodes in global memory (lo = 0, ld = N), or K9's copy of a
// CTA's slice in its shared memory.
struct NodeRows {
  const int* allocatable;   // [., Rn]
  const int* allowed_pods;  // [.]
  const unsigned char* node_valid;
  const int* visit_rank;    // [.] (null without the sampling window)
  const int* dom_ids;       // [K, ld]
  int lo, ld, K, Rn;
  __device__ __forceinline__ int alloc(int n, int r) const { return allocatable[(long long)(n - lo) * Rn + r]; }
  __device__ __forceinline__ int allowed(int n) const { return allowed_pods[n - lo]; }
  __device__ __forceinline__ bool valid(int n) const { return node_valid[n - lo] != 0; }
  __device__ __forceinline__ int vrank(int n) const { return visit_rank[n - lo]; }
  // node n's compact domain id under topology key `key` (-1: absent)
  __device__ __forceinline__ int dom(int key, int n) const {
    return key >= 0 && key < K ? dom_ids[(long long)key * ld + n - lo] : -1;
  }
};

__device__ __forceinline__ NodeRows global_nodes(const GangScanArgs& a) {
  return NodeRows{a.allocatable, a.allowed_pods, a.node_valid, a.visit_rank, a.dom_ids, 0, a.N, a.K, a.Rn};
}

// Pod p's rows of the [P, N] statics and its slots' rows of the [P, C, N] /
// [P, AT, N] ones, node n at n - lo and slot rows ld apart: global memory
// (lo = 0, ld = N), or K9's staged copy of a CTA's slice.  `extra` is null
// without an extra score.
struct PodPlanes {
  const unsigned char *mask, *all_keys, *viol, *d_unsched, *d_nodename, *d_taints, *d_nodeaff, *d_ports, *d_extra;
  const long long *ip_sym, *sc_taint, *sc_nodeaff, *sc_image, *extra;
  const unsigned char *sp_te, *sp_dom_pres, *sp_counting;  // [C, ld]
  const int *sp_dom_cnt, *sp_node_cnt, *sp_sc_dom;          // [C, ld]
  const int* ip_dom_cnt;                                    // [AT, ld]
  int lo, ld;
  __device__ __forceinline__ long long at(int n) const { return n - lo; }
  __device__ __forceinline__ long long at(int c, int n) const { return (long long)c * ld + n - lo; }
  // the values the shared per-node verdicts read (spread_verdict and the
  // rest below), at node n of slot c / term u
  __device__ __forceinline__ int dom_cnt(int c, int n) const { return sp_dom_cnt[at(c, n)]; }
  __device__ __forceinline__ bool dom_pres(int c, int n) const { return sp_dom_pres[at(c, n)]; }
  __device__ __forceinline__ int node_cnt(int c, int n) const { return sp_node_cnt[at(c, n)]; }
  __device__ __forceinline__ int sc_dom(int c, int n) const { return sp_sc_dom[at(c, n)]; }
  __device__ __forceinline__ int ip_cnt(int u, int n) const { return ip_dom_cnt[at(u, n)]; }
  __device__ __forceinline__ long long sym(int n) const { return ip_sym[at(n)]; }
  __device__ __forceinline__ bool violated(int n) const { return viol[at(n)]; }
  __device__ __forceinline__ long long taint(int n) const { return sc_taint[at(n)]; }
  __device__ __forceinline__ long long naff(int n) const { return sc_nodeaff[at(n)]; }
  __device__ __forceinline__ bool counted(int n) const { return all_keys[at(n)]; }
};

__device__ __forceinline__ PodPlanes global_planes(const GangScanArgs& a, int p) {
  const long long pn = (long long)p * a.N, pc = pn * a.C, pu = pn * a.AT;
  return PodPlanes{a.static_mask + pn, a.sp_all_keys + pn, a.ip_viol_existing + pn, a.d_unsched + pn,
                   a.d_nodename + pn, a.d_taints + pn, a.d_nodeaff + pn, a.d_ports + pn, a.d_extra + pn,
                   a.ip_sym + pn, a.sc_taint + pn, a.sc_nodeaff + pn, a.sc_image + pn,
                   a.extra_score != nullptr ? a.extra_score + pn : nullptr,
                   a.sp_te + pc, a.sp_dom_pres + pc, a.sp_counting + pc, a.sp_dom_cnt + pc, a.sp_node_cnt + pc,
                   a.sp_sc_dom + pc, a.ip_dom_cnt + pu, 0, a.N};
}

// Per-node rows of one step, node n at n - lo and sp_cnt's row c ld wide:
// global memory over all N nodes (lo = 0, ld = N), or a cluster CTA's
// slice in its shared memory.  `use` is the usage state the step reads.
struct StepScratch {
  unsigned char* feas;  // [N]
  long long* ip_raw;    // [N]
  long long* sp_raw;    // [N]
  int* sp_cnt;          // [C, ld] the spread score's per-node counts
  int lo, ld;
  UsageRows use;
  NodeRows nodes;
  __device__ __forceinline__ unsigned char& feas_of(int n) const { return feas[n - lo]; }
  __device__ __forceinline__ long long& ip_of(int n) const { return ip_raw[n - lo]; }
  __device__ __forceinline__ long long& sp_of(int n) const { return sp_raw[n - lo]; }
  __device__ __forceinline__ int& cnt_of(int c, int n) const { return sp_cnt[(long long)c * ld + n - lo]; }
};

// The global rows of a step over all N nodes.
__device__ __forceinline__ StepScratch global_scratch(const GangScanArgs& a, unsigned char* feas, long long* ip_raw,
                                                      long long* sp_raw, int* sp_cnt) {
  return StepScratch{feas, ip_raw, sp_raw, sp_cnt, 0, a.N, usage_rows(a), global_nodes(a)};
}

// The CTA's shared memory for a step.
struct StepShared {
  long long* s_wfx;     // [C] topology weights
  int* s_min;           // [C] min-match
  int* s_ndom;          // [C] distinct counted domains
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

// The spread score's raw at a node from its 32.32 fixed-point sum
// (_spread_raw): an arithmetic >> and round-half-to-even.
__device__ __forceinline__ long long spread_round(long long total_fx) {
  const long long q = total_fx >> FX;  // arithmetic shift
  const long long frac = total_fx & ((1LL << FX) - 1);
  const long long half = 1LL << (FX - 1);
  return q + ((frac > half || (frac == half && (q & 1))) ? 1 : 0);
}

// One pod's score normalizers over its feasible set: the taint and
// node-affinity raws' maxima (0 when none is positive), the inter-pod
// raws' min and max, and the spread raws' min, max and count over the
// nodes that count (n_use).
struct ScoreNorms {
  long long taint_mx, naff_mx, ip_mn, ip_mx, sp_mn, sp_mx, n_use;
};

// A feasible node's weighted total before the extra score: the seven
// weighted scores, each normalized over the feasible set as the reference
// does.  `slots`: the pod has spread slots (C > 0); `sp_use`: the node
// counts for the spread score; a0 / a1 the cpu / memory allocatable, c0 /
// c1 the non-zero request sums (node + pod), r0 / r1 the used + requested
// cpu / memory.
__device__ __forceinline__ long long node_total(const GangScanArgs& a, const ScoreNorms& m, bool slots, bool sp_use,
                                                long long taint, long long naff, long long sp_raw, long long ip_raw,
                                                long long a0, long long a1, long long c0, long long c1, long long r0,
                                                long long r1, long long img) {
  long long total = 0;
  if (a.w_taint)
    total += a.w_taint * (m.taint_mx > 0 ? MAX_NODE_SCORE - fdiv(MAX_NODE_SCORE * taint, m.taint_mx) : MAX_NODE_SCORE);
  if (a.w_naff) total += a.w_naff * (m.naff_mx > 0 ? fdiv(MAX_NODE_SCORE * naff, m.naff_mx) : naff);
  if (a.w_spread) {
    long long s = MAX_NODE_SCORE;  // no slot: every feasible node is "used", mx == 0
    if (slots) {
      s = 0;
      if (sp_use && m.n_use > 0)
        s = m.sp_mx == 0 ? MAX_NODE_SCORE : fdiv(MAX_NODE_SCORE * (m.sp_mx + m.sp_mn - sp_raw), m.sp_mx > 1 ? m.sp_mx : 1);
    }
    total += a.w_spread * s;
  }
  if (a.w_ip) {
    const long long diff = m.ip_mx - m.ip_mn;
    total += a.w_ip * (diff > 0 ? fdiv(MAX_NODE_SCORE * (ip_raw - m.ip_mn), diff) : 0);
  }
  if (a.w_fit || a.w_bal) {
    if (a.w_fit) total += a.w_fit * fit_score(a, a0, a1, c0, c1);
    total += score_total(a0, a1, c0, c1, r0, r1, 0, 0, a.w_bal, 0);
  }
  if (a.w_img) total += a.w_img * img;
  return total;
}

// A node's place in the rotation from the cursor (the walk's position),
// from its visit rank.
__device__ __forceinline__ int visit_pos(int rank, int start, int nv) {
  int r = (rank - start) % nv;
  return r < 0 ? r + nv : r;
}

// The sampling window's walk: the position, in visit order from `start`, of
// the sample_k-th feasible node (feas(n): node n's verdict), or -1 when fewer
// are feasible.  Chunks of blockDim positions, one ballot and a per-warp
// prefix each; it stops at the chunk that reaches sample_k.  Every thread
// gets the result.
template <class F>
__device__ inline int window_stop(const GangScanArgs& a, F feas, int start, int nv) {
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
      f = n >= 0 && feas(n);
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
// requested, lane_fits) against allocatable minus the usage state, and,
// with `nom`, minus the open nominations on n of priority >= prio (each
// also counts as a pod).  Every load is issued before the verdict, with
// no early return, so a node costs one memory round trip, not one a lane.
template <class Vals>
__device__ inline bool step_fits(const GangScanArgs& a, const StepScratch& sc, int n, const Vals& pv, bool all_zero,
                                 int prio, bool nom) {
  const UsageRows& use = sc.use;
  int g0 = 0, g1 = 0;
  if (nom) {
    g0 = a.nom_off[n];
    g1 = a.nom_off[n + 1];
  }
  long long n_nom = 0;
  for (int g = g0; g < g1; ++g) n_nom += a.nom_prio[g] >= prio;
  bool ok = use.pods(n) + n_nom + 1 <= sc.nodes.allowed(n);
  for (int r = 0; r < a.Rp; ++r) {
    long long avail = 0;
    if (r < a.Rn) {
      avail = (long long)sc.nodes.alloc(n, r) - use.req(a.Rn, n, r);
      for (int g = g0; g < g1; ++g)
        if (a.nom_prio[g] >= prio) avail -= a.nom_req[(long long)g * a.Rn + r];
    }
    ok = ok && lane_fits(all_zero, r, pv.req(r), avail);
  }
  return ok;
}

// The per-node verdicts and counts of the step, written once for the shared
// body (pod_step_block: K5, K9, K11) and K8's peer-free one (csrc/wave.cu).
// The pod's planes come as a view with PodPlanes' accessors (dom_cnt ...
// counted) and the nodes' domains as one with NodeRows::dom: the step's
// PodPlanes and NodeRows, or K8's views over its kernel parameters.  The
// batch peers' counts come in as a functor: the step's Dyn, or zero.

// Slot c's score-side count at node n without peers: per node for a
// hostname constraint, per domain otherwise.
template <class Planes, class Vals>
__device__ __forceinline__ long long slot_count(const Planes& pr, const Vals& pv, int c, int n) {
  return pv.sp_host(c) ? pr.node_cnt(c, n) : pr.sc_dom(c, n);
}

// PodTopologySpread's filter at node n (filtering.go): for every hard slot
// c, n's domain d is present and, where the domain counts, its count plus
// peer(c, d) (the batch peers'), plus 1 for a self-matching pod, minus the
// min-match s_min[c] is within max_skew.  each(c, d) sees every slot with
// n's domain; term is the first hard slot that fails (-1: none).
template <class Planes, class Nodes, class Vals, class Peer, class Each>
__device__ __forceinline__ bool spread_verdict(const Planes& pr, const Nodes& nd, const Vals& pv, const int* s_min,
                                               int C, int n, Peer peer, Each each, int& term) {
  bool ok = true;
  term = -1;
  for (int c = 0; c < C; ++c) {
    const int d = nd.dom(pv.sp_key(c), n);
    const long long skew = pr.dom_cnt(c, n) + peer(c, d) + (pv.sp_self(c) ? 1 : 0) - s_min[c];
    const bool c_ok = d >= 0 && (!pr.dom_pres(c, n) || skew <= pv.max_skew(c));
    if (pv.sp_hard(c) && !c_ok) {
      ok = false;
      if (term < 0) term = c;
    }
    each(c, d);
  }
  return ok;
}

// InterPodAffinity's filter at node n (filtering.go) over the pod's AT
// terms, each term's count in n's domain d being ip_cnt plus peer(u, d):
// no existing pod's anti-affinity against the pod (violated), no
// anti-affinity term matched in its domain, and every affinity term
// matched, or the escape (`escape`: nothing matches yet and the pod matches
// itself) where n has every affinity key.  raw gets the pod's inter-pod raw
// at n before the peers' symmetric terms: sym plus each present term's
// count times its preferred weight; term, the first anti-affinity term
// matched (-1: none).
template <class Planes, class Nodes, class Vals, class Peer>
__device__ __forceinline__ bool interpod_verdict(const Planes& pr, const Nodes& nd, const Vals& pv, int AT, int n,
                                                 bool escape, Peer peer, long long& raw, int& term) {
  const long long sym = pr.sym(n);
  const bool viol = pr.violated(n);
  bool viol2 = false, aff_ok = true, topo_all = true;
  long long pref = 0;
  term = -1;
  for (int u = 0; u < AT; ++u) {
    const int d = nd.dom(pv.ip_key(u), n);
    const bool present = d >= 0;
    const long long tot = pr.ip_cnt(u, n) + peer(u, d);
    if (pv.ip_anti(u) && present && tot > 0) {
      viol2 = true;
      if (term < 0) term = u;
    }
    if (pv.ip_aff(u)) {
      aff_ok = aff_ok && present && tot > 0;
      topo_all = topo_all && present;
    }
    if (present) pref += tot * pv.ip_pref_w(u);
  }
  raw = sym + pref;
  return !viol && !viol2 && (aff_ok || (escape && topo_all));
}

// The values a feasible node adds to its pod's normalizers, f[0..FEAS_VALS)
// of one reduction: the feasible count, the taint and node-affinity raws'
// maxima, the inter-pod raws' min and max, and the nodes that count (every
// spread key present); count_domain(c, d) for each non-hostname slot c with
// n's domain d present at a node that counts (the distinct domains are the
// topology size of slot c).  feas_init sets their start values, feas_op(i)
// is value i's op.
constexpr int FEAS_VALS = 6;

__host__ __device__ constexpr int feas_op(int i) {
  return i == 3 ? RED_MIN : (i == 1 || i == 2 || i == 4) ? RED_MAX : RED_SUM;
}

__device__ __forceinline__ void feas_init(long long* f) {
  f[0] = 0;
  f[1] = f[2] = 0;  // max(where(feas, raw, 0))
  f[3] = I64_MAX;
  f[4] = -I64_MAX - 1;
  f[5] = 0;
}

template <class Planes, class Nodes, class Vals, class CountDomain>
__device__ __forceinline__ void count_feasible(const Planes& pr, const Nodes& nd, const Vals& pv, int C, int n,
                                               long long ip_raw, long long* f, CountDomain count_domain) {
  const long long tr = pr.taint(n), nr = pr.naff(n);
  f[0] += 1;
  if (tr > f[1]) f[1] = tr;
  if (nr > f[2]) f[2] = nr;
  if (ip_raw < f[3]) f[3] = ip_raw;
  if (ip_raw > f[4]) f[4] = ip_raw;
  if (pr.counted(n)) {
    f[5] += 1;
    for (int c = 0; c < C; ++c) {
      if (pv.sp_host(c)) continue;
      const int d = nd.dom(pv.sp_key(c), n);
      if (d >= 0) count_domain(c, d);
    }
  }
}

// The spread score's raw at a node (_spread_raw) over the pod's soft slots:
// cnt(c), the slot's score-side count there, times its topology weight
// wfx[c], plus (max_skew - 1), in 32.32 fixed point, rounded.
template <class Vals, class Cnt>
__device__ __forceinline__ long long spread_raw(const Vals& pv, int C, const long long* wfx, Cnt cnt) {
  long long total_fx = 0;
  for (int c = 0; c < C; ++c) {
    if (!pv.sp_soft(c)) continue;
    total_fx += (long long)cnt(c) * wfx[c] + (long long)(pv.max_skew(c) - 1) * (1LL << FX);
  }
  return spread_round(total_fx);
}

// The usage commit of one placement (usage_carry_update) into `use`, or
// with delta = -1 its undo (K11's rollback); one thread.
__device__ __forceinline__ void commit_usage(const GangScanArgs& a, const UsageRows& use, int p, int choice,
                                             int delta = 1) {
  if (choice < 0) return;
  const int* req = a.requests + (long long)p * a.Rp;
  const int rn = a.Rn < a.Rp ? a.Rn : a.Rp;
  for (int r = 0; r < rn; ++r) use.req(a.Rn, choice, r) += delta * req[r];
  use.nz(choice, 0) += delta * a.nonzero_req[2 * p];
  use.nz(choice, 1) += delta * a.nonzero_req[2 * p + 1];
  use.pods(choice) += delta;
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

// Pod p's per-slot and per-pod values (its rows of the [P, C], [P, AT],
// [P, Rp] arrays of GangScanArgs and WaveArgs): read where they lie
// (GlobalVals: K11's undo), or from the copy in the CTA's shared memory
// (StagedVals: K5, K9 and K11's steps, K8's groups), refilled at each pod,
// so that no step phase waits on these small global reads.  The
// two have the same accessors; rev_anti / rev_w are the anti-affinity flag
// and the symmetric weight of the i-th admitting term t (WaveDyn's list).
struct GlobalVals {
  const GangScanArgs* a;
  const WaveArgs* w;  // null for K5
  int p;
  __device__ __forceinline__ long long pc(int c) const { return (long long)p * a->C + c; }
  __device__ __forceinline__ long long pu(int u) const { return (long long)p * a->AT + u; }
  __device__ int sp_key(int c) const { return a->sp_key[pc(c)]; }
  __device__ bool sp_host(int c) const { return a->sp_is_host[pc(c)]; }
  __device__ bool sp_self(int c) const { return a->sp_self[pc(c)]; }
  __device__ int max_skew(int c) const { return a->max_skew[pc(c)]; }
  __device__ bool sp_hard(int c) const { return a->sp_hard[pc(c)]; }
  __device__ bool sp_soft(int c) const { return a->sp_soft[pc(c)]; }
  __device__ int min_domains(int c) const { return a->min_domains[pc(c)]; }
  __device__ long long sp_ndom(int c) const { return a->sp_ndom[pc(c)]; }
  __device__ int tid_sp(int c) const { return w->tid_sp[pc(c)]; }
  __device__ int ip_key(int u) const { return a->ip_key[pu(u)]; }
  __device__ bool ip_anti(int u) const { return a->ip_is_anti[pu(u)]; }
  __device__ bool ip_aff(int u) const { return a->ip_is_aff[pu(u)]; }
  __device__ long long ip_pref_w(int u) const { return a->ip_pref_w[pu(u)]; }
  __device__ int ip_key_idx(int u) const { return a->ip_key_idx[pu(u)]; }
  __device__ int tid_ip(int u) const { return w->tid_ip[pu(u)]; }
  __device__ int req(int r) const { return a->requests[(long long)p * a->Rp + r]; }
  __device__ int nz_req(int l) const { return a->nonzero_req[2 * p + l]; }
  __device__ int priority() const { return a->priority[p]; }
  __device__ bool any_static() const { return a->ip_any_static[p]; }
  __device__ bool self_all() const { return a->ip_self_all[p]; }
  __device__ long long rep_term(int t) const { return (long long)w->rep_ip_p[t] * a->AT + w->rep_ip_u[t]; }
  __device__ bool rev_anti(int, int t) const { return a->ip_is_anti[rep_term(t)]; }
  __device__ long long rev_w(int, int t) const { return a->ip_sym_w[rep_term(t)]; }
  // pod p matches the selector of distinct spread / inter-pod term t
  __device__ bool sp_match(int t) const {
    const int rp = w->rep_sp_p[t];
    return rp >= 0 && a->C && a->sp_bmatch[((long long)rp * a->C + w->rep_sp_c[t]) * a->P + p];
  }
  __device__ bool ip_match(int t) const {
    const int rp = w->rep_ip_p[t];
    return rp >= 0 && a->AT && a->ip_bmatch[((long long)rp * a->AT + w->rep_ip_u[t]) * a->P + p];
  }
  __device__ void note_rev(const GangScanArgs&, const WaveArgs&, int, int) const {}
};

// The staged copy: ints [C] sp_key, sp_is_host, sp_self, max_skew, sp_hard,
// sp_soft, min_domains, tid_sp; [AT] ip_key, ip_is_anti, ip_is_aff,
// ip_key_idx, tid_ip; requests [Rp], nonzero_req [2], priority,
// ip_any_static, ip_self_all, then rev_anti [Tip], sp_match [Tsp], ip_match
// [Tip]; int64 [C] sp_ndom, [AT] ip_pref_w, then rev_w [Tip].
struct StagedVals {
  int* v;
  long long* l;
  int C, AT, Rp, Tsp, Tip;
  __host__ __device__ static long long ints(int C, int AT, int Rp, int Tsp, int Tip) {
    return 8LL * C + 5LL * AT + Rp + 5 + 2LL * Tip + Tsp;
  }
  __host__ __device__ static long long longs(int C, int AT, int Tip) { return (long long)C + AT + Tip; }
  __device__ int sp_key(int c) const { return v[c]; }
  __device__ bool sp_host(int c) const { return v[C + c]; }
  __device__ bool sp_self(int c) const { return v[2 * C + c]; }
  __device__ int max_skew(int c) const { return v[3 * C + c]; }
  __device__ bool sp_hard(int c) const { return v[4 * C + c]; }
  __device__ bool sp_soft(int c) const { return v[5 * C + c]; }
  __device__ int min_domains(int c) const { return v[6 * C + c]; }
  __device__ long long sp_ndom(int c) const { return l[c]; }
  __device__ int tid_sp(int c) const { return v[7 * C + c]; }
  __device__ int ip_key(int u) const { return v[8 * C + u]; }
  __device__ bool ip_anti(int u) const { return v[8 * C + AT + u]; }
  __device__ bool ip_aff(int u) const { return v[8 * C + 2 * AT + u]; }
  __device__ int ip_key_idx(int u) const { return v[8 * C + 3 * AT + u]; }
  __device__ int tid_ip(int u) const { return v[8 * C + 4 * AT + u]; }
  __device__ long long ip_pref_w(int u) const { return l[C + u]; }
  __device__ int req(int r) const { return v[8 * C + 5 * AT + r]; }
  __device__ int nz_req(int k) const { return v[8 * C + 5 * AT + Rp + k]; }
  __device__ int priority() const { return v[8 * C + 5 * AT + Rp + 2]; }
  __device__ bool any_static() const { return v[8 * C + 5 * AT + Rp + 3]; }
  __device__ bool self_all() const { return v[8 * C + 5 * AT + Rp + 4]; }
  __device__ bool rev_anti(int i, int) const { return v[8 * C + 5 * AT + Rp + 5 + i]; }
  __device__ long long rev_w(int i, int) const { return l[C + AT + i]; }
  __device__ bool sp_match(int t) const { return v[8 * C + 5 * AT + Rp + 5 + Tip + t]; }
  __device__ bool ip_match(int t) const { return v[8 * C + 5 * AT + Rp + 5 + Tip + Tsp + t]; }
  // pod p's values into the copy, one element a thread (the caller's next
  // barrier publishes them); K5 has no term tables (tid_sp / tid_ip null,
  // Tsp = Tip = 0): its term ids read -1
  __device__ void fill(const GangScanArgs& a, const WaveArgs& w, int p) const { fill(a, w, p, threadIdx.x, blockDim.x); }
  // the same by threads t0 of nt (K8: one pod's group of warps)
  __device__ void fill(const GangScanArgs& a, const WaveArgs& w, int p, int t0, int nt) const {
    const GlobalVals g{&a, &w, p};
    const int n_int = 8 * C + 5 * AT + Rp + 5, n_all = n_int + C + AT + Tsp + Tip;
    for (int j = t0; j < n_all; j += nt) {
      if (j >= n_int + C + AT) {  // the terms p matches
        const int t = j - n_int - C - AT;
        v[n_int + Tip + t] = t < Tsp ? g.sp_match(t) : g.ip_match(t - Tsp);
        continue;
      }
      if (j >= n_int) {
        const int k = j - n_int;
        l[k] = k < C ? g.sp_ndom(k) : g.ip_pref_w(k - C);
        continue;
      }
      int x;
      if (j < 8 * C) {
        const int f = j / C, c = j - f * C;
        x = f == 0 ? g.sp_key(c) : f == 1 ? g.sp_host(c) : f == 2 ? g.sp_self(c) : f == 3 ? g.max_skew(c)
          : f == 4 ? g.sp_hard(c) : f == 5 ? g.sp_soft(c) : f == 6 ? g.min_domains(c)
          : w.tid_sp != nullptr ? g.tid_sp(c) : -1;
      } else if (j < 8 * C + 5 * AT) {
        const int f = (j - 8 * C) / AT, u = j - 8 * C - f * AT;
        x = f == 0 ? g.ip_key(u) : f == 1 ? g.ip_anti(u) : f == 2 ? g.ip_aff(u) : f == 3 ? g.ip_key_idx(u)
          : w.tid_ip != nullptr ? g.tid_ip(u) : -1;
      } else {
        const int k = j - 8 * C - 5 * AT;
        x = k < Rp ? g.req(k) : k < Rp + 2 ? g.nz_req(k - Rp) : k == Rp + 2 ? g.priority()
          : k == Rp + 3 ? g.any_static() : g.self_all();
      }
      v[j] = x;
    }
  }
  // the i-th admitting term t's flag and weight, from its representative
  __device__ void note_rev(const GangScanArgs& a, const WaveArgs& w, int i, int t) const {
    const GlobalVals g{&a, &w, 0};
    v[8 * C + 5 * AT + Rp + 5 + i] = g.rev_anti(i, t);
    l[C + AT + i] = g.rev_w(i, t);
  }
};

// ---------------------------------------------------------------------------
// The step's policy: the nodes a CTA steps and the step's cluster-wide
// parts, so that one body of pod_step_block serves the thread-block
// clusters of K5 (ClusterPolicyT<false>), K9 and K11 (ClusterPolicy).
// A policy has lo / hi, the nodes [lo, hi) this CTA steps, and
//   begin(sh, C)                       before the step's first pass
//   count_domain(sc, sh, c, d, stamp)  domain d of slot c holds a counted node
//   reduce(v, op, nv, sh)              sums / mins / maxes over every node
//   reduce_counts(v, op, nv, sh, C)    the same, with sh.s_ndom complete after it
//   window(a, feas, start, nv)         the sampling window's stop (window_stop)
//   argmax(key, tie, n, n_feas, sh, at)  the choice: the largest key, then
//                                      the smallest tie (slot or visit
//                                      position)
//   gather(tot, part, cells)           pod_tables' sums: tot = every block's
//                                      part summed (one block: the same cells)
//   cursor(a), advance(a, out)         the sampling window's cursor
//   owns(n), leader()                  n is in [lo, hi); the thread that
//                                      writes the pod's outputs
//   at_flags(sh, at, f)                the verdict's pieces at node `at`
// Every combine is over int64 sums, mins and maxes, or over the argmax's
// total order (key, tie, slot), so any combine order gives the same answer.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// One thread-block cluster of G CTAs on neighbouring SMs (K5, K9, K11).  CTA `rank`
// steps the nodes [lo, hi) of its slice (S nodes a CTA, a multiple of 32),
// and the step's block-wide parts cross the cluster through distributed
// shared memory (DSMEM).  Every exchange pushes: each CTA first combines
// its own warps, then stores its result into row `rank` of every CTA's
// receive rows with st.async, whose bytes complete on the receiver's
// exchange mbarrier; each CTA waits on its own mbarrier for the G rows and
// combines them in its own shared memory.  So an exchange costs no
// cluster-wide fence: barrier.cluster's arrive.release / wait.acquire would
// add a GPU-scope membar and an invalidation of the SM's L1 (MEMBAR.ALL.GPU,
// CCTL.IVALL in its SASS), after which every phase would re-read its global
// and spilled values from L2.  Where the exchange slab lies in global
// memory (it does not fit in shared memory) the exchanges fall back to
// barrier.cluster.  The exchanges of one pod:
//   gather   pod_tables' per-domain sums, each CTA's over its slice, summed
//            into each CTA's totals, with the spread min-match's parts
//            (wave::tables_min) combined by min: s_min follows here;
//   window   (sampling) each CTA writes its slice's verdict bits into every
//            CTA's copy of the N-bit map (a word is 32 nodes of one slice,
//            so it has one writer); each CTA walks visit_order[] on its own
//            copy: all agree on the stop and advance their cursors alike;
//   reduce_counts  the 15-value reduction, with the distinct counted
//            domains, which stamps per CTA would count once per CTA: each
//            CTA flags the domains [C, Dsp] its counted nodes hold (plain
//            stores: no atomics queue on a domain's word), pushes them as
//            bits [C, Dw], and s_ndom[c] is the popcount of their OR;
//   reduce   the spread score's min / max / count;
//   argmax   each CTA's best (key, tie, slot), and to rank 0 the verdict's
//            pieces at the speculative node from the CTA that owns it.
// Buffers alternate between two sets by exchange (`phase`): a receive row
// is written again only by a CTA that has already received this CTA's part
// of the exchange in between, which this CTA pushes after reading the row.
// The pod's planes and values are staged in shared memory (K9's kernel,
// ClusterPolicy::issue / StagedVals), so the passes between exchanges read
// shared memory.
// ---------------------------------------------------------------------------

constexpr int CLUSTER_MAX = 16;
constexpr int CLUSTER_THREADS = 384;
constexpr int CL_WARPS = CLUSTER_THREADS / 32;
constexpr int XV = 16;         // values in a reduction row
constexpr int CL_PHASES = 19;  // the leader's phase clocks

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// `p` (shared memory of this CTA) in the shared memory of CTA r.
template <class T>
__device__ __forceinline__ T* on_rank(T* p, int r) {
  return cooperative_groups::this_cluster().map_shared_rank(p, (unsigned)r);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// This CTA's shared address `a` as the shared::cluster address in CTA r.
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(a), "r"(r));
  return out;
}

// A store into another CTA's shared memory that completes its byte count
// on that CTA's mbarrier `bar` (both shared::cluster addresses): the
// receiver sees the value once the barrier's phase completes, with no
// cluster-wide fence on either side.
__device__ __forceinline__ void st_async(unsigned addr, long long v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n" ::"r"(addr), "l"(v),
               "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, int v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr), "r"(v),
               "r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival on `bar` that also expects `bytes` more of its phase.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Spin until the phase of `bar` with the given parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile("{\n\t.reg .pred q;\n\tmbarrier.try_wait.parity.shared::cta.b64 q, [%1], %2;\n\tselp.u32 %0, 1, 0, q;\n}\n"
                 : "=r"(done)
                 : "r"(bar), "r"(parity)
                 : "memory");
}

// The exchange slab of CTA `rank`: shared memory, or its `stride` ints of a
// global array of one slab per CTA.
struct Xch {
  long long stride;
  int rank, smem;
  __device__ __forceinline__ int* peer(int* p, int r) const { return smem ? on_rank(p, r) : p + (r - rank) * stride; }
  __device__ __forceinline__ int ld(const int* p) const { return smem ? *p : __ldcg(p); }
  __device__ __forceinline__ void st(int* p, int v) const {
    if (smem) *p = v;
    else __stcg(p, v);
  }
};

// The cluster policy's shared memory beside the exchange slab.
struct ClusterShared {
  long long wrow[CL_WARPS * XV];          // each warp's values
  int wrow_t[CL_WARPS], wrow_n[CL_WARPS];  // each warp's argmax tie key and slot
  long long recv[2 * CLUSTER_MAX * XV];    // [2][G][XV] the CTAs' reduction rows
  long long recv_v[2 * CLUSTER_MAX];       // [2][G] the CTAs' argmax keys,
  int recv_t[2 * CLUSTER_MAX], recv_n[2 * CLUSTER_MAX];  // tie keys and slots
  long long res[XV];                       // a reduction's results
  long long clock[CL_PHASES];              // the leader's cycles per phase
  unsigned long long xbar[2];              // the exchanges' mbarriers, alternating
  int at_recv[6];                          // rank 0: the verdict's pieces at the speculative node
  int choice;
};

// kPre: the spread min-match comes with pod_tables' exchange (K9's gather);
// without it (K5) the step reduces its own min-match across the cluster.
template <bool kPre>
struct ClusterPolicyT {
  static constexpr bool kPremin = kPre;
  int lo, hi, S;       // this CTA's nodes [lo, hi); S a CTA
  int rank, G;         // this CTA's rank, the cluster's CTAs
  int cur;             // the sampling window's cursor (every thread holds it)
  int phase;           // the set of receive rows the next exchange writes
  int syncs;           // exchanges so far (each a cluster-wide synchronization)
  ClusterShared* cs;
  int* flags;          // [C, Dsp] exchange slab: the domains this CTA counted
  int* recv_bits;      // [G, C, Dw] exchange slab: every CTA's, as bits
  int* recv_part;      // [G, cells] exchange slab: every CTA's pod_tables sums
  int* wmap;           // [ceil(N / 32)] exchange slab: the window's verdict bits
  int* s_min;          // [C] shared: the min-match (StepShared::s_min)
  int C, Dsp, Dw;
  Xch x;
  unsigned char* stage;      // [2][stage_bytes] shared: two pods' staged planes (null: the global rows)
  unsigned long long* mbar;  // [2] shared: their mbarriers
  long long stage_bytes;
  StagedVals sv;             // the pod's values, in shared memory
  int xj;                    // the pod's exchanges so far
  long long t_last;    // the leader's clock at its last mark

  __device__ bool owns(int n) const { return n >= lo && n < hi; }
  __device__ bool leader() const { return rank == 0 && threadIdx.x == 0; }
  __device__ int cursor(const GangScanArgs&) const { return cur; }
  // the leader's cycles since its last mark go to phase k: for the pod's
  // exchange j, 3 j the work before it, 3 j + 1 its CTA-local combine and
  // pushes, 3 j + 2 the wait for every CTA's part and the combine;
  // CL_PHASES - 1 the commit and the outputs
  __device__ void mark(int k) {
    if (!leader()) return;
    const long long t = clock64();
    cs->clock[k] += t - t_last;
    t_last = t;
  }
  __device__ void begin_pod() {
    xj = 0;
    if (leader()) t_last = clock64();
  }
  __device__ void end_pod() { mark(CL_PHASES - 1); }
  __device__ void begin_exchange() { mark(min(3 * xj, CL_PHASES - 4)); }
  __device__ void end_exchange() {
    mark(min(3 * xj + 2, CL_PHASES - 2));
    ++xj;
  }
  // The end of an exchange's pushes: with the slab in shared memory, wait
  // for this CTA's `bytes` on the exchange's mbarrier (the pushes are
  // st.async); else one cluster barrier (barrier.cluster arrive.release /
  // wait.acquire, which also fences global memory).
  __device__ void sync(unsigned bytes) {
    mark(min(3 * xj + 1, CL_PHASES - 3));
    if (x.smem) {
      const unsigned bar = smem_u32(cs->xbar + (phase & 1));
      if (threadIdx.x == 0) mbar_expect(bar, bytes);
      mbar_wait(bar, (phase >> 1) & 1);
    } else {
      cluster_barrier();
    }
    ++syncs;
  }
  // v into `dst` (this CTA's static shared memory) of CTA r, for this
  // exchange
  template <class T>
  __device__ void push(T* dst, int r, T v) const {
    if (x.smem) st_async(cluster_addr(smem_u32(dst), r), v, cluster_addr(smem_u32(cs->xbar + (phase & 1)), r));
    else *on_rank(dst, r) = v;
  }
  // v into `dst` (this CTA's exchange slab) of CTA r, for this exchange
  __device__ void push_slab(int* dst, int r, int v) const {
    if (x.smem) st_async(cluster_addr(smem_u32(dst), r), v, cluster_addr(smem_u32(cs->xbar + (phase & 1)), r));
    else x.st(x.peer(dst, r), v);
  }
  // K9's staging of each pod's planes (PodPlanes) for its slice into one
  // of two shared buffers (planes() reads the layout: five int64 rows,
  // 3 C + AT int32 rows, 9 + 3 C byte rows, each S wide), by one thread's
  // bulk copies (cp.async.bulk) that complete on the buffer's mbarrier:
  // pod p + 1's go out when pod p starts, so they arrive while pod p steps.
  __device__ void issue(const GangScanArgs& a, int p) const {
    const int C = a.C, AT = a.AT, len = hi - lo, b = p & 1;
    const bool ip = AT > 0, extra = a.extra_score != nullptr;
    const unsigned bar = smem_u32(mbar + b);
    const unsigned long long tx = (unsigned long long)len * ((8 + ip + 3LL * C) + 8 * (3 + ip + extra) + 4 * (3LL * C + AT));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(bar, (unsigned)tx);
    if (len <= 0) return;
    unsigned char* const buf = stage + (long long)b * stage_bytes;
    const long long s = S;
    auto copy = [&](long long dst, const void* plane, long long row, int e) {
      const char* src = static_cast<const char*>(plane) + (row * a.N + lo) * e;
      asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                       smem_u32(buf + dst)),
                   "l"(src), "r"((unsigned)(len * e)), "r"(bar)
                   : "memory");
    };
    const long long i32 = 40 * s, u8 = (40 + 12LL * C + 4LL * AT) * s;
    if (ip) copy(0, a.ip_sym, p, 8);
    copy(8 * s, a.sc_taint, p, 8);
    copy(16 * s, a.sc_nodeaff, p, 8);
    copy(24 * s, a.sc_image, p, 8);
    if (extra) copy(32 * s, a.extra_score, p, 8);
    for (int c = 0; c < C; ++c) {
      const long long pc = (long long)p * C + c;
      copy(i32 + 4 * c * s, a.sp_dom_cnt, pc, 4);
      copy(i32 + 4 * (C + c) * s, a.sp_node_cnt, pc, 4);
      copy(i32 + 4 * (2LL * C + c) * s, a.sp_sc_dom, pc, 4);
      copy(u8 + (9 + c) * s, a.sp_te, pc, 1);
      copy(u8 + (9LL + C + c) * s, a.sp_dom_pres, pc, 1);
      copy(u8 + (9LL + 2 * C + c) * s, a.sp_counting, pc, 1);
    }
    for (int u = 0; u < AT; ++u) copy(i32 + 4 * (3LL * C + u) * s, a.ip_dom_cnt, (long long)p * AT + u, 4);
    const unsigned char* const u8p[9] = {a.static_mask, a.sp_all_keys, a.ip_viol_existing, a.d_unsched,
                                         a.d_nodename, a.d_taints, a.d_nodeaff, a.d_ports, a.d_extra};
    for (int k = 0; k < 9; ++k)
      if (k != 2 || ip) copy(u8 + k * s, u8p[k], p, 1);
  }
  __device__ void stage_pod(const GangScanArgs& a, int p) const {
    if (stage == nullptr) return;
    if (threadIdx.x == 0 && p + 1 < a.P) issue(a, p + 1);
    mbar_wait(smem_u32(mbar + (p & 1)), (p >> 1) & 1);
  }
  __device__ StagedVals vals(const GangScanArgs&, const WaveArgs*, int) const { return sv; }
  __device__ void stage_vals(const GangScanArgs& a, const WaveArgs& w, int p) const { sv.fill(a, w, p); }
  __device__ PodPlanes planes(const GangScanArgs& a, int p) const {
    if (stage == nullptr) return global_planes(a, p);
    const long long s = S, C = a.C, AT = a.AT;
    unsigned char* const b = stage + (long long)(p & 1) * stage_bytes;
    const long long* L = reinterpret_cast<const long long*>(b);
    const int* I = reinterpret_cast<const int*>(b + 40 * s);
    const unsigned char* U = b + (40 + 12 * C + 4 * AT) * s;
    return PodPlanes{U, U + s, U + 2 * s, U + 3 * s, U + 4 * s, U + 5 * s, U + 6 * s, U + 7 * s, U + 8 * s,
                     L, L + s, L + 2 * s, L + 3 * s, a.extra_score != nullptr ? L + 4 * s : nullptr,
                     U + 9 * s, U + (9 + C) * s, U + (9 + 2 * C) * s,
                     I, I + C * s, I + 2 * C * s, I + 3 * C * s, lo, S};
  }
  __device__ void begin(const StepShared& sh, int C) const {
    for (int c = threadIdx.x; c < C; c += blockDim.x) sh.s_ndom[c] = 0;
    for (int j = threadIdx.x; j < C * Dsp; j += blockDim.x) x.st(flags + j, 0);
  }
  __device__ void count_domain(const StepScratch&, const StepShared&, int c, int d, int) const {
    x.st(flags + c * Dsp + d, 1);
  }
  // this CTA's values (its warps combined) into row `rank` of every CTA's
  // receive set of this phase, and, with `push_bits`, its domain bits; then
  // the barrier
  // (the first nv of NV values: the loops unroll, so v stays in registers)
  template <int NV>
  __device__ void post(long long (&v)[NV], const int (&op)[NV], int nv, int C, bool push_bits) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = threadIdx.x;
    begin_exchange();
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i >= nv) break;
      for (int off = 16; off > 0; off >>= 1) v[i] = combine(v[i], __shfl_down_sync(FULL_MASK, v[i], off), op[i]);
      if (lane == 0) cs->wrow[warp * XV + i] = v[i];
    }
    __syncthreads();
    if (t < G * nv) {
      const int r = t / nv, i = t - r * nv;
      long long y = identity(op[i]);
      for (int w2 = 0; w2 < CL_WARPS; ++w2) y = combine(y, cs->wrow[w2 * XV + i], op[i]);
      push(cs->recv + ((phase & 1) * CLUSTER_MAX + rank) * XV + i, r, y);
    }
    if (push_bits) {  // word k = (c, w) of this CTA's flags as bits, to every CTA
      const int cw = C * Dw;
      for (int j = t; j < G * cw; j += blockDim.x) {
        const int r = j / cw, k = j - r * cw, c = k / Dw, d0 = (k - c * Dw) * 32;
        unsigned word = 0;
        for (int b = 0; b < 32 && d0 + b < Dsp; ++b) word |= (x.ld(flags + c * Dsp + d0 + b) != 0 ? 1u : 0u) << b;
        push_slab(recv_bits + rank * cw + k, r, (int)word);
      }
    }
    sync(8u * G * nv + (push_bits ? 4u * G * C * Dw : 0u));
  }
  // value i over the G receive rows into res[i] (warp i, lane r for rank r)
  template <int NV>
  __device__ void combine_rows(const int (&op)[NV], int nv) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long* rows = cs->recv + (phase & 1) * CLUSTER_MAX * XV;
    for (int i = warp; i < nv; i += CL_WARPS) {
      long long y = lane < G ? rows[lane * XV + i] : identity(op[i]);
      for (int off = 16; off > 0; off >>= 1) y = combine(y, __shfl_down_sync(FULL_MASK, y, off), op[i]);
      if (lane == 0) cs->res[i] = y;
    }
  }
  template <int NV>
  __device__ void finish(long long (&v)[NV], int nv) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i < nv) v[i] = cs->res[i];
    ++phase;
    end_exchange();
  }
  template <int NV>
  __device__ void reduce(long long (&v)[NV], const int (&op)[NV], int nv, const StepShared&) {
    post(v, op, nv, 0, false);
    combine_rows(op, nv);
    finish(v, nv);
  }
  template <int NV>
  __device__ void reduce_counts(long long (&v)[NV], const int (&op)[NV], int nv, const StepShared& sh, int C) {
    post(v, op, nv, C, true);
    combine_rows(op, nv);
    const int cw = C * Dw;
    for (int j = threadIdx.x; j < cw; j += blockDim.x) {
      unsigned o = 0;
      for (int r = 0; r < G; ++r) o |= (unsigned)x.ld(recv_bits + r * cw + j);
      if (o) atomicAdd(sh.s_ndom + j / Dw, __popc(o));
    }
    finish(v, nv);
  }
  template <class F>
  __device__ int window(const GangScanArgs& a, F feas, int start, int nv) {
    const int lane = threadIdx.x & 31;
    begin_exchange();
    for (int base = lo + (threadIdx.x & ~31); base < hi; base += blockDim.x) {
      const int n = base + lane;
      const unsigned bal = __ballot_sync(FULL_MASK, n < hi && feas(n));
      if (lane < G) push_slab(wmap + (base >> 5), lane, (int)bal);
    }
    sync(4u * ((a.N + 31) >> 5));  // every word of the map, once
    ++phase;
    end_exchange();
    return window_stop(a, [&](int n) { return ((unsigned)x.ld(wmap + (n >> 5)) >> (n & 31)) & 1u; }, start, nv);
  }
  __device__ int argmax(long long best, int best_t, int best_n, long long n_feas, const StepShared& sh, int at) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = threadIdx.x;
    begin_exchange();
    for (int off = 16; off > 0; off >>= 1) {
      const long long ov = __shfl_down_sync(FULL_MASK, best, off);
      const int ot = __shfl_down_sync(FULL_MASK, best_t, off);
      const int oi = __shfl_down_sync(FULL_MASK, best_n, off);
      better(best, best_t, best_n, ov, ot, oi);
    }
    if (lane == 0) {
      cs->wrow[warp * XV] = best;
      cs->wrow_t[warp] = best_t;
      cs->wrow_n[warp] = best_n;
    }
    __syncthreads();
    const int set = (phase & 1) * CLUSTER_MAX;
    if (t < G) {
      long long v = -I64_MAX - 1;
      int tk = I32_MAX, i = I32_MAX;
      for (int w2 = 0; w2 < CL_WARPS; ++w2) better(v, tk, i, cs->wrow[w2 * XV], cs->wrow_t[w2], cs->wrow_n[w2]);
      push(cs->recv_v + set + rank, t, v);
      push(cs->recv_t + set + rank, t, tk);
      push(cs->recv_n + set + rank, t, i);
    }
    // the verdict's pieces at the speculative node, from its CTA to rank 0
    if (at >= 0 && owns(at) && t >= G && t < G + 6) push(cs->at_recv + (t - G), 0, sh.s_at[t - G]);
    sync(16u * G + (rank == 0 && at >= 0 ? 24u : 0u));
    if (warp == 0) {
      long long v = lane < G ? cs->recv_v[set + lane] : -I64_MAX - 1;
      int tk = lane < G ? cs->recv_t[set + lane] : I32_MAX;
      int i = lane < G ? cs->recv_n[set + lane] : I32_MAX;
      for (int off = 16; off > 0; off >>= 1) {
        const long long ov = __shfl_down_sync(FULL_MASK, v, off);
        const int ot = __shfl_down_sync(FULL_MASK, tk, off);
        const int oi = __shfl_down_sync(FULL_MASK, i, off);
        better(v, tk, i, ov, ot, oi);
      }
      if (lane == 0) cs->choice = n_feas > 0 ? i : ABSENT;
    }
    __syncthreads();
    ++phase;
    end_exchange();
    return cs->choice;
  }
  // tot = every CTA's `part` summed: each CTA pushes its part into row
  // `rank` of every CTA's recv_part, then adds up its own rows
  // With the sums, the min-match's parts (tables_min: C Dsp per-domain
  // mins, then C direct mins, right after the `sums` sum cells in `part`)
  // are combined by min, and the spread min-match s_min follows here.
  __device__ void gather(int* tot, int* part, long long sums) {
    const long long cells = sums + (long long)C * Dsp + C;
    begin_exchange();
    __syncthreads();  // this CTA's part is complete
    for (long long j = threadIdx.x; j < G * cells; j += blockDim.x) {
      const int r = (int)(j / cells);
      const long long i = j - r * cells;
      push_slab(recv_part + rank * cells + i, r, x.ld(part + i));
    }
    sync(4u * G * (unsigned)cells);
    for (long long i = threadIdx.x; i < cells; i += blockDim.x) {
      int s = i < sums ? 0 : I32_MAX;
      for (int r = 0; r < G; ++r) {
        const int y = x.ld(recv_part + r * cells + i);
        s = i < sums ? s + y : min(s, y);
      }
      tot[i] = s;
    }
    __syncthreads();
    // minMatch per slot: the direct min, or a domain's min plus its peers
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const int* m = tot + sums;
      long long v = m[(long long)C * Dsp + c];
      for (int d = 0; d < Dsp; ++d) {
        const int md = m[(long long)c * Dsp + d];
        if (md < I32_MAX && md + (long long)tot[(long long)c * Dsp + d] < v) v = md + (long long)tot[(long long)c * Dsp + d];
      }
      const int md = sv.min_domains(c);
      s_min[c] = (md > 0 && sv.sp_ndom(c) < md) ? 0 : (int)v;
    }
    ++phase;
    end_exchange();
  }
  // pod_tables' start: the min-match parts (after the `sums` cells of
  // `part`) start at I32_MAX; wave::tables_min fills them
  __device__ void tables_begin(int* part, long long sums) const {
    for (long long i = threadIdx.x; i < (long long)C * Dsp + C; i += blockDim.x) x.st(part + sums + i, I32_MAX);
  }

  __device__ void advance(const GangScanArgs& a, const StepOut& out) {
    if (a.sample_k <= 0) return;
    const int nv = a.n_valid > 1 ? a.n_valid : 1;
    cur = (int)(((long long)cur + out.processed) % nv);
  }
  // (rank 0: pushed by the CTA that owns `at` in the argmax's exchange)
  __device__ void at_flags(const StepShared&, int, int (&f)[6]) const {
    for (int i = 0; i < 6; ++i) f[i] = cs->at_recv[i];
  }
};
using ClusterPolicy = ClusterPolicyT<true>;

// ---- the cluster kernels' common set-up (K5 csrc/gang_scan.cu, K9
// csrc/wave.cu) ----------------------------------------------------------

// The nodes of one CTA's slice: N / G rounded up to a multiple of 32 (a
// window-map word has one writer).
inline int slice_nodes(int N, int G) { return ((N + G - 1) / G + 31) / 32 * 32; }

// Bytes of one pod's staged planes for an S-node slice (ClusterPolicy::
// planes' layout): five int64 rows, 3 C + AT int32 rows, 9 + 3 C byte rows.
__host__ __device__ inline long long stage_bytes(const GangScanArgs& a, int S) {
  return (49LL + 15LL * a.C + 4LL * a.AT) * S;
}

// The planes ClusterPolicy::issue copies, each 16-byte aligned (a bulk
// copy's rule; N % 32 == 0 keeps every slice's rows so).
inline bool stage_aligned(const GangScanArgs& a) {
  const void* planes[] = {a.sc_taint, a.sc_nodeaff, a.sc_image, a.extra_score, a.sp_dom_cnt, a.sp_node_cnt,
                          a.sp_sc_dom, a.sp_te, a.sp_dom_pres, a.sp_counting, a.static_mask, a.sp_all_keys,
                          a.d_unsched, a.d_nodename, a.d_taints, a.d_nodeaff, a.d_ports, a.d_extra,
                          a.AT ? a.ip_sym : nullptr, a.AT ? a.ip_dom_cnt : nullptr,
                          a.AT ? a.ip_viol_existing : nullptr};
  for (const void* p : planes)
    if (reinterpret_cast<unsigned long long>(p) % 16) return false;
  return a.N % 32 == 0;
}

// One cluster of `G` CTAs of CLUSTER_THREADS with `smem` bytes of dynamic
// shared memory each (attr: the one launch attribute's storage).
inline cudaLaunchConfig_t cluster_config(int G, size_t smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, 1, 1);
  cfg.blockDim = dim3(CLUSTER_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster size a kernel takes: 16 where cluster_cap allows it and the
// card admits one cluster of 16 at `smem(16)` bytes of shared memory a CTA
// (a non-portable size), else 8 (the portable size; a launch the card
// refuses raises).  The card's verdict is kept by (kernel, device, bytes):
// its query costs two attribute calls and an occupancy call, and a drain
// asks for every batch at the same few sizes.  (Each launch sets the
// kernel's attributes itself.)  Returns a CUDA status.
template <class Kernel, class Smem>
inline cudaError_t cluster_size(Kernel kernel, int cluster_cap, Smem smem, int* G) {
  struct Verdict {
    const void* kernel;
    int dev;
    size_t bytes;
    bool fits;
  };
  static std::mutex mu;
  static std::vector<Verdict> seen;
  *G = 8;
  if (cluster_cap < CLUSTER_MAX) return cudaSuccess;
  const size_t bytes = smem(CLUSTER_MAX);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* k = reinterpret_cast<const void*>(kernel);
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Verdict& v : seen)
      if (v.kernel == k && v.dev == dev && v.bytes == bytes) {
        if (v.fits) *G = CLUSTER_MAX;
        return cudaSuccess;
      }
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int clusters = 0;
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(CLUSTER_MAX, bytes, nullptr, attr);
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  }
  const bool fits = e == cudaSuccess && clusters >= 1;
  cudaGetLastError();  // the query's error is not the launch's
  if (fits) *G = CLUSTER_MAX;
  std::lock_guard<std::mutex> lock(mu);
  seen.push_back({k, dev, bytes, fits});
  return cudaSuccess;
}

// The slice [use.lo, use.lo + len) of the usage state into `use` (shared
// memory), or back out of it.
__device__ inline void copy_usage(const GangScanArgs& a, const UsageRows& use, int len, bool in) {
  const long long lo = use.lo;
  for (int i = threadIdx.x; i < len * a.Rn; i += blockDim.x) {
    if (in) use.requested[i] = a.requested[lo * a.Rn + i];
    else a.requested[lo * a.Rn + i] = use.requested[i];
  }
  for (int i = threadIdx.x; i < 2 * len; i += blockDim.x) {
    if (in) use.nonzero[i] = a.nonzero[2 * lo + i];
    else a.nonzero[2 * lo + i] = use.nonzero[i];
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    if (in) use.num_pods[i] = a.num_pods[lo + i];
    else a.num_pods[lo + i] = use.num_pods[i];
  }
}

// The slice [lo, lo + len) of the node statics copied into shared memory
// (rows S wide): allocatable [S, Rn], allowed_pods, visit_rank, dom_ids
// [K, S], node_valid.
__device__ inline NodeRows stage_nodes(const GangScanArgs& a, int* alloc, int* allowed, int* vrank, int* dom,
                                       unsigned char* valid, int lo, int len, int S) {
  for (int i = threadIdx.x; i < len * a.Rn; i += blockDim.x) alloc[i] = a.allocatable[(long long)lo * a.Rn + i];
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    allowed[i] = a.allowed_pods[lo + i];
    vrank[i] = a.visit_rank != nullptr ? a.visit_rank[lo + i] : -1;
    valid[i] = a.node_valid[lo + i];
  }
  for (long long i = threadIdx.x; i < (long long)a.K * len; i += blockDim.x) {
    const long long k = i / len, n = i - k * len;
    dom[k * S + n] = a.dom_ids[k * a.N + lo + n];
  }
  return NodeRows{alloc, allowed, valid, a.visit_rank != nullptr ? vrank : nullptr, dom, lo, S, a.K, a.Rn};
}

// The staging's and the exchanges' mbarriers, one arrival a phase; one
// thread, before the cluster's first barrier.
__device__ inline void init_mbars(unsigned long long* stage_bars, ClusterShared& cs) {
  for (int b = 0; b < 2; ++b) {
    mbar_init(smem_u32(stage_bars + b), 1);
    mbar_init(smem_u32(cs.xbar + b), 1);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One pod's Filter -> Score -> Select against the usage state sc.use (read
// only here: the caller commits), over the nodes [pol.lo, pol.hi) with the
// policy's block- or cluster-wide parts.  `at` >= 0 asks for the verdict's
// pieces at that node (the wave's demotion attribution), in sh.s_at of the
// block that steps it.  Without `diagnose` the reason counts stay 0 and the
// diagnosis masks are not read (a caller that emits only the choice).
// Every thread of the block, or of the cluster, calls it and gets the
// result.
template <class Dyn, class Pol>
__device__ StepOut pod_step_block(const GangScanArgs& a, int p, const Dyn& dyn, bool any_dyn, const StepScratch& sc,
                                  const StepShared& sh, int at, bool diagnose, Pol& pol) {
  const int tid = threadIdx.x;
  const int C = a.C, AT = a.AT, lo = pol.lo, hi = pol.hi;
  const UsageRows& use = sc.use;
  const NodeRows& nd = sc.nodes;
  const PodPlanes pr = pol.planes(a, p);
  const auto pv = pol.vals(a, nullptr, p);
  pol.begin(sh, C);
  __syncthreads();

  // ---- spread min-match per constraint (filtering.go:313 minMatch),
  // RED_CHUNK constraints per reduction (a cluster's came with pod_tables)
  for (int c0 = 0; !Pol::kPremin && c0 < C; c0 += RED_CHUNK) {
    const int nc = C - c0 < RED_CHUNK ? C - c0 : RED_CHUNK;
    long long v[RED_CHUNK];
    int op[RED_CHUNK];
    for (int i = 0; i < RED_CHUNK; ++i) {
      v[i] = I32_MAX;
      op[i] = RED_MIN;
    }
    for (int n = lo + tid; n < hi; n += blockDim.x)
#pragma unroll
      for (int i = 0; i < RED_CHUNK; ++i) {
        if (i >= nc) break;
        const long long pc = (long long)p * C + c0 + i;
        const long long o = pr.at(c0 + i, n);
        if (!pr.sp_te[o]) continue;
        const int d = nd.dom(pv.sp_key(c0 + i), n);
        const long long total = pr.sp_dom_cnt[o] + dyn.f(c0 + i, pc, n, d);
        if (total < v[i]) v[i] = total;
      }
    pol.reduce(v, op, nc, sh);
    if (tid < nc) {
      const int md = pv.min_domains(c0 + tid);
      sh.s_min[c0 + tid] = (md > 0 && pv.sp_ndom(c0 + tid) < md) ? 0 : (int)v[tid];
    }
  }
  __syncthreads();

  // ---- filters, diagnosis, and the normalizers' min / max
  bool has_aff = false, has_soft = false;
  for (int u = 0; u < AT; ++u) has_aff = has_aff || pv.ip_aff(u);
  for (int c = 0; c < C; ++c) has_soft = has_soft || pv.sp_soft(c);
  const bool any_match = pv.any_static() || any_dyn;
  const bool escape = has_aff && !any_match && pv.self_all();
  bool all_zero = true;
  for (int r = 0; r < a.Rp; ++r) all_zero = all_zero && pv.req(r) == 0;
  const int prio = pv.priority();
  const int stamp = p + 1;
  const bool sampling = a.sample_k > 0;
  const int nv = a.n_valid > 1 ? a.n_valid : 1;
  int start = 0;  // the cursor, in [0, nv) like the reference's (vr - start) % nv
  if (sampling) {
    start = pol.cursor(a) % nv;
    if (start < 0) start += nv;
  }

  // 0..5 the normalizers' counts over the feasible set (count_feasible),
  // 6..14 the reason counts
  constexpr int NR = FEAS_VALS + N_DIAG;
  long long red[NR];
  const int red_op[NR] = {feas_op(0), feas_op(1), feas_op(2), feas_op(3), feas_op(4), feas_op(5), RED_SUM, RED_SUM,
                          RED_SUM,    RED_SUM,    RED_SUM,    RED_SUM,    RED_SUM,    RED_SUM,    RED_SUM};
  feas_init(red);
  for (int r = 0; r < N_DIAG; ++r) red[FEAS_VALS + r] = 0;
  // the distinct counted domains per slot (count_feasible)
  auto count_domain = [&](int c, int d) { pol.count_domain(sc, sh, c, d, stamp); };
  for (int n = lo + tid; n < hi; n += blockDim.x) {
    const long long pn = pr.at(n);
    const bool m_portb = dyn.portb(n);
    // m_fit: the resource fit with the nominations charged (the filter);
    // fit_own: without them (the wave's demotion attribution, which the
    // reference computes from the usage state alone)
    bool m_fit = true, fit_own = true;
    if (a.check_fit) {
      fit_own = step_fits(a, sc, n, pv, all_zero, prio, false);
      m_fit = fit_own;
      if (a.nom_off != nullptr && a.nom_off[n + 1] > a.nom_off[n])
        m_fit = step_fits(a, sc, n, pv, all_zero, prio, true);
    }
    int sp_term = -1;
    const bool m_spread = spread_verdict(
        pr, nd, pv, sh.s_min, C, n, [&](int c, int d) { return dyn.f(c, (long long)p * C + c, n, d); },
        [&](int c, int d) {
          sc.cnt_of(c, n) = slot_count(pr, pv, c, n) + dyn.sc(c, (long long)p * C + c, n, d, pv.sp_host(c));
        },
        sp_term);
    bool m_interpod = true;
    long long ip_raw = 0;
    int ip_term = -1;
    if (AT) {
      m_interpod = interpod_verdict(
                       pr, nd, pv, AT, n, escape, [&](int u, int d) { return dyn.ip(u, (long long)p * AT + u, n, d); },
                       ip_raw, ip_term) &&
                   !dyn.viol(n);
      ip_raw += dyn.sym(n);
    }
    const bool feas = pr.mask[pn] && m_portb && m_fit && m_spread && m_interpod;
    sc.feas_of(n) = feas;
    sc.ip_of(n) = ip_raw;
    if (n == at) {
      sh.s_at[0] = m_portb;
      sh.s_at[1] = m_spread;
      sh.s_at[2] = m_interpod;
      sh.s_at[3] = fit_own;
      sh.s_at[4] = sp_term;
      sh.s_at[5] = ip_term;
    }

    // first failure in the filter chain's order
    if (diagnose && nd.valid(n)) {
      const bool comp[N_DIAG] = {pr.d_unsched[pn] != 0, pr.d_nodename[pn] != 0, pr.d_taints[pn] != 0,
                                 pr.d_nodeaff[pn] != 0, pr.d_ports[pn] && m_portb, pr.d_extra[pn] != 0,
                                 m_fit, m_spread, m_interpod};
#pragma unroll
      for (int r = 0; r < N_DIAG; ++r)
        if (!comp[r]) {
          red[FEAS_VALS + r] += 1;
          break;
        }
    }
    if (feas && !sampling) count_feasible(pr, nd, pv, C, n, ip_raw, red, count_domain);
  }
  int processed = 0;
  if (sampling) {
    // the window: keep the feasible nodes up to the sample_k-th in visit
    // order (all of them when fewer are feasible)
    __syncthreads();  // every node's verdict is in sc.feas
    const int stop = pol.window(a, [&](int n) { return sc.feas_of(n) != 0; }, start, nv);
    processed = stop >= 0 ? stop + 1 : nv;
    for (int n = lo + tid; n < hi; n += blockDim.x) {
      const bool keep = sc.feas_of(n) && nd.vrank(n) >= 0 && (stop < 0 || visit_pos(nd.vrank(n), start, nv) <= stop);
      sc.feas_of(n) = keep;
      if (keep) count_feasible(pr, nd, pv, C, n, sc.ip_of(n), red, count_domain);
    }
  }
  pol.reduce_counts(red, red_op, NR, sh, C);
  StepOut out;
  out.processed = processed;
  out.n_feas = red[0];
  for (int r = 0; r < N_DIAG; ++r) out.rc[r] = red[FEAS_VALS + r];

  // ---- spread score (_spread_raw): topology weights, then per-node raws
  long long sp_mn = I64_MAX, sp_mx = -I64_MAX, n_use = 0;
  if (C && a.w_spread) {
    for (int c = tid; c < C; c += blockDim.x) {
      const long long size = pv.sp_host(c) ? red[5] : sh.s_ndom[c];
      sh.s_wfx[c] = a.log_tab[size < 0 ? 0 : (size >= a.L ? a.L - 1 : size)];
    }
    __syncthreads();
    long long v[3] = {I64_MAX, -I64_MAX - 1, 0};
    const int op[3] = {RED_MIN, RED_MAX, RED_SUM};
    for (int n = lo + tid; n < hi; n += blockDim.x) {
      if (!sc.feas_of(n)) continue;
      const bool use_n = !has_soft || pr.all_keys[pr.at(n)];  // valid & feas == counted
      const long long raw = has_soft ? spread_raw(pv, C, sh.s_wfx, [&](int c) { return sc.cnt_of(c, n); }) : 0;
      sc.sp_of(n) = raw;
      if (use_n) {
        if (raw < v[0]) v[0] = raw;
        if (raw > v[1]) v[1] = raw;
        v[2] += 1;
      }
    }
    pol.reduce(v, op, 3, sh);
    sp_mn = v[0];
    sp_mx = v[1];
    n_use = v[2];
  }

  // ---- weighted total and the argmax over the feasible nodes: first max by
  // slot; with a tie key the (total, bits) maximum; in the window without
  // one, the first max in visit order
  long long best = -I64_MAX - 1;
  int best_t = I32_MAX, best_n = I32_MAX;
  const ScoreNorms norms{red[1], red[2], red[3], red[4], sp_mn, sp_mx, n_use};
  unsigned tk0 = (unsigned)a.tie_k0, tk1 = (unsigned)a.tie_k1;
  if (a.tie_on) rng::fold_in(tk0, tk1, (unsigned)a.attempt_base + (unsigned)p);
  for (int n = lo + tid; n < hi; n += blockDim.x) {
    if (!sc.feas_of(n)) continue;
    const long long pn = pr.at(n);
    long long a0 = 0, a1 = 0, c0 = 0, c1 = 0, r0 = 0, r1 = 0;
    if (a.w_fit || a.w_bal) {
      a0 = nd.alloc(n, LANE_CPU);
      a1 = nd.alloc(n, LANE_MEM);
      c0 = (long long)use.nz(n, 0) + pv.nz_req(0);
      c1 = (long long)use.nz(n, 1) + pv.nz_req(1);
      r0 = (long long)use.req(a.Rn, n, LANE_CPU) + pv.req(LANE_CPU);
      r1 = (long long)use.req(a.Rn, n, LANE_MEM) + pv.req(LANE_MEM);
    }
    long long total = node_total(a, norms, C > 0, !has_soft || pr.all_keys[pn], pr.sc_taint[pn], pr.sc_nodeaff[pn],
                                 a.w_spread && C ? sc.sp_of(n) : 0, sc.ip_of(n), a0, a1, c0, c1, r0, r1,
                                 a.w_img ? pr.sc_image[pn] : 0);
    if (pr.extra) total += pr.extra[pn];
    long long key = total;
    int tie = n;
    if (a.tie_on)
      key = total * (1LL << 33) + rng::bits_at(tk0, tk1, (unsigned)n);
    else if (sampling)
      tie = visit_pos(nd.vrank(n), start, nv);
    better(best, best_t, best_n, key, tie, n);
  }
  out.choice = pol.argmax(best, best_t, best_n, out.n_feas, sh, at);
  return out;
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

// A cluster CTA's region: the per-pod sums g1 / g2 [C, Dsp] (spread,
// filter and score sides), gf [AT, D2] (inter-pod) and any_dyn, which
// ClusterPolicy::gather adds up from every CTA's partial sums g1p / g2p /
// gfp / anyp; the admitting-term list [Tip] and the conflicting-port-term
// list [Tpt] with their two lengths; and the carries cnt_sp [Tsp, N],
// cnt_ip [Tip, N], rev_cnt [Tip, N], occ_pt [Tpt, N], node n at column
// n - clo of rows cld wide (global memory: clo = 0, cld = N; the CTA's
// slice in its shared memory: its lo and slice width).
struct Region {
  int *g1, *g2, *gf, *rev, *conf, *n_rev, *n_conf, *any_dyn;
  int *g1p, *g2p, *gfp, *anyp;
  int *cnt_sp, *cnt_ip, *rev_cnt, *occ_pt;
  int clo, cld;
  __device__ __forceinline__ int& csp(int t, int n) const { return cnt_sp[(long long)t * cld + n - clo]; }
  __device__ __forceinline__ int& cip(int t, int n) const { return cnt_ip[(long long)t * cld + n - clo]; }
  __device__ __forceinline__ int& rev_at(int t, int n) const { return rev_cnt[(long long)t * cld + n - clo]; }
  __device__ __forceinline__ int& occ(int t, int n) const { return occ_pt[(long long)t * cld + n - clo]; }
};

// The admitted batch peers' counts for pod p's step, from the carries and
// the per-pod sums; `v` is pod p's values (step::GlobalVals / StagedVals).
template <class Vals>
struct WaveDyn {
  const GangScanArgs& a;
  const WaveArgs& w;
  Region r;
  int p;
  const unsigned char* dra_row;  // K11 with claims: pod p's DRA verdict per node (null: none)
  step::PodPlanes pr;            // pod p's planes
  Vals v;
  __device__ int f(int c, long long, int n, int d) const {
    const int t = v.tid_sp(c);
    if (t < 0 || d < 0) return 0;
    if (v.sp_host(c)) return pr.sp_te[pr.at(c, n)] ? r.csp(t, n) : 0;
    return r.g1[(long long)c * w.Dsp + d];
  }
  __device__ int sc(int c, long long, int n, int d, bool host) const {
    const int t = v.tid_sp(c);
    if (t < 0) return 0;
    if (host) return r.csp(t, n);
    return d >= 0 ? r.g2[(long long)c * w.Dsp + d] : 0;
  }
  __device__ int ip(int u, long long, int n, int d) const {
    const int t = v.tid_ip(u);
    if (t < 0 || d < 0) return 0;
    if (v.ip_key(u) == w.hostname_key) return r.cip(t, n);
    return r.gf[(long long)u * w.D2 + d];
  }
  __device__ bool viol(int n) const {
    for (int i = 0; i < *r.n_rev; ++i) {
      const int t = r.rev[i];
      if (v.rev_anti(i, t) && r.rev_at(t, n) > 0) return true;
    }
    return false;
  }
  __device__ long long sym(int n) const {
    long long s = 0;
    for (int i = 0; i < *r.n_rev; ++i) {
      const int t = r.rev[i];
      s += v.rev_w(i, t) * (long long)r.rev_at(t, n);
    }
    return s;
  }
  __device__ bool portb(int n) const {
    if (dra_row != nullptr && !dra_row[n]) return false;
    for (int i = 0; i < *r.n_conf; ++i)
      if (r.occ(r.conf[i], n) > 0) return false;
    return true;
  }
};

// A cluster CTA's parts of pod p's spread min-match over its slice, into
// `m` (ClusterPolicy::gather combines them): per slot c, m[c Dsp + d] the
// min of sp_dom_cnt over c's eligible nodes in domain d (the peers' count
// there, g1[c, d], is the same for all of them and is added after the
// exchange), and m[C Dsp + c] the min of the whole total over the eligible
// nodes that need no g1 (no term, no domain, or a hostname slot, whose peer
// count is the node's carry); one atomic per warp and domain.
template <class Vals, class Pol>
__device__ inline void tables_min(const GangScanArgs& a, const Region& r, int p, const step::PodPlanes& pr,
                                  const step::NodeRows& nd, const Vals& pv, int* m, const Pol& pol) {
  const int lane = threadIdx.x & 31, C = a.C, Dsp = pol.Dsp;
  for (int c = 0; c < C; ++c) {
    const int t = pv.tid_sp(c), key = pv.sp_key(c);
    const bool host = pv.sp_host(c);
    for (int base = pol.lo + (threadIdx.x & ~31); base < pol.hi; base += blockDim.x) {
      const int n = base + lane;
      int dom = -1, val = step::I32_MAX, direct = step::I32_MAX;
      if (n < pol.hi && pr.sp_te[pr.at(c, n)]) {
        const int d = nd.dom(key, n), cnt = pr.sp_dom_cnt[pr.at(c, n)];
        if (t < 0 || d < 0) direct = cnt;
        else if (host) direct = cnt + r.csp(t, n);
        else {
          dom = d;
          val = cnt;
        }
      }
      const unsigned peers = __match_any_sync(step::FULL_MASK, dom);
      const int dm = __reduce_min_sync(peers, val);
      if (dom >= 0 && lane == __ffs(peers) - 1) atomicMin(m + (long long)c * Dsp + dom, dm);
      const int best = __reduce_min_sync(step::FULL_MASK, direct);
      if (lane == 0 && best < step::I32_MAX) atomicMin(m + (long long)C * Dsp + c, best);
    }
  }
}

// Pod p's per-domain sums over the policy's nodes, gathered into g1 / g2 /
// gf / any_dyn, and its admitting terms and conflicting port terms.
template <class Pol>
__device__ inline void pod_tables(const GangScanArgs& a, const WaveArgs& w, const Region& r, int p,
                                  const step::NodeRows& nd, Pol& pol) {
  const int tid = threadIdx.x;
  const int C = a.C, AT = a.AT, P = a.P;
  const step::PodPlanes pr = pol.planes(a, p);
  const auto pv = pol.vals(a, &w, p);
  for (long long i = tid; i < 2LL * C * w.Dsp; i += blockDim.x) r.g1p[i] = 0;  // g1 and g2
  for (long long i = tid; i < (long long)AT * w.D2; i += blockDim.x) r.gfp[i] = 0;
  if (tid == 0) {
    *r.n_rev = 0;
    *r.n_conf = 0;
    *r.anyp = 0;
  }
  const long long sums = 2LL * C * w.Dsp + (long long)AT * w.D2 + 1;  // g1, g2, gf, any_dyn
  if constexpr (Pol::kPremin) pol.tables_begin(r.g1p, sums);
  __syncthreads();
  // the distinct inter-pod terms whose selector admits p (m_ip_all[:, p])
  for (int t = tid; t < w.Tip; t += blockDim.x) {
    const int rp = w.rep_ip_p[t];
    if (rp >= 0 && a.ip_bmatch[((long long)rp * AT + w.rep_ip_u[t]) * P + p]) {
      const int i = atomicAdd(r.n_rev, 1);
      r.rev[i] = t;
      pv.note_rev(a, w, i, t);
    }
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
    const int t = pv.tid_sp(c);
    if (t < 0 || pv.sp_host(c)) continue;
    const int key = pv.sp_key(c);
    for (int n = pol.lo + tid; n < pol.hi; n += blockDim.x) {
      const int v = r.csp(t, n);
      if (!v) continue;
      const int d = nd.dom(key, n);
      if (d < 0) continue;
      if (pr.sp_te[pr.at(c, n)]) atomicAdd(r.g1p + (long long)c * w.Dsp + d, v);
      if (pr.sp_counting[pr.at(c, n)]) atomicAdd(r.g2p + (long long)c * w.Dsp + d, v);
    }
  }
  for (int u = 0; u < AT; ++u) {
    const int t = pv.tid_ip(u);
    if (t < 0) continue;
    const int key = pv.ip_key(u);
    const bool host = key == w.hostname_key;
    const bool aff = pv.ip_aff(u);
    for (int n = pol.lo + tid; n < pol.hi; n += blockDim.x) {
      const int v = r.cip(t, n);
      if (!v) continue;
      if (aff) *r.anyp = 1;
      if (host) continue;
      const int d = nd.dom(key, n);
      if (d >= 0) atomicAdd(r.gfp + (long long)u * w.D2 + d, v);
    }
  }
  if constexpr (Pol::kPremin) tables_min(a, r, p, pr, nd, pv, r.g1p + sums, pol);
  pol.gather(r.g1, r.g1p, sums);
}

// Commit pod p's placement at `choice` into the carries, or with delta = -1
// undo it (K11's rollback): the node column of each term p matches where
// the policy owns `choice`, and p's own inter-pod terms over their
// topology domains at the policy's nodes.  `pv` is pod p's values.
template <class Vals, class Pol>
__device__ inline void commit_carries(const GangScanArgs& a, const WaveArgs& w, const Region& r, const Vals& pv,
                                      int choice, const step::NodeRows& nd, const Pol& pol, int delta = 1) {
  const int tid = threadIdx.x;
  const int AT = a.AT;
  if (pol.owns(choice)) {
    // one node column per term that p matches (distinct t: no two threads
    // touch one cell)
    for (int t = tid; t < w.Tsp; t += blockDim.x)
      if (pv.sp_match(t)) r.csp(t, choice) += delta;
    for (int t = tid; t < w.Tip; t += blockDim.x)
      if (pv.ip_match(t)) r.cip(t, choice) += delta;
  }
  // p's own terms over their topology domains (one thread per node)
  for (int n = pol.lo + tid; n < pol.hi; n += blockDim.x)
    for (int u = 0; u < AT; ++u) {
      const int t = pv.tid_ip(u);
      if (t < 0 || pv.ip_key_idx(u) < 0) continue;
      const int key = pv.ip_key(u);
      const int at_dom = dom_at(a, key, choice);
      if (at_dom < 0) continue;
      const bool in = key == w.hostname_key ? n == choice : nd.dom(key, n) == at_dom;
      if (in) r.rev_at(t, n) += delta;
    }
}

// The wave's port terms of p at `choice` (K9; the workloads dispatch has no
// host ports): one thread.
__device__ inline void commit_ports(const WaveArgs& w, const Region& r, int p, int choice) {
  for (int k = 0; k < w.W; ++k) {
    const int t = w.tid_pt[(long long)p * w.W + k];
    if (t >= 0) r.occ(t, choice) += 1;
  }
}

// ---------------------------------------------------------------------------
// The admission recurrence, one kernel for K9 and K11: admit_loop<false> is
// K9 (the demotion stats against the speculative node c0), admit_loop<true>
// is K11 (the gangs, no demotion stats), both on one thread-block cluster
// (admit_cluster_kernel below; csrc/wave.cu, csrc/workloads.cu).
// ---------------------------------------------------------------------------

enum Demote { DEMOTE_NONE = 0, DEMOTE_SPREAD = 1, DEMOTE_AFFINITY = 2, DEMOTE_SCORE = 3, DEMOTE_FIT = 4,
              DEMOTE_UPGRADE = 5, DEMOTE_PORTS = 6 };

// K11's per-CTA record of the batch, for the rollback by undo: every pod's
// choice, the CTA's copy of claim_node and, per claim, the pod that pinned
// it in this batch (-1: none), and the first pod a rollback undoes (the
// most recent gang's first member, or the pod after the last rollback; 0
// before either).  Every CTA keeps its own copies and applies the same
// pins from the choice every CTA knows, so no CTA reads another's.
struct GangLog {
  int* choice;  // [P]
  int* claim;   // [CL]
  int* pinner;  // [CL]
  int start;
  int undone;   // the leader's count of undone placements
};

// K11 with claims: pod p's rows of WorkloadsArgs.
__device__ __forceinline__ dra::PodRows dra_rows(const WorkloadsArgs& k, int N, int p) {
  return dra::pod_rows(k.dra_match, k.req_count, k.req_all, k.req_cl, k.q_valid, k.req_bad, k.ref_cl, p, k.DQ, k.CQ,
                       N, k.DD, k.CL);
}

// This thread's verdict words past dra::REG_DD device slots (null below).
__device__ __forceinline__ unsigned long long* dra_words(const WorkloadsArgs& k) {
  if (k.dra_scratch == nullptr) return nullptr;
  const long long row = (long long)cooperative_groups::this_cluster().block_rank() * blockDim.x + threadIdx.x;
  return k.dra_scratch + row * dra::scratch_words(k.DD);
}

// K11 with claims: commit pod p's placement at `choice` into the
// allocation carries (ops/dra.py dra_commit), thread 0 of each CTA: the CTA
// that owns the node takes the pod's devices there (free's row, logged in
// take_log's row p), then every CTA pins, in its own copy, each claim the
// pod references that is still unallocated.
template <class Pol>
__device__ inline void dra_commit(const WorkloadsArgs& k, int N, int p, int choice, GangLog& gl, const Pol& pol) {
  const int nw = (k.DD + 63) >> 6;
  if (pol.owns(choice))
    dra::node_take(dra_rows(k, N, p), k.free, gl.claim, choice, dra_words(k), k.take_log + (long long)p * nw);
  for (int c = 0; c < k.CQ; ++c) {
    const int cl = k.ref_cl[(long long)p * k.CQ + c];
    if (cl >= 0 && cl < k.CL && gl.claim[cl] < 0) {
      gl.claim[cl] = choice;
      gl.pinner[cl] = p;
    }
  }
}

// K11's rollback: undo the placements of the pods gl.start .. p (the
// reference restores the state saved before the most recent first member's
// step, or the initial state, and every commit since is additive): each
// from its recorded choice, the usage and term columns by the CTA that
// owns the node, the reverse counts by every CTA over its slice (the split
// of the commit), with claims the take from the log and the pins this
// batch made; the pods' `assigned` read -1 again.  One thread owns each
// cell across the pods (a term column's thread, a node's thread, thread 0),
// so the pods need no barrier between them.
template <class Pol>
__device__ inline void undo_gang(const GangScanArgs& a, const WaveArgs& w, const WorkloadsArgs& k, const Region& r,
                                 const step::StepScratch& sc, const Pol& pol, GangLog& gl, int p) {
  const int nw = (k.DD + 63) >> 6;
  for (int q = gl.start; q <= p; ++q) {
    const int c = gl.choice[q];
    if (c < 0) continue;
    commit_carries(a, w, r, step::GlobalVals{&a, &w, q}, c, sc.nodes, pol, -1);
    if (threadIdx.x == 0) {
      if (pol.owns(c)) {
        step::commit_usage(a, sc.use, q, c, -1);
        if (k.dra_match != nullptr) {
          unsigned char* const fr = k.free + (long long)c * k.DD;
          const unsigned long long* const log = k.take_log + (long long)q * nw;
          for (int d = 0; d < k.DD; ++d)
            if ((log[d >> 6] >> (d & 63)) & 1ULL) fr[d] = 1;
        }
      }
      if (k.dra_match != nullptr)
        for (int j = 0; j < k.CQ; ++j) {
          const int cl = k.ref_cl[(long long)q * k.CQ + j];
          if (cl >= 0 && cl < k.CL && gl.pinner[cl] == q) {
            gl.claim[cl] = ABSENT;
            gl.pinner[cl] = ABSENT;
          }
        }
    }
    if (pol.leader()) {
      k.assigned[q] = ABSENT;
      ++gl.undone;
    }
  }
}

// The pods in order: per pod, pod_tables, the shared step (with the verdict's
// pieces at the speculative node for K9), the commit of the carries and the
// usage (by the CTA that owns the chosen node), then the outputs from the
// policy's leader.  K11 also keeps the gangs: its DRA verdict per node
// first, the allocation commit, and at a gang's last member the admission
// or the rollback (undo_gang).
template <bool kGangs, class Pol>
__device__ void admit_loop(const GangScanArgs& a, const WaveArgs& w, const WorkloadsArgs& k, const Region& r,
                           const step::StepScratch& sc, const step::StepShared& sh, Pol& pol, GangLog& gl) {
  using namespace step;
  const int tid = threadIdx.x;
  int landed = 0;  // K11: the same in every thread, each reads the step's choice
  for (int p = 0; p < a.P; ++p) {
    int gid = -1;
    bool is_first = false;
    if constexpr (kGangs) {
      gid = k.gang_id[p];
      is_first = gid >= 0 && k.gang_first[p];
      if (is_first) gl.start = p;  // a rollback restores the state before this pod's step
    }
    int choice = ABSENT;
    pol.stage_pod(a, p);
    if (!a.valid[p]) {  // a pad row: nothing feasible, nothing committed
      if (pol.leader()) {
        write_step(a, p, StepOut{ABSENT, 0, {0, 0, 0, 0, 0, 0, 0, 0, 0}});
        if constexpr (!kGangs) {
          w.kinds[p] = DEMOTE_NONE;
          w.cterms[p] = -1;
        }
      }
    } else {
      const unsigned char* dra_row = nullptr;
      if constexpr (kGangs) {
        if (k.dra_match != nullptr) {  // the pod's DRA verdict per node of the slice, its port lane
          const dra::PodRows dr = dra_rows(k, a.N, p);
          unsigned long long* const words = dra_words(k);
          for (int n = pol.lo + tid; n < pol.hi; n += blockDim.x)
            k.dra_row[n] = dra::node_verdict_any(dr, k.free, gl.claim, n, words);
          dra_row = k.dra_row;
          __syncthreads();
        }
      }
      pol.begin_pod();
      pol.stage_vals(a, w, p);
      pod_tables(a, w, r, p, sc.nodes, pol);
      const int spec = kGangs ? -1 : w.c0[p];
      const auto pv = pol.vals(a, &w, p);
      const StepOut out = pod_step_block(a, p, WaveDyn<decltype(pv)>{a, w, r, p, dra_row, pol.planes(a, p), pv},
                                         *r.any_dyn != 0, sc, sh, spec, true, pol);
      choice = out.choice;
      if (choice >= 0) commit_carries(a, w, r, pv, choice, sc.nodes, pol);
      if (tid == 0 && choice >= 0 && pol.owns(choice)) {
        commit_usage(a, sc.use, p, choice);
        if (w.has_ports) commit_ports(w, r, p, choice);
      }
      if constexpr (kGangs) {
        if (tid == 0 && k.dra_match != nullptr && choice >= 0) dra_commit(k, a.N, p, choice, gl, pol);
      }
      if (pol.leader()) {
        if constexpr (kGangs) {
          k.assigned[p] = choice;
        } else {  // the demotion, from the pre-commit verdict at the speculative node
          int kind = DEMOTE_NONE, cterm = -1;
          if (choice != spec) {
            if (spec < 0) {
              kind = DEMOTE_UPGRADE;
            } else {
              int at[6];
              pol.at_flags(sh, spec, at);
              if (!at[0]) kind = DEMOTE_PORTS;
              else if (!at[1]) kind = DEMOTE_SPREAD;
              else if (!at[2]) kind = DEMOTE_AFFINITY;
              else if (a.check_fit && !at[3]) kind = DEMOTE_FIT;
              else kind = DEMOTE_SCORE;
              cterm = kind == DEMOTE_SPREAD ? at[4] : (kind == DEMOTE_AFFINITY ? at[5] : -1);
            }
          }
          w.kinds[p] = kind;
          w.cterms[p] = cterm;
        }
        write_step(a, p, out);
      }
      pol.advance(a, out);
      pol.end_pod();
    }
    bool fail = false;
    if constexpr (kGangs) {
      if (tid == 0) gl.choice[p] = choice;
      landed = (is_first ? 0 : landed) + (gid >= 0 && choice >= 0 ? 1 : 0);
      const bool is_last = gid >= 0 && k.gang_last[p];
      fail = is_last && landed < k.gang_need[p];
      if (is_last && pol.leader() && gid < k.g_cap) {
        k.gang_admit[gid] = fail ? 0 : 1;
        k.gang_landed[gid] = landed;
      }
    }
    __syncthreads();  // the commits are visible to every thread of the CTA
    if constexpr (kGangs) {
      if (fail) {  // the gang rolls back whole
        undo_gang(a, w, k, r, sc, pol, gl, p);
        gl.start = p + 1;
        __syncthreads();
      }
    }
  }
}

// ---- the cluster kernel's layout and launch (K9 csrc/wave.cu, K11
// csrc/workloads.cu) --------------------------------------------------------

// The ints of one CTA's exchange slab: its partial sums (g1p, g2p [C, Dsp],
// gfp [AT, D2], anyp) with its min-match parts ([C, Dsp] and [C]:
// `part_cells`) and every CTA's [G, part_cells], its counted-domain flags
// [C, Dsp] and every CTA's as bits [G, C, Dw], the window's map
// [ceil(N / 32)], then its totals (g1, g2, gf, any_dyn, the min-match
// parts), the term lists [Tip] and [Tpt] and their two lengths.
__host__ __device__ inline long long part_cells(const GangScanArgs& a, const WaveArgs& w) {
  return 3LL * a.C * w.Dsp + (long long)a.AT * w.D2 + 1 + a.C;
}
__host__ __device__ inline int dom_words(const WaveArgs& w) { return (w.Dsp + 31) >> 5; }
__host__ __device__ inline long long slab_cells(const GangScanArgs& a, const WaveArgs& w) {
  return (2LL + w.cluster) * part_cells(a, w) + (long long)a.C * w.Dsp + (long long)w.cluster * a.C * dom_words(w) +
         ((a.N + 31) >> 5) + w.Tip + w.Tpt + 2;
}

// Byte offsets of the cluster kernel's dynamic shared memory (only the
// parts placed there), each part 16-byte aligned: s_wfx [C] (int64), s_min
// [C], s_ndom [C], the pod's values (StagedVals: ints, then int64s); the
// exchange slab (sums_smem); the slice's usage rows requested [S, Rn],
// nonzero [S, 2], num_pods [S] and step rows ip_raw / sp_raw [S] (int64),
// sp_cnt [C, S], feas [S] (rows_smem); its node statics allocatable
// [S, Rn], allowed_pods [S], visit_rank [S], dom_ids [K, S], node_valid [S]
// and two pods' staged planes (stage); the carries [Tsp + 2 Tip + Tpt, S]
// (carry_smem); K11 with claims its copy of claim_node [CL] and the
// pinners [CL] (WorkloadsArgs::claims_smem).
struct ClusterLayout {
  size_t wfx, smin, sndom, vals_i, vals_l, slab, req, nz, pods, ip_raw, sp_raw, sp_cnt, feas, alloc, allowed, vrank,
      dom, valid, stage, carries, claims, bytes;
};

__host__ __device__ inline ClusterLayout cluster_layout(const GangScanArgs& a, const WaveArgs& w,
                                                        const WorkloadsArgs& k) {
  const size_t S = w.slice, C = a.C;
  ClusterLayout l{};
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o = (o + bytes + 15) / 16 * 16;
    return at;
  };
  l.wfx = take(8 * C);
  l.smin = take(4 * C);
  l.sndom = take(4 * C);
  l.vals_i = take(4 * (size_t)step::StagedVals::ints(a.C, a.AT, a.Rp, w.Tsp, w.Tip));
  l.vals_l = take(8 * (size_t)step::StagedVals::longs(a.C, a.AT, w.Tip));
  if (w.sums_smem) l.slab = take(4 * (size_t)w.xch_cells);
  if (w.rows_smem) {
    l.req = take(4 * S * a.Rn);
    l.nz = take(8 * S);
    l.pods = take(4 * S);
    l.ip_raw = take(8 * S);
    l.sp_raw = take(8 * S);
    l.sp_cnt = take(4 * C * S);
    l.feas = take(S);
  }
  if (w.stage) {
    l.alloc = take(4 * S * a.Rn);
    l.allowed = take(4 * S);
    l.vrank = take(4 * S);
    l.dom = take(4 * S * a.K);
    l.valid = take(S);
    l.stage = take(2 * (size_t)step::stage_bytes(a, w.slice));
  }
  if (w.carry_smem) l.carries = take(4 * S * ((size_t)w.Tsp + 2 * (size_t)w.Tip + w.Tpt));
  if (k.claims_smem) l.claims = take(8 * (size_t)k.CL);
  l.bytes = o;
  return l;
}

// The admission recurrence on one thread-block cluster: K9 (kGangs false,
// `k` empty) or K11 (kGangs true).  Laid out as csrc/wave.cu describes.
template <bool kGangs>
__global__ void __launch_bounds__(step::CLUSTER_THREADS, 1)
    admit_cluster_kernel(const GangScanArgs a, const WaveArgs w, const WorkloadsArgs k) {
  using namespace step;
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ ClusterShared s_cl;
  __shared__ int s_at[6];
  __shared__ unsigned long long s_mbar[2];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), G = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int N = a.N, C = a.C, AT = a.AT, S = w.slice;
  const int lo = min(N, rank * S), hi = min(N, lo + S), len = hi - lo;
  const ClusterLayout l = cluster_layout(a, w, k);
  const StepShared sh{reinterpret_cast<long long*>(s_raw + l.wfx), reinterpret_cast<int*>(s_raw + l.smin),
                      reinterpret_cast<int*>(s_raw + l.sndom), s_at};

  // the exchange slab, then the region over it and the carries
  const Xch x{(long long)w.xch_cells, rank, w.sums_smem};
  int* const slab = w.sums_smem ? reinterpret_cast<int*>(s_raw + l.slab) : w.sums + (long long)rank * w.xch_cells;
  const long long cd = (long long)C * w.Dsp, xp = part_cells(a, w);
  const int Dw = dom_words(w);
  Region r;
  r.g1p = slab;
  r.g2p = r.g1p + cd;
  r.gfp = r.g2p + cd;
  r.anyp = r.gfp + (long long)AT * w.D2;
  int* const recv_part = r.g1p + xp;
  int* const flags = recv_part + (long long)G * xp;
  int* const recv_bits = flags + cd;
  int* const wmap = recv_bits + (long long)G * C * Dw;
  r.g1 = wmap + ((N + 31) >> 5);
  r.g2 = r.g1 + cd;
  r.gf = r.g2 + cd;
  r.any_dyn = r.gf + (long long)AT * w.D2;
  r.rev = r.g1 + xp;
  r.conf = r.rev + w.Tip;
  r.n_rev = r.conf + w.Tpt;
  r.n_conf = r.n_rev + 1;
  int* carries = w.carries;
  r.clo = 0;
  r.cld = N;
  if (w.carry_smem) {
    carries = reinterpret_cast<int*>(s_raw + l.carries);
    r.clo = lo;
    r.cld = S;
    for (long long i = tid; i < ((long long)w.Tsp + 2LL * w.Tip + w.Tpt) * S; i += blockDim.x) carries[i] = 0;
  }
  r.cnt_sp = carries;
  r.cnt_ip = r.cnt_sp + (long long)w.Tsp * r.cld;
  r.rev_cnt = r.cnt_ip + (long long)w.Tip * r.cld;
  r.occ_pt = r.rev_cnt + (long long)w.Tip * r.cld;

  // the step's rows and the usage rows: the slice in shared memory, staged
  // in from the usage state, or the global rows; likewise the node statics
  StepScratch sc = global_scratch(a, a.feas, a.ip_raw, a.sp_raw, a.sp_cnt);
  if (w.rows_smem) {
    sc.feas = s_raw + l.feas;
    sc.ip_raw = reinterpret_cast<long long*>(s_raw + l.ip_raw);
    sc.sp_raw = reinterpret_cast<long long*>(s_raw + l.sp_raw);
    sc.sp_cnt = reinterpret_cast<int*>(s_raw + l.sp_cnt);
    sc.lo = lo;
    sc.ld = S;
    sc.use = UsageRows{reinterpret_cast<int*>(s_raw + l.req), reinterpret_cast<int*>(s_raw + l.nz),
                       reinterpret_cast<int*>(s_raw + l.pods), lo};
    copy_usage(a, sc.use, len, true);
  }
  if (w.stage)
    sc.nodes = stage_nodes(a, reinterpret_cast<int*>(s_raw + l.alloc), reinterpret_cast<int*>(s_raw + l.allowed),
                           reinterpret_cast<int*>(s_raw + l.vrank), reinterpret_cast<int*>(s_raw + l.dom),
                           s_raw + l.valid, lo, len, S);
  // K11: the gang record (the choices' and claims' copies of this CTA) and
  // rank 0's outputs cleared
  GangLog gl{};
  if constexpr (kGangs) {
    gl.choice = k.choice_log + (long long)rank * a.P;
    if (k.dra_match != nullptr) {
      gl.claim = k.claims_smem ? reinterpret_cast<int*>(s_raw + l.claims) : k.claims + 2LL * rank * k.CL;
      gl.pinner = gl.claim + k.CL;
      for (int i = tid; i < k.CL; i += blockDim.x) {
        gl.claim[i] = k.claim_node[i];
        gl.pinner[i] = ABSENT;
      }
    }
    if (rank == 0) {
      for (int i = tid; i < a.P; i += blockDim.x) k.assigned[i] = ABSENT;
      for (int i = tid; i < k.g_cap; i += blockDim.x) {
        k.gang_admit[i] = -1;
        k.gang_landed[i] = 0;
      }
    }
  }
  if (tid == 0) init_mbars(s_mbar, s_cl);

  if (tid < CL_PHASES) s_cl.clock[tid] = 0;
  ClusterPolicy pol{};
  pol.lo = lo;
  pol.hi = hi;
  pol.S = S;
  pol.rank = rank;
  pol.G = G;
  pol.cur = a.sample_k > 0 ? *a.sample_start : 0;
  pol.cs = &s_cl;
  pol.flags = flags;
  pol.recv_bits = recv_bits;
  pol.recv_part = recv_part;
  pol.wmap = wmap;
  pol.s_min = sh.s_min;
  pol.C = C;
  pol.Dsp = w.Dsp;
  pol.Dw = Dw;
  pol.x = x;
  pol.stage = w.stage ? s_raw + l.stage : nullptr;
  pol.mbar = s_mbar;
  pol.stage_bytes = stage_bytes(a, S);
  pol.sv = StagedVals{reinterpret_cast<int*>(s_raw + l.vals_i), reinterpret_cast<long long*>(s_raw + l.vals_l), C,
                      AT, a.Rp, w.Tsp, w.Tip};
  cluster_barrier();  // every CTA of the cluster runs before any DSMEM access
  if (w.stage && tid == 0 && a.P > 0) pol.issue(a, 0);
  admit_loop<kGangs>(a, w, k, r, sc, sh, pol, gl);

  if (w.rows_smem) copy_usage(a, sc.use, len, false);  // the slice's usage rows back to the usage state
  if (pol.leader()) {
    if (a.sample_k > 0) *a.sample_start = pol.cur;
    if (w.admit_info != nullptr) {
      w.admit_info[0] = G;
      w.admit_info[1] = pol.syncs;
      for (int j = 0; j < CL_PHASES; ++j) w.admit_info[2 + j] = (int)(s_cl.clock[j] >> 4);
    }
    if constexpr (kGangs) {
      if (k.undone != nullptr) *k.undone = gl.undone;
    }
  }
  if constexpr (kGangs) {  // rank 0's copy of claim_node is the batch's
    if (rank == 0 && k.dra_match != nullptr)
      for (int i = tid; i < k.CL; i += blockDim.x) k.claim_node[i] = gl.claim[i];
  }
  cluster_barrier();  // no CTA leaves while a peer may still read its shared memory
}

// The placement at cluster size G: slice, exchange slab, and, in that order
// while they fit in `budget` bytes beside the fixed s_wfx / s_min / s_ndom,
// the exchange slab, the slice's rows, its node statics with the pods'
// staged planes (when `stage` allows it), and its carries in shared memory;
// then K11's claim copies where they still fit.
inline void place(const GangScanArgs& a, WaveArgs& w, WorkloadsArgs& k, int G, long long budget, bool stage) {
  w.cluster = G;
  w.slice = step::slice_nodes(a.N, G);
  w.xch_cells = (int)slab_cells(a, w);
  w.sums_smem = w.rows_smem = w.stage = w.carry_smem = 0;
  k.claims_smem = 0;
  int* const flags[4] = {&w.sums_smem, &w.rows_smem, &w.stage, &w.carry_smem};
  for (int* f : flags) {
    if (f == &w.stage && !stage) continue;
    *f = 1;
    if ((long long)cluster_layout(a, w, k).bytes > budget) {
      *f = 0;
      if (f != &w.stage) break;
    }
  }
  if (k.dra_match != nullptr) {
    k.claims_smem = 1;
    if ((long long)cluster_layout(a, w, k).bytes > budget) k.claims_smem = 0;
  }
}

// The launch plan into `w` (and K11's `k`): the cluster size (16 where the
// card admits one cluster of 16 at the kernel's shared memory and
// cluster_cap allows it, else 8), the slice and what sits in shared memory
// under min(smem_cap, the card's opt-in limit less the static shared
// memory); the pods' planes are staged only with `stage` and 16-byte
// aligned rows.  Returns a CUDA status.
template <bool kGangs>
int admit_plan(const GangScanArgs& a, WaveArgs& w, WorkloadsArgs& k, int cluster_cap, int smem_cap, int stage) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, admit_cluster_kernel<kGangs>);
  if (e != cudaSuccess) return (int)e;
  const long long limit = (long long)optin - (long long)fa.sharedSizeBytes;
  const long long budget = smem_cap < limit ? smem_cap : limit;
  const bool staged = stage && step::stage_aligned(a);
  auto smem = [&](int G) {
    place(a, w, k, G, budget, staged);
    return cluster_layout(a, w, k).bytes;
  };
  int G = 8;
  e = step::cluster_size(admit_cluster_kernel<kGangs>, cluster_cap, smem, &G);
  if (e == cudaSuccess) smem(G);
  return (int)e;
}

// Enqueues the cluster kernel (as admit_plan laid it out) on `stream` and
// returns the launch status (cudaGetLastError).
template <bool kGangs>
int admit_launch(const GangScanArgs& a, const WaveArgs& w, const WorkloadsArgs& k, void* stream) {
  if (a.P == 0) return 0;
  const size_t smem = cluster_layout(a, w, k).bytes;
  cudaError_t e =
      cudaFuncSetAttribute(admit_cluster_kernel<kGangs>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(admit_cluster_kernel<kGangs>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = step::cluster_config(w.cluster, smem, static_cast<cudaStream_t>(stream), attr);
  e = cudaLaunchKernelEx(&cfg, admit_cluster_kernel<kGangs>, a, w, k);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace wave
}  // namespace ktpu
