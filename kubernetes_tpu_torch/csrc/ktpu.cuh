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
  // sizes and scalars
  int N, K, NVI, T, IMG;
  int S, NT, NR, NV, PT, PR, PV, TL, I;
  int name_key, unsched_key, empty_val, n_valid_nodes;
  int enabled, has_images;
};

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
  int N, K, Rn, Rp, L, P, C, AT, KD2, D, JP, use_smem;
  int w_taint, w_naff, w_spread, w_ip, w_fit, w_bal, w_img, check_fit;
};
