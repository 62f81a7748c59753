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
