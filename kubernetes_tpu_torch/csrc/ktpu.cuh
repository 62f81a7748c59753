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
