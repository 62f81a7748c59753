// K12 volume_topology_mask: the bound-PV topology filter of the workloads
// dispatch as a [P, N] mask, one launch per workloads batch that carries
// volume rows.
//
// Replaces the JAX function kubernetes_tpu/ops/coscheduling.py:66
// volume_topology_mask (evaluated inside the workloads_run jit root): every
// bound PV of a pod, packed one per PV2 slot with its node-affinity DNF on
// the term axis (and, for a zone- or region-labelled PV, one more slot of
// `key In zone-set` conjunctions), must admit the node:
//
//   mask[p, n] = !vol_bad[p] && AND over j with vol_valid[p, j] of
//                (OR over t of term_valid[p, j, t] && eval_term(row p,j,t; node n))
//
// The requirement semantics are ktpu.cuh eval_term, the conjunction
// evaluator K1 uses for node selectors (the plain version is
// ops/coscheduling.py volume_topology_mask_plain, through ops/common.py
// eval_table and dnf_any).
//
// Design: one thread per (pod, node) pair, a block per (pod, 256 nodes): the
// block copies its pod's table rows (PV2 x T x R requirement slots and their
// V values, a few hundred bytes) into shared memory once, then each thread
// walks them against its node's label row with early exits.  A pod's rows
// too large for 48 KB of shared memory are read from global memory instead.
//
// Bound on the H100: bytes.  The output is P x N bools and each thread reads
// its node's label row (K ints); the tables and val_ints are a few KB and
// stay in shared memory and L1/L2.  The arithmetic is a handful of integer
// compares per requirement slot.
#include "ktpu.cuh"

using namespace ktpu;

namespace {

constexpr int VOL_THREADS = 256;
constexpr long long VOL_SMEM_CAP = 48 * 1024;

struct VolTable {
  const int* key;             // [PV2, T, R]
  const int* op;              // [PV2, T, R]
  const int* rhs;             // [PV2, T, R]
  const int* vals;            // [PV2, T, R, V]
  const unsigned char* tv;    // [PV2, T]
  const unsigned char* vv;    // [PV2]
};

__global__ void __launch_bounds__(VOL_THREADS)
    volume_mask_kernel(const int* key, const int* op, const int* vals, const int* rhs, const unsigned char* tv,
                       const unsigned char* vol_valid, const unsigned char* vol_bad, const int* node_labels,
                       const int* val_ints, unsigned char* out, int PV2, int T, int R, int V, int N, int K, int NVI,
                       int use_smem) {
  extern __shared__ int smem[];
  const int p = blockIdx.y;
  const long long slots = (long long)PV2 * T * R;
  VolTable g{key + p * slots, op + p * slots, rhs + p * slots, vals + p * slots * V, tv + (long long)p * PV2 * T,
             vol_valid + (long long)p * PV2};
  VolTable t = g;
  if (use_smem) {
    int* s_key = smem;
    int* s_op = s_key + slots;
    int* s_rhs = s_op + slots;
    int* s_vals = s_rhs + slots;
    unsigned char* s_tv = reinterpret_cast<unsigned char*>(s_vals + slots * V);
    unsigned char* s_vv = s_tv + (long long)PV2 * T;
    for (long long i = threadIdx.x; i < slots; i += VOL_THREADS) {
      s_key[i] = g.key[i];
      s_op[i] = g.op[i];
      s_rhs[i] = g.rhs[i];
    }
    for (long long i = threadIdx.x; i < slots * V; i += VOL_THREADS) s_vals[i] = g.vals[i];
    for (long long i = threadIdx.x; i < (long long)PV2 * T; i += VOL_THREADS) s_tv[i] = g.tv[i];
    for (int i = threadIdx.x; i < PV2; i += VOL_THREADS) s_vv[i] = g.vv[i];
    __syncthreads();
    t = VolTable{s_key, s_op, s_rhs, s_vals, s_tv, s_vv};
  }
  const int n = blockIdx.x * VOL_THREADS + threadIdx.x;
  if (n >= N) return;
  bool ok = !vol_bad[p];
  const int* labels = node_labels + (long long)n * K;
  for (int j = 0; j < PV2 && ok; ++j) {
    if (!t.vv[j]) continue;  // an empty slot (or a nil-affinity PV) admits every node
    bool any = false;
    for (int k = 0; k < T && !any; ++k) {
      const long long jt = (long long)j * T + k;
      any = t.tv[jt] && eval_term(t.key + jt * R, t.op + jt * R, t.vals + jt * R * V, t.rhs + jt * R, R, V, labels,
                                   K, val_ints, NVI);
    }
    ok = any;
  }
  out[(long long)p * N + n] = ok;
}

}  // namespace

// Enqueues K12 on `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_volume_topology_mask(const int* key, const int* op, const int* vals, const int* rhs,
                                         const unsigned char* term_valid, const unsigned char* vol_valid,
                                         const unsigned char* vol_bad, const int* node_labels, const int* val_ints,
                                         unsigned char* out, int P, int PV2, int T, int R, int V, int N, int K,
                                         int NVI, void* stream) {
  if (P == 0 || N == 0) return 0;
  const long long slots = (long long)PV2 * T * R;
  const long long smem = 4 * (3 * slots + slots * V) + (long long)PV2 * T + PV2;
  const int use_smem = smem <= VOL_SMEM_CAP ? 1 : 0;
  const dim3 grid((unsigned)((N + VOL_THREADS - 1) / VOL_THREADS), (unsigned)P);
  volume_mask_kernel<<<grid, VOL_THREADS, use_smem ? (size_t)smem : 0, static_cast<cudaStream_t>(stream)>>>(
      key, op, vals, rhs, term_valid, vol_valid, vol_bad, node_labels, val_ints, out, PV2, T, R, V, N, K, NVI,
      use_smem);
  return (int)cudaGetLastError();
}
