// K1: per-signature static evaluation of the signature fast path.
//
// Replaces the JAX root kubernetes_tpu/ops/fastpath.py:50 static_eval (an
// XLA-compiled jit root: NodeName, NodeUnschedulable, TaintToleration and
// NodeAffinity masks, the raw TaintToleration and preferred NodeAffinity
// scores, and the ImageLocality score for an [S, N] signature × node grid).
//
// Design: one thread per (signature, node) pair.  The work is integer
// gathers over small ragged tables (taint slots × toleration slots, DNF
// terms × requirements × values over the node's label row), not a dense
// elementwise pass, so each thread walks its tables with early exits and
// writes the 8 outputs once.  ImageLocality needs, per image, the count of
// valid nodes holding it — a reduction over N — so a first kernel counts
// them (one block per image column) before the main kernel reads the counts.
//
// Bound on the H100: bytes.  Each thread writes 5 bool + 3 int64 outputs
// (29 bytes) and reads its node's label row, taint slots and image row; the
// signature tables are a few KB and stay in L1/L2.  The arithmetic is a few
// hundred integer operations per pair.
//
// Semantics are those of kubernetes_tpu_torch/ops/common.py eval_table and
// ops/filters.py / ops/scores.py, which the chip check holds this kernel to
// with exact equality.  Every division has a non-negative numerator (sizes,
// node counts, a clamped sum minus its lower clamp), so C++ truncation
// equals the reference's floor division.
#include "ktpu.cuh"

using namespace ktpu;

namespace {

constexpr int SPREAD_THREADS = 256;
constexpr int EVAL_THREADS = 256;

// One DNF term: AND over its requirement slots (labels.Requirement.Matches).
__device__ bool eval_term(const int* key, const int* op, const int* vals,
                          const int* rhs, int R, int V, const int* labels,
                          int K, const int* val_ints, int NVI) {
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

// OR over the terms of one signature's table (term_valid folded in).
__device__ bool any_term(const int* key, const int* op, const int* vals,
                         const int* rhs, const unsigned char* tv, int s,
                         int T, int R, int V, const int* labels, int K,
                         const int* val_ints, int NVI) {
  for (int t = 0; t < T; ++t) {
    const long long st = (long long)s * T + t;
    if (tv[st] && eval_term(key + st * R, op + st * R, vals + st * R * V,
                            rhs + st * R, R, V, labels, K, val_ints, NVI))
      return true;
  }
  return false;
}

// Does any toleration of signature s tolerate the taint (key, val, eff)?
// pref_only restricts to tolerations with effect "" or PreferNoSchedule.
__device__ bool tolerated(const StaticEvalArgs& a, int s, int tk_taint,
                          int tv_taint, int te_taint, bool pref_only) {
  for (int l = 0; l < a.TL; ++l) {
    const int i = s * a.TL + l;
    const int to = a.tol_op[i];
    if (to == PAD) continue;
    const int te = a.tol_eff[i];
    if (pref_only && te != EFFECT_ALL && te != EFFECT_PREFER_NO_SCHEDULE)
      continue;
    const int tk = a.tol_key[i];
    const bool effect_ok = te == EFFECT_ALL || te == te_taint;
    const bool wildcard = tk == ABSENT && to == TOL_OP_EXISTS;
    const bool key_eq = tk == tk_taint;
    const bool val_ok = to == TOL_OP_EXISTS || a.tol_val[i] == tv_taint;
    if (effect_ok && (wildcard || (key_eq && val_ok))) return true;
  }
  return false;
}

__global__ void image_spread_kernel(const long long* img_sizes,
                                    const unsigned char* node_valid, int N,
                                    int IMG, long long* spread) {
  __shared__ long long part[SPREAD_THREADS];
  const int c = blockIdx.x;
  long long cnt = 0;
  for (int n = threadIdx.x; n < N; n += SPREAD_THREADS)
    cnt += (img_sizes[(long long)n * IMG + c] > 0 && node_valid[n]) ? 1 : 0;
  part[threadIdx.x] = cnt;
  __syncthreads();
  for (int w = SPREAD_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) spread[c] = part[0];
}

__global__ void __launch_bounds__(EVAL_THREADS)
    static_eval_kernel(const StaticEvalArgs a) {
  const long long idx = (long long)blockIdx.x * EVAL_THREADS + threadIdx.x;
  if (idx >= (long long)a.S * a.N) return;
  const int s = (int)(idx / a.N);
  const int n = (int)(idx % a.N);
  const int* labels = a.node_labels + (long long)n * a.K;

  bool m_name = true;
  if (a.enabled & EN_NODE_NAME) {
    const int tgt = a.target_name[s];
    const int nv =
        (a.name_key >= 0 && a.name_key < a.K) ? labels[a.name_key] : ABSENT;
    m_name = tgt == ABSENT || nv == tgt;
  }

  bool m_uns = true;
  if (a.enabled & EN_UNSCHEDULABLE)
    m_uns = !a.unsched[n] ||
            tolerated(a, s, a.unsched_key, a.empty_val, EFFECT_NO_SCHEDULE,
                      false);

  bool m_taint = true;
  long long taint_raw = 0;
  for (int t = 0; t < a.T; ++t) {
    const long long nt = (long long)n * a.T + t;
    const int tk = a.taint_key[nt];
    if (tk == PAD) continue;
    const int te = a.taint_eff[nt];
    const int tv = a.taint_val[nt];
    if ((a.enabled & EN_TAINTS) && m_taint &&
        (te == EFFECT_NO_SCHEDULE || te == EFFECT_NO_EXECUTE) &&
        !tolerated(a, s, tk, tv, te, false))
      m_taint = false;
    if (te == EFFECT_PREFER_NO_SCHEDULE && !tolerated(a, s, tk, tv, te, true))
      ++taint_raw;
  }

  bool m_aff = true;
  if (a.enabled & EN_NODE_AFFINITY)
    m_aff = any_term(a.ns_key, a.ns_op, a.ns_vals, a.ns_rhs, a.ns_tv, s, a.NT,
                     a.NR, a.NV, labels, a.K, a.val_ints, a.NVI);

  long long naff_raw = 0;
  for (int t = 0; t < a.PT; ++t) {
    const long long st = (long long)s * a.PT + t;
    if (a.pf_tv[st] &&
        eval_term(a.pf_key + st * a.PR, a.pf_op + st * a.PR,
                  a.pf_vals + st * a.PR * a.PV, a.pf_rhs + st * a.PR, a.PR,
                  a.PV, labels, a.K, a.val_ints, a.NVI))
      naff_raw += a.pf_weight[st];
  }

  long long img = 0;
  if (a.has_images) {
    const long long total = a.n_valid_nodes > 1 ? a.n_valid_nodes : 1;
    long long sum = 0;
    bool has = false;
    for (int i = 0; i < a.I; ++i) {
      const int ii = a.img_ids[s * a.I + i];
      if (ii >= 0) has = true;
      if (ii >= 0 && ii < a.IMG)
        sum += a.img_sizes[(long long)n * a.IMG + ii] * a.spread[ii] / total;
    }
    if (has) {
      const long long nc = a.n_containers[s];
      const long long min_th = 23LL * 1024 * 1024 * nc;
      const long long max_th = 1000LL * 1024 * 1024 * nc;
      const long long cl = sum < min_th ? min_th : (sum > max_th ? max_th : sum);
      const long long den = max_th - min_th > 1 ? max_th - min_th : 1;
      img = MAX_NODE_SCORE * (cl - min_th) / den;
    }
  }

  a.mask[idx] = a.node_valid[n] && a.valid[s] && m_name && m_uns && m_taint &&
                m_aff;
  a.m_nodename[idx] = m_name;
  a.m_unsched[idx] = m_uns;
  a.m_taints[idx] = m_taint;
  a.m_nodeaff[idx] = m_aff;
  a.taint_raw[idx] = taint_raw;
  a.naff_raw[idx] = naff_raw;
  a.img[idx] = img;
}

}  // namespace

// Enqueues K1 on `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_static_eval(const StaticEvalArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const StaticEvalArgs a = *args;
  if (a.has_images && a.IMG > 0) {
    image_spread_kernel<<<a.IMG, SPREAD_THREADS, 0, st>>>(
        a.img_sizes, a.node_valid, a.N, a.IMG, a.spread);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long pairs = (long long)a.S * a.N;
  if (pairs == 0) return 0;
  const unsigned blocks = (unsigned)((pairs + EVAL_THREADS - 1) / EVAL_THREADS);
  static_eval_kernel<<<blocks, EVAL_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
