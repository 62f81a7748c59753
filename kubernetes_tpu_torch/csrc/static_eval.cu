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
// `mask` ANDs the filters of `mask_enabled` (the profile's, where the gang
// precompute asks for every m_* verdict) and the optional `extra` lane (the
// precompute's host-filter lane: K12's volume mask on the workloads route).
//
// Semantics are those of kubernetes_tpu_torch/ops/common.py eval_table
// (ktpu.cuh eval_term, shared with K6 and K7; the four filter verdicts are
// ktpu.cuh static_filters, shared with K10) and ops/filters.py /
// ops/scores.py, which the chip check holds this kernel to
// with exact equality.  Every division has a non-negative numerator (sizes,
// node counts, a clamped sum minus its lower clamp), so C++ truncation
// equals the reference's floor division.
#include "ktpu.cuh"

using namespace ktpu;

namespace {

constexpr int SPREAD_THREADS = 256;
constexpr int EVAL_THREADS = 256;

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

  const StaticVerdict v = static_filters(a, s, n);
  long long taint_raw = 0;
  for (int t = 0; t < a.T; ++t) {
    const long long nt = (long long)n * a.T + t;
    const int tk = a.taint_key[nt];
    if (tk == PAD) continue;
    const int te = a.taint_eff[nt];
    if (te == EFFECT_PREFER_NO_SCHEDULE && !tolerated(a, s, tk, a.taint_val[nt], te, true)) ++taint_raw;
  }

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

  const int me = a.mask_enabled;
  a.mask[idx] = a.node_valid[n] && a.valid[s] && (v.name || !(me & EN_NODE_NAME)) &&
                (v.unsched || !(me & EN_UNSCHEDULABLE)) && (v.taints || !(me & EN_TAINTS)) &&
                (v.affinity || !(me & EN_NODE_AFFINITY)) && (a.extra == nullptr || a.extra[idx]);
  a.m_nodename[idx] = v.name;
  a.m_unsched[idx] = v.unsched;
  a.m_taints[idx] = v.taints;
  a.m_nodeaff[idx] = v.affinity;
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
