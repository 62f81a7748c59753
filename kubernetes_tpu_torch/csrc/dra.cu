// K13 dra_selector_match and K14 dra_spec_mask: the DRA claim match of the
// workloads dispatch, one launch each per workloads batch with claims.
//
// K13 replaces the JAX function kubernetes_tpu/ops/dra.py:275
// selector_match (evaluated inside the workloads_schedule jit root): device
// slot (n, d) matches request slot (p, q) when the device is valid and every
// selector requirement of the slot admits its attributes,
//
//   In            the attribute is present and its value is one of the values
//   NotIn         absent, or its value is none of the values
//   Exists        present
//   DoesNotExist  absent (and every other code: the reference's last branch)
//   PAD           a padded requirement slot passes
//
// where a selector key or value the interner saw only in a selector matches
// no device attribute.  Design: one thread per (p, q, n, d), a block per
// (256 device slots, p q): the threads of a block read one requirement row
// (the same addresses: a broadcast) and each its device's DA attribute
// pairs, and write one byte of the [P, DQ, N, DD] output, coalesced.
// Bound on the H100: bytes.  The output is P DQ N DD bytes (42 MB at P=512,
// DQ=2, N=5,120, DD=8) against a few MB of attribute rows, which every
// (p, q) block row reads again from L2.
//
// K14 replaces the reference's speculation lane, the vmap of node_feasible
// against the pre-batch state in workloads_schedule's spec_one
// (kubernetes_tpu/ops/coscheduling.py:286-293): mask[p, n] is pod p's DRA
// verdict at node n against free0 and claim_node0, which K8 reads as its
// port lane.  Design: one thread per (p, n), a block per (256 nodes, p),
// each thread walking the pod's DQ request slots over its node's DD device
// slots with the pod's greedy free set as bit words; the verdict is
// ktpu::dra::node_verdict (csrc/ktpu.cuh), which K11 runs against its
// carries.  The words sit in registers, the kernel instantiated for 1, 2 or
// 4 of them, while DD <= 256; past that each thread keeps them in its own
// scratch row in global memory (the grid's p stride capped at the rows the
// wrapper allocated).  Bound on the H100: bytes (the P DQ N DD match bytes
// are read once; the arithmetic is a few popcounts per slot).
#include "ktpu.cuh"

using namespace ktpu;

namespace {

constexpr int DRA_THREADS = 256;

// The match of request slot pq (p DQ + q) at device slot nd (n DD + d).
__device__ __forceinline__ void match_one(const int* dev_key, const int* dev_val, const unsigned char* dev_valid,
                                          const int* sel_key, const int* sel_op, const int* sel_vals,
                                          unsigned char* out, long long pq, long long nd, int DS, int DV,
                                          long long ND, int DA) {
  const int* keys = sel_key + pq * DS;
  const int* ops = sel_op + pq * DS;
  const int* vals = sel_vals + pq * DS * DV;
  const int* ak = dev_key + nd * DA;
  const int* av = dev_val + nd * DA;
  bool ok = dev_valid[nd] != 0;
  for (int s = 0; s < DS && ok; ++s) {
    const int op = ops[s];
    if (op == PAD) continue;
    const int key = keys[s];
    bool present = false;
    int val = ABSENT;
    for (int a = 0; a < DA; ++a) {
      const int k = ak[a];
      if (k >= 0 && k == key) {  // the last matching pair wins, as the plain version's where
        present = true;
        val = av[a];
      }
    }
    bool in_any = false;
    if (present)
      for (int v = 0; v < DV; ++v) {
        const int sv = vals[(long long)s * DV + v];
        if (sv >= 0 && sv == val) in_any = true;
      }
    bool res;
    if (op == OP_IN) res = in_any;
    else if (op == OP_NOT_IN) res = !in_any;
    else if (op == OP_EXISTS) res = present;
    else res = !present;
    ok = res;
  }
  out[pq * ND + nd] = ok;
}

__global__ void __launch_bounds__(DRA_THREADS)
    selector_match_kernel(const int* dev_key, const int* dev_val, const unsigned char* dev_valid, const int* sel_key,
                          const int* sel_op, const int* sel_vals, unsigned char* out, long long PQ, int DS, int DV,
                          long long ND, int DA) {
  const long long nd = (long long)blockIdx.x * DRA_THREADS + threadIdx.x;
  if (nd >= ND) return;
  for (long long pq = blockIdx.y; pq < PQ; pq += gridDim.y) match_one(dev_key, dev_val, dev_valid, sel_key, sel_op,
                                                                     sel_vals, out, pq, nd, DS, DV, ND, DA);
}

template <int W>
__global__ void __launch_bounds__(DRA_THREADS)
    spec_mask_kernel(const unsigned char* match, const unsigned char* free0, const int* claim_node0,
                     const int* req_count, const unsigned char* req_all, const int* req_cl,
                     const unsigned char* q_valid, const unsigned char* req_bad, const int* ref_cl,
                     unsigned char* out, unsigned long long* scratch, int P, int DQ, int N, int DD, int CL, int CQ) {
  const int n = blockIdx.x * DRA_THREADS + threadIdx.x;
  if (n >= N) return;
  unsigned long long* const words =
      W > 0 ? nullptr : scratch + ((long long)blockIdx.y * N + n) * dra::scratch_words(DD);
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    const dra::PodRows r = dra::pod_rows(match, req_count, req_all, req_cl, q_valid, req_bad, ref_cl, p, DQ, CQ, N,
                                         DD, CL);
    out[(long long)p * N + n] = dra::node_verdict<W>(r, free0, claim_node0, n, words);
  }
}

}  // namespace

// Enqueues K13 on `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_dra_selector_match(const int* dev_key, const int* dev_val, const unsigned char* dev_valid,
                                       const int* sel_key, const int* sel_op, const int* sel_vals,
                                       unsigned char* out, int P, int DQ, int DS, int DV, int N, int DD, int DA,
                                       void* stream) {
  const long long ND = (long long)N * DD;
  if (P == 0 || DQ == 0 || ND == 0) return 0;
  const long long PQ = (long long)P * DQ;
  const dim3 grid((unsigned)((ND + DRA_THREADS - 1) / DRA_THREADS), (unsigned)(PQ < 65535 ? PQ : 65535));
  selector_match_kernel<<<grid, DRA_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      dev_key, dev_val, dev_valid, sel_key, sel_op, sel_vals, out, PQ, DS, DV, ND, DA);
  return (int)cudaGetLastError();
}

// Enqueues K14 on `stream` and returns the launch status (cudaGetLastError).
// Past dra::REG_DD slots `scratch` holds scratch_rows * N rows of
// dra::scratch_words(DD) words, one per thread of a grid scratch_rows high.
extern "C" int ktpu_dra_spec_mask(const unsigned char* match, const unsigned char* free0, const int* claim_node0,
                                  const int* req_count, const unsigned char* req_all, const int* req_cl,
                                  const unsigned char* q_valid, const unsigned char* req_bad, const int* ref_cl,
                                  unsigned char* out, unsigned long long* scratch, int P, int DQ, int N, int DD, int CL,
                                  int CQ, int scratch_rows, void* stream) {
  if (P == 0 || N == 0) return 0;
  const bool regs = DD <= dra::REG_DD;
  if (!regs && (scratch == nullptr || scratch_rows < 1)) return (int)cudaErrorInvalidValue;
  const int gy = regs ? (P < 65535 ? P : 65535) : (P < scratch_rows ? P : scratch_rows);
  const dim3 grid((unsigned)((N + DRA_THREADS - 1) / DRA_THREADS), (unsigned)gy);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KTPU_SPEC_MASK(W)                                                                                      \
  spec_mask_kernel<W><<<grid, DRA_THREADS, 0, st>>>(match, free0, claim_node0, req_count, req_all, req_cl, q_valid, \
                                                    req_bad, ref_cl, out, scratch, P, DQ, N, DD, CL, CQ)
  if (DD <= 64) KTPU_SPEC_MASK(1);
  else if (DD <= 128) KTPU_SPEC_MASK(2);
  else if (regs) KTPU_SPEC_MASK(4);
  else KTPU_SPEC_MASK(0);
#undef KTPU_SPEC_MASK
  return (int)cudaGetLastError();
}
