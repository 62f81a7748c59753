// K5: the gang scan, one launch per batch.
//
// Replaces the JAX root kubernetes_tpu/ops/gang.py:975 gang_schedule (a
// lax.scan of pod_step, :680, with its fit strategies :804-846, sampling
// window :751-780 and seeded tie-break :905-915): for each pod of the batch
// in order, the dynamic resource fit, the spread and inter-pod verdicts
// against the batch peers already committed, the first-failure reason
// counts in DIAG_KERNELS order, the seven weighted scores with their
// normalizations over the live feasible set, the first-max argmax (ties to
// the lower node index, as jnp.argmax), and the commit into the carried
// usage.
//
// Design: the pods form a serial recurrence, so the whole batch runs in ONE
// persistent block of 1024 threads that loops over the P pods (as K2 does).
// The reference re-derives the peers' contributions every step with dense
// [C, N, J] / [AT, N, J] compares (O(P^2 N) per batch).  Here each step
// instead walks the committed peers once (O(P)) and counts them into
// per-domain counters indexed by the COMPACT domain id of the peer's node
// under the slot's topology key (DeviceCluster.dom_ids, the numbering K6
// and K7 accumulate under), D cells per row:
//   cnt_f[c][d]  peers matching constraint c, tracked+eligible at their node
//   cnt_s[c][d]  peers matching c, counted by the score at their node
//   seen[c][d]   stamp of the last pod that counted domain d (n_dom)
//   cnt_i[u][d]  peers matching the pod's inter-pod term u
//   viol_t[k][d] / sym_t[k][d]  the committed peers' OWN terms that admit
//                the pod, per (distinct topology key, domain): their
//                anti-affinity flags and symmetric weights
// and every node then reads its own domain's cells (O(N) per step).  The
// counters sit in dynamic shared memory when (3C + AT + 2 KD2) * D ints
// fit (D is the largest domain count among the batch's keys: 8 for a
// zone, N for the hostname), else in a global scratch row.  Per-node peer
// counts for hostname spread (cnt_h) stay global.  The cells a step touched
// are cleared by walking the peers again, so the counters cost O(P + N) per
// step.  Per-slot values live in dynamic shared memory too, so the number
// of spread and inter-pod slots per pod is not capped.  Scores are int64
// throughout; every division is a floor division (fdiv), which equals C
// truncation where the numerator is non-negative and the reference's //
// everywhere.  The spread score's 32.32 fixed point uses an arithmetic >>
// and round-half-to-even, as _spread_raw does.
//
// The per-pod verdict, scores and argmax are ktpu::step::pod_step_block
// (csrc/ktpu.cuh), shared with K8 and K9 (csrc/wave.cu); this file supplies
// the peers' counts from the counters above and commits, advancing the
// window's rotation cursor (GangScanArgs::sample_start, the reference's
// :953-961 carry) after each real pod.
//
// Bound on the H100: the recurrence.  Per step the block reads the pod's
// [C, N] and [AT, N] static rows once and runs ~6 block-wide reductions and
// their barriers; one block uses one SM of 132.
#include "ktpu.cuh"

using namespace ktpu;
using namespace ktpu::step;

namespace {

constexpr int SCAN_THREADS = 1024;

// The peer counters, D cells per row (see the header).
struct Counters {
  int *cnt_f, *cnt_s, *seen, *cnt_i, *viol_t, *sym_t;
};

__device__ __forceinline__ Counters counters(const GangScanArgs& a, int* base) {
  const long long D = a.D, C = a.C;
  Counters k;
  k.cnt_f = base;
  k.cnt_s = base + C * D;
  k.seen = base + 2 * C * D;
  k.cnt_i = base + 3 * C * D;
  k.viol_t = k.cnt_i + (long long)a.AT * D;
  k.sym_t = k.viol_t + (long long)a.KD2 * D;
  return k;
}

// Walk the committed peers j < p and count them into their cells (add) or
// zero the same cells again (clear).
__device__ void peer_pass(const GangScanArgs& a, const Counters& k, int p, bool add, int* s_any_dyn) {
  const int C = a.C, AT = a.AT, N = a.N, P = a.P, D = a.D;
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    const int nj = a.chosen[j];
    if (nj < 0) continue;
    if (add && a.JP && a.port_b[(long long)p * a.JP + j]) a.port_stamp[nj] = p + 1;
    for (int c = 0; c < C; ++c) {
      const long long pc = (long long)p * C + c;
      if (!a.sp_bmatch[pc * P + j]) continue;
      const int d = dom_at(a, a.sp_key[pc], nj);
      if (d >= 0 && a.sp_te[pc * N + nj]) {
        if (add) atomicAdd(k.cnt_f + (long long)c * D + d, 1);
        else k.cnt_f[(long long)c * D + d] = 0;
      }
      if (a.sp_is_host[pc]) {
        if (add) atomicAdd(a.cnt_h + (long long)c * N + nj, 1);
        else a.cnt_h[(long long)c * N + nj] = 0;
      } else if (d >= 0 && a.sp_counting[pc * N + nj]) {
        if (add) atomicAdd(k.cnt_s + (long long)c * D + d, 1);
        else k.cnt_s[(long long)c * D + d] = 0;
      }
    }
    for (int u = 0; u < AT; ++u) {
      const long long pu = (long long)p * AT + u;
      if (!a.ip_bmatch[pu * P + j]) continue;
      if (add && a.ip_is_aff[pu]) *s_any_dyn = 1;
      const int d = dom_at(a, a.ip_key[pu], nj);
      if (d < 0) continue;
      if (add) atomicAdd(k.cnt_i + (long long)u * D + d, 1);
      else k.cnt_i[(long long)u * D + d] = 0;
    }
    // the peer's own terms that admit p
    for (int u = 0; u < AT; ++u) {
      const long long ju = (long long)j * AT + u;
      if (!a.ip_bmatch[ju * P + p]) continue;
      const int ki = a.ip_key_idx[ju];
      if (ki < 0) continue;
      const int d = dom_at(a, a.ip_key[ju], nj);
      if (d < 0) continue;
      const long long cell = (long long)ki * D + d;
      if (add) {
        if (a.ip_is_anti[ju]) k.viol_t[cell] = 1;
        atomicAdd(k.sym_t + cell, (int)a.ip_sym_w[ju]);  // the reference's int32 cast
      } else {
        k.viol_t[cell] = 0;
        k.sym_t[cell] = 0;
      }
    }
  }
}

// The committed peers' counts for pod p's step, read from the counters.
struct ScanDyn {
  const GangScanArgs& a;
  Counters k;
  int stamp;
  __device__ int f(int c, long long, int, int d) const { return d >= 0 ? k.cnt_f[(long long)c * a.D + d] : 0; }
  __device__ int sc(int c, long long, int n, int d, bool host) const {
    return host ? a.cnt_h[(long long)c * a.N + n] : (d >= 0 ? k.cnt_s[(long long)c * a.D + d] : 0);
  }
  __device__ int ip(int u, long long, int, int d) const { return d >= 0 ? k.cnt_i[(long long)u * a.D + d] : 0; }
  __device__ bool viol(int n) const {
    for (int ki = 0; ki < a.KD2; ++ki) {
      const int d = dom_at(a, a.kd2_key[ki], n);
      if (d >= 0 && k.viol_t[(long long)ki * a.D + d]) return true;
    }
    return false;
  }
  __device__ long long sym(int n) const {
    int sym_b = 0;  // int32, as the reference's einsum
    for (int ki = 0; ki < a.KD2; ++ki) {
      const int d = dom_at(a, a.kd2_key[ki], n);
      if (d >= 0) sym_b += k.sym_t[(long long)ki * a.D + d];
    }
    return sym_b;
  }
  __device__ bool portb(int n) const { return !(a.JP && a.port_stamp[n] == stamp); }
};

__global__ void __launch_bounds__(SCAN_THREADS) gang_scan_kernel(const GangScanArgs a) {
  // dynamic: s_wfx [C] (int64), s_min [C], s_ndom [C], then the counters
  // when use_smem
  extern __shared__ long long s_dyn[];
  __shared__ long long s_buf[32 * 16];
  __shared__ int s_any_dyn;
  __shared__ long long s_best_v[32];
  __shared__ int s_best_i[32];
  const int tid = threadIdx.x;
  const int C = a.C, AT = a.AT, D = a.D;
  const StepShared sh{s_buf, s_dyn, reinterpret_cast<int*>(s_dyn + C), reinterpret_cast<int*>(s_dyn + C) + C,
                      s_best_v, s_best_i, nullptr};
  int* base = a.cnt;
  if (a.use_smem) {
    base = sh.s_ndom + C;
    const long long cells = (3LL * C + AT + 2LL * a.KD2) * D;
    for (long long i = tid; i < cells; i += blockDim.x) base[i] = 0;
  }
  const Counters k = counters(a, base);
  const StepScratch scratch = global_scratch(a, a.feas, a.ip_raw, a.sp_raw, a.sp_cnt, k.seen, D);
  BlockPolicy pol{0, a.N};
  __syncthreads();

  for (int p = 0; p < a.P; ++p) {
    if (!a.valid[p]) {  // a pad row: nothing feasible, nothing counted
      if (tid == 0) write_step(a, p, StepOut{ABSENT, 0, {0, 0, 0, 0, 0, 0, 0, 0, 0}});
      __syncthreads();
      continue;
    }
    if (tid == 0) s_any_dyn = 0;
    __syncthreads();
    peer_pass(a, k, p, true, &s_any_dyn);
    __syncthreads();
    const StepOut out = pod_step_block(a, p, ScanDyn{a, k, p + 1}, s_any_dyn != 0, scratch, sh, -1, true, pol);
    if (tid == 0) {
      write_step(a, p, out);
      commit_usage(a, scratch.use, p, out.choice);
      advance_cursor(a, out);
    }
    __syncthreads();  // the commit is visible to every thread of the block
    peer_pass(a, k, p, false, &s_any_dyn);  // clear the cells this step touched
    __syncthreads();
  }
}

size_t dynamic_smem(const GangScanArgs& a) {
  size_t bytes = (size_t)a.C * (sizeof(long long) + 2 * sizeof(int));
  if (a.use_smem) bytes += (size_t)(3LL * a.C + a.AT + 2LL * a.KD2) * a.D * sizeof(int);
  return bytes;
}

}  // namespace

// The dynamic shared memory one K5 block may take on this device: the
// opt-in per-block limit less the kernel's static shared memory.
extern "C" int ktpu_gang_scan_smem_max() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, gang_scan_kernel) != cudaSuccess) return 0;
  return optin - (int)fa.sharedSizeBytes;
}

// Enqueues K5 on `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_gang_scan(const GangScanArgs* args, void* stream) {
  if (args->P == 0) return 0;
  const size_t smem = dynamic_smem(*args);
  cudaError_t e = cudaFuncSetAttribute(gang_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  gang_scan_kernel<<<1, SCAN_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}
