// K8 wave_speculate and K9 wave_admit: the speculative wave, two launches
// per batch.
//
// Replace the JAX root kubernetes_tpu/ops/wave.py:666 wave_schedule (its
// speculation, a vmap of gang.pod_step over the batch against the frozen
// snapshot, :798-805; and its admission, a lax.scan over the term-factored
// carries, :807-976 with the algebra of :442-643).  The verdict, scores and
// argmax of one pod are ktpu::step::pod_step_block (csrc/ktpu.cuh), the
// same device code K5 runs; only the batch peers' counts differ.
//
// K8: every pod's verdict is independent, so the grid has one block per pod
// (512 blocks at a config4 batch) and the threads of a block walk the nodes.
// The peers' counts are zero and every port is free; the usage state is the
// cluster's own, read only.  Each block has its own per-node scratch rows.
// Output: c0, the speculative node per pod (no reason counts, so the
// diagnosis masks are not read).
//
// K9: the serial recurrence choice_i = F_i(S + sum_{j<i} delta(choice_j)),
// in ONE persistent block of 1024 threads that loops over the pods, as K5
// does.  It carries per-term per-node counts instead of a peer list:
//   cnt_sp  [Tsp, N]  committed pods matching spread term t, per node
//   cnt_ip  [Tip, N]  committed pods matching inter-pod term t, per node
//   rev_cnt [Tip, N]  committed pods' own term t, spread over its topology
//                     domain (the reverse direction: who constrains p)
//   occ_pt  [Tpt, N]  committed pods holding port term t, per node
// all int32.  Per pod it
//   * sums its slots' carry rows per compact domain (DeviceCluster.dom_ids
//     under the slot's key; wave_tables' ip_cdv_tab is the same numbering),
//     into g1 / g2 (spread, filter and score sides) and gf (inter-pod); a
//     hostname-keyed slot reads its row per node instead;
//   * lists the distinct terms whose selector admits it (m_ip_all[:, p],
//     read through the representatives: no [Tip, P] tensor is built) and the
//     port terms its own ports conflict with (port_conf);
//   * runs the shared step, which also reports the verdict's pieces at the
//     speculative node;
//   * commits: the usage, one node column per matching spread / inter-pod /
//     port term (factored_carry_update's rank-1 update as O(T) stores), and
//     its own inter-pod terms over their domains into rev_cnt;
//   * attributes a demotion (kind, first violating slot) from the pre-commit
//     verdict at the speculative node.
// The carries sit in dynamic shared memory when they fit (the card's opt-in
// limit, capped by ops/wave.py ADMIT_SMEM_CAP), else in a global scratch
// row; the per-pod sums and lists likewise.
//
// Bound on the H100: K9 is the recurrence, as K5 (one SM of 132, ~6 block
// reductions and their barriers per pod); K8 fills the card but repeats one
// pod's reads of its [P, N] static rows per block.
#include "ktpu.cuh"

using namespace ktpu;
using namespace ktpu::step;

namespace {

constexpr int SPEC_THREADS = 256;
constexpr int ADMIT_THREADS = 1024;

enum Demote { DEMOTE_NONE = 0, DEMOTE_SPREAD = 1, DEMOTE_AFFINITY = 2, DEMOTE_SCORE = 3, DEMOTE_FIT = 4,
              DEMOTE_UPGRADE = 5, DEMOTE_PORTS = 6 };

// No committed peer: speculation against the frozen snapshot.
struct ZeroDyn {
  __device__ int f(int, long long, int, int) const { return 0; }
  __device__ int sc(int, long long, int, int, bool) const { return 0; }
  __device__ int ip(int, long long, int, int) const { return 0; }
  __device__ bool viol(int) const { return false; }
  __device__ long long sym(int) const { return 0; }
  __device__ bool portb(int) const { return true; }
};

__global__ void __launch_bounds__(SPEC_THREADS) wave_speculate_kernel(const GangScanArgs a, const WaveArgs w) {
  extern __shared__ long long s_dyn[];  // s_wfx [C] (int64), s_min [C], s_ndom [C]
  __shared__ long long s_buf[32 * 16];
  __shared__ long long s_best_v[32];
  __shared__ int s_best_i[32];
  const int p = blockIdx.x;
  if (!a.valid[p]) {  // a pad row: no node
    if (threadIdx.x == 0) a.chosen[p] = ABSENT;
    return;
  }
  const int C = a.C;
  const long long N = a.N;
  const StepShared sh{s_buf, s_dyn, reinterpret_cast<int*>(s_dyn + C), reinterpret_cast<int*>(s_dyn + C) + C,
                      s_best_v, s_best_i, nullptr};
  const StepScratch sc{a.feas + p * N, a.ip_raw + p * N, a.sp_raw + p * N, a.sp_cnt + p * C * N,
                       w.sums + (long long)p * C * w.Dsp, w.Dsp};
  const StepOut out = pod_step_block(a, p, ZeroDyn{}, false, sc, sh, -1, false);
  if (threadIdx.x == 0) a.chosen[p] = out.choice;
}

// K9's regions.  Per pod (sums): g1 [C, Dsp], g2 [C, Dsp], seen [C, Dsp],
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
    for (int i = 0; i < *r.n_conf; ++i)
      if (r.occ_pt[(long long)r.conf[i] * a.N + n] > 0) return false;
    return true;
  }
};

// Pod p's per-domain sums, admitting terms and conflicting port terms.
__device__ void pod_tables(const GangScanArgs& a, const WaveArgs& w, const Region& r, int p) {
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
__device__ void commit_carries(const GangScanArgs& a, const WaveArgs& w, const Region& r, int p, int choice) {
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

__global__ void __launch_bounds__(ADMIT_THREADS) wave_admit_kernel(const GangScanArgs a, const WaveArgs w) {
  // dynamic: s_wfx [C] (int64), s_min [C], s_ndom [C], then the per-pod
  // region when sums_smem and the carries when carry_smem
  extern __shared__ long long s_dyn[];
  __shared__ long long s_buf[32 * 16];
  __shared__ long long s_best_v[32];
  __shared__ int s_best_i[32];
  __shared__ int s_at[6];
  const int tid = threadIdx.x;
  const int C = a.C, N = a.N;
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
  Region r;
  r.g1 = sums;
  r.g2 = r.g1 + (long long)C * w.Dsp;
  r.seen = r.g2 + (long long)C * w.Dsp;
  r.gf = r.seen + (long long)C * w.Dsp;
  r.rev = r.gf + (long long)a.AT * w.D2;
  r.conf = r.rev + w.Tip;
  r.n_rev = r.conf + w.Tpt;
  r.n_conf = r.n_rev + 1;
  r.any_dyn = r.n_conf + 1;
  r.cnt_sp = carries;
  r.cnt_ip = r.cnt_sp + (long long)w.Tsp * N;
  r.rev_cnt = r.cnt_ip + (long long)w.Tip * N;
  r.occ_pt = r.rev_cnt + (long long)w.Tip * N;
  const StepScratch sc{a.feas, a.ip_raw, a.sp_raw, a.sp_cnt, r.seen, w.Dsp};
  __syncthreads();

  for (int p = 0; p < a.P; ++p) {
    if (!a.valid[p]) {  // a pad row: nothing feasible, nothing committed
      if (tid == 0) {
        write_step(a, p, StepOut{ABSENT, 0, {0, 0, 0, 0, 0, 0, 0, 0, 0}});
        w.kinds[p] = DEMOTE_NONE;
        w.cterms[p] = -1;
      }
      __syncthreads();
      continue;
    }
    pod_tables(a, w, r, p);
    const int spec = w.c0[p];
    const StepOut out = pod_step_block(a, p, WaveDyn{a, w, r, p}, *r.any_dyn != 0, sc, sh, spec);
    const int choice = out.choice;
    if (choice >= 0) commit_carries(a, w, r, p, choice);
    if (tid == 0) {
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
      write_step(a, p, out);
      commit_usage(a, p, choice);
    }
    __syncthreads();  // the commits are visible to every thread of the block
  }
}

size_t speculate_smem(const GangScanArgs& a) { return (size_t)a.C * (sizeof(long long) + 2 * sizeof(int)); }

size_t admit_smem(const GangScanArgs& a, const WaveArgs& w) {
  size_t bytes = (size_t)a.C * (sizeof(long long) + 2 * sizeof(int));
  if (w.sums_smem) bytes += (size_t)sums_cells(a, w) * sizeof(int);
  if (w.carry_smem) bytes += (size_t)carry_cells(a, w) * sizeof(int);
  return bytes;
}

}  // namespace

// The dynamic shared memory one K9 block may take on this device: the
// opt-in per-block limit less the kernel's static shared memory.
extern "C" int ktpu_wave_admit_smem_max() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return 0;
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, wave_admit_kernel) != cudaSuccess) return 0;
  return optin - (int)fa.sharedSizeBytes;
}

// Enqueues K8 on `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_wave_speculate(const GangScanArgs* args, const WaveArgs* wave, void* stream) {
  if (args->P == 0) return 0;
  const size_t smem = speculate_smem(*args);
  cudaError_t e =
      cudaFuncSetAttribute(wave_speculate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wave_speculate_kernel<<<args->P, SPEC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*args, *wave);
  return (int)cudaGetLastError();
}

// Enqueues K9 on `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_wave_admit(const GangScanArgs* args, const WaveArgs* wave, void* stream) {
  if (args->P == 0) return 0;
  const size_t smem = admit_smem(*args, *wave);
  cudaError_t e = cudaFuncSetAttribute(wave_admit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wave_admit_kernel<<<1, ADMIT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(*args, *wave);
  return (int)cudaGetLastError();
}
