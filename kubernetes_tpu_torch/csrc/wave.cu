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
// diagnosis masks are not read).  In sampling mode every block reads the
// batch's initial cursor and none advances it (reference :794-805).  An optional [P, N] lane (WaveArgs::lane)
// is read as the port verdict: the workloads dispatch passes its DRA
// verdict against the pre-batch allocation state there (K14, csrc/dra.cu),
// as the reference puts it in spec_one's m_portb.  An optional [P, N]
// int64 GangScanArgs::extra_score adds to every node's total in the shared
// step (the planner's target bonus, reference ops/gang.py:901-902); K8 and
// K11 take it, K5 and K9 get a null pointer.
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
//     verdict at the speculative node;
//   * advances the sampling window's cursor (reference :974).
// The carries sit in dynamic shared memory when they fit (the card's opt-in
// limit, capped by ops/wave.py ADMIT_SMEM_CAP), else in a global scratch
// row; the per-pod sums and lists likewise.
//
// K9 is ktpu::wave::admit_kernel<false> (csrc/ktpu.cuh), whose gang mode is
// K11 (csrc/workloads.cu).
//
// Bound on the H100: K9 is the recurrence, as K5 (one SM of 132, ~6 block
// reductions and their barriers per pod); K8 fills the card but repeats one
// pod's reads of its [P, N] static rows per block.
#include "ktpu.cuh"

using namespace ktpu;
using namespace ktpu::step;
using namespace ktpu::wave;

namespace {

constexpr int SPEC_THREADS = 256;

// No committed peer: speculation against the frozen snapshot, every port
// free unless the caller's lane row says otherwise (the workloads
// dispatch's DRA verdict).
struct ZeroDyn {
  const unsigned char* lane;  // pod p's [N] row of WaveArgs::lane, or null
  __device__ int f(int, long long, int, int) const { return 0; }
  __device__ int sc(int, long long, int, int, bool) const { return 0; }
  __device__ int ip(int, long long, int, int) const { return 0; }
  __device__ bool viol(int) const { return false; }
  __device__ long long sym(int) const { return 0; }
  __device__ bool portb(int n) const { return lane == nullptr || lane[n]; }
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
  const StepOut out = pod_step_block(a, p, ZeroDyn{w.lane ? w.lane + p * N : nullptr}, false, sc, sh, -1, false);
  if (threadIdx.x == 0) a.chosen[p] = out.choice;
}

size_t speculate_smem(const GangScanArgs& a) { return (size_t)a.C * (sizeof(long long) + 2 * sizeof(int)); }

}  // namespace

// The dynamic shared memory one K9 block may take on this device.
extern "C" int ktpu_wave_admit_smem_max() { return admit_smem_max<false>(); }

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
  return admit_launch<false>(*args, *wave, WorkloadsArgs{}, stream);
}
