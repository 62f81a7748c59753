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
// K9: the serial recurrence choice_i = F_i(S + sum_{j<i} delta(choice_j)).
// It carries per-term per-node counts instead of a peer list:
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
// The pods' steps are serial; the nodes of one step are not.  So K9 is ONE
// thread-block cluster (cudaLaunchKernelEx with a cluster dimension) of G
// CTAs of CLUSTER_THREADS on neighbouring SMs: G = 16 where
// cudaOccupancyMaxActiveClusters admits a cluster of 16 at the kernel's
// shared memory (a non-portable size), else 8; ops/wave.py
// ADMIT_CLUSTER_CAP caps it.  CTA r owns the nodes [r S, r S + S), S a
// multiple of 32, and keeps in its own shared memory, where they fit (the
// card's opt-in limit, or ops/wave.py ADMIT_SMEM_CAP; otherwise global
// memory):
//   * its exchange slab (the per-domain sums, the min-match parts, the
//     domain flags, the window's map, and every CTA's pushed rows of them);
//   * its slice's usage rows (requested / nonzero / num_pods, staged in at
//     the start and written back at the end) and the step's per-node rows
//     (feas, ip_raw, sp_raw, sp_cnt);
//   * its slice's node statics (allocatable, allowed_pods, node_valid,
//     visit_rank, the dom_ids rows), copied once, and each pod's planes
//     (its [P, N] and slot rows of the statics, ClusterPolicy::issue): one
//     thread's bulk copies (cp.async.bulk) into one of two buffers complete
//     on an mbarrier, pod p + 1's issued when pod p starts (ADMIT_STAGE
//     False, or rows not 16-byte aligned: the global rows);
//   * its carry columns (the mixed shape's Tip = 201 terms do not fit).
// Each pod's small per-slot values (StagedVals) are copied in at its start.
// Every node loop of the step, of pod_tables and of commit_carries walks
// the slice, and the step's block-wide parts cross the cluster in four
// exchanges a pod (five with the sampling window), each CTA pushing its
// part into every CTA's shared memory with st.async on an mbarrier
// (ktpu::step::ClusterPolicy): pod_tables' sums with the spread
// min-match, the 15-value reduction with the distinct counted domains
// (per-CTA flags, ORed as bits), the window's verdict bits (every CTA
// walks its own copy of the N-bit map, so all agree on the stop and
// advance their cursors alike), the spread min / max / count and the
// argmax.  The usage and carry commits are made by the CTA that owns the
// chosen node, rev_cnt's by every CTA over its slice.  The verdict's pieces
// at the speculative node are pushed to rank 0 by the CTA that owns it;
// rank 0 writes every output.  No combine is order-dependent (int64 sums,
// mins, maxes, the argmax's total order), so the choice is the reference's.
// The rank-0 leader's clock per phase comes back in WaveArgs::admit_info.
//
// Bound on the H100: K9 is the recurrence: per pod four exchanges and one
// pass over a slice of N / G nodes per step phase from shared memory, on G
// SMs of 132; K8 fills the card but repeats one pod's reads of its [P, N]
// static rows per block.
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
  const StepScratch sc = global_scratch(a, a.feas + p * N, a.ip_raw + p * N, a.sp_raw + p * N, a.sp_cnt + p * C * N,
                                        w.sums + (long long)p * C * w.Dsp, w.Dsp);
  BlockPolicy pol{0, a.N};
  const StepOut out = pod_step_block(a, p, ZeroDyn{w.lane ? w.lane + p * N : nullptr}, false, sc, sh, -1, false, pol);
  if (threadIdx.x == 0) a.chosen[p] = out.choice;
}

size_t speculate_smem(const GangScanArgs& a) { return (size_t)a.C * (sizeof(long long) + 2 * sizeof(int)); }

// ---- K9: the cluster ------------------------------------------------------

// The ints of one CTA's exchange slab: its partial sums (g1p, g2p [C, Dsp],
// gfp [AT, D2], anyp) with its min-match parts ([C, Dsp] and [C]:
// `part_cells`) and every CTA's [G, part_cells], its
// counted-domain flags [C, Dsp] and every CTA's as bits [G, C, Dw], the window's map
// [ceil(N / 32)], then its totals (g1, g2, gf, any_dyn, the min-match
// parts), the term lists [Tip] and [Tpt] and their two lengths.
__host__ __device__ inline long long part_cells(const GangScanArgs& a, const WaveArgs& w) {
  return 3LL * a.C * w.Dsp + (long long)a.AT * w.D2 + 1 + a.C;
}
__host__ __device__ inline int dom_words(const WaveArgs& w) { return (w.Dsp + 31) >> 5; }
__host__ __device__ inline long long slab_cells(const GangScanArgs& a, const WaveArgs& w) {
  return (2LL + w.cluster) * part_cells(a, w) + (long long)a.C * w.Dsp + (long long)w.cluster * a.C * dom_words(w) +
         ((a.N + 31) >> 5) + w.Tip + w.Tpt + 2;
}

// Byte offsets of K9's dynamic shared memory (only the parts placed there),
// each part 16-byte aligned: s_wfx [C] (int64), s_min [C], s_ndom [C], the
// pod's values (StagedVals: ints, then int64s); the
// exchange slab (sums_smem); the slice's usage rows requested [S, Rn],
// nonzero [S, 2], num_pods [S] and step rows ip_raw / sp_raw [S] (int64),
// sp_cnt [C, S], feas [S] (rows_smem); its node statics allocatable
// [S, Rn], allowed_pods [S], visit_rank [S], dom_ids [K, S], node_valid [S]
// and two pods' staged planes (stage); the carries [Tsp + 2 Tip + Tpt, S]
// (carry_smem).
struct ClusterLayout {
  size_t wfx, smin, sndom, vals_i, vals_l, slab, req, nz, pods, ip_raw, sp_raw, sp_cnt, feas, alloc, allowed, vrank, dom, valid,
      stage, carries, bytes;
};

__host__ __device__ inline ClusterLayout cluster_layout(const GangScanArgs& a, const WaveArgs& w) {
  const size_t S = w.slice, C = a.C;
  ClusterLayout l{};
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o = (o + bytes + 15) / 16 * 16;
    return at;
  };
  l.wfx = take(8 * C);
  l.smin = take(4 * C);
  l.sndom = take(4 * C);
  l.vals_i = take(4 * (size_t)StagedVals::ints(a.C, a.AT, a.Rp, w.Tsp, w.Tip));
  l.vals_l = take(8 * (size_t)StagedVals::longs(a.C, a.AT, w.Tip));
  if (w.sums_smem) l.slab = take(4 * (size_t)w.xch_cells);
  if (w.rows_smem) {
    l.req = take(4 * S * a.Rn);
    l.nz = take(8 * S);
    l.pods = take(4 * S);
    l.ip_raw = take(8 * S);
    l.sp_raw = take(8 * S);
    l.sp_cnt = take(4 * C * S);
    l.feas = take(S);
  }
  if (w.stage) {
    l.alloc = take(4 * S * a.Rn);
    l.allowed = take(4 * S);
    l.vrank = take(4 * S);
    l.dom = take(4 * S * a.K);
    l.valid = take(S);
    l.stage = take(2 * (size_t)stage_bytes(a, w.slice));
  }
  if (w.carry_smem) l.carries = take(4 * S * ((size_t)w.Tsp + 2 * (size_t)w.Tip + w.Tpt));
  l.bytes = o;
  return l;
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1) admit_cluster_kernel(const GangScanArgs a, const WaveArgs w) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ ClusterShared s_cl;
  __shared__ int s_at[6];
  __shared__ unsigned long long s_mbar[2];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), G = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int N = a.N, C = a.C, AT = a.AT, S = w.slice;
  const int lo = min(N, rank * S), hi = min(N, lo + S), len = hi - lo;
  const ClusterLayout l = cluster_layout(a, w);
  const StepShared sh{nullptr, reinterpret_cast<long long*>(s_raw + l.wfx), reinterpret_cast<int*>(s_raw + l.smin),
                      reinterpret_cast<int*>(s_raw + l.sndom), nullptr, nullptr, s_at};

  // the exchange slab, then the region over it and the carries
  const Xch x{(long long)w.xch_cells, rank, w.sums_smem};
  int* const slab = w.sums_smem ? reinterpret_cast<int*>(s_raw + l.slab) : w.sums + (long long)rank * w.xch_cells;
  const long long cd = (long long)C * w.Dsp, xp = part_cells(a, w);
  const int Dw = dom_words(w);
  Region r;
  r.g1p = slab;
  r.g2p = r.g1p + cd;
  r.gfp = r.g2p + cd;
  r.anyp = r.gfp + (long long)AT * w.D2;
  int* const recv_part = r.g1p + xp;
  int* const flags = recv_part + (long long)G * xp;
  int* const recv_bits = flags + cd;
  int* const wmap = recv_bits + (long long)G * C * Dw;
  r.g1 = wmap + ((N + 31) >> 5);
  r.g2 = r.g1 + cd;
  r.gf = r.g2 + cd;
  r.any_dyn = r.gf + (long long)AT * w.D2;
  r.rev = r.g1 + xp;
  r.conf = r.rev + w.Tip;
  r.n_rev = r.conf + w.Tpt;
  r.n_conf = r.n_rev + 1;
  r.seen = nullptr;
  int* carries = w.carries;
  r.clo = 0;
  r.cld = N;
  if (w.carry_smem) {
    carries = reinterpret_cast<int*>(s_raw + l.carries);
    r.clo = lo;
    r.cld = S;
    for (long long i = tid; i < ((long long)w.Tsp + 2LL * w.Tip + w.Tpt) * S; i += blockDim.x) carries[i] = 0;
  }
  r.cnt_sp = carries;
  r.cnt_ip = r.cnt_sp + (long long)w.Tsp * r.cld;
  r.rev_cnt = r.cnt_ip + (long long)w.Tip * r.cld;
  r.occ_pt = r.rev_cnt + (long long)w.Tip * r.cld;

  // the step's rows and the usage rows: the slice in shared memory, staged
  // in from the usage state, or the global rows; likewise the node statics
  StepScratch sc = global_scratch(a, a.feas, a.ip_raw, a.sp_raw, a.sp_cnt, nullptr, 0);
  if (w.rows_smem) {
    sc.feas = s_raw + l.feas;
    sc.ip_raw = reinterpret_cast<long long*>(s_raw + l.ip_raw);
    sc.sp_raw = reinterpret_cast<long long*>(s_raw + l.sp_raw);
    sc.sp_cnt = reinterpret_cast<int*>(s_raw + l.sp_cnt);
    sc.lo = lo;
    sc.ld = S;
    sc.use = UsageRows{reinterpret_cast<int*>(s_raw + l.req), reinterpret_cast<int*>(s_raw + l.nz),
                       reinterpret_cast<int*>(s_raw + l.pods), lo};
    copy_usage(a, sc.use, len, true);
  }
  if (w.stage)
    sc.nodes = stage_nodes(a, reinterpret_cast<int*>(s_raw + l.alloc), reinterpret_cast<int*>(s_raw + l.allowed),
                           reinterpret_cast<int*>(s_raw + l.vrank), reinterpret_cast<int*>(s_raw + l.dom),
                           s_raw + l.valid, lo, len, S);
  if (tid == 0) init_mbars(s_mbar, s_cl);

  if (tid < CL_PHASES) s_cl.clock[tid] = 0;
  ClusterPolicy pol{};
  pol.lo = lo;
  pol.hi = hi;
  pol.S = S;
  pol.rank = rank;
  pol.G = G;
  pol.cur = a.sample_k > 0 ? *a.sample_start : 0;
  pol.cs = &s_cl;
  pol.flags = flags;
  pol.recv_bits = recv_bits;
  pol.recv_part = recv_part;
  pol.wmap = wmap;
  pol.s_min = sh.s_min;
  pol.C = C;
  pol.Dsp = w.Dsp;
  pol.Dw = Dw;
  pol.x = x;
  pol.stage = w.stage ? s_raw + l.stage : nullptr;
  pol.mbar = s_mbar;
  pol.stage_bytes = stage_bytes(a, S);
  pol.sv = StagedVals{reinterpret_cast<int*>(s_raw + l.vals_i), reinterpret_cast<long long*>(s_raw + l.vals_l), C,
                      AT, a.Rp, w.Tsp, w.Tip};
  cluster_barrier();  // every CTA of the cluster runs before any DSMEM access
  if (w.stage && tid == 0 && a.P > 0) pol.issue(a, 0);
  admit_loop<false>(a, w, WorkloadsArgs{}, r, sc, sh, pol);

  if (w.rows_smem) copy_usage(a, sc.use, len, false);  // the slice's usage rows back to the usage state
  if (pol.leader()) {
    if (a.sample_k > 0) *a.sample_start = pol.cur;
    if (w.admit_info != nullptr) {
      w.admit_info[0] = G;
      w.admit_info[1] = pol.syncs;
      for (int k = 0; k < CL_PHASES; ++k) w.admit_info[2 + k] = (int)(s_cl.clock[k] >> 4);
    }
  }
  cluster_barrier();  // no CTA leaves while a peer may still read its shared memory
}

// K9's placement at cluster size G: slice, exchange slab, and, in that order
// while they fit in `budget` bytes beside the fixed s_wfx / s_min / s_ndom,
// the exchange slab, the slice's rows, its node statics with the pods'
// staged planes (when `stage` allows it), and its carries in shared memory.
void place(const GangScanArgs& a, WaveArgs& w, int G, long long budget, bool stage) {
  w.cluster = G;
  w.slice = slice_nodes(a.N, G);
  w.xch_cells = (int)slab_cells(a, w);
  w.sums_smem = w.rows_smem = w.stage = w.carry_smem = 0;
  int* const flags[4] = {&w.sums_smem, &w.rows_smem, &w.stage, &w.carry_smem};
  for (int* f : flags) {
    if (f == &w.stage && !stage) continue;
    *f = 1;
    if ((long long)cluster_layout(a, w).bytes > budget) {
      *f = 0;
      if (f != &w.stage) return;
    }
  }
}

}  // namespace

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

// K9's launch plan into `wave`: the cluster size (16 where the card admits
// one cluster of 16 at the kernel's shared memory and cluster_cap allows
// it, else 8), the slice and what sits in shared memory under
// min(smem_cap, the card's opt-in limit less the static shared memory);
// the pods' planes are staged only with `stage` and 16-byte aligned rows.
// Returns a CUDA status.
extern "C" int ktpu_wave_admit_plan(const GangScanArgs* args, WaveArgs* wave, int cluster_cap, int smem_cap,
                                    int stage) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, admit_cluster_kernel);
  if (e != cudaSuccess) return (int)e;
  const long long limit = (long long)optin - (long long)fa.sharedSizeBytes;
  const long long budget = smem_cap < limit ? smem_cap : limit;
  const bool staged = stage && stage_aligned(*args);
  auto smem = [&](int G) {
    place(*args, *wave, G, budget, staged);
    return cluster_layout(*args, *wave).bytes;
  };
  int G = 8;
  e = cluster_size(admit_cluster_kernel, cluster_cap, smem, &G);
  if (e == cudaSuccess) smem(G);
  return (int)e;
}

// Enqueues K9 (one cluster, as ktpu_wave_admit_plan laid it out) on
// `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_wave_admit(const GangScanArgs* args, const WaveArgs* wave, void* stream) {
  if (args->P == 0) return 0;
  const size_t smem = cluster_layout(*args, *wave).bytes;
  cudaError_t e = cudaFuncSetAttribute(admit_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(admit_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(wave->cluster, smem, static_cast<cudaStream_t>(stream), attr);
  e = cudaLaunchKernelEx(&cfg, admit_cluster_kernel, *args, *wave);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
