// K8 wave_speculate and K9 wave_admit: the speculative wave, two launches
// per batch.
//
// Replace the JAX root kubernetes_tpu/ops/wave.py:666 wave_schedule (its
// speculation, a vmap of gang.pod_step over the batch against the frozen
// snapshot, :798-805; and its admission, a lax.scan over the term-factored
// carries, :807-976 with the algebra of :442-643).  K9's verdict, scores
// and argmax of one pod are ktpu::step::pod_step_block (csrc/ktpu.cuh), the
// device code K5 and K11 run; K8 has a peer-free body of its own over the
// same helpers.
//
// K8: every pod's verdict is independent of the others' (the peers' counts
// are zero and every port is free; the usage state is the cluster's own,
// read only), so K8 is laid out for throughput: CTAs of SPEC_CTA threads,
// each a tile of two pods, each pod stepped by its own group of eight
// warps that synchronizes on a named barrier of its own.  A
// group keeps its pod on chip (its values, its feasibility bits, the
// counted domains' bits) and recomputes the per-node raws where a pass
// needs them; its passes load a node's inputs before any branch on them;
// a reduction is one group barrier.  K8 has its own body, not the shared
// pod_step_block, over the same helpers (see the block comment of
// wave_speculate_kernel).  Output: c0, the speculative node per pod (no
// reason counts, so the diagnosis masks are not read).  In sampling mode
// every pod reads the batch's initial cursor and none advances it
// (reference :794-805).  An optional [P, N] lane (WaveArgs::lane) is read
// as the port verdict: the workloads dispatch passes its DRA verdict
// against the pre-batch allocation state there (K14, csrc/dra.cu), as the
// reference puts it in spec_one's m_portb.  An optional [P, N] int64
// GangScanArgs::extra_score adds to every node's total (the planner's
// target bonus, reference ops/gang.py:901-902); K8 and K11 take it, K5 and
// K9 get a null pointer.  Each group's thread 0 writes its pod's start and
// end (globaltimer) and its cycles per phase to WaveArgs::spec_info.
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
// thread-block cluster (ktpu::wave::admit_cluster_kernel<false> in
// csrc/ktpu.cuh, which K11 launches as <true>; cudaLaunchKernelEx with a
// cluster dimension) of G
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
// SMs of 132.  K8 is bound by the latency of its node passes: each group
// walks N / (32 W) nodes a thread per pass, with about one global round
// trip a node (the pod's [P, N] rows, the node statics in L2) and its int64
// floor divisions in the total; the card holds some 500 groups at once.
#include "ktpu.cuh"

using namespace ktpu;
using namespace ktpu::step;
using namespace ktpu::wave;

namespace {

// ---- K8: a tile of pods per CTA, a group of warps per pod ----------------
//
// The speculation is P independent steps over one frozen snapshot, so K8 is
// laid out for throughput: a CTA of SPEC_CTA threads holds a tile of pods,
// each stepped by its own group of W warps, which synchronize on a named
// barrier of their own (bar.sync 1 + group) and never on the CTA.  A group
// keeps everything of its pod on chip: the pod's per-slot values
// (StagedVals, copied once), its feasibility as N bits, the distinct
// counted domains as [C, Dw] bit words (shared atomicOr, no return value),
// the min-match and the topology weights; the per-node raws that the
// block-per-pod step wrote to global rows and read back (ip_raw, sp_raw,
// sp_cnt) are recomputed from the pod's planes in the pass that needs them.
// Each pass walks the nodes a warp-wide row at a time, every load of a
// node issued before any branch on it (the fit, spread and inter-pod
// verdicts are ANDed, not short-circuited), so a node costs about one
// memory round trip, not one per check.  A reduction is a warp shuffle,
// one row per warp in shared memory and one group barrier (the rows
// alternate between two sets), four a pod (five with the window, one more
// for the min-match with spread slots).  The verdicts, counts and scores
// are the shared step's, with the peers' counts zero (NoPeer):
// step_fits, spread_verdict, interpod_verdict, count_feasible, slot_count,
// spread_raw, node_total (fit_score, least_parts, least_mean,
// balanced_parts), fdiv, visit_pos, rng.

constexpr int SPEC_CTA = 512;  // threads a CTA
constexpr int SPEC_WARPS = 8;  // warps of a pod's group: two pods a CTA
// CTAs an SM holds at once: 64 registers a thread.  More groups in flight
// beat the spills this forces (on an H100 at config4: 0.23 ms at 64
// registers against 0.46 ms at 160, and against 0.26 ms with 4 warps a pod
// at 128).
constexpr int SPEC_MIN_CTAS = 2;
constexpr int SPEC_PHASES = 10;   // the leader's clocks: (pass, reduction) per SpecKind
enum SpecKind { SPEC_MIN = 0, SPEC_COUNTS = 1, SPEC_WINDOW = 2, SPEC_SPREAD = 3, SPEC_ARGMAX = 4 };

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One group's shared memory, per-group offsets (each 16-byte aligned): the
// pod's StagedVals (ints, int64s), s_min [C], the topology weights [W, C]
// (int64, one row per warp), the domain bits [C, Dw], the feasibility bits
// [ceil(N / 32)].
struct SpecLayout {
  size_t vals_i, vals_l, smin, wfx, flags, feas, bytes;
};

__host__ __device__ inline int spec_dom_words(const WaveArgs& w) { return (w.Dsp + 31) >> 5; }

__host__ __device__ inline SpecLayout spec_layout(const GangScanArgs& a, const WaveArgs& w, int W) {
  SpecLayout l{};
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o = (o + bytes + 15) / 16 * 16;
    return at;
  };
  l.vals_i = take(4 * (size_t)StagedVals::ints(a.C, a.AT, a.Rp, 0, 0));
  l.vals_l = take(8 * (size_t)StagedVals::longs(a.C, a.AT, 0));
  l.smin = take(4 * (size_t)a.C);
  l.wfx = take(8 * (size_t)W * a.C);
  l.flags = take(4 * (size_t)a.C * spec_dom_words(w));
  l.feas = take(4 * (size_t)((a.N + 31) >> 5));
  l.bytes = o;
  return l;
}

// A pod's group: W warps, thread t of T = 32 W, on named barrier 1 + g.
template <int W>
struct SpecGroup {
  static constexpr int T = 32 * W;
  int g, t, lane, warp;
  __device__ void sync() const { asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(T) : "memory"); }
};

// The group's reductions: NV values (nv live) under their ops; every
// thread gets the results.  rows: [2][W][RED_CHUNK] (this group's), set by
// the parity of the reduction's count.
template <int W, int NV>
__device__ __forceinline__ void group_reduce(const SpecGroup<W>& gr, long long (&v)[NV], const int (&op)[NV], int nv,
                                             long long (*rows)[W][RED_CHUNK], int& k) {
  long long(*r)[RED_CHUNK] = rows[k & 1];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i >= nv) break;
    for (int off = 16; off > 0; off >>= 1) v[i] = combine(v[i], __shfl_down_sync(FULL_MASK, v[i], off), op[i]);
    if (gr.lane == 0) r[gr.warp][i] = v[i];
  }
  gr.sync();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i >= nv) break;
    long long y = identity(op[i]);
    for (int w2 = 0; w2 < W; ++w2) y = combine(y, r[w2][i], op[i]);
    v[i] = y;
  }
  ++k;
}

// The group's argmax of (key, tie, slot) by `better`; every thread gets the
// slot.  rows: [2][W] keys, tie keys, slots.
template <int W>
__device__ __forceinline__ int group_argmax(const SpecGroup<W>& gr, long long v, int tk, int i, long long (*rv)[W],
                                            int (*rt)[W], int (*ri)[W], int& k) {
  for (int off = 16; off > 0; off >>= 1) {
    const long long ov = __shfl_down_sync(FULL_MASK, v, off);
    const int ot = __shfl_down_sync(FULL_MASK, tk, off);
    const int oi = __shfl_down_sync(FULL_MASK, i, off);
    better(v, tk, i, ov, ot, oi);
  }
  const int b = k & 1;
  if (gr.lane == 0) {
    rv[b][gr.warp] = v;
    rt[b][gr.warp] = tk;
    ri[b][gr.warp] = i;
  }
  gr.sync();
  v = -I64_MAX - 1;
  tk = I32_MAX;
  i = I32_MAX;
  for (int w2 = 0; w2 < W; ++w2) better(v, tk, i, rv[b][w2], rt[b][w2], ri[b][w2]);
  ++k;
  return i;
}

// The sampling window's stop over the group (window_stop's walk): the
// position, in visit order from `start`, of the sample_k-th feasible node,
// or -1.  win: [W + 1] of the group's shared memory.
template <int W>
__device__ int group_window(const GangScanArgs& a, const SpecGroup<W>& gr, const unsigned* feas, int start, int nv,
                            int* win) {
  if (gr.t == 0) win[W] = -1;
  int run = 0;
  for (int base = 0; base < nv; base += SpecGroup<W>::T) {
    const int i = base + gr.t;
    bool f = false;
    if (i < nv) {
      int r = start + i;
      if (r >= nv) r -= nv;
      const int n = a.visit_order[r];
      f = n >= 0 && ((feas[n >> 5] >> (n & 31)) & 1u);
    }
    const unsigned bal = __ballot_sync(FULL_MASK, f);
    if (gr.lane == 0) win[gr.warp] = __popc(bal);
    gr.sync();
    int off = run, total = 0;
    for (int w2 = 0; w2 < W; ++w2) {
      if (w2 < gr.warp) off += win[w2];
      total += win[w2];
    }
    if (f && off + __popc(bal & (FULL_MASK >> (31 - gr.lane))) == a.sample_k) win[W] = i;
    gr.sync();
    run += total;
    if (win[W] >= 0) break;
  }
  return win[W];
}

// No batch peer: the peers' counts in the shared verdicts are zero, and no
// per-slot row is kept.
struct NoPeer {
  __device__ long long operator()(int, int) const { return 0; }
};
struct NoSlot {
  __device__ void operator()(int, int) const {}
};

// Pod p's planes and the nodes' domains as the shared verdicts read them
// (PodPlanes' accessors, NodeRows::dom), addressed from the kernel's
// parameters at each read: a group holds three offsets, not a pointer per
// plane, in its 64 registers.
struct ArgPlanes {
  const GangScanArgs& a;
  long long pn, pc, pu;  // p N, p C N, p AT N
  __device__ ArgPlanes(const GangScanArgs& a_, int p)
      : a(a_), pn((long long)p * a_.N), pc(pn * a_.C), pu(pn * a_.AT) {}
  __device__ __forceinline__ long long at(int c, int n) const { return pc + (long long)c * a.N + n; }
  __device__ __forceinline__ int dom_cnt(int c, int n) const { return a.sp_dom_cnt[at(c, n)]; }
  __device__ __forceinline__ bool dom_pres(int c, int n) const { return a.sp_dom_pres[at(c, n)]; }
  __device__ __forceinline__ int node_cnt(int c, int n) const { return a.sp_node_cnt[at(c, n)]; }
  __device__ __forceinline__ int sc_dom(int c, int n) const { return a.sp_sc_dom[at(c, n)]; }
  __device__ __forceinline__ int ip_cnt(int u, int n) const { return a.ip_dom_cnt[pu + (long long)u * a.N + n]; }
  __device__ __forceinline__ long long sym(int n) const { return a.ip_sym[pn + n]; }
  __device__ __forceinline__ bool violated(int n) const { return a.ip_viol_existing[pn + n]; }
  __device__ __forceinline__ long long taint(int n) const { return a.sc_taint[pn + n]; }
  __device__ __forceinline__ long long naff(int n) const { return a.sc_nodeaff[pn + n]; }
  __device__ __forceinline__ bool counted(int n) const { return a.sp_all_keys[pn + n]; }
};

struct ArgNodes {
  const GangScanArgs& a;
  __device__ __forceinline__ int dom(int key, int n) const { return dom_at(a, key, n); }
};

// Pod p's inter-pod raw at node n without batch peers (interpod_verdict's
// raw; the verdict itself is not needed here).
__device__ __forceinline__ long long spec_ip_raw(const ArgPlanes& pr, const ArgNodes& nd, const StagedVals& sv, int AT,
                                                 int n) {
  long long raw = 0;
  int term;
  interpod_verdict(pr, nd, sv, AT, n, false, NoPeer{}, raw, term);
  return raw;
}

// Pod p's spread raw at node n without batch peers (weights wfx [C]).
__device__ __forceinline__ long long spec_sp_raw(const ArgPlanes& pr, const StagedVals& sv, int C, int n,
                                                 const long long* wfx) {
  return spread_raw(sv, C, wfx, [&](int c) { return slot_count(pr, sv, c, n); });
}

__global__ void __launch_bounds__(SPEC_CTA, SPEC_MIN_CTAS) wave_speculate_kernel(const GangScanArgs a, const WaveArgs w) {
  constexpr int W = SPEC_WARPS, PODS = SPEC_CTA / (32 * W), T = 32 * W;
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ long long s_red[PODS][2][W][RED_CHUNK];
  __shared__ long long s_arg_v[PODS][2][W];
  __shared__ int s_arg_t[PODS][2][W], s_arg_i[PODS][2][W];
  __shared__ int s_win[PODS][W + 1];
  const SpecGroup<W> gr{(int)threadIdx.x / T, (int)threadIdx.x % T, (int)threadIdx.x & 31, ((int)threadIdx.x % T) >> 5};
  const int p = blockIdx.x * PODS + gr.g;
  if (p >= a.P) return;  // the group's barrier counts only its own threads
  const bool timed = w.spec_info != nullptr && gr.t == 0;
  const long long t0 = timed ? global_ns() : 0;
  long long clk[SPEC_PHASES], t_last = timed ? clock64() : 0;
  for (int k = 0; k < SPEC_PHASES; ++k) clk[k] = 0;
  auto mark = [&](int k) {
    if (!timed) return;
    const long long t = clock64();
    clk[k] += t - t_last;
    t_last = t;
  };
  if (!a.valid[p]) {  // a pad row: no node
    if (gr.t == 0) a.chosen[p] = ABSENT;
    return;
  }
  const int N = a.N, C = a.C, AT = a.AT, t = gr.t, lane = gr.lane;
  const long long pn0 = (long long)p * N;
  const SpecLayout L = spec_layout(a, w, W);
  // the cluster's own usage rows and node statics (the fit's; a node
  // without nominations gets the own verdict from the charged step_fits)
  const StepScratch own = global_scratch(a, nullptr, nullptr, nullptr, nullptr);
  const ArgPlanes pr(a, p);
  const ArgNodes nd{a};
  unsigned char* const sm = s_raw + (size_t)gr.g * L.bytes;
  const StagedVals sv{reinterpret_cast<int*>(sm + L.vals_i), reinterpret_cast<long long*>(sm + L.vals_l), C, AT, a.Rp,
                      0, 0};
  int* const s_min = reinterpret_cast<int*>(sm + L.smin);
  long long* const wfx = reinterpret_cast<long long*>(sm + L.wfx) + (long long)gr.warp * C;
  unsigned* const flags = reinterpret_cast<unsigned*>(sm + L.flags);
  unsigned* const feas = reinterpret_cast<unsigned*>(sm + L.feas);
  const int Dw = spec_dom_words(w);
  int k = 0;  // the group's reductions so far
  sv.fill(a, w, p, t, T);
  for (int j = t; j < C * Dw; j += T) flags[j] = 0;
  gr.sync();

  // ---- the spread min-match per slot (no batch peer: sp_dom_cnt alone)
  for (int c0 = 0; c0 < C; c0 += RED_CHUNK) {
    const int nc = C - c0 < RED_CHUNK ? C - c0 : RED_CHUNK;
    long long v[RED_CHUNK];
    int op[RED_CHUNK];
    for (int i = 0; i < RED_CHUNK; ++i) {
      v[i] = I32_MAX;
      op[i] = RED_MIN;
    }
    for (int n = t; n < N; n += T)
#pragma unroll
      for (int i = 0; i < RED_CHUNK; ++i) {
        if (i >= nc) break;
        const long long o = pr.at(c0 + i, n);
        const bool te = a.sp_te[o];
        const long long cnt = a.sp_dom_cnt[o];
        if (te && cnt < v[i]) v[i] = cnt;
      }
    mark(2 * SPEC_MIN);
    group_reduce(gr, v, op, nc, s_red[gr.g], k);
    if (t < nc) {
      const int md = sv.min_domains(c0 + t);
      s_min[c0 + t] = (md > 0 && sv.sp_ndom(c0 + t) < md) ? 0 : (int)v[t];
    }
    mark(2 * SPEC_MIN + 1);
  }
  if (C) gr.sync();  // s_min

  // ---- filters and the normalizers' counts
  bool has_aff = false, has_soft = false;
  for (int u = 0; u < AT; ++u) has_aff = has_aff || sv.ip_aff(u);
  for (int c = 0; c < C; ++c) has_soft = has_soft || sv.sp_soft(c);
  const bool escape = has_aff && !sv.any_static() && sv.self_all();
  bool all_zero = true;
  for (int r = 0; r < a.Rp; ++r) all_zero = all_zero && sv.req(r) == 0;
  const int prio = sv.priority();
  const bool sampling = a.sample_k > 0;
  const int nv = a.n_valid > 1 ? a.n_valid : 1;
  int start = 0;
  if (sampling) {
    start = *a.sample_start % nv;
    if (start < 0) start += nv;
  }
  long long red[FEAS_VALS];
  const int red_op[FEAS_VALS] = {feas_op(0), feas_op(1), feas_op(2), feas_op(3), feas_op(4), feas_op(5)};
  feas_init(red);
  auto count_domain = [&](int c, int d) {
    if (d < 32 * Dw) atomicOr(flags + c * Dw + (d >> 5), 1u << (d & 31));
  };
  for (int base = gr.warp * 32; base < N; base += T) {
    const int n = base + lane;
    bool f = false;
    if (n < N) {
      const long long pn = pn0 + n;
      const bool m_mask = a.static_mask[pn];
      const bool m_portb = w.lane == nullptr || w.lane[pn];
      const bool m_fit = !a.check_fit || step_fits(a, own, n, sv, all_zero, prio, a.nom_off != nullptr);
      int term;
      const bool m_spread = spread_verdict(pr, nd, sv, s_min, C, n, NoPeer{}, NoSlot{}, term);
      bool m_interpod = true;
      long long ip_raw = 0;
      if (AT) m_interpod = interpod_verdict(pr, nd, sv, AT, n, escape, NoPeer{}, ip_raw, term);
      f = m_mask && m_portb && m_fit && m_spread && m_interpod;
      if (f && !sampling) count_feasible(pr, nd, sv, C, n, ip_raw, red, count_domain);
    }
    const unsigned bal = __ballot_sync(FULL_MASK, f);
    if (lane == 0) feas[base >> 5] = bal;
  }
  if (sampling) {  // keep the feasible nodes up to the sample_k-th in visit order
    mark(2 * SPEC_WINDOW);
    gr.sync();  // every node's verdict is in feas
    const int stop = group_window(a, gr, feas, start, nv, s_win[gr.g]);
    mark(2 * SPEC_WINDOW + 1);
    for (int base = gr.warp * 32; base < N; base += T) {
      const int n = base + lane;
      bool keep = false;
      if (n < N && ((feas[base >> 5] >> lane) & 1u)) {
        const int vr = a.visit_rank[n];
        keep = vr >= 0 && (stop < 0 || visit_pos(vr, start, nv) <= stop);
        if (keep) count_feasible(pr, nd, sv, C, n, AT ? spec_ip_raw(pr, nd, sv, AT, n) : 0, red, count_domain);
      }
      const unsigned bal = __ballot_sync(FULL_MASK, keep);
      if (lane == 0) feas[base >> 5] = bal;
    }
  }
  mark(2 * SPEC_COUNTS);
  group_reduce(gr, red, red_op, FEAS_VALS, s_red[gr.g], k);
  const long long n_feas = red[0];
  mark(2 * SPEC_COUNTS + 1);

  // ---- spread score: each warp's topology weights from the domain bits,
  // then the raws' min / max / count over the nodes that count
  ScoreNorms norms{red[1], red[2], red[3], red[4], I64_MAX, -I64_MAX, 0};
  if (C && a.w_spread) {
    for (int c = 0; c < C; ++c) {
      long long size = red[5];
      if (!sv.sp_host(c)) {
        int s = 0;
        for (int j = lane; j < Dw; j += 32) s += __popc(flags[c * Dw + j]);
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL_MASK, s, off);
        size = s;
      }
      if (lane == 0) wfx[c] = a.log_tab[size < 0 ? 0 : (size >= a.L ? a.L - 1 : size)];
    }
    __syncwarp();
    long long v[3] = {I64_MAX, -I64_MAX - 1, 0};
    const int op[3] = {RED_MIN, RED_MAX, RED_SUM};
    for (int base = gr.warp * 32; base < N; base += T) {
      const int n = base + lane;
      if (n >= N || !((feas[base >> 5] >> lane) & 1u)) continue;
      const bool use_n = !has_soft || a.sp_all_keys[pn0 + n];
      const long long raw = has_soft ? spec_sp_raw(pr, sv, C, n, wfx) : 0;
      if (use_n) {
        if (raw < v[0]) v[0] = raw;
        if (raw > v[1]) v[1] = raw;
        v[2] += 1;
      }
    }
    mark(2 * SPEC_SPREAD);
    group_reduce(gr, v, op, 3, s_red[gr.g], k);
    norms.sp_mn = v[0];
    norms.sp_mx = v[1];
    norms.n_use = v[2];
    mark(2 * SPEC_SPREAD + 1);
  }

  // ---- the weighted total and the argmax over the feasible nodes
  long long best = -I64_MAX - 1;
  int best_t = I32_MAX, best_n = I32_MAX;
  unsigned tk0 = (unsigned)a.tie_k0, tk1 = (unsigned)a.tie_k1;
  if (a.tie_on) rng::fold_in(tk0, tk1, (unsigned)a.attempt_base + (unsigned)p);
  for (int base = gr.warp * 32; base < N; base += T) {
    const int n = base + lane;
    if (n >= N || !((feas[base >> 5] >> lane) & 1u)) continue;
    const long long rn = (long long)n * a.Rn;
    long long a0 = 0, a1 = 0, c0 = 0, c1 = 0, r0 = 0, r1 = 0;
    if (a.w_fit || a.w_bal) {
      a0 = a.allocatable[rn + LANE_CPU];
      a1 = a.allocatable[rn + LANE_MEM];
      c0 = (long long)a.nonzero[2LL * n] + sv.nz_req(0);
      c1 = (long long)a.nonzero[2LL * n + 1] + sv.nz_req(1);
      r0 = (long long)a.requested[rn + LANE_CPU] + sv.req(LANE_CPU);
      r1 = (long long)a.requested[rn + LANE_MEM] + sv.req(LANE_MEM);
    }
    const bool sp_on = a.w_spread && C;
    const long long pn = pn0 + n;
    long long total = node_total(a, norms, C > 0, !has_soft || a.sp_all_keys[pn], a.sc_taint[pn], a.sc_nodeaff[pn],
                                 sp_on && has_soft ? spec_sp_raw(pr, sv, C, n, wfx) : 0,
                                 a.w_ip && AT ? spec_ip_raw(pr, nd, sv, AT, n) : 0, a0, a1, c0, c1, r0, r1,
                                 a.w_img ? a.sc_image[pn] : 0);
    if (a.extra_score != nullptr) total += a.extra_score[pn];
    long long key = total;
    int tie = n;
    if (a.tie_on)
      key = total * (1LL << 33) + rng::bits_at(tk0, tk1, (unsigned)n);
    else if (sampling)
      tie = visit_pos(a.visit_rank[n], start, nv);
    better(best, best_t, best_n, key, tie, n);
  }
  mark(2 * SPEC_ARGMAX);
  const int choice = group_argmax(gr, best, best_t, best_n, s_arg_v[gr.g], s_arg_t[gr.g], s_arg_i[gr.g], k);
  mark(2 * SPEC_ARGMAX + 1);
  if (gr.t == 0) {
    a.chosen[p] = n_feas > 0 ? choice : ABSENT;
    if (timed) {
      long long* const row = w.spec_info + (long long)p * (2 + SPEC_PHASES);
      row[0] = t0;
      row[1] = global_ns();
      for (int j = 0; j < SPEC_PHASES; ++j) row[2 + j] = clk[j];
    }
  }
}

}  // namespace

// Enqueues K8 on `stream` and returns the launch status (cudaGetLastError):
// CTAs of SPEC_CTA threads, a group of SPEC_WARPS warps a pod.
extern "C" int ktpu_wave_speculate(const GangScanArgs* args, const WaveArgs* wave, void* stream) {
  if (args->P == 0) return 0;
  constexpr int PODS = SPEC_CTA / (32 * SPEC_WARPS);
  const size_t smem = PODS * spec_layout(*args, *wave, SPEC_WARPS).bytes;
  cudaError_t e = cudaFuncSetAttribute(wave_speculate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wave_speculate_kernel<<<(args->P + PODS - 1) / PODS, SPEC_CTA, smem, static_cast<cudaStream_t>(stream)>>>(*args,
                                                                                                           *wave);
  return (int)cudaGetLastError();
}

// K9's launch plan into `wave` (ktpu::wave::admit_plan): the cluster size
// (16 where the card admits one cluster of 16 at the kernel's shared memory
// and cluster_cap allows it, else 8), the slice and what sits in shared
// memory under smem_cap; the pods' planes staged only with `stage`.
// Returns a CUDA status.
extern "C" int ktpu_wave_admit_plan(const GangScanArgs* args, WaveArgs* wave, int cluster_cap, int smem_cap,
                                    int stage) {
  WorkloadsArgs none{};
  return admit_plan<false>(*args, *wave, none, cluster_cap, smem_cap, stage);
}

// Enqueues K9 (one cluster, as ktpu_wave_admit_plan laid it out) on
// `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_wave_admit(const GangScanArgs* args, const WaveArgs* wave, void* stream) {
  return admit_launch<false>(*args, *wave, WorkloadsArgs{}, stream);
}
