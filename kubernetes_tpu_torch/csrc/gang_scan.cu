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
// Design: the pods form a serial recurrence; the nodes of one step do not.
// So K5 is ONE thread-block cluster (cudaLaunchKernelEx with a cluster
// dimension) of G CTAs of CLUSTER_THREADS on neighbouring SMs, sized and
// laid out as K9's (csrc/wave.cu): G = 16 where cudaOccupancyMaxActiveClusters
// admits a cluster of 16 at the kernel's shared memory, else 8
// (ops/gang.py SCAN_CLUSTER_CAP caps it); CTA r owns the nodes
// [r S, r S + S), S a multiple of 32.  The per-pod verdict, scores and
// argmax are ktpu::step::pod_step_block under ClusterPolicyT<false>
// (csrc/ktpu.cuh), the body K9 and K11 run, with each pod's planes
// staged one pod ahead and its values copied in at its start as K9 does;
// its block-wide parts cross the cluster as st.async pushes on mbarriers:
// the spread min-match (the step's own reduction: K5 has no pod_tables
// exchange to carry it), the 15-value reduction with the distinct counted
// domains, the sampling window's verdict map, the spread min / max / count
// and the argmax, so 4 exchanges a pod with spread slots, 2 without, one
// more with the window.  Pad rows cost none: every CTA reads `valid` and
// skips them alike.
//
// The committed peers' counts: the reference re-derives them every step
// with dense [C, N, J] / [AT, N, J] compares (O(P^2 N) per batch).  Here
// EVERY CTA walks the committed peers j < p itself (one or two strided
// iterations at P = 512) and counts them into its own per-domain counters,
// indexed by the COMPACT domain id of the peer's node under the slot's
// topology key (DeviceCluster.dom_ids, the numbering K6 and K7 accumulate
// under), D cells per row:
//   cnt_f[c][d]  peers matching constraint c, tracked+eligible at their node
//   cnt_s[c][d]  peers matching c, counted by the score at their node
//   cnt_i[u][d]  peers matching the pod's inter-pod term u
//   viol_t[k][d] / sym_t[k][d]  the committed peers' OWN terms that admit
//                the pod, per (distinct topology key, domain): their
//                anti-affinity flags and symmetric weights
// so each CTA holds complete counters and no exchange carries them; a CTA
// counts the per-node hostname-spread counts (cnt_h) and host-port stamps
// only at the nodes of its own slice.  The cells a step touched are
// cleared by walking the peers again.  The walk reads the peers' nodes from
// each CTA's own copy of the batch's choices, which every CTA writes from
// the argmax exchange (only rank 0 writes `chosen`, and a read of it by
// another CTA would need a cluster-wide fence).  The usage commit is made by
// the CTA that owns the chosen node, on its slice's rows, written back at
// the end; the window's cursor is advanced by every CTA alike; rank 0
// writes every output.  No combine is order-dependent (int64 sums, mins,
// maxes, the argmax's total order), so the choice is the reference's.
// Shared memory holds, while they fit (the card's opt-in limit, or
// ops/gang.py SCAN_SMEM_CAP; else global rows, one set per CTA): the
// exchange slab with the choices' copy, the counters (2 C + AT + 2 KD2) * D
// (D = N with a hostname-keyed slot), the slice's usage and step rows with
// cnt_h and the stamps, and its node statics with the staged planes.
// Scores are int64 throughout; every division is a floor division (fdiv),
// which equals C truncation where the numerator is non-negative and the
// reference's // everywhere.  The spread score's 32.32 fixed point uses an
// arithmetic >> and round-half-to-even, as _spread_raw does.  The rank-0
// leader's cycles per phase come back in WaveArgs::admit_info.
//
// Bound on the H100: the recurrence: per pod 2-4 exchanges, the peer walk
// twice, and one pass over a slice of N / G nodes per step phase from
// shared memory, on G SMs of 132.
#include "ktpu.cuh"

using namespace ktpu;
using namespace ktpu::step;

namespace {

using ScanPolicy = ClusterPolicyT<false>;

// The peer counters, D cells per row (see the header).
struct Counters {
  int *cnt_f, *cnt_s, *cnt_i, *viol_t, *sym_t;
};

__host__ __device__ inline long long counter_cells(const GangScanArgs& a) {
  return (2LL * a.C + a.AT + 2LL * a.KD2) * a.D;
}

__device__ __forceinline__ Counters counters(const GangScanArgs& a, int* base) {
  const long long D = a.D, C = a.C;
  Counters k;
  k.cnt_f = base;
  k.cnt_s = base + C * D;
  k.cnt_i = base + 2 * C * D;
  k.viol_t = k.cnt_i + (long long)a.AT * D;
  k.sym_t = k.viol_t + (long long)a.KD2 * D;
  return k;
}

// The per-node peer counts of this CTA's slice: cnt_h [C, ld] and the
// host-port stamps [ld], node n at n - lo.
struct SliceCounts {
  int *cnt_h, *stamp;
  int lo, ld;
  __device__ __forceinline__ int& h(int c, int n) const { return cnt_h[(long long)c * ld + n - lo]; }
  __device__ __forceinline__ int& st(int n) const { return stamp[n - lo]; }
};

// Walk the committed peers j < p (their nodes from this CTA's copy of the
// choices) and count them into their cells (add) or zero the same cells
// again (clear); the per-node counts only at this CTA's nodes.
__device__ void peer_pass(const GangScanArgs& a, const Counters& k, const SliceCounts& sl, const int* chosen,
                          const Xch& x, const ScanPolicy& pol, int p, bool add, int* s_any_dyn) {
  const int C = a.C, AT = a.AT, N = a.N, P = a.P, D = a.D;
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    const int nj = x.ld(chosen + j);
    if (nj < 0) continue;
    const bool own = pol.owns(nj);
    if (add && own && a.JP && a.port_b[(long long)p * a.JP + j]) sl.st(nj) = p + 1;
    for (int c = 0; c < C; ++c) {
      const long long pc = (long long)p * C + c;
      if (!a.sp_bmatch[pc * P + j]) continue;
      const int d = dom_at(a, a.sp_key[pc], nj);
      if (d >= 0 && a.sp_te[pc * N + nj]) {
        if (add) atomicAdd(k.cnt_f + (long long)c * D + d, 1);
        else k.cnt_f[(long long)c * D + d] = 0;
      }
      if (a.sp_is_host[pc]) {
        if (!own) continue;
        if (add) atomicAdd(&sl.h(c, nj), 1);
        else sl.h(c, nj) = 0;
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
  SliceCounts sl;
  NodeRows nd;
  int stamp;
  __device__ int f(int c, long long, int, int d) const { return d >= 0 ? k.cnt_f[(long long)c * a.D + d] : 0; }
  __device__ int sc(int c, long long, int n, int d, bool host) const {
    return host ? sl.h(c, n) : (d >= 0 ? k.cnt_s[(long long)c * a.D + d] : 0);
  }
  __device__ int ip(int u, long long, int, int d) const { return d >= 0 ? k.cnt_i[(long long)u * a.D + d] : 0; }
  __device__ bool viol(int n) const {
    for (int ki = 0; ki < a.KD2; ++ki) {
      const int d = nd.dom(a.kd2_key[ki], n);
      if (d >= 0 && k.viol_t[(long long)ki * a.D + d]) return true;
    }
    return false;
  }
  __device__ long long sym(int n) const {
    int sym_b = 0;  // int32, as the reference's einsum
    for (int ki = 0; ki < a.KD2; ++ki) {
      const int d = nd.dom(a.kd2_key[ki], n);
      if (d >= 0) sym_b += k.sym_t[(long long)ki * a.D + d];
    }
    return sym_b;
  }
  __device__ bool portb(int n) const { return !(a.JP && sl.st(n) == stamp); }
};

// The ints of one CTA's exchange slab: its counted-domain flags [C, Dsp]
// and every CTA's as bits [G, C, Dw], the window's map [ceil(N / 32)], and
// its copy of the batch's choices [P].
__host__ __device__ inline int dom_words(const WaveArgs& w) { return (w.Dsp + 31) >> 5; }
__host__ __device__ inline long long slab_cells(const GangScanArgs& a, const WaveArgs& w) {
  return (long long)a.C * w.Dsp + (long long)w.cluster * a.C * dom_words(w) + ((a.N + 31) >> 5) + a.P;
}

// Byte offsets of K5's dynamic shared memory (only the parts placed there),
// each part 16-byte aligned: s_wfx [C] (int64), s_min [C], s_ndom [C], the
// pod's values (StagedVals: ints, then int64s); the exchange slab
// (sums_smem); the counters (carry_smem); the slice's usage rows requested
// [S, Rn], nonzero [S, 2], num_pods [S], step rows ip_raw / sp_raw [S]
// (int64), sp_cnt [C, S], feas [S], and cnt_h [C, S], the stamps [S]
// (rows_smem); its node statics allocatable [S, Rn], allowed_pods [S],
// visit_rank [S], dom_ids [K, S], node_valid [S] and two pods' staged planes
// (stage).
struct ScanLayout {
  size_t wfx, smin, sndom, vals_i, vals_l, slab, cnt, req, nz, pods, ip_raw, sp_raw, sp_cnt, feas, cnt_h, stamp,
      alloc, allowed, vrank, dom, valid, stage, bytes;
};

__host__ __device__ inline ScanLayout scan_layout(const GangScanArgs& a, const WaveArgs& w) {
  const size_t S = w.slice, C = a.C;
  ScanLayout l{};
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o = (o + bytes + 15) / 16 * 16;
    return at;
  };
  l.wfx = take(8 * C);
  l.smin = take(4 * C);
  l.sndom = take(4 * C);
  l.vals_i = take(4 * (size_t)StagedVals::ints(a.C, a.AT, a.Rp, 0, 0));
  l.vals_l = take(8 * (size_t)StagedVals::longs(a.C, a.AT, 0));
  if (w.sums_smem) l.slab = take(4 * (size_t)w.xch_cells);
  if (w.carry_smem) l.cnt = take(4 * (size_t)counter_cells(a));
  if (w.rows_smem) {
    l.req = take(4 * S * a.Rn);
    l.nz = take(8 * S);
    l.pods = take(4 * S);
    l.ip_raw = take(8 * S);
    l.sp_raw = take(8 * S);
    l.sp_cnt = take(4 * C * S);
    l.feas = take(S);
    l.cnt_h = take(4 * C * S);
    l.stamp = take(4 * S);
  }
  if (w.stage) {
    l.alloc = take(4 * S * a.Rn);
    l.allowed = take(4 * S);
    l.vrank = take(4 * S);
    l.dom = take(4 * S * a.K);
    l.valid = take(S);
    l.stage = take(2 * (size_t)stage_bytes(a, w.slice));
  }
  l.bytes = o;
  return l;
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1) gang_scan_kernel(const GangScanArgs a, const WaveArgs w) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ ClusterShared s_cl;
  __shared__ int s_at[6];
  __shared__ unsigned long long s_mbar[2];
  __shared__ int s_any_dyn;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), G = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const int N = a.N, C = a.C, S = w.slice;
  const int lo = min(N, rank * S), hi = min(N, lo + S), len = hi - lo;
  const ScanLayout l = scan_layout(a, w);
  const StepShared sh{reinterpret_cast<long long*>(s_raw + l.wfx), reinterpret_cast<int*>(s_raw + l.smin),
                      reinterpret_cast<int*>(s_raw + l.sndom), s_at};

  // the exchange slab: the domain flags and bits, the window's map, the
  // choices' copy
  const Xch x{(long long)w.xch_cells, rank, w.sums_smem};
  int* const flags = w.sums_smem ? reinterpret_cast<int*>(s_raw + l.slab) : w.sums + (long long)rank * w.xch_cells;
  const int Dw = dom_words(w);
  int* const recv_bits = flags + (long long)C * w.Dsp;
  int* const wmap = recv_bits + (long long)G * C * Dw;
  int* const chosen = wmap + ((N + 31) >> 5);
  // the counters, zeroed
  const long long cells = counter_cells(a);
  int* const cbase = w.carry_smem ? reinterpret_cast<int*>(s_raw + l.cnt) : w.carries + (long long)rank * cells;
  for (long long i = tid; i < cells; i += blockDim.x) cbase[i] = 0;
  const Counters k = counters(a, cbase);

  // the step's rows, the usage rows and the per-node peer counts: the slice
  // in shared memory (the usage staged in from the usage state), or the
  // global rows; likewise the node statics
  StepScratch sc = global_scratch(a, a.feas, a.ip_raw, a.sp_raw, a.sp_cnt);
  SliceCounts sl{a.cnt_h, a.port_stamp, 0, N};
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
    sl = SliceCounts{reinterpret_cast<int*>(s_raw + l.cnt_h), reinterpret_cast<int*>(s_raw + l.stamp), lo, S};
  }
  for (int i = tid; i < C * len; i += blockDim.x) {
    const int c = i / len;
    sl.h(c, lo + i - c * len) = 0;
  }
  for (int i = tid; i < len; i += blockDim.x) sl.st(lo + i) = 0;
  if (w.stage)
    sc.nodes = stage_nodes(a, reinterpret_cast<int*>(s_raw + l.alloc), reinterpret_cast<int*>(s_raw + l.allowed),
                           reinterpret_cast<int*>(s_raw + l.vrank), reinterpret_cast<int*>(s_raw + l.dom),
                           s_raw + l.valid, lo, len, S);
  if (tid == 0) init_mbars(s_mbar, s_cl);

  if (tid < CL_PHASES) s_cl.clock[tid] = 0;
  ScanPolicy pol{};
  pol.lo = lo;
  pol.hi = hi;
  pol.S = S;
  pol.rank = rank;
  pol.G = G;
  pol.cur = a.sample_k > 0 ? *a.sample_start : 0;
  pol.cs = &s_cl;
  pol.flags = flags;
  pol.recv_bits = recv_bits;
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
                      a.AT, a.Rp, 0, 0};
  cluster_barrier();  // every CTA of the cluster runs before any DSMEM access
  if (w.stage && tid == 0 && a.P > 0) pol.issue(a, 0);

  for (int p = 0; p < a.P; ++p) {
    pol.stage_pod(a, p);
    if (!a.valid[p]) {  // a pad row: nothing feasible, nothing counted, no exchange
      if (pol.leader()) write_step(a, p, StepOut{ABSENT, 0, {0, 0, 0, 0, 0, 0, 0, 0, 0}});
      if (tid == 0) x.st(chosen + p, ABSENT);
      __syncthreads();
      continue;
    }
    pol.begin_pod();
    pol.stage_vals(a, w, p);
    if (tid == 0) s_any_dyn = 0;
    __syncthreads();
    peer_pass(a, k, sl, chosen, x, pol, p, true, &s_any_dyn);
    __syncthreads();
    const StepOut out = pod_step_block(a, p, ScanDyn{a, k, sl, sc.nodes, p + 1}, s_any_dyn != 0, sc, sh, -1, true, pol);
    if (tid == 0) {
      if (out.choice >= 0 && pol.owns(out.choice)) commit_usage(a, sc.use, p, out.choice);
      x.st(chosen + p, out.choice);
    }
    if (pol.leader()) write_step(a, p, out);
    pol.advance(a, out);
    pol.end_pod();
    __syncthreads();  // the commit and the choice's copy are visible to the CTA
    peer_pass(a, k, sl, chosen, x, pol, p, false, &s_any_dyn);  // clear the cells this step touched
    __syncthreads();
  }

  if (w.rows_smem) copy_usage(a, sc.use, len, false);  // the slice's usage rows back to the usage state
  if (pol.leader()) {
    if (a.sample_k > 0) *a.sample_start = pol.cur;
    if (w.admit_info != nullptr) {
      w.admit_info[0] = G;
      w.admit_info[1] = pol.syncs;
      for (int i = 0; i < CL_PHASES; ++i) w.admit_info[2 + i] = (int)(s_cl.clock[i] >> 4);
    }
  }
  cluster_barrier();  // no CTA leaves while a peer may still read its shared memory
}

// K5's placement at cluster size G: slice, exchange slab, and, while each
// fits in `budget` bytes, the slab, the counters, the slice's rows and its
// node statics with the pods' staged planes (when `stage` allows it) in
// shared memory.
void place(const GangScanArgs& a, WaveArgs& w, int G, long long budget, bool stage) {
  w.cluster = G;
  w.slice = slice_nodes(a.N, G);
  w.xch_cells = (int)slab_cells(a, w);
  w.sums_smem = w.carry_smem = w.rows_smem = w.stage = 0;
  int* const flags[4] = {&w.sums_smem, &w.carry_smem, &w.rows_smem, &w.stage};
  for (int* f : flags) {
    if (f == &w.stage && !stage) continue;
    *f = 1;
    if ((long long)scan_layout(a, w).bytes > budget) *f = 0;
  }
}

}  // namespace

// K5's launch plan into `wave`: the cluster size (16 where the card admits
// one cluster of 16 at the kernel's shared memory and cluster_cap allows
// it, else 8), the slice and what sits in shared memory under
// min(smem_cap, the card's opt-in limit less the static shared memory);
// the pods' planes are staged only with 16-byte aligned rows.  Returns a
// CUDA status.
extern "C" int ktpu_gang_scan_plan(const GangScanArgs* args, WaveArgs* wave, int cluster_cap, int smem_cap) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, gang_scan_kernel);
  if (e != cudaSuccess) return (int)e;
  const long long limit = (long long)optin - (long long)fa.sharedSizeBytes;
  const long long budget = smem_cap < limit ? smem_cap : limit;
  const bool staged = stage_aligned(*args);
  auto smem = [&](int G) {
    place(*args, *wave, G, budget, staged);
    return scan_layout(*args, *wave).bytes;
  };
  int G = 8;
  e = cluster_size(gang_scan_kernel, cluster_cap, smem, &G);
  if (e == cudaSuccess) smem(G);
  return (int)e;
}

// Enqueues K5 (one cluster, as ktpu_gang_scan_plan laid it out) on
// `stream` and returns the launch status (cudaGetLastError).
extern "C" int ktpu_gang_scan(const GangScanArgs* args, const WaveArgs* wave, void* stream) {
  if (args->P == 0) return 0;
  const size_t smem = scan_layout(*args, *wave).bytes;
  cudaError_t e = cudaFuncSetAttribute(gang_scan_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gang_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(wave->cluster, smem, static_cast<cudaStream_t>(stream), attr);
  e = cudaLaunchKernelEx(&cfg, gang_scan_kernel, *args, *wave);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
