// K5: the gang scan, one launch per batch.
//
// Replaces the JAX root kubernetes_tpu/ops/gang.py:975 gang_schedule (a
// lax.scan of pod_step's default branch, :680): for each pod of the batch
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
// Bound on the H100: the recurrence.  Per step the block reads the pod's
// [C, N] and [AT, N] static rows once and runs ~6 block-wide reductions and
// their barriers; one block uses one SM of 132.
#include <climits>

#include "ktpu.cuh"

using namespace ktpu;

namespace {

constexpr int SCAN_THREADS = 1024;
constexpr int RED_CHUNK = 8;  // slots per block-wide min reduction
constexpr int N_DIAG = 9;
constexpr int FX = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long I64_MAX = LLONG_MAX;

enum Op { SUM = 0, MIN = 1, MAX = 2 };

// floor division for b > 0 (the reference's // on int64)
__device__ __forceinline__ long long fdiv(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ long long combine(long long x, long long y, int op) {
  return op == SUM ? x + y : (op == MIN ? (y < x ? y : x) : (y > x ? y : x));
}

__device__ __forceinline__ long long identity(int op) {
  return op == SUM ? 0 : (op == MIN ? I64_MAX : -I64_MAX - 1);
}

// Block-wide reduction of nv <= NV values under their ops; every thread
// gets the results in v.  s_buf holds 32 * NV entries.
template <int NV>
__device__ void block_reduce(long long (&v)[NV], const int (&op)[NV], int nv,
                             long long* s_buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < nv; ++i)
    for (int off = 16; off > 0; off >>= 1)
      v[i] = combine(v[i], __shfl_down_sync(FULL, v[i], off), op[i]);
  if (lane == 0)
    for (int i = 0; i < nv; ++i) s_buf[warp * NV + i] = v[i];
  __syncthreads();
  if (warp == 0) {
    for (int i = 0; i < nv; ++i) {
      long long x = lane < (int)(blockDim.x >> 5) ? s_buf[lane * NV + i] : identity(op[i]);
      for (int off = 16; off > 0; off >>= 1) x = combine(x, __shfl_down_sync(FULL, x, off), op[i]);
      if (lane == 0) s_buf[i] = x;
    }
  }
  __syncthreads();
  for (int i = 0; i < nv; ++i) v[i] = s_buf[i];
  __syncthreads();
}

__device__ __forceinline__ void better(long long& v, int& i, long long ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Node n's compact domain id under topology key `key` (-1: absent).
__device__ __forceinline__ int dom_at(const GangScanArgs& a, int key, int n) {
  return key >= 0 && key < a.K ? a.dom_ids[(long long)key * a.N + n] : -1;
}

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

__global__ void __launch_bounds__(SCAN_THREADS) gang_scan_kernel(const GangScanArgs a) {
  // dynamic: s_wfx [C] (int64), s_min [C], s_ndom [C], then the counters
  // when use_smem
  extern __shared__ long long s_dyn[];
  __shared__ long long s_buf[32 * 16];
  __shared__ int s_any_dyn;
  __shared__ long long s_best_v[32];
  __shared__ int s_best_i[32];
  const int tid = threadIdx.x;
  const int N = a.N, C = a.C, AT = a.AT, D = a.D;
  long long* s_wfx = s_dyn;
  int* s_min = reinterpret_cast<int*>(s_dyn + C);
  int* s_ndom = s_min + C;
  int* base = a.cnt;
  if (a.use_smem) {
    base = s_ndom + C;
    const long long cells = (3LL * C + AT + 2LL * a.KD2) * D;
    for (long long i = tid; i < cells; i += blockDim.x) base[i] = 0;
  }
  const Counters k = counters(a, base);
  __syncthreads();

  for (int p = 0; p < a.P; ++p) {
    if (!a.valid[p]) {  // a pad row: nothing feasible, nothing counted
      if (tid == 0) {
        a.chosen[p] = ABSENT;
        a.n_feas[p] = 0;
        for (int r = 0; r < N_DIAG; ++r) a.reason_counts[(long long)p * N_DIAG + r] = 0;
      }
      __syncthreads();
      continue;
    }
    if (tid == 0) s_any_dyn = 0;
    for (int c = tid; c < C; c += blockDim.x) s_ndom[c] = 0;
    __syncthreads();
    peer_pass(a, k, p, true, &s_any_dyn);
    __syncthreads();

    // ---- spread min-match per constraint (filtering.go:313 minMatch),
    // RED_CHUNK constraints per block-wide reduction
    for (int c0 = 0; c0 < C; c0 += RED_CHUNK) {
      const int nc = C - c0 < RED_CHUNK ? C - c0 : RED_CHUNK;
      long long v[RED_CHUNK];
      int op[RED_CHUNK];
      for (int i = 0; i < RED_CHUNK; ++i) {
        v[i] = INT_MAX;
        op[i] = MIN;
      }
      for (int n = tid; n < N; n += blockDim.x)
        for (int i = 0; i < nc; ++i) {
          const long long pc = (long long)p * C + c0 + i;
          const long long o = pc * N + n;
          if (!a.sp_te[o]) continue;
          const int d = dom_at(a, a.sp_key[pc], n);
          const long long total = a.sp_dom_cnt[o] + (d >= 0 ? k.cnt_f[(long long)(c0 + i) * D + d] : 0);
          if (total < v[i]) v[i] = total;
        }
      block_reduce(v, op, nc, s_buf);
      if (tid < nc) {
        const long long pc = (long long)p * C + c0 + tid;
        const int md = a.min_domains[pc];
        s_min[c0 + tid] = (md > 0 && a.sp_ndom[pc] < md) ? 0 : (int)v[tid];
      }
    }
    __syncthreads();

    // ---- filters, diagnosis, and the normalizers' min / max
    bool has_aff = false, has_soft = false;
    for (int u = 0; u < AT; ++u) has_aff = has_aff || a.ip_is_aff[(long long)p * AT + u];
    for (int c = 0; c < C; ++c) has_soft = has_soft || a.sp_soft[(long long)p * C + c];
    const bool any_match = a.ip_any_static[p] || s_any_dyn;
    const bool escape = has_aff && !any_match && a.ip_self_all[p];
    const int* req = a.requests + (long long)p * a.Rp;
    bool all_zero = true;
    for (int r = 0; r < a.Rp; ++r) all_zero = all_zero && req[r] == 0;
    const int stamp = p + 1;

    // 0 n_feas, 1..9 reason counts, 10 taint max, 11 naff max, 12 ip min,
    // 13 ip max, 14 counted nodes
    long long red[15];
    const int red_op[15] = {SUM, SUM, SUM, SUM, SUM, SUM, SUM, SUM, SUM, SUM, MAX, MAX, MIN, MAX, SUM};
    for (int i = 0; i < 15; ++i) red[i] = identity(red_op[i]);
    red[10] = red[11] = 0;  // max(where(feas, raw, 0))
    for (int n = tid; n < N; n += blockDim.x) {
      const long long pn = (long long)p * N + n;
      const bool m_portb = !(a.JP && a.port_stamp[n] == stamp);
      bool m_fit = true;
      if (a.check_fit) {
        m_fit = a.num_pods[n] + 1 <= a.allowed_pods[n];
        if (m_fit && !all_zero) {
          for (int r = 0; r < a.Rp; ++r) {
            const long long v = req[r];
            if (r >= N_FIXED_LANES && v == 0) continue;  // unrequested scalar lane
            const long long avail = r < a.Rn
                ? (long long)a.allocatable[(long long)n * a.Rn + r] - a.requested[(long long)n * a.Rn + r]
                : 0;
            if (v > avail) {
              m_fit = false;
              break;
            }
          }
        }
      }
      bool m_spread = true;
      for (int c = 0; c < C; ++c) {
        const long long pc = (long long)p * C + c;
        const long long o = pc * N + n;
        const int d = dom_at(a, a.sp_key[pc], n);
        const long long total = a.sp_dom_cnt[o] + (d >= 0 ? k.cnt_f[(long long)c * D + d] : 0);
        const long long skew = total + (a.sp_self[pc] ? 1 : 0) - s_min[c];
        const bool c_ok = d >= 0 && (!a.sp_dom_pres[o] || skew <= a.max_skew[pc]);
        if (a.sp_hard[pc] && !c_ok) m_spread = false;
        a.sp_cnt[(long long)c * N + n] =
            a.sp_is_host[pc] ? a.sp_node_cnt[o] + a.cnt_h[(long long)c * N + n]
                             : a.sp_sc_dom[o] + (d >= 0 ? k.cnt_s[(long long)c * D + d] : 0);
      }
      bool m_interpod = true;
      long long ip_raw = 0;
      if (AT) {
        ip_raw = a.ip_sym[pn];
        bool viol2 = false, aff_ok = true, topo_all = true;
        long long pref = 0;
        for (int u = 0; u < AT; ++u) {
          const long long pu = (long long)p * AT + u;
          const long long o = pu * N + n;
          const int d = dom_at(a, a.ip_key[pu], n);
          const bool present = d >= 0;
          const long long tot = a.ip_dom_cnt[o] + (present ? k.cnt_i[(long long)u * D + d] : 0);
          if (a.ip_is_anti[pu] && present && tot > 0) viol2 = true;
          if (a.ip_is_aff[pu]) {
            aff_ok = aff_ok && present && tot > 0;
            topo_all = topo_all && present;
          }
          if (present) pref += tot * a.ip_pref_w[pu];
        }
        bool viol_b = false;
        int sym_b = 0;  // int32, as the reference's einsum
        for (int ki = 0; ki < a.KD2; ++ki) {
          const int d = dom_at(a, a.kd2_key[ki], n);
          if (d < 0) continue;
          const long long cell = (long long)ki * D + d;
          viol_b = viol_b || k.viol_t[cell];
          sym_b += k.sym_t[cell];
        }
        const bool ok3 = aff_ok || (escape && topo_all);
        m_interpod = !a.ip_viol_existing[pn] && !viol2 && ok3 && !viol_b;
        ip_raw += pref + sym_b;
      }
      const bool feas = a.static_mask[pn] && m_portb && m_fit && m_spread && m_interpod;
      a.feas[n] = feas;
      a.ip_raw[n] = ip_raw;

      // first failure in the filter chain's order
      if (a.node_valid[n]) {
        const bool comp[N_DIAG] = {a.d_unsched[pn] != 0, a.d_nodename[pn] != 0, a.d_taints[pn] != 0,
                                   a.d_nodeaff[pn] != 0, a.d_ports[pn] && m_portb, a.d_extra[pn] != 0,
                                   m_fit, m_spread, m_interpod};
        for (int r = 0; r < N_DIAG; ++r)
          if (!comp[r]) {
            red[1 + r] += 1;
            break;
          }
      }
      if (feas) {
        red[0] += 1;
        if (a.sc_taint[pn] > red[10]) red[10] = a.sc_taint[pn];
        if (a.sc_nodeaff[pn] > red[11]) red[11] = a.sc_nodeaff[pn];
        if (ip_raw < red[12]) red[12] = ip_raw;
        if (ip_raw > red[13]) red[13] = ip_raw;
        if (a.sp_all_keys[pn]) {
          red[14] += 1;
          // distinct domains among the counted nodes, per non-hostname
          // constraint (the hostname's topology size is red[14])
          for (int c = 0; c < C; ++c) {
            const long long pc = (long long)p * C + c;
            if (a.sp_is_host[pc]) continue;
            const int d = dom_at(a, a.sp_key[pc], n);
            if (d < 0) continue;
            if (atomicExch(k.seen + (long long)c * D + d, stamp) != stamp) atomicAdd(s_ndom + c, 1);
          }
        }
      }
    }
    block_reduce(red, red_op, 15, s_buf);
    const long long n_feas = red[0];

    // ---- spread score (_spread_raw): topology weights, then per-node raws
    long long sp_mn = I64_MAX, sp_mx = -I64_MAX, n_use = 0;
    if (C && a.w_spread) {
      for (int c = tid; c < C; c += blockDim.x) {
        const long long pc = (long long)p * C + c;
        const long long size = a.sp_is_host[pc] ? red[14] : s_ndom[c];
        s_wfx[c] = a.log_tab[size < 0 ? 0 : (size >= a.L ? a.L - 1 : size)];
      }
      __syncthreads();
      long long v[3] = {I64_MAX, -I64_MAX - 1, 0};
      const int op[3] = {MIN, MAX, SUM};
      for (int n = tid; n < N; n += blockDim.x) {
        if (!a.feas[n]) continue;
        const long long pn = (long long)p * N + n;
        long long raw = 0;
        bool use = true;
        if (has_soft) {
          use = a.sp_all_keys[pn];  // valid & feas == counted
          long long total_fx = 0;
          for (int c = 0; c < C; ++c) {
            const long long pc = (long long)p * C + c;
            if (!a.sp_soft[pc]) continue;
            total_fx += (long long)a.sp_cnt[(long long)c * N + n] * s_wfx[c] +
                        (long long)(a.max_skew[pc] - 1) * (1LL << FX);
          }
          const long long q = total_fx >> FX;  // arithmetic shift
          const long long frac = total_fx & ((1LL << FX) - 1);
          const long long half = 1LL << (FX - 1);
          raw = q + ((frac > half || (frac == half && (q & 1))) ? 1 : 0);
        }
        a.sp_raw[n] = raw;
        if (use) {
          if (raw < v[0]) v[0] = raw;
          if (raw > v[1]) v[1] = raw;
          v[2] += 1;
        }
      }
      block_reduce(v, op, 3, s_buf);
      sp_mn = v[0];
      sp_mx = v[1];
      n_use = v[2];
    }

    // ---- weighted total and the first-max argmax over the feasible nodes
    long long best = LLONG_MIN;
    int best_n = INT_MAX;
    const long long taint_mx = red[10], naff_mx = red[11], ip_mn = red[12], ip_mx = red[13];
    for (int n = tid; n < N; n += blockDim.x) {
      if (!a.feas[n]) continue;
      const long long pn = (long long)p * N + n;
      long long total = 0;
      if (a.w_taint) {
        const long long raw = a.sc_taint[pn];
        total += a.w_taint * (taint_mx > 0 ? MAX_NODE_SCORE - fdiv(MAX_NODE_SCORE * raw, taint_mx)
                                           : MAX_NODE_SCORE);
      }
      if (a.w_naff) {
        const long long raw = a.sc_nodeaff[pn];
        total += a.w_naff * (naff_mx > 0 ? fdiv(MAX_NODE_SCORE * raw, naff_mx) : raw);
      }
      if (a.w_spread) {
        long long s = MAX_NODE_SCORE;  // C == 0: every feasible node is "used", mx == 0
        if (C) {
          const bool use = !has_soft || a.sp_all_keys[pn];
          s = 0;
          if (use && n_use > 0)
            s = sp_mx == 0 ? MAX_NODE_SCORE
                           : fdiv(MAX_NODE_SCORE * (sp_mx + sp_mn - a.sp_raw[n]), sp_mx > 1 ? sp_mx : 1);
        }
        total += a.w_spread * s;
      }
      if (a.w_ip) {
        const long long diff = ip_mx - ip_mn;
        total += a.w_ip * (diff > 0 ? fdiv(MAX_NODE_SCORE * (a.ip_raw[n] - ip_mn), diff) : 0);
      }
      if (a.w_fit || a.w_bal) {
        const long long a0 = a.allocatable[(long long)n * a.Rn + LANE_CPU];
        const long long a1 = a.allocatable[(long long)n * a.Rn + LANE_MEM];
        total += score_total(a0, a1, (long long)a.nonzero[2 * n] + a.nonzero_req[2 * p],
                             (long long)a.nonzero[2 * n + 1] + a.nonzero_req[2 * p + 1],
                             (long long)a.requested[(long long)n * a.Rn + LANE_CPU] + req[LANE_CPU],
                             (long long)a.requested[(long long)n * a.Rn + LANE_MEM] + req[LANE_MEM], 0,
                             a.w_fit, a.w_bal, 0);
      }
      if (a.w_img) total += a.w_img * a.sc_image[pn];
      if (total > best) {  // ascending n: strict > keeps the first max
        best = total;
        best_n = n;
      }
    }
    {
      const int lane = tid & 31, warp = tid >> 5;
      for (int off = 16; off > 0; off >>= 1) {
        const long long ov = __shfl_down_sync(FULL, best, off);
        const int oi = __shfl_down_sync(FULL, best_n, off);
        better(best, best_n, ov, oi);
      }
      if (lane == 0) {
        s_best_v[warp] = best;
        s_best_i[warp] = best_n;
      }
      __syncthreads();
      if (warp == 0) {
        best = s_best_v[lane];
        best_n = s_best_i[lane];
        for (int off = 16; off > 0; off >>= 1) {
          const long long ov = __shfl_down_sync(FULL, best, off);
          const int oi = __shfl_down_sync(FULL, best_n, off);
          better(best, best_n, ov, oi);
        }
        if (lane == 0) {
          const int choice = n_feas > 0 ? best_n : ABSENT;
          a.chosen[p] = choice;
          a.n_feas[p] = n_feas;
          for (int r = 0; r < N_DIAG; ++r) a.reason_counts[(long long)p * N_DIAG + r] = red[1 + r];
          if (choice >= 0) {  // the commit (usage_carry_update)
            const int rn = a.Rn < a.Rp ? a.Rn : a.Rp;
            for (int r = 0; r < rn; ++r) a.requested[(long long)choice * a.Rn + r] += req[r];
            a.nonzero[2 * choice] += a.nonzero_req[2 * p];
            a.nonzero[2 * choice + 1] += a.nonzero_req[2 * p + 1];
            a.num_pods[choice] += 1;
          }
        }
      }
      __syncthreads();  // the commit is visible to every thread of the block
    }
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
