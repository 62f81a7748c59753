// K6 gang_spread_statics and K7 gang_interpod_statics: the state-
// independent halves of the gang precompute.
//
// Replace the spread and inter-pod halves of the JAX root
// kubernetes_tpu/ops/gang.py:268 precompute (XLA: spread_precompute's
// [P, C, E] selector match, per_node_counts' segment sums, two
// domain_stats passes over the whole label-value vocabulary,
// interpod_precompute's [M, P] / [P, AT, E] matches and the int32
// [P, M] x [M, N] dot_general of interpod_weighted_ext, and the pod x pod
// and pod x node host-port compares).
//
// K6, three kernels:
//   * classes, where the placed pods number at least class_ratio times
//     the constraints (config4: 88 times; not at the mixed shape, where
//     the classes kernel's pairwise compares cost more than they save): a
//     warp per (pod, constraint) finds the first selector equal to it (same
//     requirements, same namespace): config4's 512 constraints are 20
//     selectors, and only these representatives are evaluated;
//   * match: a block stages a tile of representative selectors in shared
//     memory and takes 256 placed pods, one a thread; each thread reads
//     its pod's row once for the tile and evaluates it against every
//     selector of it (same namespace, valid, not deleting), and each warp
//     writes one 32-pod word of match bits per selector;
//   * domain, one block per (pod, constraint): the node counts
//     (sp_node_cnt) from its representative's set bits, counted in shared
//     memory; then each node's eligibility, folded into per-DOMAIN sums
//     under the compact per-key domain ids (DeviceCluster.dom_ids) held in
//     shared memory, warp-aggregated so that the nodes of a few-domain key
//     (zones) do not serialise on their cells: the tracked-and-eligible
//     total and presence (the filter's domain_stats) and the
//     all-keys-and-eligible total (the score's); each node reads its
//     domain's sums back.  A key with more domains than the shared budget
//     holds is walked in domain tiles.  A node's label value for a key is
//     read as its domain's (DeviceCluster.dom_vals), so that every row the
//     node passes read is node-major.
// K7, up to six kernels:
//   * terms: per placed term, the pod-independent part: its (key, domain)
//     cell, its symmetric weight and anti flag, or -1 for a term that can
//     never count (dead pod, no key, node without the label, a fork's
//     gone node); it marks the keys live terms use;
//   * ext, one block per pod: interpod_weighted_ext factored by (topology
//     key, domain): each live term whose namespace set and selector match
//     the pod adds its weights to its cell, and each node sums the cells
//     of its own domains over the used keys only -- O(M + N * keys) per
//     pod, exact int32; the cells sit in shared memory, laid out over the
//     used keys' domains (walked in tiles past the shared budget);
//   * the pod's own terms: the (classes and) match kernels above over the
//     batch's terms (any namespace set, deleting pods included), then one
//     block per (pod, term) counting the set bits into per-domain cells in
//     shared memory (ip_dom_cnt), the any-match flag, the self match and
//     the batch-peer matches (ip_bmatch);
//   * host ports: d_ports [P, N] against the nodes' used ports, port_b
//     [P, P] between the batch's pods.
//
// No kernel here needs anything from the host but the launch's shape
// (the wrappers make no host-to-device copy and no synchronize), and each
// kernel records its span (globaltimer): its first block's start and its
// last block's end, by atomics into its rows of the launch's span table.
//
// Bound on the H100: bytes at the shapes that matter.  The outputs are
// [P, C, N] / [P, N] rows written once, four nodes a thread in 16- and
// 4-byte stores (the wrappers require N % 4 == 0 and 16-byte aligned input
// rows); the selector evaluations (P x C x E for K6, P x (M + AT x E)
// for K7, fewer with classes) are a few integer
// compares each over tables staged in shared memory or held in L1.  What
// is left above the bound is latency: a block's selectors and a pod's terms
// are evaluated one after the other, each a chain of dependent loads.
//
// Semantics are those of the plain versions in kubernetes_tpu_torch/ops/
// gang.py precompute_plain (ops/filters.py, ops/scores.py, ops/common.py
// domain_stats), which the chip check holds these kernels to exactly.  All
// arithmetic is integer; the int32 sums wrap as the reference's int32 dot
// does (addition mod 2^32 is associative, so the order of the atomics does
// not matter).
#include <algorithm>
#include <mutex>
#include <vector>

#include "ktpu.cuh"

using namespace ktpu;

namespace {

constexpr int STAT_THREADS = 256;
constexpr int PORT_THREADS = 256;
constexpr int MATCH_THREADS = 256;  // one placed pod a thread: 8 words of match bits a block
constexpr int EXT_THREADS = 512;
constexpr int VEC = 4;  // nodes a thread of the node passes loads and stores at once
constexpr unsigned FULL = 0xffffffffu;
constexpr int TERM_REQUIRED_AFFINITY = 0;
constexpr int TERM_REQUIRED_ANTI = 1;
constexpr int TERM_PREFERRED_AFFINITY = 2;
constexpr int TERM_PREFERRED_ANTI = 3;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The span table [kernels, SPAN_SMS, 2], zeroed by the entry point: per
// kernel of a launch (in the wrappers' order, ops/gang.py SPREAD_KERNELS,
// INTERPOD_KERNELS) and per SM the earliest start and the latest end of
// its blocks there, so that the atomics of a grid's thousands of blocks
// contend only within an SM.  The start is kept complemented, so that one
// atomicMax from zero keeps the earliest; rows no block wrote stay 0.
enum SpreadSpan { SP_CLASSES, SP_MATCH, SP_DOMAIN, SP_KERNELS };
enum InterpodSpan { IP_TERMS, IP_EXT, IP_INC_CLASSES, IP_INC_MATCH, IP_INC_DOMAIN, IP_PORTS, IP_KERNELS };
constexpr int SPAN_SMS = 256;  // rows a kernel (ops/gang.py SPAN_SMS); SMs past it share the last

__device__ __forceinline__ unsigned long long* span_row(unsigned long long* kernel_rows) {
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  return kernel_rows + 2 * (sm < SPAN_SMS ? sm : SPAN_SMS - 1);
}

__device__ __forceinline__ void span_begin(unsigned long long* rows) {
  if (threadIdx.x == 0) atomicMax(span_row(rows), ~(unsigned long long)global_ns());
}

__device__ __forceinline__ void span_close(unsigned long long* rows) {
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(span_row(rows) + 1, (unsigned long long)global_ns());
}

__device__ __forceinline__ int block_sum(int v, int* s_red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? s_red[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
    if (lane == 0) s_red[0] = v;
  }
  __syncthreads();
  const int out = s_red[0];
  __syncthreads();
  return out;
}

// VEC = 4 consecutive values of a row: one 4-, 16- or 32-byte store.
__device__ __forceinline__ void store_u8(unsigned char* dst, const bool* v) {
  *reinterpret_cast<uchar4*>(dst) = make_uchar4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_i32(int* dst, const int* v) {
  *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_i64(long long* dst, const long long* v) {
  reinterpret_cast<longlong2*>(dst)[0] = make_longlong2(v[0], v[1]);
  reinterpret_cast<longlong2*>(dst)[1] = make_longlong2(v[2], v[3]);
}

// VEC = 4 consecutive values of a row: one 16- or 4-byte load (__ldcg:
// past L1, for values other threads of the block wrote).
template <bool kCg = false>
__device__ __forceinline__ void load_i32(const int* src, int* v) {
  const int4 x = kCg ? __ldcg(reinterpret_cast<const int4*>(src)) : *reinterpret_cast<const int4*>(src);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load_u8(const unsigned char* src, bool* v) {
  const uchar4 x = *reinterpret_cast<const uchar4*>(src);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

// A node's label value for a key, as the value of its domain: node-major
// rows (dom_ids [K, N]) where node_labels is node-minor.
__device__ __forceinline__ int domain_value(const int* dom_vals, const int* dom_off, int key, int d) {
  return d >= 0 ? dom_vals[dom_off[key] + d] : ABSENT;
}

// ---------------------------------------------------------------------------
// Selector tiles against the placed pods (K6's constraints, K7's own terms)
// ---------------------------------------------------------------------------

// S selector rows, each with a namespace filter: with ns_all, the
// namespace set ns_ids [S, NS] (ops/common.py ns_member); without, the one
// namespace ns_ids[s / ns_div], matched exactly.
struct MatchView {
  CTable tab;
  const int* ns_ids;
  const unsigned char* ns_all;
  int NS, ns_div, S;
  bool skip_deleting;
};

// Do selectors a and b select the same placed pods: equal term-valid
// flags, requirement rows and namespace filters.
__device__ __forceinline__ bool same_selector(const MatchView& v, int a, int b) {
  const CTable& t = v.tab;
  if ((t.tv[a] != 0) != (t.tv[b] != 0)) return false;
  const long long ra = (long long)a * t.R, rb = (long long)b * t.R;
  for (int r = 0; r < t.R; ++r)
    if (t.key[ra + r] != t.key[rb + r] || t.op[ra + r] != t.op[rb + r] || t.rhs[ra + r] != t.rhs[rb + r])
      return false;
  for (int i = 0; i < t.R * t.V; ++i)
    if (t.vals[ra * t.V + i] != t.vals[rb * t.V + i]) return false;
  if (v.ns_all == nullptr) return v.ns_ids[a / v.ns_div] == v.ns_ids[b / v.ns_div];
  if ((v.ns_all[a] != 0) != (v.ns_all[b] != 0)) return false;
  for (int i = 0; i < v.NS; ++i)
    if (v.ns_ids[(long long)a * v.NS + i] != v.ns_ids[(long long)b * v.NS + i]) return false;
  return true;
}

// One warp per selector s: rep[s], the first selector equal to it (s
// itself when none comes before).  The match kernel evaluates only the
// representatives, the domain kernels read their representative's bits
// (config4's 512 constraints are 20 selectors).
__device__ __forceinline__ void classify(const MatchView& v, int* rep) {
  const int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s < v.S) {
    int found = s;
    for (int base = 0; base < s; base += 32) {
      const int s2 = base + lane;
      const unsigned eq = __ballot_sync(FULL, s2 < s && same_selector(v, s2, s));
      if (eq != 0u) {
        found = base + __ffs(eq) - 1;
        break;
      }
    }
    if (lane == 0) rep[s] = found;
  }
}

// Shared ints of a tile of `st` selectors: key, op, rhs [st, R], vals
// [st, R, V], namespaces [st, NS or 1], flags [st].
__host__ __device__ __forceinline__ int match_smem_ints(int st, int R, int V, int NS) {
  return st * (3 * R + R * V + NS + 1);
}

// Block (blockIdx.x, blockIdx.y): the representatives among selectors
// [y * st, y * st + st) (every selector when rep is null) against placed
// pods [x * 256, x * 256 + 256).  Tile-major, so that the blocks of the
// low tiles, where the representatives gather, are dispatched first.  Bit
// e of bits[s * EW + e / 32] says placed pod e matches representative s.
// Returns false (nothing to do) when the tile holds no representative.
__device__ __forceinline__ bool match_tile(const MatchView& v, const int* rep, const int* epod_labels,
                                           const int* epod_ns, const unsigned char* epod_valid,
                                           const unsigned char* epod_deleting, int E, int K, const int* val_ints,
                                           int NVI, unsigned* bits, int EW, int st) {
  extern __shared__ int smem[];
  const int R = v.tab.R, V = v.tab.V, NSs = v.ns_all != nullptr ? v.NS : 1;
  const int s0 = blockIdx.y * st;
  const int rows = min(st, v.S - s0);
  const bool own = (int)threadIdx.x < rows && (rep == nullptr || rep[s0 + threadIdx.x] == s0 + (int)threadIdx.x);
  if (!__syncthreads_or(own)) return false;
  int* s_key = smem;
  int* s_op = s_key + st * R;
  int* s_rhs = s_op + st * R;
  int* s_vals = s_rhs + st * R;
  int* s_ns = s_vals + st * R * V;
  int* s_flags = s_ns + st * NSs;  // bit 0: term valid, bit 1: all namespaces, bit 2: representative
  for (int i = threadIdx.x; i < rows * R; i += blockDim.x) {
    const long long g = (long long)s0 * R + i;
    s_key[i] = v.tab.key[g];
    s_op[i] = v.tab.op[g];
    s_rhs[i] = v.tab.rhs[g];
  }
  for (int i = threadIdx.x; i < rows * R * V; i += blockDim.x) s_vals[i] = v.tab.vals[(long long)s0 * R * V + i];
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const int s = s0 + i;
    s_flags[i] = (v.tab.tv[s] ? 1 : 0) | (v.ns_all != nullptr && v.ns_all[s] ? 2 : 0) |
                 (rep == nullptr || rep[s] == s ? 4 : 0);
    if (v.ns_all == nullptr) s_ns[i] = v.ns_ids[s / v.ns_div];
  }
  if (v.ns_all != nullptr)
    for (int i = threadIdx.x; i < rows * NSs; i += blockDim.x) s_ns[i] = v.ns_ids[(long long)s0 * NSs + i];
  __syncthreads();

  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = false;
  int ens = 0;
  if (e < E) {
    live = epod_valid[e] && !(v.skip_deleting && epod_deleting[e]);
    ens = epod_ns[e];
  }
  const int* lab = epod_labels + (long long)min(e, E - 1) * K;  // the pod's row, read once for the tile
  const int w = (int)((blockIdx.x * blockDim.x) >> 5) + (threadIdx.x >> 5);
  for (int i = 0; i < rows; ++i) {
    const int f = s_flags[i];
    if (!(f & 4)) continue;  // its representative's bits stand for it
    bool m = live && (f & 1);
    if (m) m = v.ns_all != nullptr ? ns_member(f & 2, s_ns + i * NSs, NSs, ens) : ens == s_ns[i];
    if (m) m = eval_term(s_key + i * R, s_op + i * R, s_vals + i * R * V, s_rhs + i * R, R, V, lab, K, val_ints, NVI);
    const unsigned word = __ballot_sync(FULL, m);
    if ((threadIdx.x & 31) == 0 && w < EW) bits[(long long)(s0 + i) * EW + w] = word;
  }
  return true;
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

__device__ __forceinline__ MatchView spread_view(const GangSpreadArgs& a) {
  return MatchView{{a.tsc_key, a.tsc_op, a.tsc_vals, a.tsc_rhs, a.tsc_tv, a.R, a.V}, a.ns_id, nullptr, 1, a.C,
                   a.P * a.C, true};
}

__global__ void __launch_bounds__(STAT_THREADS) spread_class_kernel(const GangSpreadArgs a, unsigned long long* span) {
  span_begin(span);
  classify(spread_view(a), a.rep);
  span_close(span);
}

__global__ void __launch_bounds__(MATCH_THREADS) spread_match_kernel(const GangSpreadArgs a, const int* rep, int st,
                                                                     unsigned long long* span) {
  span_begin(span);
  match_tile(spread_view(a), rep, a.epod_labels, a.epod_ns, a.epod_valid, a.epod_deleting, a.E, a.K, a.val_ints,
             a.NVI, a.match, a.EW, st);
  span_close(span);
}

// Fold one node's count into its domain cell (-1: none in this tile).  A
// key of few domains (`aggregate`: zones) sums the warp's lanes that share
// a cell first, so that its nodes do not serialise on a handful of shared
// addresses; every lane of the warp calls it then.  Past AGG_DOMAINS the
// lanes' cells rarely coincide and each lane adds its own.
constexpr int AGG_DOMAINS = 64;

__device__ __forceinline__ void fold_domain(bool aggregate, int cell, bool te, bool counting, int cnt, int* te_tot,
                                            int* sc_tot, unsigned* te_pres) {
  if (!aggregate) {
    if (cell >= 0) {
      if (te) {
        if (cnt) atomicAdd(te_tot + cell, cnt);
        atomicOr(te_pres + (cell >> 5), 1u << (cell & 31));
      }
      if (counting && cnt) atomicAdd(sc_tot + cell, cnt);
    }
    return;
  }
  const unsigned grp = __match_any_sync(FULL, cell);
  const int s_te = __reduce_add_sync(grp, cell >= 0 && te ? cnt : 0);
  const int s_sc = __reduce_add_sync(grp, cell >= 0 && counting ? cnt : 0);
  const bool any_te = (__ballot_sync(FULL, cell >= 0 && te) & grp) != 0u;
  if (cell >= 0 && (int)(threadIdx.x & 31) == __ffs(grp) - 1) {
    if (s_te) atomicAdd(te_tot + cell, s_te);
    if (any_te) atomicOr(te_pres + (cell >> 5), 1u << (cell & 31));
    if (s_sc) atomicAdd(sc_tot + cell, s_sc);
  }
}

// One block per (pod, constraint); dynamic shared memory of `ints` ints:
// first the node counts of nodes [c0, c0 + chunk) (chunks of `ints`, one
// for all nodes while they fit), then te_tot [T], sc_tot [T], te_pres bits
// [T / 32] for domains [lo, lo + T) in the same memory.  Every row the node
// passes read is node-major (dom_ids, the [P, N] masks, the count row), VEC
// nodes a thread (N % VEC == 0: a group is in the row whole or not at all).
__global__ void __launch_bounds__(STAT_THREADS) spread_domain_kernel(const GangSpreadArgs a, const int* rep, int T,
                                                                     int ints, unsigned long long* span) {
  extern __shared__ int smem[];
  __shared__ int s_red[32];
  span_begin(span);
  const int pc = blockIdx.x;  // p * C + c
  const int p = pc / a.C;
  const int c = pc % a.C;
  const int N = a.N, K = a.K, C = a.C;
  const int key = a.tsc_topo[pc];
  const bool kvalid = key >= 0 && key < K;
  const int D = kvalid ? a.dom_size[key] : 0;
  const int* dom = kvalid ? a.dom_ids + (long long)key * N : nullptr;
  int* te_tot = smem;
  int* sc_tot = te_tot + T;
  unsigned* te_pres = reinterpret_cast<unsigned*>(sc_tot + T);
  int* node_cnt = a.sp_node_cnt + (long long)pc * N;
  const long long o0 = (long long)pc * N;
  const long long p0 = (long long)p * N;

  // 1. the placed pods matching the constraint, counted per node in shared
  //    memory, and the count row written out
  const unsigned* bits = a.match + (long long)(rep != nullptr ? rep[pc] : pc) * a.EW;
  const int chunk = ints / 4 * 4;
  for (int c0 = 0; c0 < N; c0 += chunk) {
    const int cn = min(chunk, N - c0);
    for (int i = threadIdx.x; i < cn; i += blockDim.x) smem[i] = 0;
    __syncthreads();
    for (int w = threadIdx.x; w < a.EW; w += blockDim.x) {
      for (unsigned word = bits[w]; word != 0u; word &= word - 1u) {
        const int node = a.epod_node[w * 32 + __ffs(word) - 1] - c0;
        if (node >= 0 && node < cn) atomicAdd(smem + node, 1);
      }
    }
    __syncthreads();
    for (int nb = threadIdx.x * VEC; nb < cn; nb += blockDim.x * VEC) {  // c0 and N: multiples of VEC
      int v[VEC];
      load_i32(smem + nb, v);
      store_i32(node_cnt + c0 + nb, v);
    }
    __syncthreads();
  }

  // 2. per-node eligibility folded into the per-domain sums, then each
  //    node's domain read back, one domain tile at a time
  const bool honor_aff = a.honor_aff[pc], honor_taints = a.honor_taints[pc];
  const bool spread_key = kvalid && key != a.hostname_key;
  const bool single = D <= T;
  const bool aggregate = D <= AGG_DOMAINS;
  int present = 0;
  for (int lo = 0; lo == 0 || lo < D; lo += T) {
    const int cells = min(T, D - lo), words = (cells + 31) / 32;  // the tile's cells of this key
    for (int i = threadIdx.x; i < cells; i += blockDim.x) te_tot[i] = sc_tot[i] = 0;
    for (int i = threadIdx.x; i < words; i += blockDim.x) te_pres[i] = 0u;
    __syncthreads();
    for (int base = 0; base < N; base += blockDim.x * VEC) {  // every lane folds: a uniform trip count
      const int nb = base + threadIdx.x * VEC;
      const bool in_row = nb < N;  // N % VEC == 0: the whole group or none
      bool te[VEC], counting[VEC], all_keys[VEC], tracked[VEC], aff[VEC], tnt[VEC];
      int d[VEC], dv[VEC], cdv[VEC], cell[VEC], cnt[VEC], pres[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        d[j] = -1;
        cnt[j] = 0;
        tracked[j] = all_keys[j] = aff[j] = tnt[j] = true;
      }
      if (in_row) {
        if (kvalid) {
          load_i32(dom + nb, d);
          load_i32<true>(node_cnt + nb, cnt);  // other threads' stores, past the barrier
        }
        for (int c2 = 0; c2 < C; ++c2) {
          const int k2 = a.tsc_topo[p * C + c2];
          if (k2 == PAD) continue;  // no constraint in this slot
          const bool hard = a.tsc_hard[p * C + c2];
          if (k2 >= 0 && k2 < K) load_i32(a.dom_ids + (long long)k2 * N + nb, pres);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const bool has = k2 >= 0 && k2 < K && pres[j] >= 0;  // the node carries the key
            if (hard) tracked[j] = tracked[j] && has;
            else all_keys[j] = all_keys[j] && has;
          }
        }
        if (honor_aff) load_u8(a.naff + p0 + nb, aff);
        if (honor_taints) load_u8(a.taints + p0 + nb, tnt);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool eligible = aff[j] && tnt[j];
        te[j] = in_row && tracked[j] && eligible;
        counting[j] = in_row && all_keys[j] && eligible;
        dv[j] = kvalid ? domain_value(a.dom_vals, a.dom_off, key, d[j]) : ABSENT;
        cdv[j] = spread_key ? d[j] : -1;
        cell[j] = d[j] >= lo && d[j] < lo + T ? d[j] - lo : -1;
      }
      if (lo == 0 && in_row) {
        store_i32(a.sp_dv + o0 + nb, dv);
        store_u8(a.sp_te + o0 + nb, te);
        store_u8(a.sp_counting + o0 + nb, counting);
        store_i32(a.sp_cdv + o0 + nb, cdv);
        if (c == 0) store_u8(a.sp_all_keys + p0 + nb, all_keys);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        fold_domain(aggregate, cell[j], te[j], counting[j], cnt[j], te_tot, sc_tot, te_pres);
    }
    __syncthreads();
    int pres_words = 0;
    for (int i = threadIdx.x; i < words; i += blockDim.x) pres_words += __popc(te_pres[i]);
    present += block_sum(pres_words, s_red);
    for (int nb = threadIdx.x * VEC; nb < N; nb += blockDim.x * VEC) {
      bool pres_d[VEC], mine[VEC];
      int d[VEC], dcnt[VEC], sc[VEC];
      if (kvalid) load_i32(dom + nb, d);
      else
        for (int j = 0; j < VEC; ++j) d[j] = -1;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool in = d[j] >= lo && d[j] < lo + T;
        mine[j] = in || (lo == 0 && d[j] < 0);
        pres_d[j] = in && ((te_pres[(d[j] - lo) >> 5] >> ((d[j] - lo) & 31)) & 1u);
        dcnt[j] = pres_d[j] ? te_tot[d[j] - lo] : 0;
        sc[j] = in ? sc_tot[d[j] - lo] : 0;
      }
      if (single) {
        store_u8(a.sp_dom_pres + o0 + nb, pres_d);
        store_i32(a.sp_dom_cnt + o0 + nb, dcnt);
        store_i32(a.sp_sc_dom + o0 + nb, sc);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          if (!mine[j]) continue;
          a.sp_dom_pres[o0 + nb + j] = pres_d[j];
          a.sp_dom_cnt[o0 + nb + j] = dcnt[j];
          a.sp_sc_dom[o0 + nb + j] = sc[j];
        }
      }
    }
    __syncthreads();
  }
  const CTable tab{a.tsc_key, a.tsc_op, a.tsc_vals, a.tsc_rhs, a.tsc_tv, a.R, a.V};
  if (threadIdx.x == 0) {
    a.sp_ndom[pc] = present;
    a.sp_self[pc] = eval_row(tab, pc, a.labels + (long long)p * K, K, a.val_ints, a.NVI);
  }
  const int ns = a.ns_id[p];
  for (int j = threadIdx.x; j < a.P; j += blockDim.x)
    a.sp_bmatch[(long long)pc * a.P + j] =
        a.valid[j] && a.ns_id[j] == ns &&
        eval_row(tab, pc, a.labels + (long long)j * K, K, a.val_ints, a.NVI);
  span_close(span);
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

// interpod_symmetric_score's per-kind weight of a placed term (scoring.go)
__device__ __forceinline__ int sym_weight(int kind, int weight, int hard) {
  if (kind == TERM_REQUIRED_AFFINITY) return hard;
  if (kind == TERM_PREFERRED_AFFINITY) return weight;
  if (kind == TERM_PREFERRED_ANTI) return -weight;
  return 0;
}

// One thread per placed term: its pod-independent record.
__global__ void __launch_bounds__(STAT_THREADS) ext_terms_kernel(const GangInterpodArgs a, unsigned long long* span) {
  span_begin(span);
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < a.M) {
    int4 t = make_int4(-1, 0, 0, 0);
    const int kind = a.term_kind[m];
    const int anti = kind == TERM_REQUIRED_ANTI ? 1 : 0;
    const int w = sym_weight(kind, a.term_weight[m], a.hard_weight);
    const int tp = a.term_pod[m];
    const int key = a.term_topo[m];
    if ((anti || w) && tp >= 0 && a.E > 0 && a.N > 0 && key >= 0 && key < a.K) {
      const int e = min(tp, a.E - 1);
      const int node = a.epod_node[e];
      if (a.epod_valid[e] && node >= 0) {
        const int d = a.dom_ids[(long long)key * a.N + min(node, a.N - 1)];
        if (d >= 0) {  // else the term's pod's node lacks the topology label
          t = make_int4(key, d, w, anti);
          a.key_used[key] = 1;
        }
      }
    }
    reinterpret_cast<int4*>(a.ext_term)[m] = t;
  }
  span_close(span);
}

// One block per pod: the placed terms against the pod.  Dynamic shared
// memory: per key its cells' offset (-1: unused), the used keys, (used
// keys, cells), the pod's labels, then the symmetric sums [T] and the anti
// bits [T / 32] of cells [lo, lo + T).  EXT_THREADS threads: the term pass
// is a chain of dependent loads per term, so more threads a pod shorten it.
__global__ void __launch_bounds__(EXT_THREADS) ext_kernel(const GangInterpodArgs a, int T, unsigned long long* span) {
  extern __shared__ int smem[];
  span_begin(span);
  const int p = blockIdx.x;
  const int N = a.N, K = a.K;
  int* s_off = smem;
  int* s_keys = s_off + K;
  int* s_hdr = s_keys + K;
  int* s_plab = s_hdr + 2;
  int* s_sym = s_plab + K;
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_sym + T);
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_plab[k] = a.labels[(long long)p * K + k];
  if (threadIdx.x < 32) {  // the used keys' cells, laid out one after the other
    const int lane = threadIdx.x;
    int run = 0, nk = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const int size = k < K ? a.dom_off[k + 1] - a.dom_off[k] : 0;
      const bool used = k < K && a.key_used[k] && size > 0;
      const int sz = used ? size : 0;
      int incl = sz;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += y;
      }
      const unsigned ball = __ballot_sync(FULL, used);
      if (k < K) s_off[k] = used ? run + incl - sz : -1;
      if (used) s_keys[nk + __popc(ball & ((1u << lane) - 1u))] = k;
      nk += __popc(ball);
      run += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) {
      s_hdr[0] = nk;
      s_hdr[1] = run;
    }
  }
  __syncthreads();
  const int nk = s_hdr[0], cells = s_hdr[1];
  const int ns = a.ns_id[p];
  const CTable tab{a.tt_key, a.tt_op, a.tt_vals, a.tt_rhs, a.tt_tv, a.TR, a.TV};
  const int4* terms = reinterpret_cast<const int4*>(a.ext_term);
  const bool single = cells <= T;
  for (int lo = 0; lo == 0 || lo < cells; lo += T) {
    const int used = min(T, cells - lo);  // the used keys' cells in this tile
    for (int i = threadIdx.x; i < used; i += blockDim.x) s_sym[i] = 0;
    for (int i = threadIdx.x; i < (used + 31) / 32; i += blockDim.x) s_bits[i] = 0u;
    __syncthreads();
    for (int m = threadIdx.x; m < a.M; m += blockDim.x) {
      const int4 t = terms[m];
      if (t.x < 0) continue;
      const int cell = s_off[t.x] + t.y - lo;
      if (cell < 0 || cell >= T) continue;
      if (!ns_member(a.term_ns_all[m], a.term_ns_ids + (long long)m * a.TNS, a.TNS, ns)) continue;
      if (!eval_row(tab, m, s_plab, K, a.val_ints, a.NVI)) continue;
      if (t.z) atomicAdd(s_sym + cell, t.z);
      if (t.w) atomicOr(s_bits + (cell >> 5), 1u << (cell & 31));
    }
    __syncthreads();
    for (int nb = threadIdx.x * VEC; nb < N; nb += blockDim.x * VEC) {  // N % VEC == 0
      bool viol[VEC];
      unsigned sym[VEC];  // int32 sums, wrapping as the reference's dot
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        viol[j] = false;
        sym[j] = 0u;
      }
      for (int i = 0; i < nk; ++i) {
        const int k = s_keys[i];
        int d[VEC];
        load_i32(a.dom_ids + (long long)k * N + nb, d);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const int cell = d[j] < 0 ? -1 : s_off[k] + d[j] - lo;
          if (cell < 0 || cell >= T) continue;
          sym[j] += (unsigned)s_sym[cell];
          viol[j] = viol[j] || ((s_bits[cell >> 5] >> (cell & 31)) & 1u);
        }
      }
      const long long pn = (long long)p * N + nb;
      if (single) {
        long long s64[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) s64[j] = (long long)(int)sym[j];
        store_u8(a.ip_viol_existing + pn, viol);
        store_i64(a.ip_sym + pn, s64);
      } else {  // this thread's own nodes: carried across the tiles in the outputs
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const unsigned prev = lo == 0 ? 0u : (unsigned)(int)a.ip_sym[pn + j];
          a.ip_sym[pn + j] = (long long)(int)(prev + sym[j]);
          a.ip_viol_existing[pn + j] = (lo != 0 && a.ip_viol_existing[pn + j]) || viol[j];
        }
      }
    }
    __syncthreads();
  }
  span_close(span);
}

__device__ __forceinline__ MatchView inc_view(const GangInterpodArgs& a) {
  return MatchView{{a.aff_key, a.aff_op, a.aff_vals, a.aff_rhs, a.aff_tv, a.AR, a.AV}, a.aff_ns_ids, a.aff_ns_all,
                   a.NS, 1, a.P * a.AT, false};
}

__global__ void __launch_bounds__(STAT_THREADS) inc_class_kernel(const GangInterpodArgs a, unsigned long long* span) {
  span_begin(span);
  classify(inc_view(a), a.inc_rep);
  span_close(span);
}

__global__ void __launch_bounds__(MATCH_THREADS) inc_match_kernel(const GangInterpodArgs a, const int* rep, int st,
                                                                  unsigned long long* span) {
  span_begin(span);
  match_tile(inc_view(a), rep, a.epod_labels, a.epod_ns, a.epod_valid, nullptr, a.E, a.K, a.val_ints, a.NVI,
             a.inc_match, a.EW, st);
  span_close(span);
}

// One block per (pod, term): the matching placed pods per domain.
// Dynamic shared memory: the cells [T] of domains [lo, lo + T).
__global__ void __launch_bounds__(STAT_THREADS) inc_domain_kernel(const GangInterpodArgs a, const int* rep, int T,
                                                                  unsigned long long* span) {
  extern __shared__ int cells[];
  __shared__ int s_any;
  span_begin(span);
  const int pu = blockIdx.x;  // p * AT + u
  const int p = pu / a.AT;
  const int N = a.N, K = a.K;
  const int key = a.aff_topo[pu];
  const bool kvalid = key >= 0 && key < K;
  const int D = kvalid ? a.dom_size[key] : 0;
  const int* dom = kvalid ? a.dom_ids + (long long)key * N : nullptr;
  const unsigned* bits = a.inc_match + (long long)(rep != nullptr ? rep[pu] : pu) * a.EW;
  const long long o0 = (long long)pu * N;
  const bool single = D <= T;
  if (threadIdx.x == 0) s_any = 0;
  for (int lo = 0; lo == 0 || lo < D; lo += T) {
    for (int i = threadIdx.x; i < min(T, D - lo); i += blockDim.x) cells[i] = 0;  // the tile's cells of this key
    __syncthreads();
    bool any = false;
    for (int w = threadIdx.x; w < a.EW; w += blockDim.x) {
      unsigned word = bits[w];
      any = any || word != 0u;
      if (!kvalid) continue;
      for (; word != 0u; word &= word - 1u) {
        const int node = a.epod_node[w * 32 + __ffs(word) - 1];
        if (node < 0 || node >= N) continue;
        const int d = dom[node];
        if (d >= lo && d < lo + T) atomicAdd(cells + d - lo, 1);
      }
    }
    if (lo == 0 && any) s_any = 1;
    __syncthreads();
    for (int nb = threadIdx.x * VEC; nb < N; nb += blockDim.x * VEC) {  // N % VEC == 0
      int d[VEC], dv[VEC], cnt[VEC];
      bool mine[VEC];
      if (kvalid) load_i32(dom + nb, d);
      else
        for (int j = 0; j < VEC; ++j) d[j] = -1;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const bool in = d[j] >= lo && d[j] < lo + T;
        mine[j] = in || (lo == 0 && d[j] < 0);
        cnt[j] = in ? cells[d[j] - lo] : 0;
        dv[j] = kvalid ? domain_value(a.dom_vals, a.dom_off, key, d[j]) : ABSENT;
      }
      if (lo == 0) store_i32(a.ip_dv + o0 + nb, dv);
      if (single) {
        store_i32(a.ip_dom_cnt + o0 + nb, cnt);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (mine[j]) a.ip_dom_cnt[o0 + nb + j] = cnt[j];
      }
    }
    __syncthreads();
  }
  const CTable tab{a.aff_key, a.aff_op, a.aff_vals, a.aff_rhs, a.aff_tv, a.AR, a.AV};
  const unsigned char ns_all = a.aff_ns_all[pu];
  const int* ns_ids = a.aff_ns_ids + (long long)pu * a.NS;
  if (threadIdx.x == 0) {
    a.inc_any[pu] = s_any;
    a.self_ok[pu] = ns_member(ns_all, ns_ids, a.NS, a.ns_id[p]) &&
                    eval_row(tab, pu, a.labels + (long long)p * K, K, a.val_ints, a.NVI);
  }
  for (int j = threadIdx.x; j < a.P; j += blockDim.x)
    a.ip_bmatch[(long long)pu * a.P + j] =
        a.valid[j] && ns_member(ns_all, ns_ids, a.NS, a.ns_id[j]) &&
        eval_row(tab, pu, a.labels + (long long)j * K, K, a.val_ints, a.NVI);
  span_close(span);
}

// Does any wanted port of `w` conflict with any used port of `u` (node_ports.go)
__device__ __forceinline__ bool ports_conflict(const int* wk, const int* wi,
                                               const unsigned char* ww, int W,
                                               const int* uk, const int* ui,
                                               const unsigned char* uw, int U) {
  for (int x = 0; x < W; ++x) {
    if (wk[x] == PAD) continue;
    for (int y = 0; y < U; ++y)
      if (uk[y] != PAD && wk[x] == uk[y] && (wi[x] == ui[y] || ww[x] || uw[y])) return true;
  }
  return false;
}

// One thread per (pod, node) and per (pod, peer).
__global__ void __launch_bounds__(PORT_THREADS) port_kernel(const GangInterpodArgs a, unsigned long long* span) {
  span_begin(span);
  const long long idx = (long long)blockIdx.x * PORT_THREADS + threadIdx.x;
  const long long pn = (long long)a.P * a.N;
  if (idx < pn) {
    const int p = (int)(idx / a.N), n = (int)(idx % a.N);
    const long long w0 = (long long)p * a.W, u0 = (long long)n * a.U;
    a.d_ports[idx] = !ports_conflict(a.want_ppk + w0, a.want_ip + w0, a.want_wild + w0, a.W,
                                     a.used_ppk + u0, a.used_ip + u0, a.used_wild + u0, a.U);
  } else if (idx < pn + (long long)a.P * a.P) {
    const long long k = idx - pn;
    const int p = (int)(k / a.P), j = (int)(k % a.P);
    const long long w0 = (long long)p * a.W, j0 = (long long)j * a.W;
    a.port_b[k] = ports_conflict(a.want_ppk + w0, a.want_ip + w0, a.want_wild + w0, a.W,
                                 a.want_ppk + j0, a.want_ip + j0, a.want_wild + j0, a.W);
  }
  span_close(span);
}

// ---------------------------------------------------------------------------
// Launch planning
// ---------------------------------------------------------------------------

// The dynamic shared memory `kernel` may take: min(smem_cap, the card's
// opt-in limit less its static shared memory).  The limit is asked for once
// per (kernel, device), and the kernel's MaxDynamicSharedMemorySize set to
// it then, so that a drain's many launches make no attribute call.
template <typename Kern>
cudaError_t smem_budget(Kern kernel, int smem_cap, long long* budget) {
  struct Limit {
    const void* kernel;
    int dev;
    long long bytes;
  };
  static std::mutex mu;
  static std::vector<Limit> seen;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* k = reinterpret_cast<const void*>(kernel);
  long long limit = -1;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Limit& l : seen)
      if (l.kernel == k && l.dev == dev) limit = l.bytes;
  }
  if (limit < 0) {
    int optin = 0;
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    limit = (long long)optin - (long long)fa.sharedSizeBytes;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)limit);
    if (e != cudaSuccess) return e;
    std::lock_guard<std::mutex> lock(mu);
    seen.push_back({k, dev, limit});
  }
  *budget = smem_cap < limit ? smem_cap : limit;
  return cudaSuccess;
}

// Cells a tile holds: `need` rounded up to whole 32-cell words, at most
// what `ints` shared ints hold at `per32` ints per 32 cells, at least one
// word.
int tile_cells(long long need, long long ints, long long per32) {
  const long long want = (need + 31) / 32 * 32;
  const long long fit = ints > 0 ? ints / per32 * 32 : 0;
  const long long t = want < fit ? want : fit;
  return (int)(t < 32 ? 32 : t);
}

// Past 48 KB of dynamic shared memory a kernel's attribute must allow it:
// smem_budget set it to the budget's limit for the kernels that go there.
template <typename Kern, typename... Args>
cudaError_t launch(Kern kernel, dim3 grid, int threads, size_t smem, cudaStream_t st, Args... args) {
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// A warp per selector.
unsigned class_blocks(int S) { return (unsigned)((S + STAT_THREADS / 32 - 1) / (STAT_THREADS / 32)); }

// Selectors a block of the match kernel stages: 8 where the placed pods
// fill 64 blocks or more, else 4 (a block evaluates its selectors one after
// the other, so a smaller tile shortens it but adds blocks), halved while
// the tile would outgrow 16 KB of shared memory.
int sel_tile(int E, int R, int V, int NS) {
  int st = (E + MATCH_THREADS - 1) / MATCH_THREADS >= 64 ? 8 : 4;
  while (st > 1 && (long long)sizeof(int) * match_smem_ints(st, R, V, NS) > 16 * 1024) st /= 2;
  return st;
}

dim3 match_grid(int S, int st, int E) {
  return dim3((unsigned)((E + MATCH_THREADS - 1) / MATCH_THREADS), (unsigned)((S + st - 1) / st));
}

// The span table zeroed on `st`, or cudaErrorInvalidValue where the
// wrapper sized it for another number of rows.
cudaError_t span_reset(unsigned long long* span, int rows, int kernels, cudaStream_t st) {
  if (rows != kernels * SPAN_SMS) return cudaErrorInvalidValue;
  return cudaMemsetAsync(span, 0, sizeof(unsigned long long) * 2 * (size_t)rows, st);
}

// Whether the match first collapses the S selectors to their classes: where
// the E placed pods number at least class_ratio times them (the classes
// kernel compares each selector with every earlier one, S^2 / 2 compares
// against the S x E evaluations they save).
bool use_classes(long long S, int E, int class_ratio) { return E > 0 && S > 0 && E >= (long long)class_ratio * S; }

}  // namespace

// Enqueue K6 on `stream`: the classes and match kernels (when there are
// placed pods), then the domain kernel.  Returns the first failing
// launch's status.
extern "C" int ktpu_gang_spread_statics(const GangSpreadArgs* args, void* stream) {
  const GangSpreadArgs a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* span = a.span;
  cudaError_t e = span_reset(span, a.span_rows, SP_KERNELS, st);
  if (e != cudaSuccess || (long long)a.P * a.C == 0) return (int)e;
  const int* rep = use_classes((long long)a.P * a.C, a.E, a.class_ratio) ? a.rep : nullptr;
  if (rep != nullptr) {
    e = launch(spread_class_kernel, dim3(class_blocks(a.P * a.C)), STAT_THREADS, 0, st, a,
               span + 2 * SPAN_SMS * SP_CLASSES);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.E > 0) {
    const int tile = sel_tile(a.E, a.R, a.V, 1);
    e = launch(spread_match_kernel, match_grid(a.P * a.C, tile, a.E), MATCH_THREADS,
               sizeof(int) * match_smem_ints(tile, a.R, a.V, 1), st, a, rep, tile, span + 2 * SPAN_SMS * SP_MATCH);
    if (e != cudaSuccess) return (int)e;
  }
  long long budget = 0;
  e = smem_budget(spread_domain_kernel, a.smem_cap, &budget);
  if (e != cudaSuccess) return (int)e;
  const long long avail = budget / (long long)sizeof(int);
  const int T = tile_cells(a.D, avail, 65);  // te_tot, sc_tot and a bit each
  // the node counts share the memory: all nodes where they fit, else chunks
  const long long cells = 2LL * T + T / 32, n4 = (a.N + 3LL) / 4 * 4;
  const int ints = (int)std::max(cells, std::min(n4, avail));
  e = launch(spread_domain_kernel, dim3((unsigned)(a.P * a.C)), STAT_THREADS, sizeof(int) * (size_t)ints, st, a, rep,
             T, ints, span + 2 * SPAN_SMS * SP_DOMAIN);
  return (int)e;
}

// Enqueue K7 on `stream`: with do_interpod the terms kernel (when there are
// placed terms) and ext, then (AT > 0) the classes and match kernels over
// the pods' terms (when there are placed pods) and the domain kernel; with
// do_ports the port kernel.  Returns the first failing launch's status.
extern "C" int ktpu_gang_interpod_statics(const GangInterpodArgs* args, void* stream) {
  const GangInterpodArgs a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* span = a.span;
  cudaError_t e = span_reset(span, a.span_rows, IP_KERNELS, st);
  if (e != cudaSuccess) return (int)e;
  if (a.do_interpod && a.P > 0) {
    if (a.K > 0) {
      e = cudaMemsetAsync(a.key_used, 0, sizeof(int) * (size_t)a.K, st);
      if (e != cudaSuccess) return (int)e;
    }
    if (a.M > 0) {
      const unsigned blocks = (unsigned)((a.M + STAT_THREADS - 1) / STAT_THREADS);
      e = launch(ext_terms_kernel, dim3(blocks), STAT_THREADS, 0, st, a, span + 2 * SPAN_SMS * IP_TERMS);
      if (e != cudaSuccess) return (int)e;
    }
    long long budget = 0;
    e = smem_budget(ext_kernel, a.smem_cap, &budget);
    if (e != cudaSuccess) return (int)e;
    const long long head = 3LL * a.K + 2;
    const int T = tile_cells(a.DSUM, budget / (long long)sizeof(int) - head, 33);  // a sum and a bit each
    e = launch(ext_kernel, dim3((unsigned)a.P), EXT_THREADS, sizeof(int) * (size_t)(head + T + T / 32), st, a, T,
               span + 2 * SPAN_SMS * IP_EXT);
    if (e != cudaSuccess) return (int)e;
    if (a.AT > 0) {
      const int* rep = use_classes((long long)a.P * a.AT, a.E, a.class_ratio) ? a.inc_rep : nullptr;
      if (rep != nullptr) {
        e = launch(inc_class_kernel, dim3(class_blocks(a.P * a.AT)), STAT_THREADS, 0, st, a,
                   span + 2 * SPAN_SMS * IP_INC_CLASSES);
        if (e != cudaSuccess) return (int)e;
      }
      if (a.E > 0) {
        const int tile = sel_tile(a.E, a.AR, a.AV, a.NS);
        e = launch(inc_match_kernel, match_grid(a.P * a.AT, tile, a.E), MATCH_THREADS,
                   sizeof(int) * match_smem_ints(tile, a.AR, a.AV, a.NS), st, a, rep, tile,
                   span + 2 * SPAN_SMS * IP_INC_MATCH);
        if (e != cudaSuccess) return (int)e;
      }
      e = smem_budget(inc_domain_kernel, a.smem_cap, &budget);
      if (e != cudaSuccess) return (int)e;
      const int Ti = tile_cells(a.D, budget / (long long)sizeof(int), 32);
      e = launch(inc_domain_kernel, dim3((unsigned)(a.P * a.AT)), STAT_THREADS, sizeof(int) * (size_t)Ti, st, a, rep,
                 Ti, span + 2 * SPAN_SMS * IP_INC_DOMAIN);
      if (e != cudaSuccess) return (int)e;
    }
  }
  if (a.do_ports) {
    const long long work = (long long)a.P * a.N + (long long)a.P * a.P;
    if (work > 0) {
      const unsigned blocks = (unsigned)((work + PORT_THREADS - 1) / PORT_THREADS);
      e = launch(port_kernel, dim3(blocks), PORT_THREADS, 0, st, a, span + 2 * SPAN_SMS * IP_PORTS);
      if (e != cudaSuccess) return (int)e;
    }
  }
  return 0;
}
