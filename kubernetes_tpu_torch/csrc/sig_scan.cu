// K2: the signature fast path's serial greedy commit, one call per batch.
//
// Replaces the JAX root kubernetes_tpu/ops/fastpath.py:220 sig_scan (a
// lax.scan of make_sig_step, :117): for each pod of the batch in order —
// resource fit against the carried usage, int64 LeastAllocated +
// BalancedAllocation + ImageLocality score, first-max argmax over the
// feasible nodes, rank-1 commit of the pod's request to the chosen node.
//
// Design: an incremental argmax.  A node's key for signature s (its score
// where the node is statics-feasible and fits, -1 otherwise) depends only on
// the node's own row (alloc, used, nz0, nz1, num_pods, allowed) and on
// sig_ok[s, n] / sig_img[s, n]; a commit changes only the chosen node's row.
// So between two pods only one column of the [S, N] key matrix changes, and
// a step re-keys one node per signature instead of all N:
//   * sig_mark (one block) flags the signatures that occur in the batch;
//   * sig_build (a grid of (signature, 1,024 nodes) blocks) keys every
//     (present signature, node) pair, its leaves, and reduces each 32-node
//     group to its first max (key, lowest node): the tree's level 1;
//   * sig_scan (one persistent block) reduces each tree's level 1 to its
//     root, then per pod reads the root of its signature's tree (the first
//     max, ties to the lower node, -1 when nothing fits), commits the
//     request to the chosen node c, re-keys c in every present tree and
//     repairs it: c's group entry and the root each keep their place unless
//     the new key beats them or their node lay in c's group; a warp
//     re-reduces c's 32 leaves, or the root over every group, only then.
// The scan is one block of 16 warps.  Tree t lives with one warp lane
// (warp t % 16, lane t / 16), so its repairs need no atomics; with at most
// 16 trees a warp's lanes share its tree's key (key_warp: the fit's lanes,
// then the LeastAllocated and BalancedAllocation quotients as one divide on
// three lanes), with more they key one tree a lane.  The leaves stay in
// global memory (L2); the signatures' request rows and the roots, then
// the groups too, sit in shared memory while they fit (all at S = 16 and N
// = 10,240, where the scan compiles to shared-memory accesses; the rows and
// roots at S = 512).  Every warp keeps its own copy of the chosen node's
// row in shared memory, updated by each commit; warp 0 writes a row back to
// the usage state once the scan has moved to another node (and at the
// end), so no thread reads a row from global memory while it is being
// written.  Each step also reads ahead the row, group leaves and column of
// the next pod's likely node (the root of its tree before this step's
// repairs: the next choice is that node or this one), so that a warp
// stalls on them only when the guess fails.  A placed pod costs one block
// barrier (none for a pad or an unplaced pod); warp argmaxes are two
// warp-wide reductions where the keys fit in 32 bits.
//
// Bound on the H100: the recurrence.  The bytes (signature rows, the
// cluster's rows, each read once) are a few MB; the integer work is ~40
// operations per key, one per (present signature, node) in the build and
// one per present signature per placed pod; but the P dependent steps each
// pay, on one SM, one warp's chain of dependent instructions: the key, the
// chosen tree's two re-reductions, the read-ahead's bookkeeping (SigScanArgs::
// info splits a step's cycles).
//
// The feasibility and score formulas are ktpu.cuh's fits / score_total,
// shared with K4 (resident_run); integer arithmetic is int64 throughout.
#include <algorithm>
#include <climits>

#include "ktpu.cuh"

using namespace ktpu;

namespace {

constexpr int SCAN_THREADS = 512;  // 16 warps: up to 128 registers a thread for the reads held across steps
constexpr int NW = SCAN_THREADS / 32;
constexpr int BUILD_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long NONE = LLONG_MIN;  // a child past the last node

// (ov, oi) beats (v, i): a larger key, then the lower node
__device__ __forceinline__ bool beats(long long ov, int oi, long long v, int i) {
  return ov > v || (ov == v && oi < i);
}

// every lane gets the warp's first max: two warp-wide reductions (one
// instruction each) where every key is at most INT_MAX (a key below
// INT_MIN, a child past the last node, counts as INT_MIN: it never holds
// the maximum unless every lane does), else five shuffle rounds
__device__ __forceinline__ void warp_argmax(long long& v, int& i) {
  if (__all_sync(FULL, v <= INT_MAX)) {
    const int m = __reduce_max_sync(FULL, (int)max(v, (long long)INT_MIN));
    i = __reduce_min_sync(FULL, max(v, (long long)INT_MIN) == m ? i : INT_MAX);
    v = m == INT_MIN ? NONE : m;
    return;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const long long ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// The signatures' request rows, each R + 3 wide: the request [R], its
// non-zero cpu and memory, and the all-zero flag (sig_mark writes them into
// SigScanArgs::sig_rows; the scan reads a copy in shared memory while it
// fits).
__device__ __forceinline__ long long sig_row(const SigScanArgs& a, int s, int j) {
  const int R = a.R;
  return j < R ? a.sig_req[(long long)s * R + j] : j < R + 2 ? a.sig_nz[2 * s + j - R] : a.sig_allzero[s];
}

// Signature s's key at a node with allocatable `al` and usage `us`, nz0 /
// nz1 / pods, from its request row `req` (sig_row's layout): -1 unless
// statics-feasible (`ok`) and, with check_fit, fitting; else the score
// (>= 0).
__device__ __forceinline__ long long key_at(const SigScanArgs& a, const long long* req, bool ok, long long img,
                                            const long long* al, const long long* us, long long nz0, long long nz1,
                                            int pods, int allowed) {
  if (!ok) return -1;
  const int R = a.R;
  if (a.check_fit && !fits(req, req[R + 2] != 0, al, us, nullptr, pods, allowed, R)) return -1;
  return score_total(al[LANE_CPU], al[LANE_MEM], nz0 + req[R], nz1 + req[R + 1], us[LANE_CPU] + req[LANE_CPU],
                     us[LANE_MEM] + req[LANE_MEM], a.w_img ? img : 0, a.w_fit, a.w_bal, a.w_img);
}

// n / d for n >= 0, d > 0 whose quotient is small (key_warp's are at most
// 100): a float estimate, within 0.03 of n / d below 2^16 (the two
// conversions round by at most 2^-24 relatively, __fdividef by 2 ulp),
// corrected by one in exact integer arithmetic; else the 64-bit divide (a
// long dependent instruction sequence: score_total's three of them are
// most of a key's latency on one warp).
__device__ __forceinline__ long long div_small(long long n, long long d) {
  const float qf = __fdividef((float)n, (float)d);
  if (qf < 65536.0f && (((unsigned long long)n >> 61) | ((unsigned long long)d >> 60)) == 0) {
    long long q = (long long)qf;
    if (q * d > n) --q;
    else if ((q + 1) * d <= n) ++q;
    return q;
  }
  return n / d;
}

// key_at by a whole warp for one tree (request row `req`, at the chosen
// node's post-commit row `row`, with its statics verdict `ok` and image
// score `img`): the fit's lanes on lanes of their own; then the two
// LeastAllocated terms and BalancedAllocation's quotient as one divide on
// lanes 0, 1 and 2 together (the same instructions on three lanes' data, so
// the three run at once, not one after another), combined by shuffles.
// Every lane gets the key.
__device__ __forceinline__ long long key_warp(const SigScanArgs& a, const long long* req, bool ok, long long img,
                                              const long long* row) {
  const int lane = threadIdx.x & 31, R = a.R;
  const long long* us = row;
  const long long* al = row + R + 3;
  bool fit = true;
  if (a.check_fit) {
    fit = pods_fit((int)row[R + 2], (int)row[2 * R + 3]);
    for (int r = lane; r < R; r += 32) fit = fit && lane_fits(req[R + 2] != 0, r, req[r], al[r] - us[r]);
    fit = __all_sync(FULL, fit);
  }
  if (!ok || !fit) return -1;
  const long long a0 = al[LANE_CPU], a1 = al[LANE_MEM];
  long long n = 0, d = 1;
  if (lane < 2)  // LeastAllocated's cpu (lane 0) and memory (lane 1) terms
    least_parts(lane ? a1 : a0, row[R + lane] + req[R + lane], n, d);
  else if (lane == 2)
    balanced_parts(a0, a1, us[LANE_CPU] + req[LANE_CPU], us[LANE_MEM] + req[LANE_MEM], n, d);
  const long long qv = div_small(n, d);
  const long long bal = MAX_NODE_SCORE - __shfl_sync(FULL, qv, 2);
  long long total = 0;
  if (a.w_fit) total += a.w_fit * least_mean(__shfl_sync(FULL, qv, 0) + __shfl_sync(FULL, qv, 1), a0, a1);
  if (a.w_bal) total += a.w_bal * bal;
  if (a.w_img) total += a.w_img * img;
  return total;
}

// The trees above the leaves: c's group, entry e (nodes [32 e, 32 e + 32))
// of tree s at [s n1 + e], and the roots at [s]; keys and nodes.  In the
// global arrays level-major (the S n1 groups, then the S roots), or copies
// in shared memory.
struct Trees {
  long long *v1, *vr;
  int *i1, *ir;
  int n1;
};

// Byte offsets of the scan's dynamic shared memory, each part 16-byte
// aligned: every warp's copy of the chosen node's row [NW][2 R + 4]
// (int64); then, by `parts`, (1) the signatures' request rows [S][R + 3]
// (int64), the tree list [S] and the roots [S] (keys, nodes), (2) the
// groups [S][n1] (keys, nodes).
struct ScanSmem {
  size_t sig, list, rv, ri, gv, gi, bytes;
};

__host__ __device__ inline ScanSmem scan_smem(int S, int R, int n1, int parts) {
  ScanSmem m{};
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o = (o + bytes + 15) / 16 * 16;
    return at;
  };
  take(8 * (size_t)NW * (2 * R + 4));
  if (parts >= 1) {
    m.sig = take(8 * (size_t)S * (R + 3));
    m.list = take(4 * (size_t)S);
    m.rv = take(8 * (size_t)S);
    m.ri = take(4 * (size_t)S);
  }
  if (parts >= 2) {
    m.gv = take(8 * (size_t)S * n1);
    m.gi = take(4 * (size_t)S * n1);
  }
  m.bytes = o;
  return m;
}

__global__ void __launch_bounds__(SCAN_THREADS) sig_mark_kernel(const SigScanArgs a) {
  const int W = a.R + 3;
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) a.present[s] = 0;
  for (long long j = threadIdx.x; j < (long long)a.S * W; j += blockDim.x)
    a.sig_rows[j] = sig_row(a, (int)(j / W), (int)(j % W));
  __syncthreads();
  for (int p = threadIdx.x; p < a.P; p += blockDim.x) {
    const int s = a.ids[p];
    if (s >= 0 && s < a.S) a.present[s] = 1;
  }
}

// Block (s, x): the leaves of nodes [1024 x, 1024 x + 1024) of tree s and
// their 32 groups (the global arrays).
__global__ void __launch_bounds__(BUILD_THREADS) sig_build_kernel(const SigScanArgs a) {
  const int s = blockIdx.x;
  if (!a.present[s]) return;
  const int n1 = (a.N + 31) >> 5;
  const int n = blockIdx.y * BUILD_THREADS + threadIdx.x;
  long long v = NONE;
  int i = INT_MAX;
  if (n < a.N) {
    const long long* al = a.alloc + (long long)n * a.R;
    const long long* us = a.used + (long long)n * a.R;
    v = key_at(a, a.sig_rows + (long long)s * (a.R + 3), a.sig_ok[(long long)s * a.N + n],
               a.sig_img[(long long)s * a.N + n], al, us, a.nz0[n], a.nz1[n], a.num_pods[n], a.allowed[n]);
    a.leaves[(long long)s * a.N + n] = v;
    i = n;
  }
  warp_argmax(v, i);
  const int e = n >> 5;
  if ((threadIdx.x & 31) == 0 && e < n1) {
    a.lv_val[(long long)s * n1 + e] = v;
    a.lv_idx[(long long)s * n1 + e] = i;
  }
}

// Where element j of a node's row lies (a warp's copy holds used [R], nz0,
// nz1, num_pods (the usage state), then allocatable [R], allowed; j <
// 2 R + 4): the int64 word at p64[node * stride] or, `is32`, the int32 word
// at p32[node].  Both addresses are valid whatever j is, so a lane can load
// both and pick later (row_val): a warp stalls on a load only where it
// first uses the value, so a row read ahead costs nothing until the next
// step picks it.
struct RowPtr {
  long long* p64;
  int* p32;
  int stride;
  bool is32;
};

__device__ __forceinline__ RowPtr row_ptr(const SigScanArgs& a, int j) {
  const int R = a.R;
  RowPtr x;
  x.is32 = j == R + 2 || j == 2 * R + 3;
  // (store_row writes only the usage lanes, never allocatable or allowed)
  x.p32 = const_cast<int*>(j == R + 2 ? a.num_pods : a.allowed);
  x.stride = j < R || j > R + 2 ? R : 1;
  x.p64 = const_cast<long long*>(j < R ? a.used + j : j == R + 1 ? a.nz1
                                 : j > R + 2 ? a.alloc + min(j - R - 3, R - 1) : a.nz0);
  return x;
}

__device__ __forceinline__ void row_load(const RowPtr& x, int c, long long& x64, int& x32) {
  x64 = x.p64[(long long)c * x.stride];
  x32 = x.p32[c];
}

__device__ __forceinline__ long long row_val(const RowPtr& x, long long x64, int x32) {
  return x.is32 ? (long long)x32 : x64;
}

// Element j < R + 3 of node c's row back to the usage state.
__device__ __forceinline__ void store_row(const RowPtr& x, int c, long long v) {
  if (x.is32) x.p32[c] = (int)v;
  else x.p64[(long long)c * x.stride] = v;
}

// Tree s's root over its n1 groups, by one warp; every lane gets it.
__device__ __forceinline__ void root_of(const Trees& T, int s, long long& v, int& i) {
  v = NONE;
  i = INT_MAX;
  const long long* gv = T.v1 + (long long)s * T.n1;
  const int* gi = T.i1 + (long long)s * T.n1;
  for (int e = threadIdx.x & 31; e < T.n1; e += 128) {  // four loads in flight a lane
    long long ev[4];
    int ei[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = e + 32 * k < T.n1;
      ev[k] = in ? gv[e + 32 * k] : NONE;
      ei[k] = in ? gi[e + 32 * k] : INT_MAX;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (beats(ev[k], ei[k], v, i)) {
        v = ev[k];
        i = ei[k];
      }
  }
  warp_argmax(v, i);
}

// c's group in tree s became (v, i): the root keeps its place, takes (v, i),
// or (true: re-reduce) lost the maximum its node held in c's group.  One
// lane.
__device__ __forceinline__ bool root_moves(const Trees& T, int s, int c, long long v, int i) {
  long long& rv = T.vr[s];
  int& ri = T.ir[s];
  if (rv == v && ri == i) return false;
  if (beats(v, i, rv, ri)) {
    rv = v;
    ri = i;
    return false;
  }
  return (ri >> 5) == (c >> 5);
}

// Every present tree (`list`, nt of them) after node c's commit: c's leaf
// from the post-commit row (`row`: used [R], nz0, nz1, num_pods,
// allocatable [R], allowed) and the signatures' rows (`sig`), then the
// repairs.  `pre` is this lane's leaf of c's group in the warp's first tree
// (`s_pre`; -1 where `pre` is not current: a commit touched the group since
// it was read); ok0 / img0 are c's column of this lane's first tree; all
// read before the step's keys.  `sp` is the pod's own signature: `own`
// tells whether this warp repaired its tree, `t_key` when the first pass's
// keys were done (the step's clocks).
__device__ inline void update_trees(const SigScanArgs& a, const Trees& T, const long long* sig, const int* list,
                                    int nt, int c, const long long* row, long long pre, int s_pre, bool ok0,
                                    long long img0, int sp, long long* t_key, bool* own) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, R = a.R;
  const long long* us = row;
  const long long* al = row + R + 3;
  const long long nz0 = row[R], nz1 = row[R + 1];
  const int pods = (int)row[R + 2], allowed = (int)row[2 * R + 3];
  const int e = c >> 5;
  for (int q = 0; warp + NW * 32 * q < nt; ++q) {
    const int t = warp + NW * (lane + 32 * q);
    const bool act = t < nt;
    const int s = act ? list[t] : -1;
    long long key = 0;
    int redo = 0;  // 1: re-reduce c's group (then maybe the root), 2: the root
    if (nt <= NW) {  // one tree a warp, on lane 0: the warp shares its key's work
      const int s0 = __shfl_sync(FULL, s, 0);
      if (s0 >= 0)
        key = key_warp(a, sig + (long long)s0 * (R + 3), __shfl_sync(FULL, ok0, 0), __shfl_sync(FULL, img0, 0), row);
    }
    if (act) {
      const long long sn = (long long)s * a.N + c;
      if (nt > NW) {
        const bool ok = q == 0 ? ok0 : a.sig_ok[sn];
        const long long img = q == 0 ? img0 : a.sig_img[sn];
        key = key_at(a, sig + (long long)s * (R + 3), ok, img, al, us, nz0, nz1, pods, allowed);
      }
      a.leaves[sn] = key;
      if (q == 0 && lane == 0) *t_key = clock64();
      long long& gv = T.v1[(long long)s * T.n1 + e];
      int& gi = T.i1[(long long)s * T.n1 + e];
      if (gv == key && gi == c) {
        // c held its group's maximum and its key did not move
      } else if (beats(key, c, gv, gi)) {
        gv = key;
        gi = c;
        redo = root_moves(T, s, c, key, c) ? 2 : 0;
      } else if (gi == c) {
        redo = 1;
      }
    }
    __syncwarp();  // the lanes' own entries are visible to the warp
    if (__ballot_sync(FULL, s == sp)) *own = true;
    unsigned need = __ballot_sync(FULL, redo > 0);
    while (need) {  // one warp-wide re-reduction at a time, tree by tree
      const int b = __ffs(need) - 1;
      need &= need - 1;
      const int sb = __shfl_sync(FULL, s, b);
      int k = __shfl_sync(FULL, redo, b);
      if (k == 1) {
        const long long kb = __shfl_sync(FULL, key, b);
        const int ch = (e << 5) + lane;
        long long v = NONE;
        int i = INT_MAX;
        if (ch < a.N) {
          v = ch == c ? kb : (sb == s_pre ? pre : a.leaves[(long long)sb * a.N + ch]);
          i = ch;
        }
        warp_argmax(v, i);
        int up = 0;
        if (lane == 0) {
          T.v1[(long long)sb * T.n1 + e] = v;
          T.i1[(long long)sb * T.n1 + e] = i;
          up = root_moves(T, sb, c, v, i) ? 2 : 0;
        }
        k = __shfl_sync(FULL, up, 0);
        __syncwarp();  // lane 0's group entry is visible to the warp
      }
      if (k == 2) {
        long long v;
        int i;
        root_of(T, sb, v, i);
        if (lane == 0) {
          T.vr[sb] = v;
          T.ir[sb] = i;
        }
      }
    }
  }
}

// kShared: every part in shared memory (tree_smem 2), so the step's tree
// accesses compile to shared-memory instructions, not generic ones.
template <bool kShared>
__global__ void __launch_bounds__(SCAN_THREADS, 1) sig_scan_kernel(const SigScanArgs a) {
  extern __shared__ __align__(16) unsigned char s_raw[];  // scan_smem's layout
  __shared__ int s_ids[SCAN_THREADS];
  __shared__ int s_nt;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, R = a.R, W = 2 * R + 4;
  const int S = a.S, n1 = (a.N + 31) >> 5, parts = a.tree_smem;
  const ScanSmem m = scan_smem(S, R, n1, kShared ? 2 : parts);
  const bool rows_s = kShared || parts >= 1, groups_s = kShared;  // (parts 2 is kShared's instance)
  long long* const row = reinterpret_cast<long long*>(s_raw) + (long long)warp * W;
  long long* const sig = rows_s ? reinterpret_cast<long long*>(s_raw + m.sig) : a.sig_rows;
  int* const list = rows_s ? reinterpret_cast<int*>(s_raw + m.list) : a.tree_sig;
  const long long gs = (long long)S * n1;  // the global arrays' roots
  const Trees T{groups_s ? reinterpret_cast<long long*>(s_raw + m.gv) : a.lv_val,
                rows_s ? reinterpret_cast<long long*>(s_raw + m.rv) : a.lv_val + gs,
                groups_s ? reinterpret_cast<int*>(s_raw + m.gi) : a.lv_idx,
                rows_s ? reinterpret_cast<int*>(s_raw + m.ri) : a.lv_idx + gs, n1};

  // the present signatures, in order; the signatures' rows
  if (warp == 0) {
    int nt = 0;
    for (int base = 0; base < S; base += 32) {
      const int s = base + lane;
      const bool f = s < S && a.present[s];
      const unsigned bal = __ballot_sync(FULL, f);
      if (f) list[nt + __popc(bal & ((1u << lane) - 1))] = s;
      nt += __popc(bal);
    }
    if (lane == 0) s_nt = nt;
  }
  if (rows_s)
    for (long long j = tid; j < (long long)S * (R + 3); j += blockDim.x) sig[j] = a.sig_rows[j];
  __syncthreads();
  const int nt = s_nt;
  // the build's groups into shared memory, then the roots
  if (groups_s)
    for (long long j = tid; j < (long long)nt * n1; j += blockDim.x) {
      const int t = (int)(j / n1), e = (int)(j - (long long)t * n1);
      const long long o = (long long)list[t] * n1 + e;
      T.v1[o] = a.lv_val[o];
      T.i1[o] = a.lv_idx[o];
    }
  __syncthreads();
  for (int t = warp; t < nt; t += NW) {
    const int s = list[t];
    long long v;
    int i;
    root_of(T, s, v, i);
    if (lane == 0) {
      T.vr[s] = v;
      T.ir[s] = i;
    }
  }
  __syncthreads();
  // this warp's first tree (lane 0's) and this lane's, whose c column the
  // step reads ahead of the keys
  const int s_pre = warp < nt ? list[warp] : -1;
  const int s_mine = warp + NW * lane < nt ? list[warp + NW * lane] : -1;
  // What this lane reads of a node, raw (see row_load): its element `lane`
  // of the node's row (when a lane holds one: W <= 32), its leaf of the
  // node's group in the warp's first tree, and the node's column in its
  // first tree; for the node the warp's row copy holds (`cur`) and for the
  // next pod's likely node (`nxt`): the root of the next pod's tree before
  // this step's repairs.  When that root is not this step's node, the next
  // choice is it or this step's node (only this node's leaf changes), so
  // the next row's loads fly during this step.
  struct Reads {
    int node;       // -1: none
    bool pre_ok;    // `pre` is current (no commit touched the group since)
    long long r64, pre, img;
    int r32, ok;
  };
  const bool regs = W <= 32;  // a lane holds one element of a row
  const long long pre_base = (long long)max(s_pre, 0) * a.N, mine_base = (long long)max(s_mine, 0) * a.N;
  const RowPtr mine_row = row_ptr(a, min(lane, W - 1));  // this lane's element of a row
  auto read = [&](int node, Reads& x) {
    x.node = node;
    x.pre_ok = true;
    x.pre = a.leaves[pre_base + min((node & ~31) + lane, a.N - 1)];
    x.ok = a.sig_ok[mine_base + node];
    x.img = a.sig_img[mine_base + node];
    if (regs) row_load(mine_row, node, x.r64, x.r32);
  };
  Reads cur{-1, false, 0, 0, 0, 0, 0}, nxt{-1, false, 0, 0, 0, 0, 0};

  long long clk[5] = {0, 0, 0, 0, 0};  // lane 0: the placed pods and cycles a.info sums
  for (int p0 = 0; p0 < a.P; p0 += SCAN_THREADS) {
    const int len = min(SCAN_THREADS, a.P - p0);
    __syncthreads();  // the last chunk's ids are read
    if (tid < len) s_ids[tid] = a.ids[p0 + tid];
    __syncthreads();
    for (int q = 0; q < len; ++q) {
      const int p = p0 + q, s = s_ids[q];
      int c = -1;  // a pad chooses nothing
      if (s >= 0 && T.vr[s] >= 0) c = T.ir[s];
      if (tid == 0) a.choices[p] = c;
      if (c < 0) continue;  // nothing changes: no barrier
      const long long t0 = clock64();
      // the next placed pod's likely node (a guess: a root another warp is
      // repairing meanwhile is as good)
      int s_next = -1;
      for (int k = q + 1; k < len && k <= q + 64 && s_next < 0; ++k) s_next = s_ids[k];
      const int r_next = s_next >= 0 && T.vr[s_next] >= 0 ? T.ir[s_next] : -1;
      // c's reads: held, read last step, or read now
      const int c_prev = cur.node;
      const Reads old = cur;
      if (c != c_prev) {
        if (c == nxt.node) cur = nxt;
        else read(c, cur);
      }
      // the chosen node's row with the commit, into this warp's copy: warp
      // 0 first writes the last node's back (no warp reads that row from
      // global memory in this step: c differs)
      const long long* req = sig + (long long)s * (R + 3);
      long long held = 0;  // this lane's element of c_prev's row
      for (int j = lane; j < W; j += 32) {
        const RowPtr x = regs ? mine_row : row_ptr(a, j);
        held = row[j];
        if (c != c_prev && warp == 0 && c_prev >= 0 && j < R + 3) store_row(x, c_prev, held);
        long long v = held;
        if (c != c_prev) {
          long long x64 = cur.r64;
          int x32 = cur.r32;
          if (!regs) row_load(x, c, x64, x32);
          v = row_val(x, x64, x32);
        }
        row[j] = v + (j < R + 2 ? req[j] : j == R + 2 ? 1 : 0);
      }
      // the next pod's likely node: c itself (held), c_prev (its row was
      // just written back; this lane's element of it stays in `held`), or
      // read now (kept from an earlier step if it is the same node)
      if (r_next < 0 || r_next == c || !regs) {
        nxt.node = -1;
      } else if (r_next == c_prev) {
        nxt = old;
        nxt.r64 = held;
        nxt.r32 = (int)held;
      } else if (r_next != nxt.node) {
        read(r_next, nxt);
      }
      if (nxt.node >= 0 && (nxt.node >> 5) == (c >> 5)) nxt.pre_ok = false;  // c's leaf changes now
      __syncwarp();
      const long long t1 = clock64();
      long long t2 = t1;
      bool own = false;
      // (cur.pre stays current while the warp holds c: only c's own leaf,
      // which the repair replaces, changes at c)
      update_trees(a, T, sig, list, nt, c, row, cur.pre, cur.pre_ok ? s_pre : -1, cur.ok != 0, cur.img, s, &t2,
                   &own);
      const long long t3 = clock64();
      __syncthreads();  // every tree is current: the next pod reads its root
      if (own && lane == 0) {
        clk[0] += 1;
        clk[1] += t1 - t0;
        clk[2] += t2 - t1;
        clk[3] += t3 - t2;
        clk[4] += clock64() - t3;
      }
    }
  }
  if (a.info != nullptr && lane == 0 && clk[0] > 0)
    for (int k = 0; k < 5; ++k) atomicAdd(reinterpret_cast<unsigned long long*>(a.info) + k, (unsigned long long)clk[k]);
  if (warp == 0 && cur.node >= 0)  // the last node's row back to the usage state
    for (int j = lane; j < R + 3; j += 32) store_row(row_ptr(a, j), cur.node, row[j]);
}

}  // namespace

// Enqueues K2 (sig_mark, sig_build, sig_scan) on `stream` and returns the
// launch status (cudaGetLastError); counts the kernels it enqueued in
// `launches`.  The scan puts in shared memory as many of scan_smem's parts
// as fit under min(smem_cap, the card's opt-in limit less its static shared
// memory), and reports how many in tree_smem.
extern "C" int ktpu_sig_scan(SigScanArgs* args, int smem_cap, void* stream) {
  SigScanArgs& a = *args;
  a.launches = 0;
  if (a.P == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.N == 0 || a.S == 0) return (int)cudaMemsetAsync(a.choices, 0xff, sizeof(int) * (size_t)a.P, st);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, sig_scan_kernel<false>);
  if (e != cudaSuccess) return (int)e;
  const long long budget = std::min<long long>(smem_cap, (long long)optin - (long long)fa.sharedSizeBytes);
  const int n1 = (a.N + 31) >> 5;
  a.tree_smem = 2;
  while (a.tree_smem > 0 && (long long)scan_smem(a.S, a.R, n1, a.tree_smem).bytes > budget) --a.tree_smem;
  const size_t smem = scan_smem(a.S, a.R, n1, a.tree_smem).bytes;
  const bool all = a.tree_smem == 2;
  e = all ? cudaFuncSetAttribute(sig_scan_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
          : cudaFuncSetAttribute(sig_scan_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  sig_mark_kernel<<<1, SCAN_THREADS, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ++a.launches;
  sig_build_kernel<<<dim3(a.S, (a.N + BUILD_THREADS - 1) / BUILD_THREADS), BUILD_THREADS, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ++a.launches;
  if (all) sig_scan_kernel<true><<<1, SCAN_THREADS, smem, st>>>(a);
  else sig_scan_kernel<false><<<1, SCAN_THREADS, smem, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ++a.launches;
  return 0;
}
