// K4: one resident run of the signature fast path, a speculation/admission
// fixed point over the pod feed.
//
// Replaces the JAX root kubernetes_tpu/ops/resident.py:265 resident_run.
// Each round freezes the usage state, packs every (signature, node) pair
// into the unique key score * N + (N - 1 - n) (-1 when infeasible), orders
// the nodes into a walk by the window head's keys, lets the i-th scheduled
// pod of the window take the i-th walk node, and commits the prefix of the
// window on which that speculation provably equals the serial greedy
// (ops/resident.py says why).  The adaptive stop and the round cap leave the
// rest to a tail: the caller's host committer, or K2 (sig_scan) enqueued by
// the wrapper behind the rounds, on the feed with its resolved prefix masked.
//
// Design: six kernels per round on one stream, enqueued by the host in
// groups of STOP_GRACE rounds.  The loop's state (q, rounds, the checkpoint,
// the stop and done flags) lives in a device control block; every kernel
// first reads `done` and returns at once when it is set, so the rounds
// enqueued past the loop's end change nothing, and the wrapper reads the
// block once per group to decide whether to enqueue more.
//   keys    one thread per (signature, node): the [S, N] keys (fits and
//           score_total of ktpu.cuh, shared with K2).
//   rank    the walk without a library sort.  The admission only reads
//           walk positions below W = min(window, N), so each node counts
//           the nodes whose head key is larger, or equal with a smaller
//           index (the stable argsort's order among the -1 keys); a node
//           of rank < W writes order[rank].  The head's keys are staged
//           through shared memory, and a block stops counting once all its
//           nodes are past W.  About N^2 integer compares at worst.
//   sufmax  one block per signature: the best key among the nodes ranked
//           >= W (none when W == N: -inf, not -1), then a block scan from
//           the walk's end gives the best untouched key at each position.
//   window  one block: the slots' live / dead / scheduled flags, the
//           exclusive count of scheduled slots (the walk position), and
//           each slot's node, key and its signature's suffix max.
//   thr     one block per signature s: the post-commit key under s of each
//           scheduled slot's node (the [W, S] keys, never materialised),
//           an exclusive running max over the slots, kept for the slots of
//           signature s.
//   commit  one block: the first disagreeing slot A, the scatter of the
//           admitted commits into used / nz0 / nz1 / num_pods (each walk
//           position commits at most once per round, so the nodes are
//           distinct and no atomics are needed), the choices of the
//           admitted live slots, and the loop state with the adaptive stop.
//
// Bound on the H100: per round the key pass reads the [S, N] static rows
// and the usage state once (a few MB at config0), and the window's work is
// O(W * S); the operations are the key formulas, S * N + W * S of them.
// This design adds the N^2 compares of the rank pass and ~6 dependent
// launches per round, which dominate at N = 10240.
#include <climits>

#include "ktpu.cuh"

using namespace ktpu;

namespace {

constexpr int UNRESOLVED = -2;
constexpr long long NEG = LLONG_MIN / 4;  // "no committed node yet"
enum { CTL_Q = 0, CTL_ROUNDS, CTL_QCKPT, CTL_STOP, CTL_DONE, CTL_PLIVE };
constexpr unsigned char FLAG_LIVE = 1;
constexpr unsigned char FLAG_DEAD = 2;
constexpr unsigned char FLAG_SPEC = 4;

constexpr int KEY_THREADS = 256;
constexpr int RANK_THREADS = 128;
constexpr int RANK_TILE = 2048;  // head keys staged per pass: 16 KB
constexpr int BLOCK = 1024;      // the one-block and per-signature kernels
constexpr int TAIL_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct SumOp {
  __device__ long long operator()(long long x, long long y) const {
    return x + y;
  }
};
struct MaxOp {
  __device__ long long operator()(long long x, long long y) const {
    return x > y ? x : y;
  }
};
struct MinOp {
  __device__ long long operator()(long long x, long long y) const {
    return x < y ? x : y;
  }
};

// Inclusive scan of `v` over the block in thread order (blockDim.x a
// multiple of 32).  Every thread gets its prefix; `total` is the whole
// block's.  `sh` holds 32 values; every thread of the block must call.
template <class Op>
__device__ long long block_scan(long long v, long long identity, Op op,
                                long long* sh, long long& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const long long o = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v = op(o, v);
  }
  __syncthreads();  // the previous call's readers of sh are done
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < nw ? sh[lane] : identity;
    for (int off = 1; off < 32; off <<= 1) {
      const long long o = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w = op(o, w);
    }
    sh[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = op(sh[warp - 1], v);
  total = sh[nw - 1];
  return v;
}

__device__ __forceinline__ long long lmax(long long x, long long y) {
  return x > y ? x : y;
}

// Key of signature s on node n under the carried state plus, when t >= 0,
// one commit of signature t on n (the reference's _sig_node_keys and
// _upd_keys, one element each).
__device__ __forceinline__ long long node_key(const ResidentArgs& a, int s,
                                              int n, int t) {
  const long long N = a.N;
  if (!a.sig_ok[(long long)s * N + n]) return -1;
  const int R = a.R;
  const long long* req = a.sig_req + (long long)s * R;
  const long long* al = a.alloc + (long long)n * R;
  const long long* us = a.used + (long long)n * R;
  const long long* extra = t >= 0 ? a.sig_req + (long long)t * R : nullptr;
  if (a.check_fit &&
      !fits(req, a.sig_allzero[s], al, us, extra,
            a.num_pods[n] + (t >= 0 ? 1 : 0), a.allowed[n], R))
    return -1;
  long long c0 = a.nz0[n] + a.sig_nz[2 * s];
  long long c1 = a.nz1[n] + a.sig_nz[2 * s + 1];
  long long r0 = us[LANE_CPU] + req[LANE_CPU];
  long long r1 = us[LANE_MEM] + req[LANE_MEM];
  if (t >= 0) {
    c0 += a.sig_nz[2 * t];
    c1 += a.sig_nz[2 * t + 1];
    r0 += extra[LANE_CPU];
    r1 += extra[LANE_MEM];
  }
  const long long img = a.w_img ? a.sig_img[(long long)s * N + n] : 0;
  const long long total = score_total(al[LANE_CPU], al[LANE_MEM], c0, c1, r0,
                                      r1, img, a.w_fit, a.w_bal, a.w_img);
  return total * N + (N - 1 - n);
}

__device__ __forceinline__ bool done(const ResidentArgs& a) {
  return a.ctl[CTL_DONE] != 0;
}

// The slot's speculation equals the serial greedy's choice.
__device__ __forceinline__ bool slot_ok(const ResidentArgs& a, int i) {
  if (!(a.slot_flags[i] & FLAG_SPEC)) return false;
  const long long ck = a.slot_ckey[i];
  return ck >= 0 && ck == a.slot_csuf[i] && ck > a.slot_thr[i];
}

__global__ void __launch_bounds__(BLOCK)
    resident_init_kernel(const ResidentArgs a) {
  __shared__ long long sh[32];
  long long live = 0;
  for (int p = threadIdx.x; p < a.P; p += BLOCK) live += a.ids[p] >= 0;
  for (int i = threadIdx.x; i < a.P + a.W; i += BLOCK)
    a.choices[i] = UNRESOLVED;
  long long p_live;
  block_scan(live, 0, SumOp(), sh, p_live);
  if (threadIdx.x == 0) {
    a.ctl[CTL_Q] = 0;
    a.ctl[CTL_ROUNDS] = 0;
    a.ctl[CTL_QCKPT] = 0;
    a.ctl[CTL_STOP] = 0;
    a.ctl[CTL_PLIVE] = p_live;
    a.ctl[CTL_DONE] = !(p_live > 0 && a.r_cap > 0);
  }
}

__global__ void __launch_bounds__(KEY_THREADS)
    resident_keys_kernel(const ResidentArgs a) {
  if (done(a)) return;
  const long long i = (long long)blockIdx.x * KEY_THREADS + threadIdx.x;
  if (i >= (long long)a.S * a.N) return;
  a.keys[i] = node_key(a, (int)(i / a.N), (int)(i % a.N), -1);
}

__global__ void __launch_bounds__(RANK_THREADS)
    resident_rank_kernel(const ResidentArgs a) {
  __shared__ long long tile[RANK_TILE];
  if (done(a)) return;  // uniform over the block
  const long long q = a.ctl[CTL_Q];  // q < p_live <= P in a live round
  int head = q < a.P ? a.ids[q] : 0;
  if (head < 0) head = 0;
  const long long* hk = a.keys + (long long)head * a.N;
  const int n = blockIdx.x * RANK_THREADS + threadIdx.x;
  const bool mine = n < a.N;
  const long long my = mine ? hk[n] : 0;
  int cnt = 0;
  for (int base = 0; base < a.N; base += RANK_TILE) {
    const int len = min(RANK_TILE, a.N - base);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < len; j += RANK_THREADS) tile[j] = hk[base + j];
    __syncthreads();
    if (mine && cnt < a.W) {
      const int lim = n - base;  // tile entries before node n
      for (int j = 0; j < len; ++j) {
        const long long k = tile[j];
        cnt += (k > my) | ((k == my) & (j < lim));
      }
    }
    if (__syncthreads_and(!mine || cnt >= a.W)) break;
  }
  if (mine) {
    a.rank[n] = cnt < a.W ? cnt : a.W;
    if (cnt < a.W) a.order[cnt] = n;
  }
}

__global__ void __launch_bounds__(BLOCK)
    resident_sufmax_kernel(const ResidentArgs a) {
  __shared__ long long sh[32];
  if (done(a)) return;
  const int s = blockIdx.x;
  const long long* ks = a.keys + (long long)s * a.N;
  long long rest = LLONG_MIN;  // the nodes past the walk's first W
  for (int n = threadIdx.x; n < a.N; n += BLOCK)
    if (a.rank[n] >= a.W) rest = lmax(rest, ks[n]);
  long long carry, tot;
  block_scan(rest, LLONG_MIN, MaxOp(), sh, carry);
  // thread t takes the chunk's (BLOCK - 1 - t)-th position, so the
  // inclusive scan over threads is a suffix max over positions
  for (int c = (a.W - 1) / BLOCK; c >= 0; --c) {
    const int p = c * BLOCK + (BLOCK - 1 - threadIdx.x);
    const long long v = p < a.W ? ks[a.order[p]] : LLONG_MIN;
    const long long inc = block_scan(v, LLONG_MIN, MaxOp(), sh, tot);
    if (p < a.W) a.sufmax[(long long)s * a.W + p] = lmax(inc, carry);
    carry = lmax(carry, tot);
  }
}

__global__ void __launch_bounds__(BLOCK)
    resident_window_kernel(const ResidentArgs a) {
  __shared__ long long sh[32];
  if (done(a)) return;
  const long long q = a.ctl[CTL_Q];
  long long carry = 0;  // scheduled slots before this chunk
  for (int base = 0; base < a.W; base += BLOCK) {
    const int i = base + threadIdx.x;
    const int win = (i < a.W && q + i < a.P) ? a.ids[q + i] : -1;
    const bool live = win >= 0;
    const int sw = live ? win : 0;
    const bool dead = live && a.sufmax[(long long)sw * a.W] < 0;
    const bool spec = live && !dead;
    long long tot;
    const long long inc = block_scan(spec ? 1 : 0, 0, SumOp(), sh, tot);
    if (i < a.W) {
      long long pos = carry + inc - (spec ? 1 : 0);
      if (pos > a.N - 1) pos = a.N - 1;
      const int node = a.order[pos];
      a.slot_sig[i] = sw;
      a.slot_node[i] = node;
      a.slot_flags[i] = (live ? FLAG_LIVE : 0) | (dead ? FLAG_DEAD : 0) |
                        (spec ? FLAG_SPEC : 0);
      a.slot_ckey[i] = a.keys[(long long)sw * a.N + node];
      a.slot_csuf[i] = a.sufmax[(long long)sw * a.W + pos];
    }
    carry += tot;
  }
}

__global__ void __launch_bounds__(BLOCK)
    resident_thr_kernel(const ResidentArgs a) {
  __shared__ long long sh[32];
  __shared__ long long ubuf[BLOCK];
  if (done(a)) return;
  const int s = blockIdx.x;
  long long carry = NEG;
  for (int base = 0; base < a.W; base += BLOCK) {
    const int i = base + threadIdx.x;
    long long u = NEG;
    int t = -1;
    if (i < a.W) {
      t = a.slot_sig[i];
      if (a.slot_flags[i] & FLAG_SPEC) u = node_key(a, s, a.slot_node[i], t);
    }
    ubuf[threadIdx.x] = u;
    __syncthreads();
    // exclusive within the chunk: scan the predecessor's value
    const long long prev = threadIdx.x > 0 ? ubuf[threadIdx.x - 1] : NEG;
    long long tot;
    const long long excl = block_scan(prev, NEG, MaxOp(), sh, tot);
    if (t == s) a.slot_thr[i] = lmax(carry, excl);
    carry = lmax(carry, lmax(tot, ubuf[BLOCK - 1]));
    __syncthreads();  // ubuf is consumed before the next chunk writes it
  }
}

__global__ void __launch_bounds__(BLOCK)
    resident_commit_kernel(const ResidentArgs a) {
  __shared__ long long sh[32];
  if (done(a)) return;
  const long long q = a.ctl[CTL_Q];
  long long first = a.W;
  for (int i = threadIdx.x; i < a.W; i += BLOCK) {
    const bool agree = slot_ok(a, i) || (a.slot_flags[i] & FLAG_DEAD);
    if (!agree && i < first) first = i;
  }
  long long A;  // the admitted prefix; slot 0 always agrees
  block_scan(first, LLONG_MAX, MinOp(), sh, A);
  const int R = a.R;
  for (int i = threadIdx.x; i < A; i += BLOCK) {
    if (!(a.slot_flags[i] & FLAG_LIVE)) continue;  // a pad keeps its choice
    if (slot_ok(a, i)) {
      const int n = a.slot_node[i];
      const int t = a.slot_sig[i];
      long long* us = a.used + (long long)n * R;
      const long long* rq = a.sig_req + (long long)t * R;
      for (int r = 0; r < R; ++r) us[r] += rq[r];
      a.nz0[n] += a.sig_nz[2 * t];
      a.nz1[n] += a.sig_nz[2 * t + 1];
      a.num_pods[n] += 1;
      a.choices[q + i] = n;
    } else {
      a.choices[q + i] = -1;  // admitted dead signature: unschedulable
    }
  }
  if (threadIdx.x == 0) {
    const long long nq = q + A;
    const long long rounds = a.ctl[CTL_ROUNDS] + 1;
    long long q_ckpt = a.ctl[CTL_QCKPT];
    long long stop = 0;
    if (rounds % a.stop_grace == 0) {
      stop = nq - q_ckpt < (long long)a.stop_grace * a.min_yield;
      q_ckpt = nq;
    }
    a.ctl[CTL_Q] = nq;
    a.ctl[CTL_ROUNDS] = rounds;
    a.ctl[CTL_QCKPT] = q_ckpt;
    a.ctl[CTL_STOP] = stop;
    a.ctl[CTL_DONE] = !(nq < a.ctl[CTL_PLIVE] && rounds < a.r_cap && !stop);
  }
}

__global__ void resident_tail_ids_kernel(const ResidentArgs a, int* masked) {
  const int i = blockIdx.x * TAIL_THREADS + threadIdx.x;
  if (i < a.P) masked[i] = i < a.ctl[CTL_Q] ? -1 : a.ids[i];
}

__global__ void resident_tail_merge_kernel(const ResidentArgs a,
                                           const int* tail) {
  const int i = blockIdx.x * TAIL_THREADS + threadIdx.x;
  if (i < a.P && a.choices[i] == UNRESOLVED) a.choices[i] = tail[i];
}

unsigned tail_blocks(int P) {
  return (unsigned)((P + TAIL_THREADS - 1) / TAIL_THREADS);
}

}  // namespace

// Resets the control block (q = rounds = 0, p_live = live ids) and fills
// choices with UNRESOLVED.  Every entry point enqueues on `stream` and
// returns the launch status (cudaGetLastError).
extern "C" int ktpu_resident_init(const ResidentArgs* a, void* stream) {
  resident_init_kernel<<<1, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      *a);
  return (int)cudaGetLastError();
}

// Enqueues n_rounds rounds; those past the loop's end return at once.
extern "C" int ktpu_resident_rounds(const ResidentArgs* a, int n_rounds,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long sn = (long long)a->S * a->N;
  const unsigned key_blocks = (unsigned)((sn + KEY_THREADS - 1) / KEY_THREADS);
  const unsigned rank_blocks =
      (unsigned)((a->N + RANK_THREADS - 1) / RANK_THREADS);
  for (int r = 0; r < n_rounds; ++r) {
    resident_keys_kernel<<<key_blocks, KEY_THREADS, 0, st>>>(*a);
    resident_rank_kernel<<<rank_blocks, RANK_THREADS, 0, st>>>(*a);
    resident_sufmax_kernel<<<a->S, BLOCK, 0, st>>>(*a);
    resident_window_kernel<<<1, BLOCK, 0, st>>>(*a);
    resident_thr_kernel<<<a->S, BLOCK, 0, st>>>(*a);
    resident_commit_kernel<<<1, BLOCK, 0, st>>>(*a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// masked[i] = -1 below the resolved prefix q, else ids[i]: the serial
// tail's feed for K2.
extern "C" int ktpu_resident_tail_ids(const ResidentArgs* a, int* masked,
                                      void* stream) {
  if (a->P == 0) return 0;
  resident_tail_ids_kernel<<<tail_blocks(a->P), TAIL_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(*a, masked);
  return (int)cudaGetLastError();
}

// choices[i] = tail[i] wherever the fixed point left it UNRESOLVED.
extern "C" int ktpu_resident_tail_merge(const ResidentArgs* a,
                                        const int* tail, void* stream) {
  if (a->P == 0) return 0;
  resident_tail_merge_kernel<<<tail_blocks(a->P), TAIL_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(*a, tail);
  return (int)cudaGetLastError();
}
