"""Device-resident placement of the fast path: kernels K4 and K3.

``resident_run`` (K4) places one RUN of the signature fast path (thousands
of pods) as a speculation/admission fixed point instead of sig_scan's one
pod per step.  Each ROUND freezes the usage state and packs every
(signature, node) pair into a unique key ``score * N + (N - 1 - n)`` (-1
when infeasible), so "max key" is "first-max score".  The window head's
signature orders the nodes into a shared walk; the i-th scheduled pod of the
window speculatively takes the i-th node of the walk.  A pod's speculation
equals its serial argmax iff (1) its walk position is its signature's best
untouched node (key equals the suffix max along the walk) and (2) no node
committed by an earlier slot of the window beats it after that commit.  The
agreeing prefix is committed with one scatter, and the next round
re-speculates from the updated state.  Signatures with no feasible node at
round start stay dead for the round, so their pods are admitted as
unschedulable without consuming walk positions.  An adaptive stop (every
``STOP_GRACE`` rounds the run must have admitted ``STOP_GRACE * min_yield``
pods) and a round cap hand the unresolved tail over: with ``serial_tail`` to
the exact serial replay (sig_scan, K2) inside the same call, without it back
to the caller as ``UNRESOLVED`` (-2) for the host committer.

``usage_checksum`` (K3) is the epoch guard: the exact sum of the carried
usage state, checked by the scheduler against the host-tracked sum.

Each has a plain PyTorch version here; the wrapper takes it only for CPU
tensors and launches the CUDA kernel (csrc/) for CUDA tensors, raising if
that fails.  Decisions are bit-identical to the serial greedy.
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import fastpath as ops_fp
from kubernetes_tpu_torch.ops.common import usage_carry_update
from kubernetes_tpu_torch.snapshot.schema import LANE_CPU, LANE_MEM, N_FIXED_LANES

MAX = 100  # MaxNodeScore
I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool

NEG = torch.iinfo(torch.int64).min // 4  # "no committed node yet" threshold
UNRESOLVED = -2  # choice sentinel: pod not reached before the stop / round cap
# adaptive stop: every STOP_GRACE rounds the run must have admitted
# STOP_GRACE * min_yield pods since the last checkpoint, or it stops
STOP_GRACE = 4
MIN_YIELD = 64

# K4's control block (int64 [CTL_LEN] on the device), csrc/resident_run.cu
CTL_Q, CTL_ROUNDS, CTL_QCKPT, CTL_STOP, CTL_DONE, CTL_PLIVE = range(6)
CTL_LEN = 8


# ---------------------------------------------------------------------------
# K4: resident_run
# ---------------------------------------------------------------------------


def round_cap(P: int, W: int) -> int:
    """Rounds a run may take: a small multiple of the best case."""
    return 64 + 8 * (P // W + 1)


def min_yield(W: int) -> int:
    """Admissions per round the adaptive stop asks for (scaled down on
    clusters smaller than the window could fill)."""
    return min(MIN_YIELD, max(1, W // 4))


def resident_run(
    sig_ids,  # i32 [P]    per-pod signature id in queue order, -1 pads (suffix)
    sig_req,  # i64 [S, R]
    sig_nz,  # i64 [S, 2]
    sig_allzero,  # bool [S]
    sig_ok,  # bool [S, N]
    sig_img,  # i64 [S, N]
    alloc,  # i64 [N, R]
    allowed,  # i32 [N]
    used,  # i64 [N, R]  updated in place
    nz0,  # i64 [N]      updated in place
    nz1,  # i64 [N]      updated in place
    num_pods,  # i32 [N] updated in place
    *,
    w_fit: int,
    w_bal: int,
    w_img: int,
    check_fit: bool,
    window: int,
    serial_tail: bool = True,
):
    """One resident run.  The JAX root donates the usage buffers and returns
    new ones; here they are updated in place.

    Returns (choices i32 [P], (used, nz0, nz1, num_pods), stats i64 [3]),
    stats = (rounds, pods resolved by the fixed point q, tail_left 0/1).
    With ``serial_tail`` the state covers the whole run; without it exactly
    the resolved prefix, and unresolved pods (and pads the fixed point did
    not reach) are UNRESOLVED.
    """
    args = (sig_ids, sig_req, sig_nz, sig_allzero, sig_ok, sig_img, alloc, allowed,
            used, nz0, nz1, num_pods)
    kw = dict(w_fit=w_fit, w_bal=w_bal, w_img=w_img, check_fit=check_fit,
              window=window, serial_tail=serial_tail)
    if sig_ids.device.type == "cpu":
        return resident_run_plain(*args, **kw)
    return _resident_run_cuda(*args, **kw)


def _score_keys(feas, a0, a1, c0, c1, r0, r1, img, node_ids, n_total: int,
                w_fit: int, w_bal: int, w_img: int):
    """Packed (score, first-max index) keys from broadcast-ready operands:
    ``a0/a1`` cpu/mem allocatable, ``c0/c1`` non-zero request sums (node +
    signature), ``r0/r1`` UNCLAMPED used + request cpu/mem, ``img`` the
    ImageLocality term, ``node_ids`` the int64 node index.  -1 where
    infeasible.  The same integer formulas as make_sig_step."""
    total = torch.zeros(feas.shape, dtype=I64, device=feas.device)
    h0 = a0 > 0
    h1 = a1 > 0
    if w_fit:
        fit_w = h0.to(I64) + h1.to(I64)
        f0 = torch.where(c0 > a0, 0, torch.div((a0 - c0) * MAX, a0.clamp(min=1), rounding_mode="floor"))
        f1 = torch.where(c1 > a1, 0, torch.div((a1 - c1) * MAX, a1.clamp(min=1), rounding_mode="floor"))
        least = torch.where(
            fit_w > 0,
            torch.div(torch.where(h0, f0, 0) + torch.where(h1, f1, 0), fit_w.clamp(min=1),
                      rounding_mode="floor"),
            0,
        )
        total = total + w_fit * least
    if w_bal:
        den = (a0 * a1).clamp(min=1)
        rr0 = torch.minimum(r0, a0)
        rr1 = torch.minimum(r1, a1)
        d = (rr0 * a1 - rr1 * a0).abs()
        bal = torch.where(h0 & h1, MAX - torch.div(50 * d + den - 1, den, rounding_mode="floor"), MAX)
        total = total + w_bal * bal
    if w_img:
        total = total + w_img * img
    key = total * n_total + (n_total - 1 - node_ids)
    return torch.where(feas, key, -1)


def _lane_ok(sig_req, avail):
    """Per-lane fit of request rows against available rows (broadcast):
    an unrequested extended lane always fits."""
    R = sig_req.shape[-1]
    ext_lane = torch.arange(R, device=sig_req.device) >= N_FIXED_LANES
    return (ext_lane & (sig_req == 0)) | (sig_req <= avail)


def _sig_node_keys(sig_req, sig_nz, sig_allzero, sig_ok, sig_img, alloc, allowed,
                   used, nz0, nz1, num_pods, w_fit, w_bal, w_img, check_fit):
    """[S, N] keys under the CURRENT usage state; -1 where infeasible."""
    N = alloc.shape[0]
    if check_fit:
        fits_count = (num_pods + 1 <= allowed)[None, :]
        lane_ok = _lane_ok(sig_req[:, None, :], (alloc - used)[None, :, :])  # [S, N, R]
        fits_lanes = sig_allzero[:, None] | lane_ok.all(dim=2)
        feas = sig_ok & fits_count & fits_lanes
    else:
        feas = sig_ok
    return _score_keys(
        feas,
        alloc[:, LANE_CPU][None, :],
        alloc[:, LANE_MEM][None, :],
        nz0[None, :] + sig_nz[:, 0, None],
        nz1[None, :] + sig_nz[:, 1, None],
        used[:, LANE_CPU][None, :] + sig_req[:, LANE_CPU, None],
        used[:, LANE_MEM][None, :] + sig_req[:, LANE_MEM, None],
        sig_img,
        torch.arange(N, dtype=I64, device=alloc.device)[None, :],
        N,
        w_fit, w_bal, w_img,
    )


def _upd_keys(cnode, csig, sig_req, sig_nz, sig_allzero, sig_ok, sig_img, alloc, allowed,
              used, nz0, nz1, num_pods, w_fit, w_bal, w_img, check_fit):
    """[W, S] keys of each slot's node under EVERY signature AFTER that
    slot's commit (slot i commits signature ``csig[i]`` to ``cnode[i]``)."""
    N = alloc.shape[0]
    a_rows = alloc[cnode]  # [W, R]
    n_used = used[cnode] + sig_req[csig]  # [W, R]
    n_nz0 = nz0[cnode] + sig_nz[csig, 0]
    n_nz1 = nz1[cnode] + sig_nz[csig, 1]
    n_np = num_pods[cnode] + 1
    if check_fit:
        fits_count = (n_np + 1 <= allowed[cnode])[:, None]  # [W, 1]
        lane_ok = _lane_ok(sig_req[None, :, :], (a_rows - n_used)[:, None, :])  # [W, S, R]
        fits_lanes = sig_allzero[None, :] | lane_ok.all(dim=2)
        feas = sig_ok[:, cnode].T & fits_count & fits_lanes
    else:
        feas = sig_ok[:, cnode].T
    return _score_keys(
        feas,
        a_rows[:, LANE_CPU][:, None],
        a_rows[:, LANE_MEM][:, None],
        n_nz0[:, None] + sig_nz[None, :, 0],
        n_nz1[:, None] + sig_nz[None, :, 1],
        n_used[:, LANE_CPU][:, None] + sig_req[None, :, LANE_CPU],
        n_used[:, LANE_MEM][:, None] + sig_req[None, :, LANE_MEM],
        sig_img[:, cnode].T,
        cnode.to(I64)[:, None],
        N,
        w_fit, w_bal, w_img,
    )


def resident_run_plain(sig_ids, sig_req, sig_nz, sig_allzero, sig_ok, sig_img, alloc, allowed,
                       used, nz0, nz1, num_pods, *, w_fit, w_bal, w_img, check_fit, window,
                       serial_tail=True):
    """Plain PyTorch version of K4: the JAX root line for line, with a
    Python loop over the rounds (one host read of the round's admitted
    prefix length per round)."""
    dev = sig_ids.device
    P = sig_ids.shape[0]
    S = sig_req.shape[0]
    N = alloc.shape[0]
    W = min(window, N)
    p_live = int((sig_ids >= 0).sum())
    ids_pad = torch.cat([sig_ids, torch.full((W,), -1, dtype=I32, device=dev)])
    iota_w = torch.arange(W, device=dev)
    r_cap = round_cap(P, W)
    yield_min = min_yield(W)
    score_kw = dict(w_fit=w_fit, w_bal=w_bal, w_img=w_img, check_fit=check_fit)
    state = {"used": used, "nz0": nz0, "nz1": nz1, "num_pods": num_pods}
    choices = torch.full((P + W,), UNRESOLVED, dtype=I32, device=dev)
    neg_row = torch.full((1, S), NEG, dtype=I64, device=dev)
    q = rounds = q_ckpt = 0
    stop = False
    while q < p_live and rounds < r_cap and not stop:
        keys = _sig_node_keys(sig_req, sig_nz, sig_allzero, sig_ok, sig_img, alloc, allowed,
                              used, nz0, nz1, num_pods, **score_kw)  # [S, N]
        win = ids_pad[q : q + W]
        live = win >= 0
        sig_w = win.clamp(min=0).long()
        # the shared walk: nodes in the window head's preference order (a
        # stable sort, so the -1 keys of infeasible nodes keep index order)
        order = torch.argsort(-keys[sig_w[0]], stable=True)  # [N]
        skey = keys[:, order]
        sufmax = torch.cummax(skey.flip(1), dim=1).values.flip(1)  # best untouched key from pos on
        dead = sufmax[:, 0] < 0
        dead_w = dead[sig_w] & live
        sched_spec = live & ~dead_w
        si = sched_spec.to(I64)
        pos = (torch.cumsum(si, 0) - si).clamp(max=N - 1)  # exclusive count
        ckey = skey[sig_w, pos]
        csuf = sufmax[sig_w, pos]
        cnode = order[pos]
        u = _upd_keys(cnode, sig_w, sig_req, sig_nz, sig_allzero, sig_ok, sig_img, alloc, allowed,
                      used, nz0, nz1, num_pods, **score_kw)  # [W, S]
        u = torch.where(sched_spec[:, None], u, NEG)
        # exclusive running max over the predecessors' committed nodes
        thr = torch.cat([neg_row, torch.cummax(u, dim=0).values[:-1]])
        thr_i = thr[iota_w, sig_w]
        ok_sched = sched_spec & (ckey >= 0) & (ckey == csuf) & (ckey > thr_i)
        disagree = ~(ok_sched | dead_w)
        first = torch.nonzero(disagree)
        A = int(first[0, 0]) if first.numel() else W  # admitted prefix (>= 1)
        adm = iota_w < A
        commit = adm & ok_sched
        usage_carry_update(
            state,
            {"used": sig_req[sig_w], "nz0": sig_nz[sig_w, 0], "nz1": sig_nz[sig_w, 1], "num_pods": 1},
            cnode,
            commit,
        )
        cvals = torch.where(commit, cnode, -1).to(I32)  # admitted dead pods: -1
        old = choices[q : q + W]
        choices[q : q + W] = torch.where(adm & live, cvals, old)
        q += A
        rounds += 1
        if rounds % STOP_GRACE == 0:
            stop = q - q_ckpt < STOP_GRACE * yield_min
            q_ckpt = q
    choices = choices[:P]
    tail_left = q < p_live
    if serial_tail and tail_left:
        # the exact serial replay from the resolved prefix on
        masked = torch.where(torch.arange(P, device=dev) < q, -1, sig_ids).to(I32)
        tail, _ = ops_fp.sig_scan_plain(masked, sig_req, sig_nz, sig_allzero, sig_ok, sig_img,
                                        alloc, allowed, used, nz0, nz1, num_pods,
                                        w_fit, w_bal, w_img, check_fit)
        choices = torch.where(choices == UNRESOLVED, tail, choices)
    stats = torch.tensor([rounds, q, int(tail_left)], dtype=I64, device=dev)
    return choices, (used, nz0, nz1, num_pods), stats


def _resident_run_cuda(sig_ids, sig_req, sig_nz, sig_allzero, sig_ok, sig_img, alloc, allowed,
                       used, nz0, nz1, num_pods, *, w_fit, w_bal, w_img, check_fit, window,
                       serial_tail=True):
    dev = sig_ids.device
    lib = _build.load()
    P = sig_ids.shape[0]
    Sg, R = sig_req.shape
    N = alloc.shape[0]
    W = min(int(window), N)
    if W < 1:
        raise ValueError(f"resident_run: window {window} over {N} nodes")
    c = _build.check_cuda
    a = _build.ResidentArgs()
    a.ids = c("sig_ids", sig_ids, dev, I32, (P,))
    a.sig_req = c("sig_req", sig_req, dev, I64, (Sg, R))
    a.sig_nz = c("sig_nz", sig_nz, dev, I64, (Sg, 2))
    a.sig_allzero = c("sig_allzero", sig_allzero, dev, BOOL, (Sg,))
    a.sig_ok = c("sig_ok", sig_ok, dev, BOOL, (Sg, N))
    a.sig_img = c("sig_img", sig_img, dev, I64, (Sg, N))
    a.alloc = c("alloc", alloc, dev, I64, (N, R))
    a.allowed = c("allowed", allowed, dev, I32, (N,))
    a.used = c("used", used, dev, I64, (N, R))
    a.nz0 = c("nz0", nz0, dev, I64, (N,))
    a.nz1 = c("nz1", nz1, dev, I64, (N,))
    a.num_pods = c("num_pods", num_pods, dev, I32, (N,))
    # outputs and scratch (the kernels allocate nothing)
    choices = torch.empty((P + W,), dtype=I32, device=dev)
    ctl = torch.empty((CTL_LEN,), dtype=I64, device=dev)
    scratch = dict(
        keys=torch.empty((Sg, N), dtype=I64, device=dev),
        rank=torch.empty((N,), dtype=I32, device=dev),
        order=torch.empty((W,), dtype=I32, device=dev),
        sufmax=torch.empty((Sg, W), dtype=I64, device=dev),
        slot_sig=torch.empty((W,), dtype=I32, device=dev),
        slot_node=torch.empty((W,), dtype=I32, device=dev),
        slot_flags=torch.empty((W,), dtype=torch.uint8, device=dev),
        slot_ckey=torch.empty((W,), dtype=I64, device=dev),
        slot_csuf=torch.empty((W,), dtype=I64, device=dev),
        slot_thr=torch.empty((W,), dtype=I64, device=dev),
    )
    a.choices, a.ctl = choices.data_ptr(), ctl.data_ptr()
    for k, t in scratch.items():
        setattr(a, k, t.data_ptr())
    a.P, a.N, a.R, a.S, a.W = P, N, R, Sg, W
    a.w_fit, a.w_bal, a.w_img, a.check_fit = int(w_fit), int(w_bal), int(w_img), int(bool(check_fit))
    a.r_cap, a.min_yield, a.stop_grace = round_cap(P, W), min_yield(W), STOP_GRACE
    stream = _build.stream_handle(dev)
    _build.check_launch(lib, lib.ktpu_resident_init(ctypes.byref(a), stream), "resident_run")
    _build.launches["resident_run"] += 1
    # rounds go out in groups of STOP_GRACE; every kernel of a round first
    # reads the device's done flag and returns at once when it is set, so
    # the rounds enqueued past the loop's end change nothing
    while True:
        rc = lib.ktpu_resident_rounds(ctypes.byref(a), STOP_GRACE, stream)
        _build.check_launch(lib, rc, "resident_run")
        host = ctl.cpu().tolist()
        if host[CTL_DONE]:
            break
    q, rounds, p_live = host[CTL_Q], host[CTL_ROUNDS], host[CTL_PLIVE]
    tail_left = q < p_live
    if serial_tail and tail_left:
        masked = torch.empty_like(sig_ids)
        rc = lib.ktpu_resident_tail_ids(ctypes.byref(a), masked.data_ptr(), stream)
        _build.check_launch(lib, rc, "resident_run")
        tail, _ = ops_fp.sig_scan(masked, sig_req, sig_nz, sig_allzero, sig_ok, sig_img, alloc,
                                  allowed, used, nz0, nz1, num_pods, w_fit, w_bal, w_img, check_fit)
        rc = lib.ktpu_resident_tail_merge(ctypes.byref(a), tail.data_ptr(), stream)
        _build.check_launch(lib, rc, "resident_run")
    stats = torch.tensor([rounds, q, int(tail_left)], dtype=I64, device=dev)
    return choices[:P], (used, nz0, nz1, num_pods), stats


# ---------------------------------------------------------------------------
# K3: usage_checksum — the epoch guard
# ---------------------------------------------------------------------------


def usage_checksum(used, nz0, nz1, num_pods):
    """Exact int64 sum of every usage row, as a 0-d int64 tensor.  The host
    tracks the same quantity (base sum + per-batch commit deltas), so after
    each device batch the two must agree; a mismatch means the device
    lineage is torn and the scheduler raises."""
    if used.device.type == "cpu":
        return usage_checksum_plain(used, nz0, nz1, num_pods)
    return _usage_checksum_cuda(used, nz0, nz1, num_pods)


def usage_checksum_plain(used, nz0, nz1, num_pods):
    """Plain PyTorch version of K3."""
    return used.sum() + nz0.sum() + nz1.sum() + num_pods.to(I64).sum()


def _usage_checksum_cuda(used, nz0, nz1, num_pods):
    dev = used.device
    lib = _build.load()
    N, R = used.shape
    c = _build.check_cuda
    p_used = c("used", used, dev, I64, (N, R))
    p_nz0 = c("nz0", nz0, dev, I64, (N,))
    p_nz1 = c("nz1", nz1, dev, I64, (N,))
    p_np = c("num_pods", num_pods, dev, I32, (N,))
    out = torch.empty((), dtype=I64, device=dev)
    rc = lib.ktpu_usage_checksum(
        p_used, N * R, p_nz0, p_nz1, p_np, N, out.data_ptr(), _build.stream_handle(dev)
    )
    _build.check_launch(lib, rc, "usage_checksum")
    _build.launches["usage_checksum"] += 1
    return out
