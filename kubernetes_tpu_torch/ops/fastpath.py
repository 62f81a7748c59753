"""Device half of the signature fast path: kernels K1 and K2.

For batches whose only batch-dynamic constraint is resources, pods collapse
into a handful of SIGNATURES and the per-pod work factors as

    total(p, n) = static(sig(p), n) + dynamic_resources(state(n), sig(p))

``static_eval`` (K1) evaluates the static half once per signature over all
nodes; ``sig_scan`` (K2) replays the reference's one-pod-at-a-time argmax
commit (schedule_one.go ScheduleOne → selectHost first-max) over the carried
node usage.  Each has a plain PyTorch version here; the wrapper takes it
only for CPU tensors and launches the CUDA kernel (csrc/) for CUDA tensors,
raising if that fails.  Decisions are bit-identical to the host
kubernetes_tpu_torch.fastpath.FastCommitter.
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import filters as F
from kubernetes_tpu_torch.ops import scores as S
from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster, usage_carry_update
from kubernetes_tpu_torch.snapshot.schema import LANE_CPU, LANE_MEM, N_FIXED_LANES

MAX = 100  # MaxNodeScore
I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool

STATIC_KEYS = (
    "mask",
    "m_nodename",
    "m_unsched",
    "m_taints",
    "m_nodeaff",
    "taint_raw",
    "naff_raw",
    "img",
)

_ENABLED_BITS = {
    "NodeName": 1,
    "NodeUnschedulable": 2,
    "TaintToleration": 4,
    "NodeAffinity": 8,
}


# ---------------------------------------------------------------------------
# K1: static_eval
# ---------------------------------------------------------------------------


def static_eval(dc: DeviceCluster, db: DeviceBatch, enabled: frozenset, has_images: bool, extra_mask=None,
                mask_enabled: frozenset = None):
    """Static filters + raw static scores for a representative batch.

    Returns a dict of [S, N] tensors:
      mask        — statics-feasible (node valid, the filters of
                    ``mask_enabled`` (default ``enabled``) among name,
                    unschedulable, taints and node affinity, and
                    ``extra_mask`` [S, N] where one is given: the gang
                    precompute's host-filter lane, K12's volume mask)
      m_taints / m_nodeaff / m_nodename / m_unsched — per-plugin masks
      taint_raw / naff_raw — raw score inputs (the scheduler checks they are
                    CONSTANT over the feasible set, which makes their
                    normalized contribution argmax-neutral)
      img         — ImageLocality contribution
    """
    if mask_enabled is None:
        mask_enabled = enabled
    if dc.node_valid.device.type == "cpu":
        return static_eval_plain(dc, db, enabled, has_images, extra_mask, mask_enabled)
    return _static_eval_cuda(dc, db, enabled, has_images, extra_mask, mask_enabled)


def static_eval_plain(dc: DeviceCluster, db: DeviceBatch, enabled: frozenset, has_images: bool, extra_mask=None,
                      mask_enabled: frozenset = None):
    """Plain PyTorch version of K1 (the reference's formulas, vectorized)."""
    P = db.valid.shape[0]
    N = dc.node_valid.shape[0]
    if mask_enabled is None:
        mask_enabled = enabled
    true_pn = torch.ones((P, N), dtype=BOOL, device=dc.node_valid.device)
    m_nodename = F.mask_node_name(dc, db) if "NodeName" in enabled else true_pn
    m_unsched = F.mask_unschedulable(dc, db) if "NodeUnschedulable" in enabled else true_pn
    m_taints = F.mask_taints(dc, db) if "TaintToleration" in enabled else true_pn
    m_nodeaff = F.mask_node_affinity(dc, db) if "NodeAffinity" in enabled else true_pn
    mask = dc.node_valid[None, :] & db.valid[:, None]
    for name, m in (("NodeName", m_nodename), ("NodeUnschedulable", m_unsched), ("TaintToleration", m_taints),
                    ("NodeAffinity", m_nodeaff)):
        if name in mask_enabled:
            mask = mask & m
    if extra_mask is not None:
        mask = mask & extra_mask
    img = (
        S.score_image_locality(dc, db)
        if has_images
        else torch.zeros((P, N), dtype=I64, device=mask.device)
    )
    return {
        "mask": mask,
        "m_nodename": m_nodename,
        "m_unsched": m_unsched,
        "m_taints": m_taints,
        "m_nodeaff": m_nodeaff,
        "taint_raw": S.score_taint_toleration(dc, db),
        "naff_raw": S.score_node_affinity(dc, db),
        "img": img,
    }


def static_eval_args(dc: DeviceCluster, db: DeviceBatch, enabled: frozenset, has_images: bool):
    """The StaticEvalArgs of (dc, db) after the wrapper checks, with the
    output pointers left null, and the scratch tensor it points at (keep it
    alive until the launch).  K1 fills in its outputs; K10 reads the four
    static filters of each batch row through the same block."""
    dev = dc.node_valid.device
    N, K = dc.node_labels.shape
    T = dc.taint_key.shape[1]
    IMG = dc.img_sizes.shape[1]
    Sg = db.valid.shape[0]
    _, NT, NR = db.node_sel.req_key.shape
    NV = db.node_sel.req_vals.shape[-1]
    _, PT, PR = db.pref_node.req_key.shape
    PV = db.pref_node.req_vals.shape[-1]
    TL = db.tol_key.shape[1]
    I = db.img_ids.shape[1]
    c = _build.check_cuda
    a = _build.StaticEvalArgs()
    a.node_labels = c("node_labels", dc.node_labels, dev, I32, (N, K))
    a.val_ints = c("val_ints", dc.val_ints, dev, I32)
    a.taint_key = c("taint_key", dc.taint_key, dev, I32, (N, T))
    a.taint_val = c("taint_val", dc.taint_val, dev, I32, (N, T))
    a.taint_eff = c("taint_effect", dc.taint_effect, dev, I32, (N, T))
    a.unsched = c("unschedulable", dc.unschedulable, dev, BOOL, (N,))
    a.node_valid = c("node_valid", dc.node_valid, dev, BOOL, (N,))
    a.img_sizes = c("img_sizes", dc.img_sizes, dev, I64, (N, IMG))
    a.valid = c("valid", db.valid, dev, BOOL, (Sg,))
    for pre, tab, (TT, RR, VV) in (
        ("ns", db.node_sel, (NT, NR, NV)),
        ("pf", db.pref_node, (PT, PR, PV)),
    ):
        setattr(a, pre + "_key", c(pre + "_key", tab.req_key, dev, I32, (Sg, TT, RR)))
        setattr(a, pre + "_op", c(pre + "_op", tab.req_op, dev, I32, (Sg, TT, RR)))
        setattr(a, pre + "_vals", c(pre + "_vals", tab.req_vals, dev, I32, (Sg, TT, RR, VV)))
        setattr(a, pre + "_rhs", c(pre + "_rhs", tab.req_rhs, dev, I32, (Sg, TT, RR)))
        setattr(a, pre + "_tv", c(pre + "_tv", tab.term_valid, dev, BOOL, (Sg, TT)))
    a.pf_weight = c("pref_weight", db.pref_weight, dev, I32, (Sg, PT))
    a.tol_key = c("tol_key", db.tol_key, dev, I32, (Sg, TL))
    a.tol_op = c("tol_op", db.tol_op, dev, I32, (Sg, TL))
    a.tol_val = c("tol_val", db.tol_val, dev, I32, (Sg, TL))
    a.tol_eff = c("tol_effect", db.tol_effect, dev, I32, (Sg, TL))
    a.target_name = c("target_name_val", db.target_name_val, dev, I32, (Sg,))
    a.img_ids = c("img_ids", db.img_ids, dev, I32, (Sg, I))
    a.n_containers = c("n_containers", db.n_containers, dev, I32, (Sg,))
    spread = torch.empty((max(IMG, 1),), dtype=I64, device=dev)
    a.spread = spread.data_ptr()
    a.N, a.K, a.NVI, a.T, a.IMG = N, K, dc.val_ints.shape[0], T, IMG
    a.S, a.NT, a.NR, a.NV, a.PT, a.PR, a.PV, a.TL, a.I = Sg, NT, NR, NV, PT, PR, PV, TL, I
    a.name_key, a.unsched_key = dc.name_key, dc.unsched_key
    a.empty_val, a.n_valid_nodes = dc.empty_val, dc.n_valid_nodes
    a.enabled = sum(bit for name, bit in _ENABLED_BITS.items() if name in enabled)
    a.mask_enabled = a.enabled
    a.has_images = int(bool(has_images))
    return a, spread


def _static_eval_cuda(dc: DeviceCluster, db: DeviceBatch, enabled: frozenset, has_images: bool, extra_mask,
                      mask_enabled: frozenset):
    dev = dc.node_valid.device
    lib = _build.load()
    a, _spread = static_eval_args(dc, db, enabled, has_images)
    a.mask_enabled = sum(bit for name, bit in _ENABLED_BITS.items() if name in enabled and name in mask_enabled)
    if extra_mask is not None:  # null: every pair passes the host-filter lane
        a.extra = _build.check_cuda("extra_mask", extra_mask, dev, BOOL, (db.valid.shape[0], dc.node_valid.shape[0]))
    out = {}
    for k in STATIC_KEYS:
        dt = I64 if k in ("taint_raw", "naff_raw", "img") else BOOL
        out[k] = torch.empty((db.valid.shape[0], dc.node_valid.shape[0]), dtype=dt, device=dev)
        setattr(a, k, out[k].data_ptr())
    rc = lib.ktpu_static_eval(ctypes.byref(a), _build.stream_handle(dev))
    _build.check_launch(lib, rc, "static_eval")
    _build.launches["static_eval"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: sig_scan — the sequential-equivalent greedy over the pod feed
# ---------------------------------------------------------------------------


def make_sig_step(
    sig_req,
    sig_nz,
    sig_allzero,
    sig_ok,
    sig_img,
    alloc,
    allowed,
    w_fit: int,
    w_bal: int,
    w_img: int,
    check_fit: bool,
):
    """Build the plain one-pod greedy step ``(state, sig_id) -> choice`` over
    the carried node usage ``state = {used, nz0, nz1, num_pods}`` (updated
    in place).  Integer score/feasibility math is bit-identical to
    kubernetes_tpu_torch.fastpath.FastCommitter."""
    R = alloc.shape[1]
    a0 = alloc[:, LANE_CPU]
    a1 = alloc[:, LANE_MEM]
    h0 = a0 > 0
    h1 = a1 > 0
    fit_w = h0.to(I64) + h1.to(I64)
    den_bal = (a0 * a1).clamp(min=1)
    ext_lane = torch.arange(R, device=alloc.device) >= N_FIXED_LANES

    def step(state, s):
        used, nz0, nz1, num_pods = state["used"], state["nz0"], state["nz1"], state["num_pods"]
        active = s >= 0
        sc = s.clamp(min=0)
        req = sig_req[sc]  # [R]
        snz0 = sig_nz[sc, 0]
        snz1 = sig_nz[sc, 1]
        ok = sig_ok[sc]  # [N]

        if check_fit:
            fits_count = num_pods + 1 <= allowed
            avail = alloc - used
            lane_ok = (ext_lane & (req == 0))[None, :] | (req[None, :] <= avail)
            fits_lanes = sig_allzero[sc] | lane_ok.all(dim=1)
            feas = ok & fits_count & fits_lanes
        else:
            feas = ok

        total = torch.zeros_like(a0)
        if w_fit:
            c0 = nz0 + snz0
            c1 = nz1 + snz1
            f0 = torch.where(c0 > a0, 0, torch.div((a0 - c0) * MAX, a0.clamp(min=1), rounding_mode="floor"))
            f1 = torch.where(c1 > a1, 0, torch.div((a1 - c1) * MAX, a1.clamp(min=1), rounding_mode="floor"))
            least = torch.where(
                fit_w > 0,
                torch.div(
                    torch.where(h0, f0, 0) + torch.where(h1, f1, 0),
                    fit_w.clamp(min=1),
                    rounding_mode="floor",
                ),
                0,
            )
            total = total + w_fit * least
        if w_bal:
            r0 = torch.minimum(used[:, LANE_CPU] + req[LANE_CPU], a0)
            r1 = torch.minimum(used[:, LANE_MEM] + req[LANE_MEM], a1)
            d = (r0 * a1 - r1 * a0).abs()
            bal = torch.where(
                h0 & h1,
                MAX - torch.div(50 * d + den_bal - 1, den_bal, rounding_mode="floor"),
                MAX,
            )
            total = total + w_bal * bal
        if w_img:
            total = total + w_img * sig_img[sc]

        # first-max argmax over feasible nodes (torch.argmax returns the
        # first maximal index) + one-hot commit
        ranked = torch.where(feas, total, -1)
        choice = torch.argmax(ranked)
        any_feas = ranked[choice] >= 0
        choice = torch.where(active & any_feas, choice, -1)
        usage_carry_update(
            state,
            {"used": req, "nz0": snz0, "nz1": snz1, "num_pods": 1},
            choice,
            choice >= 0,
        )
        return choice

    return step


def sig_scan(
    sig_ids,  # i32 [P]   per-pod signature id, -1 pads
    sig_req,  # i64 [S, R] request row per signature
    sig_nz,  # i64 [S, 2]  non-zero-defaulted cpu,mem per signature
    sig_allzero,  # bool [S] request row entirely zero (fit check skipped)
    sig_ok,  # bool [S, N] statics-feasible, from static_eval
    sig_img,  # i64 [S, N] ImageLocality contribution (zeros when unused)
    alloc,  # i64 [N, R]
    allowed,  # i32 [N]
    used,  # i64 [N, R]   updated in place
    nz0,  # i64 [N]       updated in place
    nz1,  # i64 [N]       updated in place
    num_pods,  # i32 [N]  updated in place
    w_fit: int,
    w_bal: int,
    w_img: int,
    check_fit: bool,
):
    """One batch of the signature fast path.  The JAX root donates the usage
    buffers and returns new ones; here they are updated in place.

    Returns (choices i32 [P] — node index or -1, (used, nz0, nz1, num_pods)).
    """
    args = (sig_ids, sig_req, sig_nz, sig_allzero, sig_ok, sig_img, alloc, allowed,
            used, nz0, nz1, num_pods, w_fit, w_bal, w_img, check_fit)
    if sig_ids.device.type == "cpu":
        return sig_scan_plain(*args)
    return _sig_scan_cuda(*args)


def sig_scan_plain(sig_ids, sig_req, sig_nz, sig_allzero, sig_ok, sig_img, alloc, allowed,
                   used, nz0, nz1, num_pods, w_fit, w_bal, w_img, check_fit):
    """Plain PyTorch version of K2: a Python loop of make_sig_step with no
    host synchronisation inside the loop.  A pad id (-1) chooses nothing and
    commits nothing, so the ids are read to the host once, before the loop,
    and pad steps are skipped (resident_run's serial tail masks its resolved
    prefix to pads)."""
    step = make_sig_step(sig_req, sig_nz, sig_allzero, sig_ok, sig_img, alloc, allowed,
                         w_fit, w_bal, w_img, check_fit)
    state = {"used": used, "nz0": nz0, "nz1": nz1, "num_pods": num_pods}
    choices = torch.full_like(sig_ids, -1)
    host_ids = sig_ids.tolist()
    for p in range(sig_ids.shape[0]):
        if host_ids[p] < 0:
            continue
        choices[p] = step(state, sig_ids[p])
    return choices, (used, nz0, nz1, num_pods)


# The most dynamic shared memory K2's scan block may put the signatures'
# request rows, its trees' roots and groups in (the card's own limit
# applies below it); what does not fit stays in global memory.
SIG_TREE_SMEM_CAP = 1 << 30
# K2's last call: {"tree_smem": the parts of its scan in shared memory (0
# none, 1 the request rows, the tree list and the roots, 2 and the groups),
# "launches": the kernels it enqueued, "info": int64 [5] on the card (the
# placed pods, then the cycles summed over them in the warp that repairs the
# pod's own tree: the chosen row, the keys, the repairs, the barrier)}; read
# "info" after a synchronize.
sig_scan_stats: dict = {}


def tree_entries(N: int):
    """K2's tree over N leaves (csrc/sig_scan.cu): its 32-node groups n1 and
    the entries above the leaves, n1 + 1 with the root."""
    n1 = (max(int(N), 0) + 31) // 32
    return n1, n1 + 1


def _sig_scan_cuda(sig_ids, sig_req, sig_nz, sig_allzero, sig_ok, sig_img, alloc, allowed,
                   used, nz0, nz1, num_pods, w_fit, w_bal, w_img, check_fit):
    dev = sig_ids.device
    lib = _build.load()
    P = sig_ids.shape[0]
    Sg, R = sig_req.shape
    N = alloc.shape[0]
    c = _build.check_cuda
    a = _build.SigScanArgs()
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
    choices = torch.empty((P,), dtype=I32, device=dev)
    a.choices = choices.data_ptr()
    a.P, a.N, a.R, a.S = P, N, R, Sg
    a.w_fit, a.w_bal, a.w_img, a.check_fit = int(w_fit), int(w_bal), int(w_img), int(bool(check_fit))
    # the trees: a leaf per (signature, node), then per signature its
    # 32-node groups and its root; the scan keeps the request rows, the
    # roots and the groups in shared memory while they fit
    _, M = tree_entries(N)
    scratch = [("present", (Sg,), torch.uint8), ("sig_rows", (Sg * (R + 3),), I64), ("tree_sig", (Sg,), I32),
               ("leaves", (Sg * N,), I64), ("lv_val", (Sg * M,), I64), ("lv_idx", (Sg * M,), I32)]
    keep = [torch.empty(tuple(max(d, 1) for d in shape), dtype=dt, device=dev) for _, shape, dt in scratch]
    for (f, _, _), t in zip(scratch, keep):
        setattr(a, f, t.data_ptr())
    info = torch.zeros((5,), dtype=I64, device=dev)
    a.info = info.data_ptr()
    rc = lib.ktpu_sig_scan(ctypes.byref(a), int(min(SIG_TREE_SMEM_CAP, 2**31 - 1)), _build.stream_handle(dev))
    _build.check_launch(lib, rc, "sig_scan")
    _build.launches["sig_scan"] += 1
    sig_scan_stats.update(tree_smem=int(a.tree_smem), launches=int(a.launches), info=info)
    return choices, (used, nz0, nz1, num_pods)
