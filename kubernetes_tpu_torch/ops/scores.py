"""Score plugins → ``[P, N]`` int64, and their normalizations (plain
PyTorch).

All score math is exact int64, like the reference's fixed-point kernels:
every division is a floor division and the spread score's topology weights
are 32.32 fixed point from ``dc.log_tab``.  The static ones are the plain
versions of the score half of kernel K1 (ops/fastpath.py static_eval); the
symmetric inter-pod score is part of K7's plain version (ops/gang.py
precompute).  The normalizations and ``all_scores`` judge every pod alone
against the snapshot: the score half of the independent pipeline
(ops/pipeline.py pipeline_plain).
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster, domain_stats, eval_table, per_node_counts
from kubernetes_tpu_torch.ops.filters import InterPodPre, SpreadPre, any_tolerates
from kubernetes_tpu_torch.snapshot.interner import PAD
from kubernetes_tpu_torch.snapshot.schema import (
    EFFECT_ALL,
    EFFECT_PREFER_NO_SCHEDULE,
    LANE_CPU,
    LANE_MEM,
    TERM_PREFERRED_AFFINITY,
    TERM_PREFERRED_ANTI,
    TERM_REQUIRED_AFFINITY,
)

I32 = torch.int32
I64 = torch.int64
MAX_NODE_SCORE = 100
_FX = 32  # fixed-point fractional bits of the spread log weights
INT64_MAX = 2**63 - 1


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def default_normalize(raw, feasible, reverse: bool = False):
    """plugins/helper/normalize_score.go DefaultNormalizeScore over each
    pod's feasible set: score = 100·s/max (optionally reversed)."""
    raw = raw.to(I64)
    mx = torch.where(feasible, raw, 0).max(dim=1, keepdim=True).values
    scaled = torch.where(mx > 0, _fdiv(MAX_NODE_SCORE * raw, mx.clamp(min=1)), raw)
    if reverse:
        scaled = torch.where(mx > 0, MAX_NODE_SCORE - scaled, MAX_NODE_SCORE)
    return scaled


# ---------------------------------------------------------------------------
# NodeResourcesFit, LeastAllocated (noderesources/least_allocated.go:29-60)
# ---------------------------------------------------------------------------


def score_least_allocated(dc: DeviceCluster, db: DeviceBatch, nonzero_req=None):
    """(alloc−req)·100/alloc averaged over cpu and memory, on the non-zero
    defaulted requests (resource_allocation.go:37-115)."""
    nonzero_req = dc.nonzero_req if nonzero_req is None else nonzero_req
    alloc = torch.stack([dc.allocatable[:, LANE_CPU], dc.allocatable[:, LANE_MEM]], dim=1).to(I64)  # [N, 2]
    req = nonzero_req[None, :, :].to(I64) + db.nonzero_req[:, None, :].to(I64)  # [P, N, 2]
    frac = torch.where(req > alloc[None], 0, _fdiv((alloc[None] - req) * MAX_NODE_SCORE, alloc[None].clamp(min=1)))
    lane_ok = (alloc > 0)[None]  # [1, N, 2]
    total = torch.where(lane_ok, frac, 0).sum(dim=2)
    wsum = lane_ok.to(I64).sum(dim=2)
    return torch.where(wsum > 0, _fdiv(total, wsum.clamp(min=1)), 0)


# ---------------------------------------------------------------------------
# NodeResourcesBalancedAllocation (balanced_allocation.go:138-160)
# ---------------------------------------------------------------------------


def score_balanced_allocation(dc: DeviceCluster, db: DeviceBatch, requested=None):
    """1 − |cpu_frac − mem_frac|/2, scaled to 100, in exact int64
    rationals: 100 − ceil(50·|r0·a1 − r1·a0| / (a0·a1))."""
    requested = dc.requested if requested is None else requested
    a0 = dc.allocatable[:, LANE_CPU].to(I64)
    a1 = dc.allocatable[:, LANE_MEM].to(I64)
    r0 = requested[:, LANE_CPU].to(I64)[None] + db.requests[:, LANE_CPU].to(I64)[:, None]
    r1 = requested[:, LANE_MEM].to(I64)[None] + db.requests[:, LANE_MEM].to(I64)[:, None]
    r0 = torch.minimum(r0, a0[None])  # min(fraction, 1)
    r1 = torch.minimum(r1, a1[None])
    d = (r0 * a1[None] - r1 * a0[None]).abs()
    den = (a0 * a1).clamp(min=1)[None]
    both = ((a0 > 0) & (a1 > 0))[None]
    score = MAX_NODE_SCORE - _fdiv(50 * d + den - 1, den)
    return torch.where(both, score, MAX_NODE_SCORE)


# ---------------------------------------------------------------------------
# NodeAffinity preferred terms (nodeaffinity/node_affinity.go:239)
# ---------------------------------------------------------------------------


def score_node_affinity(dc: DeviceCluster, db: DeviceBatch):
    terms = eval_table(db.pref_node, dc.node_labels, dc.val_ints)  # [P, PT, N]
    w = db.pref_weight.to(I64)[:, :, None]
    return torch.where(terms, w, 0).sum(dim=1)


# ---------------------------------------------------------------------------
# TaintToleration (tainttoleration/taint_toleration.go:164-196)
# ---------------------------------------------------------------------------


def score_taint_toleration(dc: DeviceCluster, db: DeviceBatch):
    """Count of PreferNoSchedule taints not tolerated (tolerations filtered
    to effect ∈ {"", PreferNoSchedule}); lower is better."""
    slot_use = (db.tol_effect == EFFECT_ALL) | (
        db.tol_effect == EFFECT_PREFER_NO_SCHEDULE
    )  # [P, TL]
    tol = any_tolerates(
        db, dc.taint_key, dc.taint_val, dc.taint_effect, slot_use=slot_use
    )
    pns = (dc.taint_effect == EFFECT_PREFER_NO_SCHEDULE) & (dc.taint_key != PAD)
    return (pns[None] & ~tol).to(I64).sum(dim=-1)


# ---------------------------------------------------------------------------
# ImageLocality (imagelocality/image_locality.go:54-96)
# ---------------------------------------------------------------------------

_MB = 1024 * 1024
_MIN_THRESHOLD = 23 * _MB
_MAX_CONTAINER_THRESHOLD = 1000 * _MB


def score_image_locality(dc: DeviceCluster, db: DeviceBatch):
    """Every division here has a non-negative numerator (sizes, counts and
    clamped sums), so floor and truncation agree."""
    IMG = dc.img_sizes.shape[1]
    spread = ((dc.img_sizes > 0) & dc.node_valid[:, None]).to(I64).sum(dim=0)  # [IMG]
    total = max(dc.n_valid_nodes, 1)

    I = db.img_ids.shape[1]
    sum_scores = torch.zeros(
        (db.img_ids.shape[0], dc.img_sizes.shape[0]), dtype=I64, device=spread.device
    )
    for i in range(I):
        ii = db.img_ids[:, i]
        known = (ii >= 0) & (ii < IMG)
        safe = ii.clamp(0, IMG - 1).long()
        size = dc.img_sizes[:, safe].T  # [P, N]
        sp = spread[safe]  # [P]
        contrib = torch.div(size * sp[:, None], total, rounding_mode="floor")
        sum_scores = sum_scores + torch.where(known[:, None], contrib, 0)

    nc = db.n_containers.to(I64)[:, None]
    min_th = _MIN_THRESHOLD * nc
    max_th = _MAX_CONTAINER_THRESHOLD * nc
    clamped = torch.minimum(torch.maximum(sum_scores, min_th), max_th)
    score = torch.div(
        MAX_NODE_SCORE * (clamped - min_th),
        (max_th - min_th).clamp(min=1),
        rounding_mode="floor",
    )
    has_imgs = (db.img_ids >= 0).any(dim=1)
    return torch.where(has_imgs[:, None], score, 0)


# ---------------------------------------------------------------------------
# InterPodAffinity, symmetric half (interpodaffinity/scoring.go
# processExistingPod)
# ---------------------------------------------------------------------------


def score_interpod(dc: DeviceCluster, db: DeviceBatch, pre: InterPodPre, v_cap: int,
                   hard_pod_affinity_weight: int = 1):
    """topo_score aggregation (scoring.go:50-265): the incoming preferred
    terms (±w per matching placed pod in the node's domain) plus the
    symmetric existing-term contributions."""
    kind = db.aff_kind
    w = torch.where(
        kind == TERM_PREFERRED_AFFINITY, db.aff_weight, torch.where(kind == TERM_PREFERRED_ANTI, -db.aff_weight, 0)
    ).to(I64)  # [P, AT]
    dom_tot, _, _, _ = domain_stats(pre.inc_cnt, torch.zeros_like(pre.inc_cnt, dtype=torch.bool), pre.inc_dv, v_cap)
    topo_present = pre.inc_dv >= 0
    incoming = torch.where(topo_present, dom_tot.to(I64) * w[:, :, None], 0).sum(dim=1)  # [P, N]
    return incoming + interpod_symmetric_score(dc, pre, hard_pod_affinity_weight)


def normalize_interpod(raw, feasible):
    """scoring.go:265: [min, max] over the feasible set → [0, 100]."""
    raw = raw.to(I64)
    mn = torch.where(feasible, raw, INT64_MAX).min(dim=1, keepdim=True).values
    mx = torch.where(feasible, raw, -INT64_MAX).max(dim=1, keepdim=True).values
    diff = mx - mn
    return torch.where(diff > 0, _fdiv(MAX_NODE_SCORE * (raw - mn), diff.clamp(min=1)), 0)


# ---------------------------------------------------------------------------
# PodTopologySpread (podtopologyspread/scoring.go)
# ---------------------------------------------------------------------------


def round_fx(total_fx):
    """round-half-to-even of a 32.32 fixed-point int64 (an arithmetic
    shift, as Go's float64 round of the reference's scores)."""
    k = total_fx >> _FX
    frac = total_fx & ((1 << _FX) - 1)
    half = 1 << (_FX - 1)
    return k + ((frac > half) | ((frac == half) & ((k & 1) == 1))).to(I64)


def score_spread(dc: DeviceCluster, db: DeviceBatch, pre: SpreadPre, feasible, v_cap: int, hostname_val_key: int):
    """ScheduleAnyway constraints: Σ_c count·log(topoSize+2) + (maxSkew−1),
    in 32.32 fixed point from the host-built log table, rounded half to
    even.  Returns (raw [P, N] i64, valid [P, N] bool); valid=False marks
    ignored nodes (a soft topology key missing), which normalize to 0."""
    soft = pre.exists & ~db.tsc_hard  # [P, C]
    has_soft = soft.any(dim=1)  # [P]
    P, C, N = pre.dv.shape
    topo_present = pre.dv >= 0
    all_keys = (~soft[:, :, None] | topo_present).all(dim=1)  # [P, N]
    ignored = feasible & ~all_keys
    counted_node = feasible & ~ignored
    is_hostname = db.tsc_topo == hostname_val_key  # [P, C]

    # topoSize: distinct domains among the counted nodes (non-hostname keys)
    soft_pcn = soft[:, :, None].expand(P, C, N)
    _, _, _, n_dom = domain_stats(torch.zeros((P, C, N), dtype=I32, device=feasible.device),
                                  counted_node[:, None, :] & soft_pcn, pre.dv, v_cap)
    n_counted = counted_node.to(I32).sum(dim=1)  # [P]
    size = torch.where(is_hostname, n_counted[:, None].to(n_dom.dtype), n_dom)  # [P, C]
    w_fx = dc.log_tab[size.clamp(0, dc.log_tab.shape[0] - 1).long()]  # [P, C] i64

    # Matching-pod counts over the nodes with every soft key, eligible by the
    # inclusion policies; only domains seen among counted nodes accumulate.
    cnt_n = per_node_counts(pre.sel_match.to(I32), dc.epod_node, N)
    pair_init = counted_node[:, None, :] & soft_pcn & ~is_hostname[:, :, None]
    counting = all_keys[:, None, :] & pre.eligible
    dom_tot, dom_pres, _, _ = domain_stats(torch.where(counting, cnt_n, 0), pair_init, pre.dv, v_cap)
    # the hostname key counts per node, not per domain
    cnt = torch.where(is_hostname[:, :, None], cnt_n, torch.where(dom_pres, dom_tot, 0))

    contrib = cnt.to(I64) * w_fx[:, :, None] + ((db.tsc_max_skew.to(I64) - 1)[:, :, None] << _FX)
    total_fx = torch.where(soft[:, :, None], contrib, 0).sum(dim=1)  # [P, N]
    raw = torch.where(has_soft[:, None], round_fx(total_fx), 0)
    valid = torch.where(has_soft[:, None], ~ignored, feasible)
    return raw, valid


def normalize_spread(raw, valid, feasible):
    """scoring.go:227: 100·(max+min−s)/max over the valid nodes; invalid → 0."""
    raw = raw.to(I64)
    use = valid & feasible
    mn = torch.where(use, raw, INT64_MAX).min(dim=1, keepdim=True).values
    mx = torch.where(use, raw, -INT64_MAX).max(dim=1, keepdim=True).values
    any_valid = use.any(dim=1, keepdim=True)
    out = torch.where(mx == 0, MAX_NODE_SCORE, _fdiv(MAX_NODE_SCORE * (mx + mn - raw), mx.clamp(min=1)))
    return torch.where(use & any_valid, out, 0)


def interpod_symmetric_score(dc: DeviceCluster, pre, hard_pod_affinity_weight: int = 1):
    """[P, N] i64: existing pods' terms matching the incoming pod, credited
    to nodes sharing the term's topology value."""
    from kubernetes_tpu_torch.ops.filters import interpod_weighted_ext

    kind = dc.term_kind
    ew = torch.where(
        kind == TERM_REQUIRED_AFFINITY,
        torch.full_like(dc.term_weight, hard_pod_affinity_weight),
        torch.where(
            kind == TERM_PREFERRED_AFFINITY,
            dc.term_weight,
            torch.where(kind == TERM_PREFERRED_ANTI, -dc.term_weight, torch.zeros_like(dc.term_weight)),
        ),
    ).to(torch.int32)
    return interpod_weighted_ext(dc, pre, ew).to(I64)


# ---------------------------------------------------------------------------
# Weights (runtime/framework.go:1177-1201); the fast path's weight tuple is
# this dict's order: [0] taint, [1] naff, [4] fit, [5] bal, [6] img
# ---------------------------------------------------------------------------

DEFAULT_SCORE_WEIGHTS = {
    "TaintToleration": 3,
    "NodeAffinity": 2,
    "PodTopologySpread": 2,
    "InterPodAffinity": 2,
    "NodeResourcesFit": 1,
    "NodeResourcesBalancedAllocation": 1,
    "ImageLocality": 1,
}

WEIGHT_ORDER = tuple(DEFAULT_SCORE_WEIGHTS)


def all_scores(dc: DeviceCluster, db: DeviceBatch, feasible, ipre, spre, v_cap: int, hostname_val_key: int,
               weights=None, requested=None, nonzero_req=None, has_images: bool = True):
    """Weighted sum of the normalized plugin scores over the feasible set
    (runtime/framework.go:1177-1201).  ``ipre`` / ``spre`` may be None (the
    batch carries no such constraints): spread then normalizes to 100 on
    every feasible node and inter-pod to 0, as the oracle does.  Returns
    (total i64 [P, N], per-plugin scores)."""
    w = DEFAULT_SCORE_WEIGHTS if weights is None else weights
    total = torch.zeros(feasible.shape, dtype=I64, device=feasible.device)
    per_plugin = {}

    def acc(name, scores):
        nonlocal total
        per_plugin[name] = scores
        total = total + scores.to(I64) * w.get(name, 0)

    zeros = torch.zeros(feasible.shape, dtype=I64, device=feasible.device)
    if w.get("TaintToleration"):
        acc("TaintToleration", default_normalize(score_taint_toleration(dc, db), feasible, reverse=True))
    if w.get("NodeAffinity"):
        acc("NodeAffinity", default_normalize(score_node_affinity(dc, db), feasible))
    if w.get("PodTopologySpread"):
        if spre is not None:
            raw, valid = score_spread(dc, db, spre, feasible, v_cap, hostname_val_key)
            acc("PodTopologySpread", normalize_spread(raw, valid, feasible))
        else:
            acc("PodTopologySpread", torch.where(feasible, MAX_NODE_SCORE, 0).to(I64))
    if w.get("InterPodAffinity"):
        if ipre is not None:
            acc("InterPodAffinity", normalize_interpod(score_interpod(dc, db, ipre, v_cap), feasible))
        else:
            acc("InterPodAffinity", zeros)
    if w.get("NodeResourcesFit"):
        acc("NodeResourcesFit", score_least_allocated(dc, db, nonzero_req))
    if w.get("NodeResourcesBalancedAllocation"):
        acc("NodeResourcesBalancedAllocation", score_balanced_allocation(dc, db, requested))
    if w.get("ImageLocality"):
        acc("ImageLocality", score_image_locality(dc, db) if has_images else zeros)
    return total, per_plugin
