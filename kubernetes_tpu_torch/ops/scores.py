"""Raw static Score plugins → ``[P, N]`` int64 (plain PyTorch).

All score math is exact int64, like the reference's fixed-point kernels.
These are the plain versions of the score half of kernel K1
(ops/fastpath.py static_eval).
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster, eval_table
from kubernetes_tpu_torch.ops.filters import any_tolerates
from kubernetes_tpu_torch.snapshot.interner import PAD
from kubernetes_tpu_torch.snapshot.schema import EFFECT_ALL, EFFECT_PREFER_NO_SCHEDULE

I64 = torch.int64
MAX_NODE_SCORE = 100


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
