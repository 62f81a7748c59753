"""Batched static Filter plugins → ``[P, N]`` feasibility masks (plain
PyTorch).

Each function reproduces one in-tree Filter plugin for every (pending pod,
node) pair at once; the reference citations point at the Go plugins.  These
are the plain versions of the filter half of kernel K1 (ops/fastpath.py
static_eval) and run on the CPU path and in the kernel checks.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.ops.common import (
    DeviceBatch,
    DeviceCluster,
    dnf_any,
    eval_table,
    gather_at,
)
from kubernetes_tpu_torch.snapshot.interner import ABSENT, PAD
from kubernetes_tpu_torch.snapshot.schema import (
    EFFECT_ALL,
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    TOL_OP_EXISTS,
)


# ---------------------------------------------------------------------------
# NodeName (plugins/nodename/node_name.go)
# ---------------------------------------------------------------------------


def mask_node_name(dc: DeviceCluster, db: DeviceBatch):
    node_name_val = gather_at(dc.node_labels.T, dc.name_key)  # [N]
    tgt = db.target_name_val.unsqueeze(1)  # [P, 1]
    return (tgt == ABSENT) | (node_name_val.unsqueeze(0) == tgt)


# ---------------------------------------------------------------------------
# Taints / tolerations (plugins/tainttoleration/taint_toleration.go:103)
# ---------------------------------------------------------------------------


def any_tolerates(db: DeviceBatch, taint_key, taint_val, taint_effect, slot_use=None):
    """[P, N, T] — does any toleration of pod p tolerate taint slot t of node
    n (api/core/v1/toleration.go ToleratesTaint).

    taint_* are [N, T]; ``slot_use`` optionally restricts which toleration
    slots participate ([P, TL] bool — the PreferNoSchedule effect filter of
    the TaintToleration score).
    """
    P, TL = db.tol_key.shape
    N, T = taint_key.shape
    out = torch.zeros((P, N, T), dtype=torch.bool, device=taint_key.device)
    tk_n, tv_n, te_n = taint_key[None], taint_val[None], taint_effect[None]
    for l in range(TL):
        tk = db.tol_key[:, l][:, None, None]
        to = db.tol_op[:, l][:, None, None]
        tv = db.tol_val[:, l][:, None, None]
        te = db.tol_effect[:, l][:, None, None]
        use = db.tol_op[:, l] != PAD
        if slot_use is not None:
            use = use & slot_use[:, l]
        effect_ok = (te == EFFECT_ALL) | (te == te_n)
        wildcard = (tk == ABSENT) & (to == TOL_OP_EXISTS)
        key_eq = tk == tk_n
        val_ok = (to == TOL_OP_EXISTS) | (tv == tv_n)
        out = out | (use[:, None, None] & effect_ok & (wildcard | (key_eq & val_ok)))
    return out


def _tolerated(dc: DeviceCluster, db: DeviceBatch):
    return any_tolerates(db, dc.taint_key, dc.taint_val, dc.taint_effect)


def mask_taints(dc: DeviceCluster, db: DeviceBatch, tolerated=None):
    if tolerated is None:
        tolerated = _tolerated(dc, db)
    hard = (dc.taint_effect == EFFECT_NO_SCHEDULE) | (
        dc.taint_effect == EFFECT_NO_EXECUTE
    )
    taint_real = dc.taint_key != PAD
    untol = ((hard & taint_real)[None] & ~tolerated).any(dim=-1)
    return ~untol


# ---------------------------------------------------------------------------
# NodeUnschedulable (plugins/nodeunschedulable/node_unschedulable.go)
# ---------------------------------------------------------------------------


def mask_unschedulable(dc: DeviceCluster, db: DeviceBatch):
    """Unschedulable nodes pass only if the pod tolerates the synthetic
    node.kubernetes.io/unschedulable:NoSchedule taint."""
    dev = dc.node_valid.device
    synth_key = torch.full((1, 1), dc.unsched_key, dtype=torch.int32, device=dev)
    synth_val = torch.full((1, 1), dc.empty_val, dtype=torch.int32, device=dev)
    synth_eff = torch.full((1, 1), EFFECT_NO_SCHEDULE, dtype=torch.int32, device=dev)
    tol = any_tolerates(db, synth_key, synth_val, synth_eff)[:, 0, 0]  # [P]
    return (~dc.unschedulable)[None, :] | tol[:, None]


# ---------------------------------------------------------------------------
# NodeAffinity (plugins/nodeaffinity/node_affinity.go:182-203)
# ---------------------------------------------------------------------------


def mask_node_affinity(dc: DeviceCluster, db: DeviceBatch):
    terms = eval_table(db.node_sel, dc.node_labels, dc.val_ints)  # [P, T, N]
    return dnf_any(terms)
