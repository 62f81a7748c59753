"""Batched Filter plugins → ``[P, N]`` feasibility masks (plain PyTorch).

Each function reproduces one in-tree Filter plugin for every (pending pod,
node) pair at once; the reference citations point at the Go plugins.  The
static ones are the plain versions of the filter half of kernel K1
(ops/fastpath.py static_eval); the port, spread and inter-pod ones are the
plain halves of K6 and K7 (ops/gang.py precompute).  ``mask_resources``,
``mask_interpod``, ``mask_spread`` and ``all_masks`` judge every pod alone
against the snapshot: the filter half of the independent pipeline
(ops/pipeline.py pipeline_plain).  They run on the CPU path and in the
kernel checks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from kubernetes_tpu_torch.ops.common import (
    DeviceBatch,
    DeviceCluster,
    dnf_any,
    domain_stats,
    eval_table,
    eval_table_self,
    gather_at,
    ns_member,
    per_node_counts,
)
from kubernetes_tpu_torch.snapshot.interner import ABSENT, PAD
from kubernetes_tpu_torch.snapshot.schema import (
    EFFECT_ALL,
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    N_FIXED_LANES,
    TERM_REQUIRED_AFFINITY,
    TERM_REQUIRED_ANTI,
    TOL_OP_EXISTS,
)

I32 = torch.int32


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
# NodeResourcesFit (plugins/noderesources/fit.go:423-503)
# ---------------------------------------------------------------------------


def mask_resources(dc: DeviceCluster, db: DeviceBatch, requested=None, num_pods=None):
    """requested / num_pods default to the snapshot's.  fit.go:460
    fitsRequest: an all-zero request always fits; cpu / memory / ephemeral
    are compared unconditionally after that; an extended lane only when the
    pod requests it.  Lanes the batch has beyond the snapshot's have zero
    allocatable everywhere."""
    requested = dc.requested if requested is None else requested
    num_pods = dc.num_pods if num_pods is None else num_pods
    Rn = dc.allocatable.shape[1]
    Rp = db.requests.shape[1]
    N = dc.allocatable.shape[0]
    fits = (num_pods + 1 <= dc.allowed_pods)[None, :]
    all_zero = (db.requests == 0).all(dim=1)  # [P]
    lane_ok = None
    for r in range(Rp):
        req = db.requests[:, r][:, None]  # [P, 1]
        if r < Rn:
            avail = (dc.allocatable[:, r] - requested[:, r])[None, :]  # [1, N]
        else:
            avail = torch.zeros((1, N), dtype=I32, device=req.device)
        conflict = req > avail
        if r >= N_FIXED_LANES:
            conflict = conflict & (req > 0)  # unrequested scalars are skipped
        lane_ok = ~conflict if lane_ok is None else (lane_ok & ~conflict)
    if lane_ok is None:
        lane_ok = torch.ones((db.requests.shape[0], N), dtype=torch.bool, device=db.requests.device)
    return fits & (all_zero[:, None] | lane_ok)


# ---------------------------------------------------------------------------
# NodeAffinity (plugins/nodeaffinity/node_affinity.go:182-203)
# ---------------------------------------------------------------------------


def mask_node_affinity(dc: DeviceCluster, db: DeviceBatch):
    terms = eval_table(db.node_sel, dc.node_labels, dc.val_ints)  # [P, T, N]
    return dnf_any(terms)


# ---------------------------------------------------------------------------
# NodePorts (plugins/nodeports/node_ports.go)
# ---------------------------------------------------------------------------


def port_conflicts(want_ppk, want_ip, want_wild, used_ppk, used_ip, used_wild):
    """[A, B]: does any wanted port of row a conflict with any used port of
    row b (same proto:port, and the same host IP or either side 0.0.0.0)."""
    out = torch.zeros((want_ppk.shape[0], used_ppk.shape[0]), dtype=torch.bool, device=want_ppk.device)
    for w in range(want_ppk.shape[1]):
        wk = want_ppk[:, w][:, None]
        wi = want_ip[:, w][:, None]
        ww = want_wild[:, w][:, None]
        for u in range(used_ppk.shape[1]):
            uk = used_ppk[:, u][None, :]
            ui = used_ip[:, u][None, :]
            uw = used_wild[:, u][None, :]
            out = out | ((wk != PAD) & (uk != PAD) & (wk == uk) & ((wi == ui) | ww | uw))
    return out


def mask_ports(dc: DeviceCluster, db: DeviceBatch):
    return ~port_conflicts(db.want_ppk, db.want_ip, db.want_wild, dc.used_ppk, dc.used_ip, dc.used_wild)


# ---------------------------------------------------------------------------
# InterPodAffinity (plugins/interpodaffinity/filtering.go:306-365)
# ---------------------------------------------------------------------------


class InterPodPre(NamedTuple):
    """Precomputed inter-pod state shared by the filter and score kernels."""

    ext_match: torch.Tensor  # bool [M, P] term matches incoming pod
    ext_topo_eq: torch.Tensor  # bool [M, N] node shares term's topology value
    inc_match: torch.Tensor  # bool [P, AT, E]
    inc_dv: torch.Tensor  # i32 [P, AT, N] node's domain id per incoming term
    inc_cnt: torch.Tensor  # i32 [P, AT, N] matching placed pods per node


def interpod_precompute(dc: DeviceCluster, db: DeviceBatch) -> InterPodPre:
    # Existing terms vs incoming pods (selector on pod labels, incoming
    # namespace in the term's namespace set).
    ext_sel = eval_table(dc.term_table, db.labels, dc.val_ints)[:, 0, :]  # [M, P]
    ext_ns = ns_member(dc.term_ns_all, dc.term_ns_ids, db.ns_id)  # [M, P]
    E = dc.epod_valid.shape[0]
    tp = dc.term_pod.clamp(0, E - 1).long()
    src_valid = (dc.term_pod >= 0) & dc.epod_valid[tp]
    ext_match = ext_sel & ext_ns & src_valid[:, None]

    # The term's topology value at its own pod's node, compared to all nodes.
    node_of = torch.where(dc.term_pod >= 0, dc.epod_node[tp], ABSENT)
    cols = dc.node_labels.T  # [K, N]
    nv = gather_at(cols, dc.term_topo)  # [M, N]
    ev = torch.gather(nv, 1, node_of.clamp(0, nv.shape[1] - 1).long()[:, None])[:, 0]
    ev = torch.where(node_of >= 0, ev, ABSENT)
    ext_topo_eq = (ev >= 0)[:, None] & (nv == ev[:, None])

    # Incoming terms vs existing pods.
    inc_sel = eval_table(db.aff_table, dc.epod_labels, dc.val_ints)  # [P, AT, E]
    inc_ns = ns_member(db.aff_ns_all, db.aff_ns_ids, dc.epod_ns)  # [P, AT, E]
    inc_match = inc_sel & inc_ns & dc.epod_valid[None, None, :]
    inc_cnt = per_node_counts(inc_match.to(I32), dc.epod_node, dc.node_labels.shape[0])
    inc_dv = gather_at(cols, db.aff_topo)  # [P, AT, N]
    return InterPodPre(ext_match, ext_topo_eq, inc_match, inc_dv, inc_cnt)


def interpod_weighted_ext(dc: DeviceCluster, pre: InterPodPre, row_weight):
    """Σ over existing-term rows of row_weight · [term matches pod] · [node
    shares the term's topology value]: the shared core of the existing-anti-
    affinity filter and the symmetric score.  row_weight: i32 [M]; returns
    i32 [P, N].  The reference takes an int32 [P, M] × [M, N] product; here
    the same sum is taken in int64 (one integer matmul on the CPU; on CUDA,
    which has no integer matmul, over row chunks of at most 2**26 products)
    and wrapped to int32, which equals int32 accumulation."""
    m = pre.ext_match.to(torch.int64) * row_weight.to(torch.int64)[:, None]  # [M, P]
    eq = pre.ext_topo_eq.to(torch.int64)  # [M, N]
    if m.device.type == "cpu":
        return m.t().matmul(eq).to(I32)
    M, P = m.shape
    N = eq.shape[1]
    out = torch.zeros((P, N), dtype=torch.int64, device=m.device)
    step = max(1, (1 << 26) // max(P * N, 1))
    for lo in range(0, M, step):
        out += (m[lo : lo + step, :, None] * eq[lo : lo + step, None, :]).sum(dim=0)
    return out.to(I32)


def interpod_existing_violation(dc: DeviceCluster, pre: InterPodPre):
    """[P, N]: forbidden by some existing pod's required anti-affinity."""
    anti_row = (dc.term_kind == TERM_REQUIRED_ANTI).to(I32)
    return interpod_weighted_ext(dc, pre, anti_row) > 0


def mask_interpod(dc: DeviceCluster, db: DeviceBatch, pre: InterPodPre, v_cap: int):
    # 1. Existing pods' required anti-affinity forbids same-domain nodes.
    viol1 = interpod_existing_violation(dc, pre)  # [P, N]

    # Domain totals of matching placed pods per incoming term.
    dom_tot, _, _, _ = domain_stats(pre.inc_cnt, torch.zeros_like(pre.inc_cnt, dtype=torch.bool), pre.inc_dv, v_cap)
    topo_present = pre.inc_dv >= 0  # [P, AT, N]

    # 2. Incoming required anti-affinity: any matching placed pod in the
    #    node's domain rejects (a missing topology label passes).
    is_anti = db.aff_kind == TERM_REQUIRED_ANTI  # [P, AT]
    viol2 = (is_anti[:, :, None] & topo_present & (dom_tot > 0)).any(dim=1)

    # 3. Incoming required affinity: every term satisfied in-domain, with the
    #    first-pod-in-series escape hatch (filtering.go:336-363).
    is_aff = db.aff_kind == TERM_REQUIRED_AFFINITY
    term_ok = topo_present & (dom_tot > 0)
    aff_ok = (~is_aff[:, :, None] | term_ok).all(dim=1)  # [P, N]
    any_match_anywhere = (is_aff[:, :, None] & pre.inc_match).any(dim=2).any(dim=1)  # [P]
    # Self-match: the term's selector against the pod's own labels and namespace.
    P = db.valid.shape[0]
    self_sel = eval_table_self(db.aff_table, db.labels, dc.val_ints)  # [P, AT]
    self_ns = ns_member(db.aff_ns_all, db.aff_ns_ids, db.ns_id)  # [P, AT, P]
    self_ns = torch.diagonal(self_ns, dim1=0, dim2=2).T if P else self_ns[..., 0]
    self_all = (~is_aff | (self_sel & self_ns)).all(dim=1)
    has_aff = is_aff.any(dim=1)
    escape = has_aff & ~any_match_anywhere & self_all  # [P]

    # A node missing any required-affinity topology label is rejected before
    # the escape hatch is consulted (filtering.go: early return).
    topo_all = (~is_aff[:, :, None] | topo_present).all(dim=1)  # [P, N]
    ok3 = aff_ok | (escape[:, None] & topo_all)
    return ~viol1 & ~viol2 & ok3


# ---------------------------------------------------------------------------
# PodTopologySpread (plugins/podtopologyspread/filtering.go)
# ---------------------------------------------------------------------------


class SpreadPre(NamedTuple):
    """Shared spread-filter state (also read by the gang scan)."""

    exists: torch.Tensor  # bool [P, C] constraint slot holds a constraint
    sel_match: torch.Tensor  # bool [P, C, E] selector matches placed pod
    self_match: torch.Tensor  # bool [P, C] selector matches the pod itself
    dv: torch.Tensor  # i32 [P, C, N] domain id per node
    eligible: torch.Tensor  # bool [P, C, N] inclusion-policy eligibility
    tracked: torch.Tensor  # bool [P, N] node has all hard topo keys


def spread_precompute(dc: DeviceCluster, db: DeviceBatch, node_affinity_mask, taint_mask) -> SpreadPre:
    exists = db.tsc_topo != PAD  # [P, C]
    cols = dc.node_labels.T
    dv = gather_at(cols, db.tsc_topo)  # [P, C, N]
    topo_present = dv >= 0

    hard = exists & db.tsc_hard
    tracked = (~hard[:, :, None] | topo_present).all(dim=1)  # [P, N]

    eligible = torch.where(db.tsc_honor_affinity[:, :, None], node_affinity_mask[:, None, :], True) & torch.where(
        db.tsc_honor_taints[:, :, None], taint_mask[:, None, :], True
    )

    sel = eval_table(db.tsc_table, dc.epod_labels, dc.val_ints)  # [P, C, E]
    same_ns = db.ns_id[:, None] == dc.epod_ns[None, :]  # [P, E]
    sel_match = sel & same_ns[:, None, :] & dc.epod_valid[None, None, :] & ~dc.epod_deleting[None, None, :]
    self_match = eval_table_self(db.tsc_table, db.labels, dc.val_ints)  # [P, C]
    return SpreadPre(exists, sel_match, self_match, dv, eligible, tracked)


def mask_spread(dc: DeviceCluster, db: DeviceBatch, pre: SpreadPre, v_cap: int):
    """DoNotSchedule constraints: matchNum + selfMatch − minMatch > maxSkew
    rejects (filtering.go:313-362)."""
    hard = pre.exists & db.tsc_hard  # [P, C]
    N = pre.dv.shape[2]
    cnt_n = per_node_counts(pre.sel_match.to(I32), dc.epod_node, N)
    counted = pre.tracked[:, None, :] & pre.eligible
    cnt_n = torch.where(counted, cnt_n, 0)
    dom_tot, dom_pres, dom_min, n_dom = domain_stats(cnt_n, counted, pre.dv, v_cap)
    min_match = torch.where((db.tsc_min_domains > 0) & (n_dom < db.tsc_min_domains), 0, dom_min)  # [P, C]
    topo_present = pre.dv >= 0
    selfm = pre.self_match.to(I32)[:, :, None]
    skew = dom_tot + selfm - min_match[:, :, None]
    c_ok = topo_present & (~dom_pres | (skew <= db.tsc_max_skew[:, :, None]))
    return (~hard[:, :, None] | c_ok).all(dim=1)


# ---------------------------------------------------------------------------
# Combined
# ---------------------------------------------------------------------------


ALL_FILTER_KERNELS = frozenset(
    {
        "NodeName",
        "NodeUnschedulable",
        "TaintToleration",
        "NodeAffinity",
        "NodePorts",
        "NodeResourcesFit",
        "InterPodAffinity",
        "PodTopologySpread",
    }
)


def all_masks(dc: DeviceCluster, db: DeviceBatch, v_cap: int, has_interpod: bool = True, has_spread: bool = True,
              enabled: frozenset = ALL_FILTER_KERNELS) -> dict:
    """Every Filter plugin's mask for the batch against the snapshot, plus
    their AND (``_combined``, which also drops invalid node slots and pad
    pod rows) and the shared inter-pod / spread state (``_interpod_pre`` /
    ``_spread_pre``, None where the has_* flag or the profile drops the
    plugin: the reference's PreFilter Skip)."""
    tolerated = _tolerated(dc, db)
    node_affinity = mask_node_affinity(dc, db)
    taints = mask_taints(dc, db, tolerated)
    masks = {}
    if "NodeName" in enabled:
        masks["NodeName"] = mask_node_name(dc, db)
    if "NodeUnschedulable" in enabled:
        masks["NodeUnschedulable"] = mask_unschedulable(dc, db)
    if "TaintToleration" in enabled:
        masks["TaintToleration"] = taints
    if "NodeAffinity" in enabled:
        masks["NodeAffinity"] = node_affinity
    if "NodePorts" in enabled:
        masks["NodePorts"] = mask_ports(dc, db)
    if "NodeResourcesFit" in enabled:
        masks["NodeResourcesFit"] = mask_resources(dc, db)
    ipre = spre = None
    if has_interpod and "InterPodAffinity" in enabled:
        ipre = interpod_precompute(dc, db)
        masks["InterPodAffinity"] = mask_interpod(dc, db, ipre, v_cap)
    if has_spread and "PodTopologySpread" in enabled:
        spre = spread_precompute(dc, db, node_affinity, taints)
        masks["PodTopologySpread"] = mask_spread(dc, db, spre, v_cap)
    combined = dc.node_valid[None, :] & db.valid[:, None]
    for m in masks.values():
        combined = combined & m
    masks["_combined"] = combined
    masks["_interpod_pre"] = ipre
    masks["_spread_pre"] = spre
    return masks
