"""The gang scan: sequential-equivalent batch scheduling, one step per pod.

Port of the JAX package's ops/gang.py (its jit roots ``gang_run`` and
``gang_schedule``).  The reference schedules one pod at a time, each seeing
every earlier placement through the assume cache (schedule_one.go:65), so a
batch must reproduce that order exactly:

  * everything state-independent is computed once per batch by
    ``precompute``: the static masks and raw scores, the spread and
    inter-pod counts against the placed pods, the pod×pod match matrices
    and port conflicts (the ``GangStatics``);
  * ``gang_schedule`` walks the batch in queue order; each step evaluates
    the state-dependent pieces (resource fit, spread and inter-pod counts
    contributed by the peers already committed, score normalization over
    the live feasible set), takes the first-max argmax and commits.

Each function has a plain PyTorch version, the reference's formulas
vectorized, which the wrapper takes for CPU tensors; for CUDA tensors it
launches the hand-written kernels (csrc/) or raises:

  K1 static_eval          the static half of precompute (reused)
  K6 gang_spread_statics  the spread half of precompute
  K7 gang_interpod_statics the inter-pod half and the host-port masks
  K5 gang_scan            gang_schedule's serial scan

pod_step carries every branch of the reference's:

  * the nominated-pod charge: ``nom_node`` / ``nom_prio`` / ``nom_req``
    (optional [G] / [G] / [G, Rn]) carry preemptors whose victims are still
    terminating, charged to their nominated node for every pod of lower or
    equal priority (RunFilterPluginsWithNominatedPods,
    runtime/framework.go:973); the kernels read them as a per-node CSR
    built on the host (``nominations_csr``);
  * the host-filter lane ``extra_mask`` (the workloads route's K12 volume
    mask) and ``extra_score`` (the planner's target bonus);
  * the NodeResourcesFit strategy ``fit_strategy`` = (id, shape, (w_cpu,
    w_mem)): 0 LeastAllocated, 1 MostAllocated, 2 RequestedToCapacityRatio
    over the broken-linear ``shape`` ((utilization, score), ...);
  * the sampling window (``sample_k``, schedule_one.go:588-699): each pod's
    feasible set is cut to the first ``sample_k`` feasible nodes in visit
    order (DeviceCluster.visit_rank, util/nodetree.py) rotated by the
    carried cursor ``sample_start``, which advances by the nodes visited
    for every real pod and comes back in ``tallies["sample_start"]``;
    without a tie key, max-score ties go to the first node in that order;
  * the seeded tie-break (``tie_key`` from ops/rng.py ``prng_key``, with
    ``attempt_base``): ties among max-score nodes break by the bits of
    ``fold_in(tie_key, attempt_base + p)`` at each node's packed slot.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import fastpath as ops_fp
from kubernetes_tpu_torch.ops import filters as F
from kubernetes_tpu_torch.ops import rng
from kubernetes_tpu_torch.ops import scores as S
from kubernetes_tpu_torch.ops.common import (
    DeviceBatch,
    DeviceCluster,
    domain_stats,
    eval_table,
    eval_table_self,
    gather_at,
    ns_member,
    per_node_counts,
    usage_carry_update,
)
from kubernetes_tpu_torch.snapshot.interner import ABSENT, PAD
from kubernetes_tpu_torch.snapshot.schema import (
    LANE_CPU,
    LANE_MEM,
    N_FIXED_LANES,
    TERM_PREFERRED_AFFINITY,
    TERM_PREFERRED_ANTI,
    TERM_REQUIRED_AFFINITY,
    TERM_REQUIRED_ANTI,
    bucket_cap,
)

MAX = S.MAX_NODE_SCORE
_FX = 32  # fixed-point fractional bits of the spread log weights
I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool
INT32_MAX = 2**31 - 1
INT64_MAX = 2**63 - 1

ALL_FILTER_KERNELS = F.ALL_FILTER_KERNELS

# Diagnosis rows of the [P, N_DIAG] reason-count output, in chain order.
DIAG_KERNELS = (
    "NodeUnschedulable",
    "NodeName",
    "TaintToleration",
    "NodeAffinity",
    "NodePorts",
    "HostFilters",
    "NodeResourcesFit",
    "PodTopologySpread",
    "InterPodAffinity",
)
N_DIAG = 9
assert N_DIAG == len(DIAG_KERNELS)

# Positional weight order of the scan's `weights` tuple.
WEIGHT_ORDER = S.WEIGHT_ORDER
DEFAULT_WEIGHTS = tuple(S.DEFAULT_SCORE_WEIGHTS[n] for n in WEIGHT_ORDER)

# (strategy id, shape, per-lane weights): LeastAllocated with cpu/memory
# weight 1, as resource_allocation.go defaults
DEFAULT_FIT_STRATEGY = (0, (), (1, 1))
STRAT_MOST_ALLOCATED = 1
STRAT_RTCR = 2


class GangStatics(NamedTuple):
    """State-independent precompute for one (cluster, batch) pair."""

    static_mask: torch.Tensor  # bool [P, N]
    # spread filter (hard constraints, filtering.go:236-362)
    sp_hard: torch.Tensor  # bool [P, C]
    sp_soft: torch.Tensor  # bool [P, C]
    sp_dv: torch.Tensor  # i32 [P, C, N]
    sp_te: torch.Tensor  # bool [P, C, N] tracked & eligible (filter counting)
    sp_dom_cnt: torch.Tensor  # i32 [P, C, N] per-domain counts (existing pods)
    sp_dom_pres: torch.Tensor  # bool [P, C, N]
    sp_ndom: torch.Tensor  # i64 [P, C]
    sp_self: torch.Tensor  # bool [P, C]
    sp_bmatch: torch.Tensor  # bool [P, C, J]
    # spread score (scoring.go)
    sp_is_host: torch.Tensor  # bool [P, C]
    sp_counting: torch.Tensor  # bool [P, C, N] all-keys ∧ eligible (score gate)
    sp_node_cnt: torch.Tensor  # i32 [P, C, N] raw per-node matching counts
    sp_sc_dom: torch.Tensor  # i32 [P, C, N] score-gated per-domain counts
    sp_all_keys: torch.Tensor  # bool [P, N] node has every soft topo key
    sp_cdv: torch.Tensor  # i32 [P, C, N] compact domain ids (<0: host/absent)
    # inter-pod
    ip_dv: torch.Tensor  # i32 [P, AT, N]
    ip_dom_cnt: torch.Tensor  # i32 [P, AT, N] matching existing in node's domain
    ip_viol_existing: torch.Tensor  # bool [P, N]
    ip_sym: torch.Tensor  # i64 [P, N] symmetric score from existing terms
    ip_any_static: torch.Tensor  # bool [P]
    ip_self_all: torch.Tensor  # bool [P]
    ip_bmatch: torch.Tensor  # bool [P, AT, J]  (read [j,u,p]: p matches j's term u)
    ip_is_aff: torch.Tensor  # bool [P, AT]
    ip_is_anti: torch.Tensor  # bool [P, AT]
    ip_pref_w: torch.Tensor  # i64 [P, AT]
    ip_sym_w: torch.Tensor  # i64 [P, AT] weight of p's terms once p is placed
    ip_key_idx: torch.Tensor  # i32 [P, AT] index into ip_key_cols (<0 absent)
    ip_key_cols: torch.Tensor  # i32 [Kd2, N] node label value per distinct key
    # static raw scores
    sc_taint: torch.Tensor  # i64 [P, N]
    sc_nodeaff: torch.Tensor  # i64 [P, N]
    sc_image: torch.Tensor  # i64 [P, N]
    # batch port conflicts
    port_b: torch.Tensor  # bool [P, J]
    # per-kernel masks for failure diagnosis (all-True when disabled)
    d_nodename: torch.Tensor  # bool [P, N]
    d_unsched: torch.Tensor  # bool [P, N]
    d_taints: torch.Tensor  # bool [P, N]
    d_nodeaff: torch.Tensor  # bool [P, N]
    d_ports: torch.Tensor  # bool [P, N]
    d_extra: torch.Tensor  # bool [P, N] (host-filter lane: K12's volume mask, else all True)


def batch_tables(tsc_topo, aff_topo, node_label_vals, hostname_id: int):
    """Host-side per-batch key tables (numpy, as in the reference).

    Returns a dict of precompute/gang_schedule arguments:
      sp_keys    i32 [Kd]   distinct NON-hostname spread topology keys
      sp_cdv_tab i32 [Kd,N] per-key compact domain id per node (-1: absent)
      ip_keys    i32 [Kd2]  distinct inter-pod topology keys (incl hostname)
      d_cap      int        bucket over the max distinct-domain count
    """
    lv = np.asarray(node_label_vals)
    n_cap, K = lv.shape

    def _distinct(keys_arr, exclude_host: bool):
        out = []
        for k in np.unique(np.asarray(keys_arr).reshape(-1)):
            k = int(k)
            if k < 0 or k >= K or (exclude_host and k == hostname_id):
                continue
            out.append(k)
        return out

    sp_ids = _distinct(tsc_topo, exclude_host=True)
    d_max = 1
    rows = []
    for k in sp_ids:
        col = lv[:, k]
        cdv = np.full(n_cap, -1, np.int32)
        pos = col >= 0
        if pos.any():
            uniq, inv = np.unique(col[pos], return_inverse=True)
            cdv[pos] = inv.astype(np.int32)
            d_max = max(d_max, len(uniq))
        rows.append(cdv)
    kd = bucket_cap(max(len(sp_ids), 1), 1)
    sp_keys = np.full(kd, -1, np.int32)
    sp_keys[: len(sp_ids)] = sp_ids
    sp_cdv_tab = np.full((kd, n_cap), -1, np.int32)
    for i, r in enumerate(rows):
        sp_cdv_tab[i] = r

    ip_ids = _distinct(aff_topo, exclude_host=False)
    kd2 = bucket_cap(max(len(ip_ids), 1), 1)
    ip_keys = np.full(kd2, -1, np.int32)
    ip_keys[: len(ip_ids)] = ip_ids
    return dict(sp_keys=sp_keys, sp_cdv_tab=sp_cdv_tab, ip_keys=ip_keys, d_cap=bucket_cap(d_max, 8))


# ---------------------------------------------------------------------------
# precompute
# ---------------------------------------------------------------------------


def precompute(
    dc: DeviceCluster,
    db: DeviceBatch,
    hostname_key: int,
    v_cap: int,
    hard_pod_affinity_weight: int = 1,
    has_interpod: bool = True,
    has_spread: bool = True,
    has_ports: bool = True,
    has_images: bool = True,
    enabled: frozenset = ALL_FILTER_KERNELS,
    extra_mask=None,
    sp_keys=None,
    sp_cdv_tab=None,
    ip_keys=None,
) -> GangStatics:
    """When a has_* flag is False the matching statics have a zero-width
    constraint axis (the PreFilter Skip of the gang path).  ``enabled`` is
    the profile's Filter plugin set; ``extra_mask`` (bool [P, N], None for
    all True) is the host-filter lane, ANDed into static_mask and kept as
    ``d_extra`` for the diagnosis (the workloads route's K12 volume mask);
    sp_keys / sp_cdv_tab / ip_keys come from batch_tables() and are required
    when the matching flag is set."""
    kw = dict(
        hard_pod_affinity_weight=hard_pod_affinity_weight,
        has_interpod=has_interpod and "InterPodAffinity" in enabled,
        has_spread=has_spread and "PodTopologySpread" in enabled,
        has_ports=has_ports,
        has_images=has_images,
        enabled=enabled,
        extra_mask=extra_mask,
    )
    if kw["has_spread"] and sp_keys is None:
        # missing tables would silently zero n_dom for every non-host soft
        # constraint (a wrong topologyNormalizingWeight)
        raise ValueError("precompute: sp_keys/sp_cdv_tab (from batch_tables) are required when has_spread is set")
    if kw["has_interpod"] and ip_keys is None:
        raise ValueError("precompute: ip_keys (from batch_tables) is required when has_interpod is set")
    dev = dc.node_valid.device
    sp_keys, sp_cdv_tab, ip_keys = (
        None if t is None else torch.as_tensor(t, dtype=I32, device=dev) for t in (sp_keys, sp_cdv_tab, ip_keys)
    )
    if dev.type == "cpu":
        return precompute_plain(dc, db, hostname_key, v_cap, sp_keys=sp_keys, sp_cdv_tab=sp_cdv_tab,
                                ip_keys=ip_keys, **kw)
    return _precompute_cuda(dc, db, hostname_key, sp_keys=sp_keys, ip_keys=ip_keys, **kw)


def _interpod_weights(db: DeviceBatch, hard_pod_affinity_weight: int):
    """(is_aff, is_anti, pref_w i64, sym_w i64) of the batch's terms."""
    is_aff = db.aff_kind == TERM_REQUIRED_AFFINITY
    is_anti = db.aff_kind == TERM_REQUIRED_ANTI
    w = db.aff_weight.to(I64)
    pref_w = torch.where(
        db.aff_kind == TERM_PREFERRED_AFFINITY, w, torch.where(db.aff_kind == TERM_PREFERRED_ANTI, -w, 0)
    )
    sym_w = torch.where(is_aff, torch.full_like(pref_w, hard_pod_affinity_weight), pref_w.to(I32).to(I64))
    return is_aff, is_anti, pref_w, sym_w


def _key_index(topo, keys):
    """Index of each topology key in ``keys`` (first match), -1 if absent."""
    k_eq = (topo[..., None] == keys) & (keys >= 0)
    return torch.where(k_eq.any(dim=-1), k_eq.to(I32).argmax(dim=-1).to(I32), -1)


def _empty_spread(P, N, dev):
    z2 = torch.zeros((P, 0), dtype=BOOL, device=dev)
    z3b = torch.zeros((P, 0, N), dtype=BOOL, device=dev)
    z3i = torch.zeros((P, 0, N), dtype=I32, device=dev)
    return dict(
        sp_hard=z2, sp_soft=z2, sp_dv=z3i, sp_te=z3b, sp_dom_cnt=z3i, sp_dom_pres=z3b,
        sp_ndom=torch.zeros((P, 0), dtype=I32, device=dev), sp_self=z2,
        sp_bmatch=torch.zeros((P, 0, P), dtype=BOOL, device=dev), sp_is_host=z2, sp_counting=z3b,
        sp_node_cnt=z3i, sp_sc_dom=z3i, sp_all_keys=torch.ones((P, N), dtype=BOOL, device=dev), sp_cdv=z3i,
    )


def _empty_interpod(P, N, dev):
    return dict(
        ip_dv=torch.zeros((P, 0, N), dtype=I32, device=dev),
        ip_dom_cnt=torch.zeros((P, 0, N), dtype=I32, device=dev),
        ip_viol_existing=torch.zeros((P, N), dtype=BOOL, device=dev),
        ip_sym=torch.zeros((P, N), dtype=I64, device=dev),
        ip_any_static=torch.zeros((P,), dtype=BOOL, device=dev),
        ip_self_all=torch.ones((P,), dtype=BOOL, device=dev),
        ip_bmatch=torch.zeros((P, 0, P), dtype=BOOL, device=dev),
        ip_is_aff=torch.zeros((P, 0), dtype=BOOL, device=dev),
        ip_is_anti=torch.zeros((P, 0), dtype=BOOL, device=dev),
        ip_pref_w=torch.zeros((P, 0), dtype=I64, device=dev),
        ip_sym_w=torch.zeros((P, 0), dtype=I64, device=dev),
        ip_key_idx=torch.zeros((P, 0), dtype=I32, device=dev),
        ip_key_cols=torch.full((1, N), ABSENT, dtype=I32, device=dev),
    )


def spread_statics_plain(dc, db, node_affinity, taints, hostname_key, v_cap, sp_keys, sp_cdv_tab) -> dict:
    """Plain version of K6: the spread half of precompute (filtering.go /
    scoring.go), given the unconditional node-affinity and taint masks."""
    N = dc.node_valid.shape[0]
    spre = F.spread_precompute(dc, db, node_affinity, taints)
    cnt_n = per_node_counts(spre.sel_match.to(I32), dc.epod_node, N)
    te = spre.tracked[:, None, :] & spre.eligible
    dom_tot, dom_pres, _, n_dom = domain_stats(torch.where(te, cnt_n, 0), te, spre.dv, v_cap)
    soft = spre.exists & ~db.tsc_hard
    topo_present = spre.dv >= 0
    all_keys = (~soft[:, :, None] | topo_present).all(dim=1)  # [P, N]
    counting = all_keys[:, None, :] & spre.eligible
    sc_dom, _, _, _ = domain_stats(torch.where(counting, cnt_n, 0), counting, spre.dv, v_cap)
    b_sel = eval_table(db.tsc_table, db.labels, dc.val_ints)  # [P, C, J]
    same_ns = db.ns_id[:, None] == db.ns_id[None, :]
    ki = _key_index(db.tsc_topo, sp_keys)  # [P, C]
    sp_cdv = torch.where((ki >= 0)[..., None], sp_cdv_tab[ki.clamp(min=0).long()], -1)
    return dict(
        sp_hard=spre.exists & db.tsc_hard,
        sp_soft=soft,
        sp_dv=spre.dv,
        sp_te=te,
        sp_dom_cnt=torch.where(dom_pres, dom_tot, 0),
        sp_dom_pres=dom_pres,
        sp_ndom=n_dom,
        sp_self=spre.self_match,
        sp_bmatch=b_sel & same_ns[:, None, :] & db.valid[None, None, :],
        sp_is_host=db.tsc_topo == hostname_key,
        sp_counting=counting,
        sp_node_cnt=cnt_n,
        sp_sc_dom=torch.where(spre.dv >= 0, sc_dom, 0),
        sp_all_keys=all_keys,
        sp_cdv=sp_cdv.to(I32),
    )


def interpod_statics_plain(dc, db, v_cap, ip_keys, hard_pod_affinity_weight: int = 1) -> dict:
    """Plain version of K7's inter-pod half: interpod_precompute, the
    existing-term violation and symmetric score, the per-domain incoming
    counts and the batch matches (filtering.go:306-365, scoring.go)."""
    P = db.valid.shape[0]
    ipre = F.interpod_precompute(dc, db)
    ip_dom_cnt, _, _, _ = domain_stats(ipre.inc_cnt, torch.zeros_like(ipre.inc_cnt, dtype=BOOL), ipre.inc_dv, v_cap)
    is_aff, is_anti, pref_w, sym_w = _interpod_weights(db, hard_pod_affinity_weight)
    self_sel = eval_table_self(db.aff_table, db.labels, dc.val_ints)  # [P, AT]
    self_ns = ns_member(db.aff_ns_all, db.aff_ns_ids, db.ns_id)  # [P, AT, P]
    self_ns = torch.diagonal(self_ns, dim1=0, dim2=2).T if P else self_ns[..., 0]
    b_aff = eval_table(db.aff_table, db.labels, dc.val_ints) & ns_member(db.aff_ns_all, db.aff_ns_ids, db.ns_id)
    return dict(
        ip_dv=ipre.inc_dv,
        ip_dom_cnt=torch.where(ipre.inc_dv >= 0, ip_dom_cnt, 0),
        ip_viol_existing=F.interpod_existing_violation(dc, ipre),
        ip_sym=S.interpod_symmetric_score(dc, ipre, hard_pod_affinity_weight),
        ip_any_static=(is_aff[:, :, None] & ipre.inc_match).any(dim=2).any(dim=1),
        ip_self_all=(~is_aff | (self_sel & self_ns)).all(dim=1),
        ip_bmatch=b_aff & db.valid[None, None, :],
        ip_is_aff=is_aff,
        ip_is_anti=is_anti,
        ip_pref_w=pref_w,
        ip_sym_w=sym_w,
        ip_key_idx=_key_index(db.aff_topo, ip_keys),
        ip_key_cols=gather_at(dc.node_labels.T, ip_keys),
    )


def port_masks_plain(dc, db):
    """Plain version of K7's port half: (d_ports [P, N], port_b [P, P])."""
    return F.mask_ports(dc, db), F.port_conflicts(db.want_ppk, db.want_ip, db.want_wild, db.want_ppk, db.want_ip,
                                                  db.want_wild)


def precompute_plain(dc, db, hostname_key, v_cap, *, hard_pod_affinity_weight, has_interpod, has_spread,
                     has_ports, has_images, enabled, sp_keys, sp_cdv_tab, ip_keys, extra_mask=None) -> GangStatics:
    """Plain PyTorch version of precompute: the reference's formulas."""
    P = db.valid.shape[0]
    N = dc.node_valid.shape[0]
    dev = dc.node_valid.device
    tolerated = F._tolerated(dc, db)
    node_affinity = F.mask_node_affinity(dc, db)
    taints = F.mask_taints(dc, db, tolerated)
    true_pn = torch.ones((P, N), dtype=BOOL, device=dev)
    d_nodename = F.mask_node_name(dc, db) if "NodeName" in enabled else true_pn
    d_unsched = F.mask_unschedulable(dc, db) if "NodeUnschedulable" in enabled else true_pn
    d_taints = taints if "TaintToleration" in enabled else true_pn
    d_nodeaff = node_affinity if "NodeAffinity" in enabled else true_pn
    d_ports, port_b = port_masks_plain(dc, db)
    if "NodePorts" not in enabled:
        d_ports = true_pn
    if not has_ports:
        port_b = torch.zeros((P, 0), dtype=BOOL, device=dev)
    d_extra = extra_mask if extra_mask is not None else true_pn
    static_mask = (dc.node_valid[None, :] & db.valid[:, None] & d_extra & d_nodename & d_unsched & d_taints
                   & d_nodeaff & d_ports)
    if has_spread:
        sp = spread_statics_plain(dc, db, node_affinity, taints, hostname_key, v_cap, sp_keys, sp_cdv_tab)
    else:
        sp = _empty_spread(P, N, dev)
    if has_interpod:
        ip = interpod_statics_plain(dc, db, v_cap, ip_keys, hard_pod_affinity_weight)
    else:
        ip = _empty_interpod(P, N, dev)
    sc_image = S.score_image_locality(dc, db) if has_images else torch.zeros((P, N), dtype=I64, device=dev)
    return GangStatics(
        static_mask=static_mask,
        **sp,
        **ip,
        sc_taint=S.score_taint_toleration(dc, db),
        sc_nodeaff=S.score_node_affinity(dc, db),
        sc_image=sc_image,
        port_b=port_b,
        d_nodename=d_nodename,
        d_unsched=d_unsched,
        d_taints=d_taints,
        d_nodeaff=d_nodeaff,
        d_ports=d_ports,
        d_extra=d_extra,
    )


# ---------------------------------------------------------------------------
# Per-step helpers (single pod, [N]-wide)
# ---------------------------------------------------------------------------


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _norm_default(raw, feas, reverse=False):
    raw = raw.to(I64)
    mx = torch.where(feas, raw, 0).max()
    out = torch.where(mx > 0, _fdiv(MAX * raw, mx.clamp(min=1)), raw)
    if reverse:
        out = torch.where(mx > 0, MAX - out, MAX)
    return out


def _norm_minmax(raw, feas):
    raw = raw.to(I64)
    mn = torch.where(feas, raw, INT64_MAX).min()
    mx = torch.where(feas, raw, -INT64_MAX).max()
    diff = mx - mn
    return torch.where(diff > 0, _fdiv(MAX * (raw - mn), diff.clamp(min=1)), 0)


def _norm_spread(raw, valid, feas):
    raw = raw.to(I64)
    use = valid & feas
    mn = torch.where(use, raw, INT64_MAX).min()
    mx = torch.where(use, raw, -INT64_MAX).max()
    out = torch.where(mx == 0, MAX, _fdiv(MAX * (mx + mn - raw), mx.clamp(min=1)))
    return torch.where(use & use.any(), out, 0)


class SpreadDyn(NamedTuple):
    """Batch-peer contributions to pod p's spread counts (all [C, N] i32)."""

    dyn_f: torch.Tensor  # filter-side counts (bm ∧ te-at-peer ∧ same-domain)
    dyn_host: torch.Tensor  # score-side per-node counts (bm only)
    dyn_dom: torch.Tensor  # score-side domain counts (bm ∧ counting-at-peer)


class InterpodDyn(NamedTuple):
    """Batch-peer contributions to pod p's inter-pod state."""

    ip_dyn: torch.Tensor  # i32 [AT, N] incoming matches per term domain
    viol_b: torch.Tensor  # bool [N] anti-affinity of committed peers' terms
    sym_b: torch.Tensor  # i64 [N] symmetric score from committed peers' terms
    any_dyn: torch.Tensor  # bool [] any committed peer matches an aff term


def spread_constraints(db: DeviceBatch, g: GangStatics, p: int, sd: SpreadDyn):
    """Filter verdict + score counts for pod p's spread constraints given
    the batch-peer contributions.  Returns (m_spread [N], sp_cnt [C, N],
    c_ok [C, N])."""
    total = g.sp_dom_cnt[p] + sd.dyn_f  # [C, N]
    min_match = torch.where(g.sp_te[p], total, INT32_MAX).min(dim=1).values
    md = db.tsc_min_domains[p]
    min_match = torch.where((md > 0) & (g.sp_ndom[p] < md), 0, min_match)
    skew = total + g.sp_self[p].to(I32)[:, None] - min_match[:, None]
    c_ok = (g.sp_dv[p] >= 0) & (~g.sp_dom_pres[p] | (skew <= db.tsc_max_skew[p][:, None]))
    m_spread = (~g.sp_hard[p][:, None] | c_ok).all(dim=0)
    sp_cnt = torch.where(g.sp_is_host[p][:, None], g.sp_node_cnt[p] + sd.dyn_host, g.sp_sc_dom[p] + sd.dyn_dom)
    return m_spread, sp_cnt, c_ok


def interpod_constraints(g: GangStatics, p: int, idyn: InterpodDyn):
    """Filter verdict + raw score for pod p's inter-pod terms given the
    batch-peer contributions.  Returns (m_interpod [N], ip_raw [N],
    anti_viol [AT, N])."""
    ip_total = g.ip_dom_cnt[p] + idyn.ip_dyn  # [AT, N]
    topo_present = g.ip_dv[p] >= 0
    anti_viol = g.ip_is_anti[p][:, None] & topo_present & (ip_total > 0)
    viol2 = anti_viol.any(dim=0)
    aff_ok = (~g.ip_is_aff[p][:, None] | (topo_present & (ip_total > 0))).all(dim=0)
    any_match = g.ip_any_static[p] | idyn.any_dyn
    topo_all = (~g.ip_is_aff[p][:, None] | topo_present).all(dim=0)
    escape = g.ip_is_aff[p].any() & ~any_match & g.ip_self_all[p]
    ok3 = aff_ok | (escape & topo_all)
    m_interpod = ~g.ip_viol_existing[p] & ~viol2 & ok3 & ~idyn.viol_b
    pref = torch.where(topo_present, ip_total.to(I64) * g.ip_pref_w[p][:, None], 0).sum(dim=0)
    ip_raw = g.ip_sym[p] + pref + idyn.sym_b.to(I64)
    return m_interpod, ip_raw, anti_viol


def _spread_raw(dc, db, g, p, feas, cnt, d_cap):
    """ScheduleAnyway scoring for one pod (podtopologyspread/scoring.go) in
    32.32 fixed point, given the per-constraint count rows ``cnt`` [C, N].
    Returns (raw [N] i64, valid [N] bool)."""
    soft = g.sp_soft[p]  # [C]
    has_soft = soft.any()
    ignored = feas & ~g.sp_all_keys[p]
    counted = feas & g.sp_all_keys[p]
    n_counted = counted.to(I32).sum()

    cdv = g.sp_cdv[p]  # [C, N]
    dom_hit = (cdv[:, :, None] == torch.arange(d_cap, dtype=I32, device=cdv.device)) & counted[None, :, None]
    n_dom = dom_hit.any(dim=1).to(I32).sum(dim=1)  # [C]
    size = torch.where(g.sp_is_host[p], n_counted, n_dom)
    w_fx = dc.log_tab[size.clamp(0, dc.log_tab.shape[0] - 1).long()]  # [C] i64

    contrib_fx = cnt.to(I64) * w_fx[:, None] + ((db.tsc_max_skew[p].to(I64) - 1)[:, None] << _FX)
    total_fx = torch.where(soft[:, None], contrib_fx, 0).sum(dim=0)  # [N]
    raw = torch.where(has_soft, S.round_fx(total_fx), 0)
    valid = torch.where(has_soft, ~ignored, feas)
    return raw, valid


def nominated_charge(nom, priority, N: int, Rn: int, dev):
    """(count [N], request delta [N, Rn]) of the nominations whose priority
    is >= ``priority``, per node; ``nom`` is (one-hot [G, N], prio [G],
    req [G, Rn]) or None."""
    if nom is None:
        return 0, 0
    oh, prio, req = nom
    gate = (prio >= priority).to(I64)  # [G]
    cnt = (gate[:, None] * oh).sum(dim=0)  # [N]
    delta = ((req.to(I64) * gate[:, None])[:, None, :] * oh[:, :, None]).sum(dim=0)  # [N, Rn]
    return cnt.to(I32), delta.to(I32)


def nominations_onehot(nom_node, nom_prio, nom_req, N: int):
    """The plain versions' form of the nominations: (one-hot [G, N] i64,
    prio, req), or None without nominations (rows with node < 0 match no
    node)."""
    if nom_node is None:
        return None
    oh = (nom_node.long()[:, None] == torch.arange(N, device=nom_node.device)[None, :]).to(I64)
    return oh, nom_prio, nom_req


def nominations_csr(nom_node, nom_prio, nom_req, N: int, dev):
    """The kernels' form of the nominations, built on the host: rows
    grouped by node (a stable sort, so node order keeps the input order),
    ``off`` [N + 1] i32 their offsets, ``prio`` [G] i32, ``req`` [G, Rn]
    i32.  Rows with node < 0 never enter it.  None without nominations."""
    if nom_node is None:
        return None
    node = nom_node.cpu().numpy().astype(np.int64)
    keep = np.nonzero((node >= 0) & (node < N))[0]
    order = keep[np.argsort(node[keep], kind="stable")]
    off = np.zeros(N + 1, np.int32)
    np.cumsum(np.bincount(node[order], minlength=N), out=off[1:])
    prio = nom_prio.cpu().numpy().astype(np.int32)[order]
    req = nom_req.cpu().numpy().astype(np.int32)[order]
    if not len(order):  # keep one row so every pointer is valid
        prio = np.zeros(1, np.int32)
        req = np.zeros((1, nom_req.shape[1]), np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (off, prio, req))


def broken_linear_dev(points: tuple, x):
    """BuildBrokenLinearFunction (helper/shape_score.go:40) over an integer
    tensor; ``points`` is ((utilization, score), ...), divisions truncating
    as Go's."""
    out = torch.full_like(x, points[0][1])
    for (x0, y0), (x1, y1) in zip(points, points[1:]):
        seg = y0 + torch.div((y1 - y0) * (x - x0), x1 - x0, rounding_mode="trunc")
        out = torch.where((x > x0) & (x <= x1), seg, out)
    return torch.where(x > points[-1][0], points[-1][1], out)


def fit_score(fit_strategy: tuple, nz, alloc2):
    """NodeResourcesFit's score under ``fit_strategy`` on the non-zero-
    defaulted requests ``nz`` [N, 2] against allocatable ``alloc2`` [N, 2]
    (resource_allocation.go:37-115): LeastAllocated, MostAllocated, or
    RequestedToCapacityRatio, whose weighted mean counts only the lanes with
    a positive score and rounds (requested_to_capacity_ratio.go:46-52)."""
    strat_id, shape, w = fit_strategy
    lane_has = alloc2 > 0
    den = alloc2.clamp(min=1)
    if strat_id == STRAT_MOST_ALLOCATED:
        frac = torch.where(nz > alloc2, 0, _fdiv(nz * MAX, den))
    elif strat_id == STRAT_RTCR:
        util = torch.where(~lane_has | (nz > alloc2), MAX, _fdiv(nz * MAX, den))
        frac = broken_linear_dev(shape, util)
    else:
        frac = torch.where(nz > alloc2, 0, _fdiv((alloc2 - nz) * MAX, den))
    w2 = torch.tensor(w, dtype=I64, device=nz.device)[None, :]
    use = lane_has & (frac > 0) if strat_id == STRAT_RTCR else lane_has
    wsum = torch.where(use, w2, 0).sum(dim=1)
    total = torch.where(use, frac * w2, 0).sum(dim=1)
    if strat_id == STRAT_RTCR:  # math.Round of the weighted mean
        return torch.where(wsum > 0, _fdiv(2 * total + wsum, (2 * wsum).clamp(min=1)), 0)
    return torch.where(wsum > 0, _fdiv(total, wsum.clamp(min=1)), 0)


def sampling_window(dc, feas, start, sample_k: int):
    """The sampling cut of one pod's feasible set: keep the first
    ``sample_k`` feasible nodes in visit order from the cursor ``start``.
    Returns (feas cut, rank [N] each node's place in that rotation (N for
    rows without a visit rank), processed: the nodes visited)."""
    N = feas.shape[0]
    nv = max(int(dc.n_valid_nodes), 1)
    vr = dc.visit_rank.long()
    valid_vr = vr >= 0
    rank = torch.where(valid_vr, torch.remainder(vr - start, nv), N)
    rot = torch.zeros((N + 1,), dtype=BOOL, device=feas.device)
    rot[rank[valid_vr]] = feas[valid_vr]
    cum = rot[:N].to(I64).cumsum(0)
    keep = torch.cat([rot[:N] & (cum <= sample_k), torch.zeros((1,), dtype=BOOL, device=feas.device)])
    total = cum[N - 1] if N else torch.zeros((), dtype=I64)
    processed = torch.where(total >= sample_k, (cum < sample_k).sum() + 1, nv)
    return keep[rank] & feas, rank, processed


def pod_step(dc, db, g: GangStatics, p: int, state, hv, *, check_fit: bool, weights: tuple, d_cap: int,
             commit: bool = True, nom=None, extra_score=None, fit_strategy: tuple = DEFAULT_FIT_STRATEGY,
             sample_k=None, tie_key=None, attempt_base: int = 0):
    """One pod's Filter → Score → Select → commit against ``state``
    (requested [N, Rn] / nonzero [N, 2] / num_pods [N], plus sample_start
    [] with ``sample_k``; updated in place), as the reference's pod_step.
    ``nom`` (``nominations_onehot``) charges the open nominations of
    priority >= the pod's to their nodes in the resource fit.
    ``extra_score`` (i64 [P, N], or None) adds its row to every node's
    total.  ``fit_strategy``, ``sample_k`` and ``tie_key`` /
    ``attempt_base`` select the branches of the module docstring.  With
    ``commit=False`` the state is left untouched (the wave's speculation
    evaluates without placing).  Returns (choice, n_feas, reason_counts)."""
    N = g.static_mask.shape[1]
    Rn = dc.allocatable.shape[1]
    Rp = db.requests.shape[1]
    C = g.sp_dv.shape[1]
    dev = g.static_mask.device
    true_n = torch.ones((N,), dtype=BOOL, device=dev)

    req = db.requests[p]  # [Rp]
    mask = g.static_mask[p] & hv["m_portb"]
    m_fit = true_n
    if check_fit:
        nom_cnt, nom_delta = nominated_charge(nom, db.priority[p], N, Rn, dev)
        fits = state["num_pods"] + nom_cnt + 1 <= dc.allowed_pods
        all_zero = (req == 0).all()
        avail = dc.allocatable - state["requested"] - nom_delta  # [N, Rn]
        if Rp > Rn:
            avail = torch.cat([avail, torch.zeros((N, Rp - Rn), dtype=I32, device=dev)], dim=1)
        conflict = req[None, :] > avail[:, :Rp]
        scalar_lane = torch.arange(Rp, device=dev) >= N_FIXED_LANES
        conflict = conflict & (~scalar_lane | (req > 0))[None, :]
        m_fit = fits & (all_zero | ~conflict.any(dim=1))
        mask = mask & m_fit
    m_portb, m_spread, m_interpod = hv["m_portb"], hv["m_spread"], hv["m_interpod"]
    feas = mask & m_spread & m_interpod
    if sample_k is not None:
        feas, rank, processed = sampling_window(dc, feas, state["sample_start"], int(sample_k))
    n_feas = feas.to(I32).sum()

    # first-failure reason counts in the filter chain's order
    remaining = dc.node_valid & db.valid[p]
    rc = []
    for comp in (g.d_unsched[p], g.d_nodename[p], g.d_taints[p], g.d_nodeaff[p], g.d_ports[p] & m_portb,
                 g.d_extra[p], m_fit, m_spread, m_interpod):
        rc.append((remaining & ~comp).to(I64).sum())
        remaining = remaining & comp
    reason_counts = torch.stack(rc)

    # NodeResourcesFit on the non-zero-defaulted requests, BalancedAllocation
    # on the real requests (resource_allocation.go, balanced_allocation.go)
    nz = state["nonzero"].to(I64) + db.nonzero_req[p][None, :].to(I64)  # [N, 2]
    alloc2 = torch.stack([dc.allocatable[:, LANE_CPU], dc.allocatable[:, LANE_MEM]], dim=1).to(I64)
    least = fit_score(fit_strategy, nz, alloc2)
    a0 = dc.allocatable[:, LANE_CPU].to(I64)
    a1 = dc.allocatable[:, LANE_MEM].to(I64)
    r0 = torch.minimum(state["requested"][:, LANE_CPU].to(I64) + db.requests[p, LANE_CPU].to(I64), a0)
    r1 = torch.minimum(state["requested"][:, LANE_MEM].to(I64) + db.requests[p, LANE_MEM].to(I64), a1)
    d = (r0 * a1 - r1 * a0).abs()
    den = (a0 * a1).clamp(min=1)
    balanced = torch.where((a0 > 0) & (a1 > 0), MAX - _fdiv(50 * d + den - 1, den), MAX)

    ip_raw = hv["ip_raw"]
    if C:
        sp_raw, sp_valid = _spread_raw(dc, db, g, p, feas, hv["sp_cnt"], d_cap)
    else:
        sp_raw = torch.zeros((N,), dtype=I64, device=dev)
        sp_valid = feas

    w_taint, w_naff, w_spread, w_ip, w_fit, w_bal, w_img = weights
    total = torch.zeros((N,), dtype=I64, device=dev)
    if w_taint:
        total += w_taint * _norm_default(g.sc_taint[p], feas, reverse=True)
    if w_naff:
        total += w_naff * _norm_default(g.sc_nodeaff[p], feas)
    if w_spread:
        total += w_spread * _norm_spread(sp_raw, sp_valid, feas)
    if w_ip:
        total += w_ip * _norm_minmax(ip_raw, feas)
    if w_fit:
        total += w_fit * least
    if w_bal:
        total += w_bal * balanced
    if w_img:
        total += w_img * g.sc_image[p]
    if extra_score is not None:
        total += extra_score[p]

    neg = -INT64_MAX - 1
    if tie_key is not None:
        # seeded uniform tie-break: the (score, bits) lexicographic argmax
        h = rng.bits(rng.fold_in(tie_key, int(attempt_base) + p), N, dev)
        choice = torch.argmax(torch.where(feas, total * (1 << 33) + h, neg))
    elif sample_k is not None:
        # compat first-max: the first max-score node in visit order
        ranked = torch.where(feas, total, neg)
        choice = torch.argmin(torch.where(feas & (ranked == ranked.max()), rank, N + 1))
    else:
        # first-max argmax over the feasible nodes (ties to the lower index)
        choice = torch.argmax(torch.where(feas, total, neg))
    choice = torch.where(n_feas > 0, choice.to(I32), ABSENT)
    if not commit:
        return choice, n_feas, reason_counts
    usage_carry_update(
        {k: state[k] for k in ("requested", "nonzero", "num_pods")},
        {"requested": db.requests[p][:Rn], "nonzero": db.nonzero_req[p], "num_pods": 1},
        choice,
        choice >= 0,
    )
    if sample_k is not None:
        # nextStartNodeIndex advances by the nodes visited, for real pods
        # only (schedule_one.go:625)
        nv = max(int(dc.n_valid_nodes), 1)
        state["sample_start"] = torch.where(db.valid[p], torch.remainder(state["sample_start"] + processed, nv),
                                            state["sample_start"]).to(I32)
    return choice, n_feas, reason_counts


def _heavy_parts(db, g: GangStatics, p: int, assigned):
    """The state-dependent tensors of pod p's step from the committed batch
    peers (``assigned`` [P] node index or -1), as the reference contracts
    them: dense [C, N, J] / [AT, N, J] compares against the peers' nodes."""
    P, N = g.static_mask.shape
    C = g.sp_dv.shape[1]
    AT = g.ip_dv.shape[1]
    dev = g.static_mask.device
    true_n = torch.ones((N,), dtype=BOOL, device=dev)
    av = assigned >= 0  # [J]
    a_clip = assigned.clamp(0, N - 1).long()
    eqJ = (a_clip[:, None] == torch.arange(N, device=dev)[None, :]) & av[:, None]  # [J, N]

    m_portb = true_n
    if g.port_b.shape[1]:
        m_portb = ~(g.port_b[p][:, None] & eqJ).any(dim=0)

    if C:
        dv = g.sp_dv[p]  # [C, N]
        dv_at = torch.where(av[None, :], dv[:, a_clip], 0)  # [C, J] (gated by bm below)
        te_at = g.sp_te[p][:, a_clip] & av[None, :]
        bm = g.sp_bmatch[p] & av[None, :]
        eq_dom = (dv[:, :, None] >= 0) & (dv_at[:, None, :] >= 0) & (dv[:, :, None] == dv_at[:, None, :])
        dyn_f = (eq_dom & (bm & te_at)[:, None, :]).to(I32).sum(dim=2)
        dyn_host = (bm[:, :, None] & eqJ[None, :, :]).to(I32).sum(dim=1)
        cg_at = g.sp_counting[p][:, a_clip] & av[None, :]
        dyn_dom = (eq_dom & (bm & cg_at)[:, None, :]).to(I32).sum(dim=2)
        m_spread, sp_cnt, _ = spread_constraints(db, g, p, SpreadDyn(dyn_f, dyn_host, dyn_dom))
    else:
        m_spread = true_n
        sp_cnt = torch.zeros((C, N), dtype=I32, device=dev)

    if AT:
        ip_dv = g.ip_dv[p]  # [AT, N]
        ip_dv_at = torch.where(av[None, :], ip_dv[:, a_clip], 0)
        ip_eq = (ip_dv[:, :, None] >= 0) & (ip_dv_at[:, None, :] >= 0) & (ip_dv[:, :, None] == ip_dv_at[:, None, :])
        ip_bm = g.ip_bmatch[p] & av[None, :]  # [AT, J]
        ip_dyn = (ip_eq & ip_bm[:, None, :]).to(I32).sum(dim=2)
        any_dyn = (g.ip_is_aff[p][:, None] & ip_bm).any()

        # the committed peers' own terms vs p, factored by distinct key
        Kd2 = g.ip_key_cols.shape[0]
        m_jp = g.ip_bmatch[:, :, p] & av[:, None]  # [J, AT]
        ki = g.ip_key_idx  # [J, AT]
        ki_clip = ki.clamp(0, Kd2 - 1).long()
        dv_ju = torch.where(av[:, None], g.ip_key_cols[ki_clip, a_clip[:, None]], ABSENT)  # [J, AT]
        term_live = m_jp & (ki >= 0) & (dv_ju >= 0)
        g_anti = (term_live & g.ip_is_anti).reshape(-1)
        w_sym = torch.where(term_live, g.ip_sym_w, 0).to(I32).reshape(-1)
        ki_f = ki_clip.reshape(-1)
        live_f = (ki >= 0).reshape(-1)
        dvf = dv_ju.reshape(-1)
        viol_b = torch.zeros((N,), dtype=BOOL, device=dev)
        sym_b = torch.zeros((N,), dtype=I32, device=dev)
        for k in range(Kd2):
            in_k = live_f & (ki_f == k)
            col = g.ip_key_cols[k]
            eqk = (dvf[:, None] == col[None, :]) & (col >= 0)[None, :]  # [J·AT, N]
            viol_b = viol_b | ((g_anti & in_k)[:, None] & eqk).any(dim=0)
            sym_b = sym_b + (torch.where(in_k, w_sym, 0)[:, None].to(I64) * eqk.to(I64)).sum(dim=0).to(I32)
        m_interpod, ip_raw, _ = interpod_constraints(g, p, InterpodDyn(ip_dyn, viol_b, sym_b.to(I64), any_dyn))
    else:
        m_interpod = true_n
        ip_raw = g.ip_sym[p]
    return dict(m_portb=m_portb, m_spread=m_spread, sp_cnt=sp_cnt, m_interpod=m_interpod, ip_raw=ip_raw)


# ---------------------------------------------------------------------------
# gang_schedule / gang_run
# ---------------------------------------------------------------------------


def gang_schedule(
    dc: DeviceCluster,
    db: DeviceBatch,
    g: GangStatics,
    v_cap: int,
    weights: tuple = DEFAULT_WEIGHTS,
    check_fit: bool = True,
    d_cap: int = 8,
    nom_node=None,
    nom_prio=None,
    nom_req=None,
    fit_strategy: tuple = DEFAULT_FIT_STRATEGY,
    sample_k=None,
    sample_start=None,
    tie_key=None,
    attempt_base=None,
):
    """Scan the batch in order; each pod sees every earlier in-batch
    placement and the open nominations of priority >= its own (``nom_*``,
    see the module docstring).  ``fit_strategy``, ``sample_k`` /
    ``sample_start`` and ``tie_key`` / ``attempt_base`` select the step's
    branches (module docstring).  The cluster's usage rows are read, not
    written: the carried usage starts as copies and comes back in the
    tallies.

    Returns (chosen i32 [P] node index or -1, n_feas i64 [P], reason_counts
    i64 [P, N_DIAG], tallies {requested, nonzero, num_pods, and
    sample_start with sample_k})."""
    mode = step_mode(fit_strategy, sample_k, sample_start, tie_key, attempt_base)
    if dc.node_valid.device.type == "cpu":
        return gang_schedule_plain(dc, db, g, v_cap, weights, check_fit, d_cap, nom_node, nom_prio, nom_req, **mode)
    return _gang_scan_cuda(dc, db, g, weights, check_fit, nom_node, nom_prio, nom_req, **mode)


def step_mode(fit_strategy=DEFAULT_FIT_STRATEGY, sample_k=None, sample_start=None, tie_key=None,
              attempt_base=None) -> dict:
    """The step's branch arguments in one normalized dict: host ints for
    ``sample_k`` / ``sample_start`` / ``attempt_base`` (0-dim tensors are
    read once), ``tie_key`` a (high, low) word pair."""
    if sample_k is not None and int(sample_k) < 1:
        raise ValueError(f"sample_k must be >= 1, got {int(sample_k)}")
    return dict(
        fit_strategy=(int(fit_strategy[0]), tuple((int(u), int(s)) for u, s in fit_strategy[1]),
                      tuple(int(w) for w in fit_strategy[2])),
        sample_k=None if sample_k is None else int(sample_k),
        sample_start=int(sample_start or 0) if sample_k is not None else None,
        tie_key=None if tie_key is None else (int(tie_key[0]), int(tie_key[1])),
        attempt_base=int(attempt_base or 0),
    )


def _state0(dc, sample_start=None) -> dict:
    """The carried state at the batch's start: copies of the usage rows,
    and the rotation cursor in sampling mode."""
    state = {"requested": dc.requested.clone(), "nonzero": dc.nonzero_req.clone(), "num_pods": dc.num_pods.clone()}
    if sample_start is not None:
        state["sample_start"] = torch.tensor(sample_start, dtype=I32, device=dc.node_valid.device)
    return state


def gang_schedule_plain(dc, db, g, v_cap, weights=DEFAULT_WEIGHTS, check_fit=True, d_cap=8, nom_node=None,
                        nom_prio=None, nom_req=None, fit_strategy=DEFAULT_FIT_STRATEGY, sample_k=None,
                        sample_start=None, tie_key=None, attempt_base=0):
    """Plain PyTorch version of K5: a Python loop of the reference's step."""
    P, N = g.static_mask.shape
    dev = g.static_mask.device
    nom = nominations_onehot(nom_node, nom_prio, nom_req, N)
    state = _state0(dc, sample_start if sample_k is not None else None)
    mode = dict(fit_strategy=fit_strategy, sample_k=sample_k, tie_key=tie_key, attempt_base=attempt_base)
    assigned = torch.full((P,), ABSENT, dtype=I32, device=dev)
    chosen = torch.full((P,), ABSENT, dtype=I32, device=dev)
    n_feas = torch.zeros((P,), dtype=I64, device=dev)
    reason_counts = torch.zeros((P, N_DIAG), dtype=I64, device=dev)
    for p in range(P):
        hv = _heavy_parts(db, g, p, assigned)
        choice, nf, rc = pod_step(dc, db, g, p, state, hv, check_fit=check_fit, weights=weights, d_cap=d_cap,
                                  nom=nom, **mode)
        assigned[p] = choice
        chosen[p] = choice
        n_feas[p] = nf
        reason_counts[p] = rc
    return chosen, n_feas, reason_counts, state


def gang_run(
    dc: DeviceCluster,
    db: DeviceBatch,
    hostname_key: int,
    v_cap: int,
    hard_pod_affinity_weight: int = 1,
    has_interpod: bool = True,
    has_spread: bool = True,
    has_ports: bool = True,
    has_images: bool = True,
    enabled: frozenset = ALL_FILTER_KERNELS,
    weights: tuple = DEFAULT_WEIGHTS,
    sp_keys=None,
    sp_cdv_tab=None,
    ip_keys=None,
    d_cap: int = 8,
    nom_node=None,
    nom_prio=None,
    nom_req=None,
    fit_strategy: tuple = DEFAULT_FIT_STRATEGY,
    sample_k=None,
    sample_start=None,
    tie_key=None,
    attempt_base=None,
):
    """precompute + gang_schedule for one batch."""
    g = precompute(dc, db, hostname_key, v_cap, hard_pod_affinity_weight, has_interpod=has_interpod,
                   has_spread=has_spread, has_ports=has_ports, has_images=has_images, enabled=enabled,
                   sp_keys=sp_keys, sp_cdv_tab=sp_cdv_tab, ip_keys=ip_keys)
    return gang_schedule(dc, db, g, v_cap, weights=weights, check_fit="NodeResourcesFit" in enabled, d_cap=d_cap,
                         nom_node=nom_node, nom_prio=nom_prio, nom_req=nom_req, fit_strategy=fit_strategy,
                         sample_k=sample_k, sample_start=sample_start, tie_key=tie_key, attempt_base=attempt_base)


# ---------------------------------------------------------------------------
# CUDA: K1 + K6 + K7 (precompute) and K5 (gang_schedule)
# ---------------------------------------------------------------------------

_STATIC_ALL = frozenset({"NodeName", "NodeUnschedulable", "TaintToleration", "NodeAffinity"})
# The most dynamic shared memory a CTA of K5's cluster may put its exchange
# slab, peer counters, slice rows and staged planes in (the card's own limit
# applies below it); what does not fit goes to global scratch rows.
SCAN_SMEM_CAP = 1 << 30
# The most CTAs in K5's cluster: 16 where the card admits a cluster of 16 at
# the kernel's shared memory, else 8 (the portable size); 8 here forces 8.
SCAN_CLUSTER_CAP = 16
CL_PHASES = 19  # csrc/ktpu.cuh CL_PHASES: the cluster leader's clocks (K5, K9)
# K5's last launch: {"cluster": its CTAs, "staged": whether it staged the
# planes, "info": int32 [2 + CL_PHASES] on the card (the CTAs, the
# cluster-wide exchanges over the batch, then the rank-0 leader's cycles / 16
# per phase)}; read "info" after a synchronize.
scan_stats: dict = {}
# The most dynamic shared memory a block of K6's domain kernel or K7's ext
# and domain kernels may put its domain cells in (the card's own limit
# applies below it); a key (ext: the used keys) with more cells is walked in
# domain tiles.
STATICS_SMEM_CAP = 1 << 30
# K6 / K7 collapse equal selectors to one representative before matching
# (a warp a selector, comparing it with every earlier one) where the placed
# pods number at least this many times the selectors (csrc/gang_statics.cu
# use_classes); 0 always.  Measured on the H100: classes win at 10 and 88
# times (config3, config4), lose at 1 and 0.25 (the mixed shape's K6 and
# K7 own terms).
STATICS_CLASS_RATIO = 2
# The kernels of a K6 / K7 launch, in the order of their rows in its span
# table (csrc/gang_statics.cu SpreadSpan, InterpodSpan), and the rows a
# kernel has there, one an SM (SPAN_SMS).
SPREAD_KERNELS = ("classes", "match", "domain")
INTERPOD_KERNELS = ("terms", "ext", "inc_classes", "inc_match", "inc_domain", "ports")
SPAN_SMS = 256
# The last K6 / K7 launch's span table: {"spread" / "interpod": int64
# [kernels, SPAN_SMS, 2] on the card, per kernel and SM its blocks' first
# start (complemented) and last end (globaltimer ns), 0 where no block
# ran}; statics_spans reads it.
statics_stats: dict = {}
# GangStatics fields K5 does not read: it takes the compact domain ids from
# DeviceCluster.dom_ids under the batch's topology keys instead.
_SCAN_UNREAD = frozenset({"sp_dv", "sp_cdv", "ip_dv", "ip_key_cols"})


def _statics_spec(P, N, C, AT, KD2, JP):
    """Dtype and shape of every GangStatics field."""
    b, i, l = BOOL, I32, I64
    return dict(
        static_mask=(b, (P, N)), sp_hard=(b, (P, C)), sp_soft=(b, (P, C)), sp_dv=(i, (P, C, N)),
        sp_te=(b, (P, C, N)), sp_dom_cnt=(i, (P, C, N)), sp_dom_pres=(b, (P, C, N)),
        sp_ndom=(l if C else i, (P, C)),  # the reference's empty axis is int32
        sp_self=(b, (P, C)), sp_bmatch=(b, (P, C, P)), sp_is_host=(b, (P, C)), sp_counting=(b, (P, C, N)),
        sp_node_cnt=(i, (P, C, N)), sp_sc_dom=(i, (P, C, N)), sp_all_keys=(b, (P, N)), sp_cdv=(i, (P, C, N)),
        ip_dv=(i, (P, AT, N)), ip_dom_cnt=(i, (P, AT, N)), ip_viol_existing=(b, (P, N)), ip_sym=(l, (P, N)),
        ip_any_static=(b, (P,)), ip_self_all=(b, (P,)), ip_bmatch=(b, (P, AT, P)), ip_is_aff=(b, (P, AT)),
        ip_is_anti=(b, (P, AT)), ip_pref_w=(l, (P, AT)), ip_sym_w=(l, (P, AT)), ip_key_idx=(i, (P, AT)),
        ip_key_cols=(i, (KD2, N)), sc_taint=(l, (P, N)), sc_nodeaff=(l, (P, N)), sc_image=(l, (P, N)),
        port_b=(b, (P, JP)), d_nodename=(b, (P, N)), d_unsched=(b, (P, N)), d_taints=(b, (P, N)),
        d_nodeaff=(b, (P, N)), d_ports=(b, (P, N)), d_extra=(b, (P, N)),
    )


def _set_ptrs(args, dev, pairs):
    """args.<name> = pointer of each (name, tensor, dtype, shape) after the
    wrapper checks (device, dtype, shape, contiguity).  Each tensor is kept
    on ``args`` until the next one set under its name: a temporary freed
    before the launch would hand its memory to the wrapper's next
    allocation, and the kernel would read that instead."""
    keep = args.__dict__.setdefault("_tensors", {})
    for name, t, dt, shape in pairs:
        if name not in type(args)._PTRS:
            raise AttributeError(f"{type(args).__name__} has no pointer field {name}")
        setattr(args, name, _build.check_cuda(name, t, dev, dt, shape))
        keep[name] = t


def _table_ptrs(prefix, tab, lead, R, V):
    return [
        (prefix + "_key", tab.req_key, I32, lead + (R,)),
        (prefix + "_op", tab.req_op, I32, lead + (R,)),
        (prefix + "_vals", tab.req_vals, I32, lead + (R, V)),
        (prefix + "_rhs", tab.req_rhs, I32, lead + (R,)),
        (prefix + "_tv", tab.term_valid, BOOL, lead),
    ]


def spread_statics(dc: DeviceCluster, db: DeviceBatch, naff, taints, hostname_key: int) -> dict:
    """K6 launch: the spread half of precompute on CUDA tensors; ``naff`` /
    ``taints`` are the unconditional [P, N] node-affinity and taint masks.
    No host-to-device copy and no synchronize: the domain counts are the
    cluster's device leaf ``dom_size``, the scratch is each constraint's
    representative and the match bits."""
    dev = dc.node_valid.device
    lib = _build.load()
    N, K = dc.node_labels.shape
    E = dc.epod_node.shape[0]
    P, C = db.tsc_topo.shape
    _, _, R, V = db.tsc_table.req_vals.shape
    out = {
        "sp_dv": torch.empty((P, C, N), dtype=I32, device=dev),
        "sp_te": torch.empty((P, C, N), dtype=BOOL, device=dev),
        "sp_dom_cnt": torch.empty((P, C, N), dtype=I32, device=dev),
        "sp_dom_pres": torch.empty((P, C, N), dtype=BOOL, device=dev),
        "sp_ndom": torch.empty((P, C), dtype=I64, device=dev),
        "sp_self": torch.empty((P, C), dtype=BOOL, device=dev),
        "sp_bmatch": torch.empty((P, C, P), dtype=BOOL, device=dev),
        "sp_counting": torch.empty((P, C, N), dtype=BOOL, device=dev),
        "sp_node_cnt": torch.empty((P, C, N), dtype=I32, device=dev),
        "sp_sc_dom": torch.empty((P, C, N), dtype=I32, device=dev),
        "sp_all_keys": torch.empty((P, N), dtype=BOOL, device=dev),
        "sp_cdv": torch.empty((P, C, N), dtype=I32, device=dev),
    }
    EW = -(-E // 32)
    _check_rows(N, dc.dom_ids, naff, taints)
    rep = torch.empty((max(P * C, 1),), dtype=I32, device=dev)
    match = torch.empty((max(P * C * EW, 1),), dtype=I32, device=dev)
    span = torch.empty((len(SPREAD_KERNELS), SPAN_SMS, 2), dtype=I64, device=dev)
    a = _build.GangSpreadArgs()
    _set_ptrs(a, dev, [
        ("node_labels", dc.node_labels, I32, (N, K)), ("val_ints", dc.val_ints, I32, None),
        ("dom_ids", dc.dom_ids, I32, (K, N)), ("dom_size", dc.dom_size, I32, (K,)),
        ("dom_off", dc.dom_off, I32, (K + 1,)), ("dom_vals", dc.dom_vals, I32, (sum(dc.dom_counts),)),
        ("epod_node", dc.epod_node, I32, (E,)), ("epod_ns", dc.epod_ns, I32, (E,)),
        ("epod_labels", dc.epod_labels, I32, (E, K)), ("epod_valid", dc.epod_valid, BOOL, (E,)),
        ("epod_deleting", dc.epod_deleting, BOOL, (E,)), ("valid", db.valid, BOOL, (P,)),
        ("ns_id", db.ns_id, I32, (P,)), ("labels", db.labels, I32, (P, K)),
        *_table_ptrs("tsc", db.tsc_table, (P, C), R, V),
        ("tsc_topo", db.tsc_topo, I32, (P, C)), ("tsc_hard", db.tsc_hard, BOOL, (P, C)),
        ("honor_aff", db.tsc_honor_affinity, BOOL, (P, C)), ("honor_taints", db.tsc_honor_taints, BOOL, (P, C)),
        ("naff", naff, BOOL, (P, N)), ("taints", taints, BOOL, (P, N)),
        *[(k, t, t.dtype, tuple(t.shape)) for k, t in out.items()], ("rep", rep, I32, None),
        ("match", match, I32, None), ("span", span, I64, None),
    ])
    a.N, a.K, a.NVI, a.E, a.P, a.C, a.R, a.V = N, K, dc.val_ints.shape[0], E, P, C, R, V
    a.EW, a.D, a.hostname_key = EW, max(dc.dom_counts, default=0), int(hostname_key)
    a.smem_cap, a.class_ratio = int(min(STATICS_SMEM_CAP, 2**31 - 1)), int(STATICS_CLASS_RATIO)
    a.span_rows = len(SPREAD_KERNELS) * SPAN_SMS
    rc = lib.ktpu_gang_spread_statics(ctypes.byref(a), _build.stream_handle(dev))
    _build.check_launch(lib, rc, "gang_spread_statics")
    _build.launches["gang_spread_statics"] += 1
    statics_stats["spread"] = span
    return out


def interpod_statics(dc: DeviceCluster, db: DeviceBatch, *, do_interpod: bool, do_ports: bool,
                     hard_pod_affinity_weight: int = 1) -> dict:
    """K7 launch: the inter-pod half of precompute (raw per-term outputs)
    and the host-port masks, on CUDA tensors.  No host-to-device copy and
    no synchronize: the domain counts and their prefix sums are the
    cluster's device leaves ``dom_size`` / ``dom_off``; the scratch is the
    placed terms' records, the used-key marks, each own term's
    representative and the match bits."""
    dev = dc.node_valid.device
    lib = _build.load()
    N, K = dc.node_labels.shape
    E = dc.epod_node.shape[0]
    M = dc.term_pod.shape[0]
    _, _, TR, TV = dc.term_table.req_vals.shape
    TNS = dc.term_ns_ids.shape[1]
    U = dc.used_ppk.shape[1]
    P, AT = db.aff_kind.shape
    _, _, AR, AV = db.aff_table.req_vals.shape
    NS = db.aff_ns_ids.shape[2]
    W = db.want_ppk.shape[1]
    out = {
        "ip_dv": torch.empty((P, AT, N), dtype=I32, device=dev),
        "ip_dom_cnt": torch.empty((P, AT, N), dtype=I32, device=dev),
        "ip_viol_existing": torch.empty((P, N), dtype=BOOL, device=dev),
        "ip_sym": torch.empty((P, N), dtype=I64, device=dev),
        "inc_any": torch.empty((P, AT), dtype=BOOL, device=dev),
        "self_ok": torch.empty((P, AT), dtype=BOOL, device=dev),
        "ip_bmatch": torch.empty((P, AT, P), dtype=BOOL, device=dev),
        "d_ports": torch.empty((P, N), dtype=BOOL, device=dev),
        "port_b": torch.empty((P, P), dtype=BOOL, device=dev),
    }
    EW = -(-E // 32)
    inc = bool(do_interpod) and P * AT > 0
    _check_rows(N, dc.dom_ids)
    ext_term = torch.empty((max(M, 1), 4), dtype=I32, device=dev)
    key_used = torch.empty((max(K, 1),), dtype=I32, device=dev)
    inc_rep = torch.empty((max(P * AT, 1),), dtype=I32, device=dev)
    inc_match = torch.empty((max(P * AT * EW, 1) if inc else 1,), dtype=I32, device=dev)
    span = torch.empty((len(INTERPOD_KERNELS), SPAN_SMS, 2), dtype=I64, device=dev)
    a = _build.GangInterpodArgs()
    _set_ptrs(a, dev, [
        ("node_labels", dc.node_labels, I32, (N, K)), ("val_ints", dc.val_ints, I32, None),
        ("dom_ids", dc.dom_ids, I32, (K, N)), ("dom_size", dc.dom_size, I32, (K,)),
        ("dom_off", dc.dom_off, I32, (K + 1,)), ("dom_vals", dc.dom_vals, I32, (sum(dc.dom_counts),)),
        ("epod_node", dc.epod_node, I32, (E,)), ("epod_ns", dc.epod_ns, I32, (E,)),
        ("epod_labels", dc.epod_labels, I32, (E, K)),
        ("epod_valid", dc.epod_valid, BOOL, (E,)), ("term_pod", dc.term_pod, I32, (M,)),
        ("term_kind", dc.term_kind, I32, (M,)), ("term_topo", dc.term_topo, I32, (M,)),
        ("term_weight", dc.term_weight, I32, (M,)),
        *_table_ptrs("tt", dc.term_table, (M, 1), TR, TV),
        ("term_ns_all", dc.term_ns_all, BOOL, (M,)), ("term_ns_ids", dc.term_ns_ids, I32, (M, TNS)),
        ("used_ppk", dc.used_ppk, I32, (N, U)), ("used_ip", dc.used_ip, I32, (N, U)),
        ("used_wild", dc.used_wild, BOOL, (N, U)), ("valid", db.valid, BOOL, (P,)),
        ("ns_id", db.ns_id, I32, (P,)), ("labels", db.labels, I32, (P, K)),
        *_table_ptrs("aff", db.aff_table, (P, AT), AR, AV),
        ("aff_kind", db.aff_kind, I32, (P, AT)), ("aff_topo", db.aff_topo, I32, (P, AT)),
        ("aff_ns_all", db.aff_ns_all, BOOL, (P, AT)), ("aff_ns_ids", db.aff_ns_ids, I32, (P, AT, NS)),
        ("want_ppk", db.want_ppk, I32, (P, W)), ("want_ip", db.want_ip, I32, (P, W)),
        ("want_wild", db.want_wild, BOOL, (P, W)),
        *[(k, t, t.dtype, tuple(t.shape)) for k, t in out.items()],
        ("ext_term", ext_term, I32, None), ("key_used", key_used, I32, None), ("inc_rep", inc_rep, I32, None),
        ("inc_match", inc_match, I32, None), ("span", span, I64, None),
    ])
    a.N, a.K, a.NVI, a.E, a.M, a.TR, a.TV, a.TNS, a.U = N, K, dc.val_ints.shape[0], E, M, TR, TV, TNS, U
    a.P, a.AT, a.AR, a.AV, a.NS, a.W, a.EW = P, AT, AR, AV, NS, W, EW
    a.DSUM, a.D = sum(dc.dom_counts), max(dc.dom_counts, default=0)
    a.hard_weight = int(hard_pod_affinity_weight)
    a.do_interpod, a.do_ports = int(bool(do_interpod)), int(bool(do_ports))
    a.smem_cap, a.class_ratio = int(min(STATICS_SMEM_CAP, 2**31 - 1)), int(STATICS_CLASS_RATIO)
    a.span_rows = len(INTERPOD_KERNELS) * SPAN_SMS
    rc = lib.ktpu_gang_interpod_statics(ctypes.byref(a), _build.stream_handle(dev))
    _build.check_launch(lib, rc, "gang_interpod_statics")
    _build.launches["gang_interpod_statics"] += 1
    statics_stats["interpod"] = span
    return out


def _check_rows(N: int, *rows) -> None:
    """K6's / K7's node passes take four nodes a thread in 16- and 4-byte
    accesses: the node bucket must be a multiple of 4 and each input row
    base 16-byte aligned (DeviceCluster's leaves and a fork's rows are; the
    outputs are the wrapper's own)."""
    if N % 4:
        raise ValueError(f"K6 / K7 need a node bucket that is a multiple of 4, got {N}")
    for t in rows:
        if t.data_ptr() % 16:
            raise ValueError(f"K6 / K7 need 16-byte aligned rows, got a base at {t.data_ptr():#x}")


def statics_spans(which: str) -> dict:
    """The last K6 (``"spread"``) or K7 (``"interpod"``) launch's span per
    kernel that ran, in microseconds: from its first block's start to its
    last block's end (globaltimer), and ``"all"`` over the launch.
    Synchronizes."""
    names = SPREAD_KERNELS if which == "spread" else INTERPOD_KERNELS
    rows = statics_stats[which].cpu()
    out, first, last = {}, [], []
    for name, sm in zip(names, rows):
        ran = sm[:, 1] != 0
        if bool(ran.any()):
            first.append(int((~sm[ran, 0]).min()))
            last.append(int(sm[ran, 1].max()))
            out[name] = (last[-1] - first[-1]) / 1e3
    if first:
        out["all"] = (max(last) - min(first)) / 1e3
    return out


def _precompute_cuda(dc, db, hostname_key, *, hard_pod_affinity_weight, has_interpod, has_spread, has_ports,
                     has_images, enabled, sp_keys, ip_keys, extra_mask=None) -> GangStatics:
    """K1 for the static half (every static verdict evaluated, so the spread
    eligibility reads the real taint and node-affinity masks whatever the
    profile enables; its mask ANDs the profile's filters and the
    ``extra_mask`` lane), K6 for spread, K7 for inter-pod and ports."""
    P = db.valid.shape[0]
    N = dc.node_valid.shape[0]
    dev = dc.node_valid.device
    st = ops_fp.static_eval(dc, db, _STATIC_ALL, has_images, extra_mask=extra_mask, mask_enabled=enabled)
    true_pn = torch.ones((P, N), dtype=BOOL, device=dev)
    d_nodename = st["m_nodename"] if "NodeName" in enabled else true_pn
    d_unsched = st["m_unsched"] if "NodeUnschedulable" in enabled else true_pn
    d_taints = st["m_taints"] if "TaintToleration" in enabled else true_pn
    d_nodeaff = st["m_nodeaff"] if "NodeAffinity" in enabled else true_pn
    do_ports = has_ports or "NodePorts" in enabled
    ip7 = None
    if has_interpod or do_ports:
        ip7 = interpod_statics(dc, db, do_interpod=has_interpod, do_ports=do_ports,
                               hard_pod_affinity_weight=hard_pod_affinity_weight)
    static_mask = st["mask"]
    d_ports = true_pn
    if "NodePorts" in enabled:
        d_ports = ip7["d_ports"]
        static_mask = static_mask & d_ports

    if has_spread:
        sp = spread_statics(dc, db, st["m_nodeaff"], st["m_taints"], hostname_key)
        exists = db.tsc_topo != PAD
        sp.update(
            sp_hard=exists & db.tsc_hard,
            sp_soft=exists & ~db.tsc_hard,
            sp_is_host=db.tsc_topo == hostname_key,
        )
    else:
        sp = _empty_spread(P, N, dev)

    if has_interpod:
        is_aff, is_anti, pref_w, sym_w = _interpod_weights(db, hard_pod_affinity_weight)
        ip = dict(
            ip_dv=ip7["ip_dv"],
            ip_dom_cnt=ip7["ip_dom_cnt"],
            ip_viol_existing=ip7["ip_viol_existing"],
            ip_sym=ip7["ip_sym"],
            ip_any_static=(is_aff & ip7["inc_any"]).any(dim=1),
            ip_self_all=(~is_aff | ip7["self_ok"]).all(dim=1),
            ip_bmatch=ip7["ip_bmatch"],
            ip_is_aff=is_aff,
            ip_is_anti=is_anti,
            ip_pref_w=pref_w,
            ip_sym_w=sym_w,
            ip_key_idx=_key_index(db.aff_topo, ip_keys),
            ip_key_cols=gather_at(dc.node_labels.T, ip_keys).contiguous(),
        )
    else:
        ip = _empty_interpod(P, N, dev)
    port_b = ip7["port_b"] if has_ports else torch.zeros((P, 0), dtype=BOOL, device=dev)
    return GangStatics(
        static_mask=static_mask,
        **sp,
        **ip,
        sc_taint=st["taint_raw"],
        sc_nodeaff=st["naff_raw"],
        sc_image=st["img"],
        port_b=port_b,
        d_nodename=d_nodename,
        d_unsched=d_unsched,
        d_taints=d_taints,
        d_nodeaff=d_nodeaff,
        d_ports=d_ports,
        d_extra=extra_mask if extra_mask is not None else true_pn,
    )


def _scan_domains(dc, db, g: GangStatics, C: int, AT: int, dsp=None):
    """K5's topology keys: per spread slot, per inter-pod slot, and per
    ip_key_idx entry; D, the largest compact-domain count among them; and
    Dsp, max_domains of the live pods' non-hostname spread slots (a cluster
    launch's counted domains).  One device-to-host copy for both.  A kernel
    that keeps no peer counters (K8) gives its own bound on the counted
    domains as ``dsp``: then no D is taken (0) and nothing is copied."""
    dev = dc.node_valid.device
    K = dc.node_labels.shape[1]
    sp_key = db.tsc_topo[:, :C].contiguous()
    ip_key = db.aff_topo[:, :AT].contiguous()
    KD2 = g.ip_key_cols.shape[0]
    # one key per index; the pad slots land in a spare cell KD2
    kd2_key = torch.full((KD2 + 1,), ABSENT, dtype=I32, device=dev)
    has_key = g.ip_key_idx >= 0
    kd2_key.scatter_(0, torch.where(has_key, g.ip_key_idx, KD2).long().reshape(-1), ip_key.reshape(-1))
    kd2_key = kd2_key[:KD2]
    if dsp is not None:
        return sp_key, ip_key, kd2_key, 0, dsp
    keys = torch.cat([sp_key.reshape(-1), ip_key.reshape(-1)]).long()
    counts = torch.tensor(tuple(dc.dom_counts) + (0,), dtype=torch.int64, device=dev)
    keys = torch.where((keys >= 0) & (keys < K), keys, K)
    sp_live = db.valid[:, None] & ~g.sp_is_host & (sp_key >= 0) & (sp_key < K)
    sp = torch.where(sp_live, sp_key.long(), K).reshape(-1)
    D, Dsp = (torch.cat([counts[k], counts[K:]]).max() for k in (keys, sp))  # counts[K] = 0: none
    D, Dsp = torch.stack([D, Dsp]).tolist()
    return sp_key, ip_key, kd2_key, max(D, 1), max(Dsp, 1)


def max_domains(dc, keys, live) -> int:
    """The largest compact-domain count among the topology keys of the
    slots in ``live`` (keys and live [P, S]); at least 1."""
    counts = dc.dom_counts
    k = set(keys[live].cpu().tolist())
    return max([counts[x] for x in k if 0 <= x < len(counts)] + [1])


def visit_order(dc) -> torch.Tensor:
    """order[r] = the node whose visit rank is r, i32 [max(n_valid, 1)]:
    the sampling window's walk, built on the host once per snapshot (kept
    on ``dc`` until its visit_rank row changes)."""
    vr_t = dc.visit_rank
    key = (vr_t.data_ptr(), vr_t._version, int(dc.n_valid_nodes))
    memo = getattr(dc, "_visit_order", None)
    if memo is not None and memo[0] == key:
        return memo[1]
    vr = vr_t.cpu().numpy()
    nv = max(int(dc.n_valid_nodes), 1)
    live = np.nonzero(vr >= 0)[0]
    if len(live) > nv or (vr[live] >= nv).any():
        raise ValueError("visit ranks outrun the real node count")
    order = np.full(nv, -1, np.int32)
    order[vr[live]] = live
    t = torch.from_numpy(order).to(vr_t.device)
    dc._visit_order = (key, t)
    return t


def _word(x: int) -> int:
    """A uint32 as the int32 of the same bits (a ctypes int field)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def step_args(dc, db, g: GangStatics, weights, check_fit, state, outs, scratch, nom=None,
              extra_score=None, mode=None, dsp=None) -> "_build.GangScanArgs":
    """The GangScanArgs of a kernel that runs the shared per-pod step (K5,
    and the wave's K8 and K9): the statics, the usage ``state``
    (requested / nonzero / num_pods, and sample_start [] in sampling mode),
    ``outs`` (chosen, n_feas, reason_counts), the ``scratch`` tensors, the
    nominations' CSR (``nominations_csr``, or None), ``extra_score`` (i64
    [P, N], or None: a null pointer) and ``mode`` (``step_mode``; None: the
    default branch), after the wrapper checks.  ``a.Dsp`` (an attribute,
    not a field) is _scan_domains' Dsp; ``dsp`` (a kernel without peer
    counters: its bound on the counted domains, or None) leaves ``a.D`` 0
    and spares _scan_domains its device-to-host copy."""
    mode = step_mode() if mode is None else mode
    dev = dc.node_valid.device
    P, N = g.static_mask.shape
    K = dc.node_labels.shape[1]
    C = g.sp_dv.shape[1]
    AT = g.ip_dv.shape[1]
    KD2 = g.ip_key_cols.shape[0]
    JP = g.port_b.shape[1]
    Rn = dc.allocatable.shape[1]
    Rp = db.requests.shape[1]
    L = dc.log_tab.shape[0]
    sp_key, ip_key, kd2_key, D, Dsp = _scan_domains(dc, db, g, C, AT, dsp)
    chosen, n_feas, reason_counts = outs
    spec = _statics_spec(P, N, C, AT, KD2, JP)
    a = _build.GangScanArgs()
    _set_ptrs(a, dev, [
        ("allocatable", dc.allocatable, I32, (N, Rn)), ("allowed_pods", dc.allowed_pods, I32, (N,)),
        ("node_valid", dc.node_valid, BOOL, (N,)), ("log_tab", dc.log_tab, I64, (L,)),
        ("requested", state["requested"], I32, (N, Rn)), ("nonzero", state["nonzero"], I32, (N, 2)),
        ("num_pods", state["num_pods"], I32, (N,)), ("requests", db.requests, I32, (P, Rp)),
        ("nonzero_req", db.nonzero_req, I32, (P, 2)), ("valid", db.valid, BOOL, (P,)),
        # the batch's constraint slots; none when the spread statics are empty
        ("max_skew", db.tsc_max_skew[:, :C].contiguous(), I32, (P, C)),
        ("min_domains", db.tsc_min_domains[:, :C].contiguous(), I32, (P, C)),
        *[(f, getattr(g, f), dt, shape) for f, (dt, shape) in spec.items() if f not in _SCAN_UNREAD],
        ("chosen", chosen, I32, (P,)), ("n_feas", n_feas, I64, (P,)),
        ("reason_counts", reason_counts, I64, (P, N_DIAG)),
        ("dom_ids", dc.dom_ids, I32, (K, N)), ("sp_key", sp_key, I32, (P, C)), ("ip_key", ip_key, I32, (P, AT)),
        ("kd2_key", kd2_key, I32, (KD2,)), ("priority", db.priority, I32, (P,)),
        *[(k, t, t.dtype, None) for k, t in scratch.items()],
    ])
    if nom is not None:
        off, prio, req = nom
        G = prio.shape[0]
        _set_ptrs(a, dev, [("nom_off", off, I32, (N + 1,)), ("nom_prio", prio, I32, (G,)),
                           ("nom_req", req, I32, (G, Rn))])
    if extra_score is not None:
        _set_ptrs(a, dev, [("extra_score", extra_score.contiguous(), I64, (P, N))])
    a.N, a.K, a.Rn, a.Rp, a.L, a.P, a.C, a.AT, a.KD2, a.D, a.JP = N, K, Rn, Rp, L, P, C, AT, KD2, D, JP
    (a.w_taint, a.w_naff, a.w_spread, a.w_ip, a.w_fit, a.w_bal, a.w_img) = (int(w) for w in weights)
    a.check_fit = int(bool(check_fit))
    strat_id, shape, (a.w_cpu, a.w_mem) = mode["fit_strategy"]
    a.strat_id = strat_id
    if strat_id == STRAT_RTCR:
        if not shape:
            raise ValueError("RequestedToCapacityRatio needs a shape")
        _set_ptrs(a, dev, [("fit_shape", torch.tensor(shape, dtype=I32, device=dev), I32, (len(shape), 2))])
        a.n_shape = len(shape)
    a.n_valid = int(dc.n_valid_nodes)
    if mode["sample_k"] is not None:
        order = visit_order(dc)
        _set_ptrs(a, dev, [("visit_rank", dc.visit_rank, I32, (N,)), ("visit_order", order, I32, tuple(order.shape)),
                           ("sample_start", state["sample_start"], I32, ())])
        a.sample_k = mode["sample_k"]
    if mode["tie_key"] is not None:
        a.tie_on = 1
        a.tie_k0, a.tie_k1 = (_word(k) for k in mode["tie_key"])
        a.attempt_base = _word(mode["attempt_base"])
    a.Dsp = Dsp
    return a


def _gang_scan_cuda(dc, db, g: GangStatics, weights, check_fit, nom_node=None, nom_prio=None, nom_req=None,
                    **mode):
    """K5 launch: the whole batch's scan in one thread-block cluster, laid
    out by ktpu_gang_scan_plan (the cluster size under SCAN_CLUSTER_CAP,
    shared memory under SCAN_SMEM_CAP), with the exchange slabs and peer
    counters that do not fit in global scratch rows, one set per CTA;
    ``mode`` is step_mode's dict (the cursor rides the state)."""
    dev = dc.node_valid.device
    lib = _build.load()
    g = GangStatics(*(t.contiguous() for t in g))
    P, N = g.static_mask.shape
    C = g.sp_dv.shape[1]
    mode = step_mode(**mode)
    state = _state0(dc, mode["sample_start"])
    chosen = torch.empty((P,), dtype=I32, device=dev)
    n_feas = torch.empty((P,), dtype=I64, device=dev)
    reason_counts = torch.empty((P, N_DIAG), dtype=I64, device=dev)

    def zeros(*shape, dtype=I32):
        return torch.zeros(tuple(max(s, 1) for s in shape), dtype=dtype, device=dev)

    scratch = dict(
        cnt_h=zeros(C, N), port_stamp=zeros(N),
        feas=zeros(N, dtype=BOOL), ip_raw=zeros(N, dtype=I64), sp_raw=zeros(N, dtype=I64), sp_cnt=zeros(C, N),
    )
    nom = nominations_csr(nom_node, nom_prio, nom_req, N, dev)
    a = step_args(dc, db, g, weights, check_fit, state, (chosen, n_feas, reason_counts), scratch, nom, mode=mode)
    w = _build.WaveArgs()
    w.Dsp = a.Dsp  # the counted domains' flags
    rc = lib.ktpu_gang_scan_plan(ctypes.byref(a), ctypes.byref(w), int(SCAN_CLUSTER_CAP),
                                 int(min(SCAN_SMEM_CAP, 2**31 - 1)))
    _build.check_launch(lib, rc, "gang_scan")
    cells = (2 * C + a.AT + 2 * a.KD2) * a.D
    info = torch.zeros((2 + CL_PHASES,), dtype=I32, device=dev)
    _set_ptrs(w, dev, [
        ("sums", zeros(1 if w.sums_smem else w.cluster * w.xch_cells), I32, None),
        ("carries", zeros(1 if w.carry_smem else w.cluster * cells), I32, None),
        ("admit_info", info, I32, (2 + CL_PHASES,)),
    ])
    rc = lib.ktpu_gang_scan(ctypes.byref(a), ctypes.byref(w), _build.stream_handle(dev))
    _build.check_launch(lib, rc, "gang_scan")
    _build.launches["gang_scan"] += 1
    scan_stats.update(cluster=int(w.cluster), staged=bool(w.stage), info=info)
    return chosen, n_feas, reason_counts, state
