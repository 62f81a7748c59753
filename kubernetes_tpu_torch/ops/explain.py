"""Explain-mode masks: one pass/fail mask per Filter plugin for a pod batch.

Port of the JAX package's ops/explain.py (its jit root ``explain_masks``).
The batched filter pipeline computes a pass mask per plugin for every (pod,
node) pair but keeps only the winner and the reason counts; explain
recomputes those masks for a diagnosed batch and returns the whole
``[N_DIAG, P, N]`` stack, so one device-to-host copy answers "why is this
pod unschedulable on each node", plugin by plugin.

Verdicts are judged against the current snapshot, with no in-batch peers
and no nominated-pod charges: the state a fresh one-pod attempt (and the
host oracle's ``feasible_nodes``) sees.  The rows follow
``gang.DIAG_KERNELS``:

    NodeUnschedulable, NodeName, TaintToleration, NodeAffinity, NodePorts,
    HostFilters, NodeResourcesFit, PodTopologySpread, InterPodAffinity

Each row is the plugin's own verdict, not first-failure attributed: a node
three plugins reject is False in three rows, as the oracle collects every
reason.

``explain_masks`` runs the gang precompute (K1 + K6 + K7 on CUDA, their
plain versions on the CPU) and then ``explain_stack``: K17 (csrc/explain.cu)
for CUDA tensors, ``explain_stack_plain`` for CPU tensors.  Both write one
``[N_DIAG + 1, P, N]`` bool buffer, the stack and then the combined
feasibility, so the caller fetches both in one copy (``explain_buffer``).
With every filter enabled and no host-filter lane the combined mask is the
independent pipeline's ``feasible`` (ops/pipeline.py).
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import gang
from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster
from kubernetes_tpu_torch.snapshot.schema import N_FIXED_LANES

I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool
INT32_MAX = 2**31 - 1
N_DIAG = gang.N_DIAG


def explain_stack(dc: DeviceCluster, db: DeviceBatch, g: gang.GangStatics, check_fit: bool = True):
    """bool ``[N_DIAG + 1, P, N]``: the per-plugin rows of the statics ``g``
    against the snapshot's usage, then their AND with the valid node slots
    and pod rows.  K17 on CUDA tensors, its plain version on CPU."""
    if dc.node_valid.device.type == "cpu":
        return explain_stack_plain(dc, db, g, check_fit)
    return _explain_stack_cuda(dc, db, g, check_fit)


def explain_stack_plain(dc: DeviceCluster, db: DeviceBatch, g: gang.GangStatics, check_fit: bool = True):
    """Plain version of K17: the reference's formulas (ops/explain.py:99-198)."""
    P, N = g.static_mask.shape
    Rn = dc.requested.shape[1]
    Rp = db.requests.shape[1]
    dev = g.static_mask.device
    true_pn = torch.ones((P, N), dtype=BOOL, device=dev)

    # ---- NodeResourcesFit against the snapshot usage (no in-batch commits)
    if check_fit:
        fits = dc.num_pods + 1 <= dc.allowed_pods  # [N]
        req = db.requests  # [P, Rp]
        all_zero = (req == 0).all(dim=1)  # [P]
        avail = dc.allocatable - dc.requested  # [N, Rn]
        if Rp > Rn:
            avail = torch.cat([avail, torch.zeros((N, Rp - Rn), dtype=I32, device=dev)], dim=1)
        conflict = req[:, None, :] > avail[None, :, :Rp]  # [P, N, Rp]
        # extended-resource lanes only count when requested
        scalar_lane = torch.arange(Rp, device=dev) >= N_FIXED_LANES
        conflict = conflict & (~scalar_lane[None, None, :] | (req[:, None, :] > 0))
        lane_ok = ~conflict.any(dim=2)  # [P, N]
        m_fit = fits[None, :] & (all_zero[:, None] | lane_ok)
    else:
        m_fit = true_pn

    # ---- PodTopologySpread hard constraints against the placed pods only
    C = g.sp_dv.shape[1]
    if C:
        total = g.sp_dom_cnt  # [P, C, N]: no batch-peer contributions
        min_match = torch.where(g.sp_te, total, INT32_MAX).min(dim=2).values  # [P, C]
        mind = db.tsc_min_domains[:, :C]
        min_match = torch.where((mind > 0) & (g.sp_ndom < mind), 0, min_match)
        skew = total + g.sp_self.to(I32)[:, :, None] - min_match[:, :, None]
        c_ok = (g.sp_dv >= 0) & (~g.sp_dom_pres | (skew <= db.tsc_max_skew[:, :C, None]))
        m_spread = (~g.sp_hard[:, :, None] | c_ok).all(dim=1)  # [P, N]
    else:
        m_spread = true_pn

    # ---- InterPodAffinity against the placed pods only
    AT = g.ip_dv.shape[1]
    if AT:
        topo_present = g.ip_dv >= 0  # [P, AT, N]
        total = g.ip_dom_cnt
        viol2 = (g.ip_is_anti[:, :, None] & topo_present & (total > 0)).any(dim=1)
        aff_ok = (~g.ip_is_aff[:, :, None] | (topo_present & (total > 0))).all(dim=1)
        topo_all = (~g.ip_is_aff[:, :, None] | topo_present).all(dim=1)
        escape = g.ip_is_aff.any(dim=1) & ~g.ip_any_static & g.ip_self_all  # [P]
        ok3 = aff_ok | (escape[:, None] & topo_all)
        m_interpod = ~g.ip_viol_existing & ~viol2 & ok3
    else:
        m_interpod = ~g.ip_viol_existing

    base = dc.node_valid[None, :] & db.valid[:, None]
    stack = torch.stack([g.d_unsched, g.d_nodename, g.d_taints, g.d_nodeaff, g.d_ports, g.d_extra, m_fit, m_spread,
                         m_interpod])  # [N_DIAG, P, N]; the port row is the static conflicts only (no peers)
    feasible = base & stack.all(dim=0)
    return torch.cat([stack, feasible[None]])


def _explain_stack_cuda(dc: DeviceCluster, db: DeviceBatch, g: gang.GangStatics, check_fit: bool):
    """K17 launch: one block per pod writes its N_DIAG + 1 rows."""
    dev = dc.node_valid.device
    lib = _build.load()
    P, N = g.static_mask.shape
    Rn = dc.allocatable.shape[1]
    Rp = db.requests.shape[1]
    C = g.sp_dv.shape[1]
    AT = g.ip_dv.shape[1]
    out = torch.empty((N_DIAG + 1, P, N), dtype=BOOL, device=dev)
    a = _build.ExplainArgs()
    pn = (P, N)
    gang._set_ptrs(a, dev, [
        ("node_valid", dc.node_valid, BOOL, (N,)), ("num_pods", dc.num_pods, I32, (N,)),
        ("allowed_pods", dc.allowed_pods, I32, (N,)), ("allocatable", dc.allocatable, I32, (N, Rn)),
        ("requested", dc.requested, I32, (N, Rn)), ("valid", db.valid, BOOL, (P,)),
        ("requests", db.requests, I32, (P, Rp)),
        *[(f, getattr(g, f).contiguous(), BOOL, pn)
          for f in ("d_unsched", "d_nodename", "d_taints", "d_nodeaff", "d_ports", "d_extra")],
        ("sp_hard", g.sp_hard.contiguous(), BOOL, (P, C)), ("sp_dv", g.sp_dv.contiguous(), I32, (P, C, N)),
        ("sp_te", g.sp_te.contiguous(), BOOL, (P, C, N)), ("sp_dom_cnt", g.sp_dom_cnt.contiguous(), I32, (P, C, N)),
        ("sp_dom_pres", g.sp_dom_pres.contiguous(), BOOL, (P, C, N)),
        ("sp_ndom", g.sp_ndom.to(I64).contiguous(), I64, (P, C)), ("sp_self", g.sp_self.contiguous(), BOOL, (P, C)),
        ("min_domains", db.tsc_min_domains[:, :C].contiguous(), I32, (P, C)),
        ("max_skew", db.tsc_max_skew[:, :C].contiguous(), I32, (P, C)),
        ("ip_viol_existing", g.ip_viol_existing.contiguous(), BOOL, pn),
        ("ip_dv", g.ip_dv.contiguous(), I32, (P, AT, N)), ("ip_dom_cnt", g.ip_dom_cnt.contiguous(), I32, (P, AT, N)),
        ("ip_is_aff", g.ip_is_aff.contiguous(), BOOL, (P, AT)), ("ip_is_anti", g.ip_is_anti.contiguous(), BOOL, (P, AT)),
        ("ip_any_static", g.ip_any_static.contiguous(), BOOL, (P,)),
        ("ip_self_all", g.ip_self_all.contiguous(), BOOL, (P,)),
        ("out", out, BOOL, (N_DIAG + 1, P, N)),
    ])
    a.N, a.P, a.Rn, a.Rp, a.C, a.AT = N, P, Rn, Rp, C, AT
    a.check_fit = int(bool(check_fit))
    rc = lib.ktpu_explain_stack(ctypes.byref(a), _build.stream_handle(dev))
    _build.check_launch(lib, rc, "explain_stack")
    _build.launches["explain_stack"] += 1
    return out


def _statics(dc, db, hostname_key, v_cap, has_interpod, has_spread, has_ports, enabled, extra_mask, tables,
             plain: bool) -> gang.GangStatics:
    kw = dict(hard_pod_affinity_weight=1, has_interpod=has_interpod and "InterPodAffinity" in enabled,
              has_spread=has_spread and "PodTopologySpread" in enabled, has_ports=has_ports, has_images=False,
              enabled=enabled, extra_mask=extra_mask)
    if not plain:
        return gang.precompute(dc, db, hostname_key, v_cap, **kw, **tables)
    dev = dc.node_valid.device
    t = {k: None if v is None else torch.as_tensor(v, dtype=I32, device=dev) for k, v in tables.items()}
    return gang.precompute_plain(dc, db, hostname_key, v_cap, **kw, **t)


def explain_buffer(dc: DeviceCluster, db: DeviceBatch, hostname_key: int, v_cap: int, has_interpod: bool = True,
                   has_spread: bool = True, has_ports: bool = True, enabled: frozenset = gang.ALL_FILTER_KERNELS,
                   check_fit: bool = True, extra_mask=None, sp_keys=None, sp_cdv_tab=None, ip_keys=None):
    """The precompute, then ``explain_stack``: bool [N_DIAG + 1, P, N] (the
    stack, then the combined feasibility).  Table arguments come from
    ``gang.batch_tables``."""
    g = _statics(dc, db, hostname_key, v_cap, has_interpod, has_spread, has_ports, enabled, extra_mask,
                 dict(sp_keys=sp_keys, sp_cdv_tab=sp_cdv_tab, ip_keys=ip_keys), plain=False)
    return explain_stack(dc, db, g, check_fit)


def explain_masks(dc: DeviceCluster, db: DeviceBatch, hostname_key: int, v_cap: int, has_interpod: bool = True,
                  has_spread: bool = True, has_ports: bool = True, enabled: frozenset = gang.ALL_FILTER_KERNELS,
                  check_fit: bool = True, extra_mask=None, sp_keys=None, sp_cdv_tab=None, ip_keys=None):
    """(stack bool [N_DIAG, P, N] in gang.DIAG_KERNELS row order, combined
    feasibility bool [P, N]): views of one ``explain_buffer``."""
    buf = explain_buffer(dc, db, hostname_key, v_cap, has_interpod, has_spread, has_ports, enabled, check_fit,
                         extra_mask, sp_keys, sp_cdv_tab, ip_keys)
    return buf[:N_DIAG], buf[N_DIAG]


def explain_masks_plain(dc: DeviceCluster, db: DeviceBatch, hostname_key: int, v_cap: int, has_interpod: bool = True,
                        has_spread: bool = True, has_ports: bool = True, enabled: frozenset = gang.ALL_FILTER_KERNELS,
                        check_fit: bool = True, extra_mask=None, sp_keys=None, sp_cdv_tab=None, ip_keys=None):
    """``explain_masks`` on the plain versions (precompute_plain, then
    explain_stack_plain), on tensors of any device."""
    g = _statics(dc, db, hostname_key, v_cap, has_interpod, has_spread, has_ports, enabled, extra_mask,
                 dict(sp_keys=sp_keys, sp_cdv_tab=sp_cdv_tab, ip_keys=ip_keys), plain=True)
    buf = explain_stack_plain(dc, db, g, check_fit)
    return buf[:N_DIAG], buf[N_DIAG]
