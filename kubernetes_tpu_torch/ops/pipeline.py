"""The independent scheduling pipeline: masks → scores → first-max argmax.

Port of the JAX package's ops/pipeline.py (its jit root ``_pipeline``):
every pod of the batch is judged alone against one snapshot (no in-batch
peers, no nominations), the batched form of schedulePod
(schedule_one.go:408-456) with first-max selection.  It is the parity
floor of the gang and wave paths; no Scheduler route takes it.

``pipeline`` is the statics route on every device: the gang precompute
(K1 + K6 + K7), K17 (ops/explain.py explain_stack, every filter enabled and
no host-filter lane) for ``feasible``, then K18 ``pipeline_score``
(csrc/pipeline.cu), which normalizes every plugin score over each pod's
feasible set and writes the totals, the feasible counts and the choice.
Each step takes its plain version for CPU tensors.  ``pipeline_plain``, the
reference's formulas line for line (``all_masks`` of ops/filters.py,
``all_scores`` of ops/scores.py, then the argmax), is what the tests and
the chip smoke hold ``pipeline`` against; no route takes it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from kubernetes_tpu_torch.cache.mirror import HOSTNAME_LABEL
from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import explain as ops_explain
from kubernetes_tpu_torch.ops import filters as F
from kubernetes_tpu_torch.ops import gang
from kubernetes_tpu_torch.ops import scores as S
from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster
from kubernetes_tpu_torch.snapshot.interner import PAD
from kubernetes_tpu_torch.snapshot.schema import bucket_cap

I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool
MAX = S.MAX_NODE_SCORE
_FX = S._FX
INT64_MIN = -(2**63)


class PipelineResult(NamedTuple):
    chosen: torch.Tensor  # i32 [P] node index or -1
    feasible: torch.Tensor  # bool [P, N]
    totals: torch.Tensor  # i64 [P, N] weighted scores (0 where infeasible)
    n_feasible: torch.Tensor  # i64 [P] (the reference's int32 sum, promoted)


def _select(feasible, totals) -> PipelineResult:
    """First-max argmax over the feasible nodes (-1 with none), the totals
    zeroed where infeasible, the feasible counts."""
    ranked = torch.where(feasible, totals, INT64_MIN)
    any_ok = feasible.any(dim=1)
    chosen = torch.where(any_ok, torch.argmax(ranked, dim=1).to(I32), -1).to(I32)
    return PipelineResult(chosen=chosen, feasible=feasible, totals=torch.where(feasible, totals, 0),
                          n_feasible=feasible.to(I32).sum(dim=1))


def pipeline_plain(dc: DeviceCluster, db: DeviceBatch, hostname_key: int, v_cap: int, has_interpod: bool = True,
                   has_spread: bool = True, has_images: bool = True) -> PipelineResult:
    """The reference's _pipeline (ops/pipeline.py:52-85) in plain PyTorch."""
    masks = F.all_masks(dc, db, v_cap, has_interpod=has_interpod, has_spread=has_spread)
    feasible = masks["_combined"]
    totals, _ = S.all_scores(dc, db, feasible, masks["_interpod_pre"], masks["_spread_pre"], v_cap, hostname_key,
                             has_images=has_images)
    return _select(feasible, totals)


# ---------------------------------------------------------------------------
# K18: pipeline_score
# ---------------------------------------------------------------------------


def pipeline_score(dc: DeviceCluster, db: DeviceBatch, g: gang.GangStatics, feasible, weights=gang.DEFAULT_WEIGHTS,
                   d_cap: int = 8) -> PipelineResult:
    """The weighted, normalized scores of each pod over its ``feasible``
    nodes from the precompute's statics ``g``, and the first-max choice.
    ``weights`` in gang.WEIGHT_ORDER; ``d_cap`` bounds the compact domain ids
    of the spread keys (gang.batch_tables).  K18 on CUDA tensors, its plain
    version on CPU."""
    if dc.node_valid.device.type == "cpu":
        return pipeline_score_plain(dc, db, g, feasible, weights, d_cap)
    return _pipeline_score_cuda(dc, db, g, feasible, weights, d_cap)


def _spread_scores(dc, db, g: gang.GangStatics, feasible, d_cap: int):
    """normalize_spread of the soft spread score from the statics: the
    counted nodes (feasible, every soft key present), their distinct
    domains per constraint, the 32.32 topology weights, the per-node or
    per-domain counts (_spread_raw's formulas, batched over pods)."""
    P, C, N = g.sp_dv.shape
    dev = feasible.device
    soft = g.sp_soft  # [P, C]
    has_soft = soft.any(dim=1)  # [P]
    counted = feasible & g.sp_all_keys  # [P, N]
    n_counted = counted.to(I64).sum(dim=1)  # [P]
    cdv = g.sp_cdv  # [P, C, N]
    hit = counted[:, None, :] & (cdv >= 0) & (cdv < d_cap)
    seg = torch.where(hit, cdv, d_cap).long().reshape(P * C, N)
    seen = torch.zeros((P * C, d_cap + 1), dtype=I32, device=dev).scatter_(1, seg, 1)
    n_dom = seen[:, :d_cap].to(I64).sum(dim=1).reshape(P, C)
    size = torch.where(g.sp_is_host, n_counted[:, None], n_dom)
    w_fx = dc.log_tab[size.clamp(0, dc.log_tab.shape[0] - 1).long()]  # [P, C] i64
    cnt = torch.where(g.sp_is_host[:, :, None], g.sp_node_cnt, g.sp_sc_dom)  # [P, C, N]
    contrib = cnt.to(I64) * w_fx[:, :, None] + ((db.tsc_max_skew[:, :C].to(I64) - 1)[:, :, None] << _FX)
    total_fx = torch.where(soft[:, :, None], contrib, 0).sum(dim=1)  # [P, N]
    raw = torch.where(has_soft[:, None], S.round_fx(total_fx), 0)
    valid = torch.where(has_soft[:, None], ~feasible | g.sp_all_keys, feasible)
    return S.normalize_spread(raw, valid, feasible)


def pipeline_score_plain(dc: DeviceCluster, db: DeviceBatch, g: gang.GangStatics, feasible,
                         weights=gang.DEFAULT_WEIGHTS, d_cap: int = 8) -> PipelineResult:
    """Plain version of K18: all_scores' normalizations on the statics."""
    w_taint, w_naff, w_spread, w_ip, w_fit, w_bal, w_img = (int(w) for w in weights)
    P, N = feasible.shape
    C = g.sp_dv.shape[1]
    AT = g.ip_dv.shape[1]
    total = torch.zeros((P, N), dtype=I64, device=feasible.device)
    if w_taint:
        total += w_taint * S.default_normalize(g.sc_taint, feasible, reverse=True)
    if w_naff:
        total += w_naff * S.default_normalize(g.sc_nodeaff, feasible)
    if w_spread:
        if C:
            total += w_spread * _spread_scores(dc, db, g, feasible, d_cap)
        else:
            total += w_spread * torch.where(feasible, MAX, 0).to(I64)
    if w_ip:
        ip_raw = g.ip_sym.to(I64)
        if AT:
            ip_raw = ip_raw + torch.where(g.ip_dv >= 0, g.ip_dom_cnt.to(I64) * g.ip_pref_w[:, :, None], 0).sum(dim=1)
        total += w_ip * S.normalize_interpod(ip_raw, feasible)
    if w_fit:
        total += w_fit * S.score_least_allocated(dc, db)
    if w_bal:
        total += w_bal * S.score_balanced_allocation(dc, db)
    if w_img:
        total += w_img * g.sc_image
    return _select(feasible, total)


def _pipeline_score_cuda(dc, db, g: gang.GangStatics, feasible, weights, d_cap: int) -> PipelineResult:
    """K18 launch: one block per pod."""
    dev = dc.node_valid.device
    lib = _build.load()
    P, N = feasible.shape
    Rn = dc.allocatable.shape[1]
    Rp = db.requests.shape[1]
    C = g.sp_dv.shape[1]
    AT = g.ip_dv.shape[1]
    L = dc.log_tab.shape[0]
    D = max(int(d_cap), 1)
    totals = torch.empty((P, N), dtype=I64, device=dev)
    n_feasible = torch.empty((P,), dtype=I64, device=dev)
    chosen = torch.empty((P,), dtype=I32, device=dev)
    seen = torch.zeros((max(P * C * D, 1),), dtype=I32, device=dev)
    a = _build.PipelineArgs()
    gang._set_ptrs(a, dev, [
        ("feasible", feasible.contiguous(), BOOL, (P, N)), ("allocatable", dc.allocatable, I32, (N, Rn)),
        ("requested", dc.requested, I32, (N, Rn)), ("nonzero", dc.nonzero_req, I32, (N, 2)),
        ("log_tab", dc.log_tab, I64, (L,)), ("requests", db.requests, I32, (P, Rp)),
        ("nonzero_req", db.nonzero_req, I32, (P, 2)), ("max_skew", db.tsc_max_skew[:, :C].contiguous(), I32, (P, C)),
        ("sc_taint", g.sc_taint.contiguous(), I64, (P, N)), ("sc_nodeaff", g.sc_nodeaff.contiguous(), I64, (P, N)),
        ("sc_image", g.sc_image.contiguous(), I64, (P, N)), ("sp_soft", g.sp_soft.contiguous(), BOOL, (P, C)),
        ("sp_is_host", g.sp_is_host.contiguous(), BOOL, (P, C)),
        ("sp_all_keys", g.sp_all_keys.contiguous(), BOOL, (P, N)), ("sp_cdv", g.sp_cdv.contiguous(), I32, (P, C, N)),
        ("sp_node_cnt", g.sp_node_cnt.contiguous(), I32, (P, C, N)),
        ("sp_sc_dom", g.sp_sc_dom.contiguous(), I32, (P, C, N)), ("ip_sym", g.ip_sym.contiguous(), I64, (P, N)),
        ("ip_dv", g.ip_dv.contiguous(), I32, (P, AT, N)), ("ip_dom_cnt", g.ip_dom_cnt.contiguous(), I32, (P, AT, N)),
        ("ip_pref_w", g.ip_pref_w.contiguous(), I64, (P, AT)), ("seen", seen, I32, None),
        ("totals", totals, I64, (P, N)), ("n_feasible", n_feasible, I64, (P,)), ("chosen", chosen, I32, (P,)),
    ])
    a.N, a.P, a.Rn, a.Rp, a.C, a.AT, a.L, a.D = N, P, Rn, Rp, C, AT, L, D
    (a.w_taint, a.w_naff, a.w_spread, a.w_ip, a.w_fit, a.w_bal, a.w_img) = (int(w) for w in weights)
    rc = lib.ktpu_pipeline_score(ctypes.byref(a), _build.stream_handle(dev))
    _build.check_launch(lib, rc, "pipeline_score")
    _build.launches["pipeline_score"] += 1
    return PipelineResult(chosen=chosen, feasible=feasible, totals=totals, n_feasible=n_feasible)


# ---------------------------------------------------------------------------
# The pipeline and its host wrapper
# ---------------------------------------------------------------------------


def pipeline(dc: DeviceCluster, db: DeviceBatch, hostname_key: int, v_cap: int, has_interpod: bool = True,
             has_spread: bool = True, has_images: bool = True, *, sp_keys, sp_cdv_tab, ip_keys,
             d_cap: int) -> PipelineResult:
    """The statics route: precompute (every filter enabled), explain_stack's
    combined mask as ``feasible``, then pipeline_score.  Each step takes its
    kernel (K1, K6, K7, K17, K18) on CUDA tensors and its plain version on
    CPU."""
    dev = dc.node_valid.device
    tables = {k: torch.as_tensor(v, dtype=I32, device=dev) for k, v in
              (("sp_keys", sp_keys), ("sp_cdv_tab", sp_cdv_tab), ("ip_keys", ip_keys))}
    g = gang.precompute(dc, db, hostname_key, v_cap, has_interpod=has_interpod, has_spread=has_spread,
                        has_ports=False, has_images=has_images, **tables)
    feasible = ops_explain.explain_stack(dc, db, g, check_fit=True)[gang.N_DIAG]
    return pipeline_score(dc, db, g, feasible, gang.DEFAULT_WEIGHTS, d_cap)


def batch_feature_flags(pc, pb):
    """Which constraint families does this (snapshot, batch) pair use?
    ``pc`` is any object with the packed ``nodes`` and ``existing``.
    Returns (has_interpod, has_spread, has_images, has_ports)."""
    has_interpod = bool((np.asarray(pb.aff_kind) != PAD).any() or (np.asarray(pc.existing.term_kind) != PAD).any())
    has_spread = bool((np.asarray(pb.tsc_topo_key) != PAD).any())
    has_images = bool((np.asarray(pb.img_ids) >= 0).any())
    has_ports = bool((np.asarray(pb.want_ppk) != PAD).any() or (np.asarray(pc.nodes.used_ppk) != PAD).any())
    return has_interpod, has_spread, has_images, has_ports


def schedule_independent(pc, pb, device=None) -> PipelineResult:
    """Schedule each pod of the packed batch ``pb`` against the unmodified
    snapshot ``pc`` (any object with the packed ``nodes``, ``existing`` and
    their ``vocab``: a Scheduler's ``mirror``).  Runs on CUDA unless
    ``device`` says otherwise; the result comes back on the CPU."""
    from kubernetes_tpu_torch.scheduler import resolve_device

    dev = resolve_device(device)
    vocab = pc.vocab
    dc = DeviceCluster.from_host(pc.nodes, vocab, dev, ep=pc.existing)
    db = DeviceBatch.from_host(pb, dev)
    v_cap = bucket_cap(len(vocab.label_vals))
    hostname_key = vocab.label_keys.lookup(HOSTNAME_LABEL)
    has_interpod, has_spread, has_images, _ = batch_feature_flags(pc, pb)
    tables = gang.batch_tables(pb.tsc_topo_key, pb.aff_topo_key, pc.nodes.label_vals, hostname_key)
    res = pipeline(dc, db, hostname_key, v_cap, has_interpod, has_spread, has_images, **tables)
    return PipelineResult(*(t.cpu() for t in res))
