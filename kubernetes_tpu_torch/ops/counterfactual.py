"""K forked snapshots × one batch: the counterfactual planner's dispatch.

Port of the JAX package's ops/counterfactual.py (its jit root
``counterfactual_run``).  A fork is a set of per-fork planes over the shared
packed snapshot (planner/forks.py ``pack_forks``):

  * ``fk_alive``      [KF, N]      node exists in this fork (removals clear
                                   it; clone slots are set only in the forks
                                   that add them)
  * ``fk_unsched``    [KF, N]      cordons
  * ``fk_alloc``      [KF, N, Rn]  capacity (scaled per fork)
  * ``fk_req`` / ``fk_nz`` / ``fk_npods``  usage rows with the fork's
                                   evictions taken out (recomputed on the
                                   host per touched node)
  * ``fk_epod_valid`` [KF, E]      placed pods still there (evicted pods
                                   and pods on removed nodes drop out)
  * ``fk_nvalid``     [KF]         alive nodes (host ints)
  * ``fk_pod_live``   [KF, P]      the batch pods this fork simulates

The reference vmaps (view, workloads_run, summaries) over the fork axis.
The port takes three steps:

  1. **K15** ``fork_view`` writes every fork's neutralized static planes in
     one launch: where a node is not alive in the fork its labels read
     ABSENT, its taints PAD, its compact domain ids (DeviceCluster.dom_ids,
     which the gang kernels read in place of label values) -1, so an absent
     node is exactly a node never packed: it leaves spread domain tracking,
     inter-pod topology membership and min-match as a repack without it
     would.
  2. A host loop runs the unmodified workloads engine (ops/coscheduling.py
     ``workloads_run``: K12 with volumes, K1, K6, K7, K8, K11) on each
     fork's ``DeviceCluster``, a ``dataclasses.replace`` whose planes are
     row views ``[k]`` of the stacked planes (nothing is copied), the batch
     masked by ``fk_pod_live[k]``.  The tables built off the extended,
     un-neutralized label rows (``sp_cdv_tab``, ``ip_cdv_tab``, ``d_cap``)
     are shared by every fork, as in the reference.  Padding forks (no live
     pods) run too, so the outputs equal the reference's row for row.
  3. **K16** ``fork_summary`` reduces every fork's outcome in one launch:
     live pods admitted and left, their summed first-failure reason counts
     and the bin-packing density.

Every output lands in one packed buffer (``packed``), so ``readback`` is one
device-to-host copy, as the reference reads its dict with one ``_d2h``.
Each step has its plain PyTorch version (the reference's formulas), which
the wrappers take for CPU tensors; for CUDA tensors they launch the kernel
(csrc/counterfactual.cu) or raise.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from kubernetes_tpu_torch.ops import _build, wire
from kubernetes_tpu_torch.ops import coscheduling as cos
from kubernetes_tpu_torch.ops import gang
from kubernetes_tpu_torch.ops.gang import N_DIAG
from kubernetes_tpu_torch.snapshot.interner import ABSENT, PAD
from kubernetes_tpu_torch.snapshot.schema import LANE_CPU, LANE_MEM

I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool

# fixed-point scale of the density readout (parts per million)
DENSITY_SCALE = 1_000_000

# the reference's output dict, in its order
OUTPUT_KEYS = ("chosen", "n_feas", "reasons", "admitted", "unschedulable", "density_ppm", "gang_admit",
               "gang_landed")


@dataclass
class ForkPlanes:
    """pack_forks' planes as counterfactual_run takes them: tensors, and
    ``fk_nvalid`` as host ints (each fork's DeviceCluster.n_valid_nodes)."""

    fk_alive: Any  # bool [KF, N]
    fk_unsched: Any  # bool [KF, N]
    fk_alloc: Any  # i32 [KF, N, Rn]
    fk_req: Any  # i32 [KF, N, Rn]
    fk_nz: Any  # i32 [KF, N, 2]
    fk_npods: Any  # i32 [KF, N]
    fk_epod_valid: Any  # bool [KF, E]
    fk_nvalid: tuple  # KF host ints
    fk_pod_live: Any  # bool [KF, P]

    @classmethod
    def from_host(cls, planes: Dict[str, np.ndarray], device) -> "ForkPlanes":
        """pack_forks' numpy planes on ``device`` in one host-to-device copy."""
        host = {f.name: np.asarray(planes[f.name]) for f in dataclasses.fields(cls)}
        host["fk_nvalid"] = tuple(int(x) for x in host["fk_nvalid"])
        return wire.device_put_packed(cls(**host), device)

    def kwargs(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


# ---------------------------------------------------------------------------
# K15: fork_view
# ---------------------------------------------------------------------------


def fork_cluster_view_plain(dc, fk_alive, visit_rank=None) -> Dict[str, torch.Tensor]:
    """Plain version of K15: fork_cluster_view's neutralization
    (ops/counterfactual.py:78-100) for every fork at once.  Returns
    node_labels [KF, N, K], taint_key / taint_val / taint_effect [KF, N, T],
    dom_ids [KF, K, N] and, with ``visit_rank`` [N], visit_rank [KF, N]."""
    gone = ~fk_alive
    out = dict(
        node_labels=torch.where(gone[:, :, None], ABSENT, dc.node_labels[None]).to(I32),
        taint_key=torch.where(gone[:, :, None], PAD, dc.taint_key[None]).to(I32),
        taint_val=torch.where(gone[:, :, None], PAD, dc.taint_val[None]).to(I32),
        taint_effect=torch.where(gone[:, :, None], PAD, dc.taint_effect[None]).to(I32),
        dom_ids=torch.where(gone[:, None, :], -1, dc.dom_ids[None]).to(I32),
    )
    if visit_rank is not None:
        out["visit_rank"] = torch.where(gone, -1, visit_rank[None]).to(I32)
    return out


def fork_cluster_view(dc, fk_alive, visit_rank=None) -> Dict[str, torch.Tensor]:
    """The forks' neutralized static planes: K15 on CUDA tensors, its plain
    version on CPU."""
    if dc.node_valid.device.type == "cpu":
        return fork_cluster_view_plain(dc, fk_alive, visit_rank)
    return _fork_view_cuda(dc, fk_alive, visit_rank)


def _fork_view_cuda(dc, fk_alive, visit_rank=None):
    dev = dc.node_valid.device
    lib = _build.load()
    KF, N = fk_alive.shape
    L = dc.node_labels.shape[1]
    T = dc.taint_key.shape[1]
    c = _build.check_cuda
    out = dict(
        node_labels=torch.empty((KF, N, L), dtype=I32, device=dev),
        taint_key=torch.empty((KF, N, T), dtype=I32, device=dev),
        taint_val=torch.empty((KF, N, T), dtype=I32, device=dev),
        taint_effect=torch.empty((KF, N, T), dtype=I32, device=dev),
        dom_ids=torch.empty((KF, L, N), dtype=I32, device=dev),
    )
    vr = vr_out = None
    if visit_rank is not None:
        vr = c("visit_rank", visit_rank, dev, I32, (N,))
        out["visit_rank"] = torch.empty((KF, N), dtype=I32, device=dev)
        vr_out = out["visit_rank"].data_ptr()
    rc = lib.ktpu_fork_view(
        c("node_labels", dc.node_labels, dev, I32, (N, L)), c("taint_key", dc.taint_key, dev, I32, (N, T)),
        c("taint_val", dc.taint_val, dev, I32, (N, T)), c("taint_effect", dc.taint_effect, dev, I32, (N, T)),
        vr, c("dom_ids", dc.dom_ids, dev, I32, (L, N)), c("fk_alive", fk_alive, dev, BOOL, (KF, N)),
        out["node_labels"].data_ptr(), out["taint_key"].data_ptr(), out["taint_val"].data_ptr(),
        out["taint_effect"].data_ptr(), vr_out, out["dom_ids"].data_ptr(), KF, N, L, T, _build.stream_handle(dev))
    _build.check_launch(lib, rc, "fork_view")
    _build.launches["fork_view"] += 1
    return out


# ---------------------------------------------------------------------------
# K16: fork_summary
# ---------------------------------------------------------------------------


def fork_density_plain(alive, alloc, used):
    """The mean cpu and memory utilization over alive nodes with capacity,
    in DENSITY_SCALE fixed point: the reference's fork_density
    (ops/counterfactual.py:103-117) for one fork (alive [N], alloc and
    used [N, Rn]); an i64 scalar."""
    a_cpu = alloc[:, LANE_CPU].to(I64)
    a_mem = alloc[:, LANE_MEM].to(I64)
    u_cpu = used[:, LANE_CPU].to(I64)
    u_mem = used[:, LANE_MEM].to(I64)
    counted = alive & (a_cpu > 0) & (a_mem > 0)
    util = torch.div(
        torch.div(u_cpu * DENSITY_SCALE, a_cpu.clamp(min=1), rounding_mode="floor")
        + torch.div(u_mem * DENSITY_SCALE, a_mem.clamp(min=1), rounding_mode="floor"),
        2, rounding_mode="floor")
    total = torch.where(counted, util, 0).sum()
    n = counted.to(I64).sum()
    return torch.div(total, n.clamp(min=1), rounding_mode="floor")


def fork_summary_plain(chosen, reason_counts, requested, fk_alloc, fk_alive, valid, fk_pod_live, out=None):
    """Plain version of K16 (ops/counterfactual.py:249-266): per fork, the
    live valid pods placed and left (i64 [KF] each), their summed reason
    counts (i64 [KF, ND]) and fork_density of the post-admission usage
    (i64 [KF]).  ``out`` (four tensors of those shapes, optional) receives
    them in place."""
    is_live = valid[None, :] & fk_pod_live
    admitted = (is_live & (chosen >= 0)).to(I64).sum(dim=1)
    unsched = (is_live & (chosen < 0)).to(I64).sum(dim=1)
    reasons = torch.where(is_live[:, :, None], reason_counts, 0).sum(dim=1)
    density = torch.stack([fork_density_plain(fk_alive[k], fk_alloc[k], requested[k])
                           for k in range(fk_alive.shape[0])])
    res = (admitted, unsched, reasons, density)
    if out is None:
        return res
    for dst, src in zip(out, res):
        dst.copy_(src)
    return out


def fork_summary(chosen, reason_counts, requested, fk_alloc, fk_alive, valid, fk_pod_live, out=None):
    """The per-fork outcome: K16 on CUDA tensors, its plain version on CPU.
    ``out`` (admitted, unschedulable, reasons, density, optional) receives
    the result in place."""
    if chosen.device.type == "cpu":
        return fork_summary_plain(chosen, reason_counts, requested, fk_alloc, fk_alive, valid, fk_pod_live, out)
    return _fork_summary_cuda(chosen, reason_counts, requested, fk_alloc, fk_alive, valid, fk_pod_live, out)


def _fork_summary_cuda(chosen, reason_counts, requested, fk_alloc, fk_alive, valid, fk_pod_live, out=None):
    dev = chosen.device
    lib = _build.load()
    KF, P = chosen.shape
    ND = reason_counts.shape[2]
    N, Rn = requested.shape[1:]
    if out is None:
        out = (torch.empty((KF,), dtype=I64, device=dev), torch.empty((KF,), dtype=I64, device=dev),
               torch.empty((KF, ND), dtype=I64, device=dev), torch.empty((KF,), dtype=I64, device=dev))
    c = _build.check_cuda
    admitted, unsched, reasons, density = out
    rc = lib.ktpu_fork_summary(
        c("chosen", chosen, dev, I32, (KF, P)), c("reason_counts", reason_counts, dev, I64, (KF, P, ND)),
        c("requested", requested, dev, I32, (KF, N, Rn)), c("fk_alloc", fk_alloc, dev, I32, (KF, N, Rn)),
        c("fk_alive", fk_alive, dev, BOOL, (KF, N)), c("valid", valid, dev, BOOL, (P,)),
        c("fk_pod_live", fk_pod_live, dev, BOOL, (KF, P)), c("admitted", admitted, dev, I64, (KF,)),
        c("unschedulable", unsched, dev, I64, (KF,)), c("reasons", reasons, dev, I64, (KF, ND)),
        c("density_ppm", density, dev, I64, (KF,)), KF, P, N, Rn, ND, _build.stream_handle(dev))
    _build.check_launch(lib, rc, "fork_summary")
    _build.launches["fork_summary"] += 1
    return out


# ---------------------------------------------------------------------------
# counterfactual_run
# ---------------------------------------------------------------------------


def _layout(KF: int, P: int, G2: int):
    """(name, dtype, shape) of the packed outputs, the int64 ones first so
    every view is aligned."""
    return [("n_feas", I64, (KF, P)), ("reasons", I64, (KF, N_DIAG)), ("admitted", I64, (KF,)),
            ("unschedulable", I64, (KF,)), ("density_ppm", I64, (KF,)), ("chosen", I32, (KF, P)),
            ("gang_admit", I32, (KF, G2)), ("gang_landed", I32, (KF, G2))]


def _nbytes(layout) -> int:
    return sum(int(np.prod(shape)) * dt.itemsize for _, dt, shape in layout)


def _carve(buf: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """Typed views of the byte buffer ``buf``, one per layout entry."""
    out, off = {}, 0
    for name, dt, shape in layout:
        nb = int(np.prod(shape)) * dt.itemsize
        out[name] = buf[off:off + nb].view(dt).view(shape)
        off += nb
    return out


def readback(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """counterfactual_run's outputs on the host with ONE device-to-host copy
    (of the packed buffer all of them are views of)."""
    buf = out["packed"]
    KF, P = out["chosen"].shape
    host = buf.cpu()
    got = _carve(host, _layout(KF, P, out["gang_admit"].shape[1]))
    return {k: got[k].numpy() for k in OUTPUT_KEYS}


def _fork_cluster(dc, view, planes, k: int, n_valid: int):
    """Fork k's DeviceCluster: row views of the stacked planes."""
    return dataclasses.replace(
        dc,
        allocatable=planes["fk_alloc"][k],
        requested=planes["fk_req"][k],
        nonzero_req=planes["fk_nz"][k],
        num_pods=planes["fk_npods"][k],
        node_valid=planes["fk_alive"][k],
        unschedulable=planes["fk_unsched"][k],
        node_labels=view["node_labels"][k],
        taint_key=view["taint_key"][k],
        taint_val=view["taint_val"][k],
        taint_effect=view["taint_effect"][k],
        dom_ids=view["dom_ids"][k],
        visit_rank=view["visit_rank"][k],
        epod_valid=planes["fk_epod_valid"][k],
        n_valid_nodes=n_valid,
    )


def _run(view_fn, summary_fn, dc, db, hostname_key, v_cap, g_cap, wave_rows, gang_rows, planes, run_kw):
    dev = dc.node_valid.device
    KF, N = planes["fk_alive"].shape
    P = db.valid.shape[0]
    Rn = dc.allocatable.shape[1]
    nvalid = torch.as_tensor(planes["fk_nvalid"]).cpu().tolist()  # host ints (one copy from a device tensor)
    fk = {k: v for k, v in planes.items() if k != "fk_nvalid"}
    view = view_fn(dc, fk["fk_alive"], dc.visit_rank)
    layout = _layout(KF, P, g_cap)
    buf = torch.empty((_nbytes(layout),), dtype=torch.uint8, device=dev)
    out = _carve(buf, layout)
    reason_counts = torch.empty((KF, P, N_DIAG), dtype=I64, device=dev)
    requested = torch.empty((KF, N, Rn), dtype=I32, device=dev)
    for k in range(KF):
        dc_k = _fork_cluster(dc, view, fk, k, int(nvalid[k]))
        db_k = dataclasses.replace(db, valid=db.valid & fk["fk_pod_live"][k])
        chosen, n_feas, rc, tallies, wl = cos.workloads_run(dc_k, db_k, hostname_key, v_cap, g_cap, *wave_rows,
                                                            *gang_rows, **run_kw)
        out["chosen"][k].copy_(chosen)
        out["n_feas"][k].copy_(n_feas)
        out["gang_admit"][k].copy_(wl["gang_admit"])
        out["gang_landed"][k].copy_(wl["gang_landed"])
        reason_counts[k].copy_(rc)
        requested[k].copy_(tallies["requested"])
    summary_fn(out["chosen"], reason_counts, requested, fk["fk_alloc"], fk["fk_alive"], db.valid, fk["fk_pod_live"],
               out=(out["admitted"], out["unschedulable"], out["reasons"], out["density_ppm"]))
    out["packed"] = buf
    return out


def counterfactual_run_plain(dc, db, hostname_key: int, v_cap: int, g_cap: int, tid_sp, rep_sp_p, rep_sp_c, tid_ip,
                             rep_ip_p, rep_ip_u, ip_cdv_tab, gang_id, gang_first, gang_last, gang_need, fk_alive,
                             fk_unsched, fk_alloc, fk_req, fk_nz, fk_npods, fk_epod_valid, fk_nvalid, fk_pod_live,
                             **kw):
    """Plain version of counterfactual_run: K15's and K16's plain versions
    around the workloads engine, which takes its own plain versions on CPU
    tensors."""
    planes = dict(fk_alive=fk_alive, fk_unsched=fk_unsched, fk_alloc=fk_alloc, fk_req=fk_req, fk_nz=fk_nz,
                  fk_npods=fk_npods, fk_epod_valid=fk_epod_valid, fk_nvalid=fk_nvalid, fk_pod_live=fk_pod_live)
    return _run(fork_cluster_view_plain, fork_summary_plain, dc, db, hostname_key, v_cap, g_cap,
                (tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u, ip_cdv_tab),
                (gang_id, gang_first, gang_last, gang_need), planes, kw)


def counterfactual_run(dc, db, hostname_key: int, v_cap: int, g_cap: int, tid_sp, rep_sp_p, rep_sp_c, tid_ip,
                       rep_ip_p, rep_ip_u, ip_cdv_tab, gang_id, gang_first, gang_last, gang_need, fk_alive,
                       fk_unsched, fk_alloc, fk_req, fk_nz, fk_npods, fk_epod_valid, fk_nvalid, fk_pod_live,
                       vol_table=None, vol_valid=None, vol_bad=None, hard_pod_affinity_weight: int = 1,
                       has_interpod: bool = True, has_spread: bool = True, has_images: bool = True,
                       enabled: frozenset = gang.ALL_FILTER_KERNELS, weights: tuple = gang.DEFAULT_WEIGHTS,
                       extra_score=None, sp_keys=None, sp_cdv_tab=None, ip_keys=None, d_cap: int = 8,
                       d2_cap: int = 8, fit_strategy: tuple = gang.DEFAULT_FIT_STRATEGY):
    """KF forked snapshots × one batch.  ``dc`` is the shared snapshot over
    the extended node tensors (clone slots appended), ``db`` the batch in
    plan_batch order, the wave and gang rows and tables as for
    workloads_run, the fk_* planes pack_forks' (``fk_nvalid`` may be host
    ints).  ``extra_score`` (i64 [P, N]) adds to every fork's totals;
    ``fit_strategy`` is the NodeResourcesFit strategy (ops/gang.py).

    Returns the reference's dict, every entry leading with KF, plus
    ``packed`` (the one buffer they are views of; ``readback`` copies it):
      chosen        i32 [KF, P]   placements after rollback (-1: none)
      n_feas        i64 [KF, P]   feasible-node counts
      reasons       i64 [KF, ND]  summed first-failure reason counts
      admitted      i64 [KF]      live batch pods placed
      unschedulable i64 [KF]      live batch pods left pending
      density_ppm   i64 [KF]      mean cpu and memory utilization after
      gang_admit    i32 [KF, G2]  per-gang verdicts (-1 / 0 / 1)
      gang_landed   i32 [KF, G2]  members placed per gang
    """
    planes = dict(fk_alive=fk_alive, fk_unsched=fk_unsched, fk_alloc=fk_alloc, fk_req=fk_req, fk_nz=fk_nz,
                  fk_npods=fk_npods, fk_epod_valid=fk_epod_valid, fk_nvalid=fk_nvalid, fk_pod_live=fk_pod_live)
    kw = dict(vol_table=vol_table, vol_valid=vol_valid, vol_bad=vol_bad,
              hard_pod_affinity_weight=hard_pod_affinity_weight, has_interpod=has_interpod, has_spread=has_spread,
              has_images=has_images, enabled=enabled, weights=weights, extra_score=extra_score, sp_keys=sp_keys,
              sp_cdv_tab=sp_cdv_tab, ip_keys=ip_keys, d_cap=d_cap, d2_cap=d2_cap, fit_strategy=fit_strategy)
    args = (dc, db, hostname_key, v_cap, g_cap, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u, ip_cdv_tab,
            gang_id, gang_first, gang_last, gang_need)
    if dc.node_valid.device.type == "cpu":
        return counterfactual_run_plain(*args, **planes, **kw)
    return _run(fork_cluster_view, fork_summary, dc, db, hostname_key, v_cap, g_cap, args[5:12], args[12:16], planes,
                kw)
