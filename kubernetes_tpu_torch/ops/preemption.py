"""Preemption narrowing: K10, the batched front of the PostFilter dry run.

Port of the JAX package's ops/preemption.py (its jit root
``narrow_candidates``).  ONE call computes, for every pod of a batch that
failed to schedule, the per-node mask of PLAUSIBLE preemption candidates
(DryRunPreemption, preemption.go:548).  A node survives for pod p iff:

  * the victim-independent filters pass (NodeName, NodeUnschedulable,
    TaintToleration, NodeAffinity: what no victim removal can fix);
  * the node carries at least one strictly lower-priority victim;
  * p FITS once every lower-priority pod is removed (the dry run's most
    optimistic state), pod count and every resource lane.

The mask is a superset of the true candidates; the host evaluator
(framework/preemption.py) runs the exact reprieve walk on it.  Victim
removal is factored by the failed pods' distinct priorities (groups): per
group, a segment sum over the placed pods gives the per-node requests that
stay.

The batch's own committed placements (``batch_*`` rows), not yet in the
cache when the failures are walked, are charged asymmetrically so the mask
stays a superset of each failed pod's later host walk: strictly higher
priority peers are kept (the walk sees them assumed), equal ones are
ignored (they may commit after the failed pod's walk), strictly lower ones
count as removable victims.

``narrow_candidates`` launches K10 (csrc/preemption.cu) for CUDA tensors
and runs ``narrow_candidates_plain`` (``index_add_`` segment sums) for CPU
tensors.
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import filters as F
from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster
from kubernetes_tpu_torch.ops.fastpath import static_eval_args

I32 = torch.int32
BOOL = torch.bool
INT32_MIN = -(2**31)
_STATIC_ALL = frozenset({"NodeName", "NodeUnschedulable", "TaintToleration", "NodeAffinity"})


def narrow_candidates(
    dc: DeviceCluster,
    db: DeviceBatch,
    victim_node,  # i32 [E]     placed pod's node index (< 0 pads)
    victim_prio,  # i32 [E]     placed pod's priority
    victim_req,  # i32 [E, R]   placed pod's request row
    prio_groups,  # i32 [G]     distinct failed-pod priorities (pad INT32_MIN)
    pod_group,  # i32 [P]       index into prio_groups per batch pod
    batch_node=None,  # i32 [B2]  this batch's committed placements (< 0 pads)
    batch_prio=None,  # i32 [B2]
    batch_req=None,  # i32 [B2, R]
):
    """bool [P, N]: the nodes worth dry-running per failed pod."""
    if dc.node_valid.device.type == "cpu":
        return narrow_candidates_plain(dc, db, victim_node, victim_prio, victim_req, prio_groups, pod_group,
                                       batch_node, batch_prio, batch_req)
    return _narrow_candidates_cuda(dc, db, victim_node, victim_prio, victim_req, prio_groups, pod_group,
                                   batch_node, batch_prio, batch_req)


def _segment_sum(values, seg, n: int):
    """Sum of ``values`` rows into ``n`` node rows (seg == n: dropped)."""
    out = torch.zeros((n + 1,) + tuple(values.shape[1:]), dtype=values.dtype, device=values.device)
    out.index_add_(0, seg, values)
    return out[:n]


def narrow_candidates_plain(dc, db, victim_node, victim_prio, victim_req, prio_groups, pod_group,
                            batch_node=None, batch_prio=None, batch_req=None):
    """Plain PyTorch version of K10, the reference's formulas."""
    N = dc.node_valid.shape[0]
    Rn = dc.allocatable.shape[1]
    static = (
        dc.node_valid[None, :]
        & db.valid[:, None]
        & F.mask_node_name(dc, db)
        & F.mask_unschedulable(dc, db)
        & F.mask_taints(dc, db)
        & F.mask_node_affinity(dc, db)
    )  # [P, N]

    valid = victim_node >= 0
    seg = torch.where(valid, victim_node, N).long()  # dump row N
    if batch_node is not None:
        bvalid = batch_node >= 0
        bseg = torch.where(bvalid, batch_node, N).long()

    kept_req_g, kept_cnt_g, victim_g = [], [], []
    for thr in prio_groups.tolist():
        lower = (victim_prio < thr) & valid  # victims that go
        keep = (~lower & valid).to(I32)
        kept_req = _segment_sum(victim_req * keep[:, None], seg, N)  # [N, R]
        kept_cnt = _segment_sum(keep, seg, N)
        victim_here = _segment_sum(lower.to(I32), seg, N) > 0
        if batch_node is not None:
            bkeep = (bvalid & (batch_prio > thr)).to(I32)
            blower = bvalid & (batch_prio < thr)
            kept_req = kept_req + _segment_sum(batch_req * bkeep[:, None], bseg, N)
            kept_cnt = kept_cnt + _segment_sum(bkeep, bseg, N)
            victim_here = victim_here | (_segment_sum(blower.to(I32), bseg, N) > 0)
        kept_req_g.append(kept_req)
        kept_cnt_g.append(kept_cnt)
        victim_g.append(victim_here)

    gid = pod_group.long().clamp(0, prio_groups.shape[0] - 1)
    kept_req = torch.stack(kept_req_g)[gid]  # [P, N, R]
    kept_cnt = torch.stack(kept_cnt_g)[gid]  # [P, N]
    has_victim = torch.stack(victim_g)[gid]  # [P, N]

    req = db.requests[:, :Rn]  # [P, R]
    fits_cnt = kept_cnt + 1 <= dc.allowed_pods[None, :]
    avail = dc.allocatable[None, :, :] - kept_req
    fits_res = (req[:, None, :] <= avail).all(dim=2) | (req == 0).all(dim=1)[:, None]
    return static & has_victim & fits_cnt & fits_res


def _narrow_candidates_cuda(dc, db, victim_node, victim_prio, victim_req, prio_groups, pod_group,
                            batch_node, batch_prio, batch_req):
    """K10 launch: the kept planes (a), then the [P, N] mask (b)."""
    dev = dc.node_valid.device
    lib = _build.load()
    N, R = dc.allocatable.shape
    P, Rp = db.requests.shape
    E = victim_node.shape[0]
    G = prio_groups.shape[0]
    if batch_node is None:
        batch_node = torch.full((1,), -1, dtype=I32, device=dev)
        batch_prio = torch.zeros((1,), dtype=I32, device=dev)
        batch_req = torch.zeros((1, R), dtype=I32, device=dev)
    B2 = batch_node.shape[0]
    s, _spread = static_eval_args(dc, db, _STATIC_ALL, has_images=False)
    mask = torch.empty((P, N), dtype=BOOL, device=dev)
    planes = [torch.empty(shape, dtype=I32, device=dev) for shape in ((G, N, R), (G, N), (G, N))]
    keep = []  # every operand stays referenced until the launch
    a = _build.PreemptArgs()
    for name, t, dt, shape in (
        ("victim_node", victim_node, I32, (E,)), ("victim_prio", victim_prio, I32, (E,)),
        ("victim_req", victim_req, I32, (E, R)), ("groups", prio_groups, I32, (G,)),
        ("pod_group", pod_group, I32, (P,)), ("batch_node", batch_node, I32, (B2,)),
        ("batch_prio", batch_prio, I32, (B2,)), ("batch_req", batch_req, I32, (B2, R)),
        ("allocatable", dc.allocatable, I32, (N, R)), ("allowed_pods", dc.allowed_pods, I32, (N,)),
        ("requests", db.requests, I32, (P, Rp)), ("kept_req", planes[0], I32, (G, N, R)),
        ("kept_cnt", planes[1], I32, (G, N)), ("victims", planes[2], I32, (G, N)),
        ("mask", mask, BOOL, (P, N)),
    ):
        setattr(a, name, _build.check_cuda(name, t, dev, dt, shape))
        keep.append(t)
    a.N, a.R, a.Rp, a.E, a.B2, a.G, a.P = N, R, Rp, E, B2, G, P
    rc = lib.ktpu_preempt_narrow(ctypes.byref(s), ctypes.byref(a), _build.stream_handle(dev))
    _build.check_launch(lib, rc, "narrow_candidates")
    _build.launches["narrow_candidates"] += 1
    return mask
