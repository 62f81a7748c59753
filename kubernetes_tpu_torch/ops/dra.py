"""DRA claim allocation as a batched device match: the host packer, the
match, the per-node verdict and the commit.

Port of the JAX package's ops/dra.py.  The structured allocator (staging
DRA structured/allocator.go, mirrored serially by
framework/dynamicresources.py) walks every node's ResourceSlices per pod;
here the surface is packed into tensors:

  * ResourceSlice devices into ``[N, DD, DA]`` attribute key / value rows
    (a device slot axis per node, an attribute slot axis per device);
  * claim requests into ``[P, DQ]`` slots whose selector requirements
    (DeviceClass selectors, then the request's own) become ``[P, DQ, DS(,
    DV)]`` rows, so matching is one pass giving the ``[P, DQ, N, DD]`` match
    tensor (DeviceSelector.matches: In / NotIn / Exists / DoesNotExist,
    NotIn admitting an absent attribute);
  * the allocation state is two carries of the workloads admission,
    ``free [N, DD]`` (no allocated claim holds the device) and
    ``claim_node [CL]`` (the node a referenced claim is allocated to, -1
    none), so claims take part in the admission's conflict resolution and
    in gang rollback as the usage rows do;
  * a node's verdict for one pod: every referenced allocated claim pins to
    it, and every active request slot (its claim still unallocated) is met
    from the node's free devices, the slots of one pod taking greedily in
    slot order (a device granted to slot q is gone for q+1): ExactCount
    needs ``count`` matching free devices, taken lowest slot first (the
    slice / device enumeration order, which the packer keeps), All needs
    every matching device free, and at least one (allocator.go:530-552).

Each device function has a plain PyTorch version (the reference's formulas),
which the wrapper takes for CPU tensors; on CUDA tensors it launches the
hand-written kernel or raises:

  K13 selector_match   the match tensor, a thread per (pod, slot, node,
                       device) (csrc/dra.cu)
  K14 dra_spec_mask    every pod's verdict against the pre-batch state
                       (free0, claim_node0): the speculation's lane, a
                       thread per (pod, node) (csrc/dra.cu)

The admission's verdict and commit (``node_feasible_plain``,
``dra_commit_plain``) run inside K11 (ops/coscheduling.py), which shares
K14's device verdict (csrc/ktpu.cuh ``ktpu::dra``).
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.api.dra import ALLOCATION_MODE_ALL
from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.snapshot.interner import ABSENT, PAD
from kubernetes_tpu_torch.snapshot.schema import bucket_cap
from kubernetes_tpu_torch.snapshot.selectors import OP_DOES_NOT_EXIST, OP_EXISTS, OP_IN, OP_NOT_IN

I32 = torch.int32
BOOL = torch.bool

_SEL_OPS = {
    "In": OP_IN,
    "NotIn": OP_NOT_IN,
    "Exists": OP_EXISTS,
    "DoesNotExist": OP_DOES_NOT_EXIST,
}

# the workloads dispatch's DRA arguments (ops/coscheduling.py), all or none
DRA_ARGS = ("dev_key", "dev_val", "dev_valid", "free0", "sel_key", "sel_op", "sel_vals", "req_count", "req_all",
            "req_cl", "req_bad", "q_valid", "ref_cl", "claim_node0")
# K14 and K11 keep a node's free set in registers up to this many device
# slots (csrc/ktpu.cuh ktpu::dra::REG_DD); past it each thread's words go to a
# scratch row in global memory, and K14's grid is at most this many pods high
REG_DD = 256
SPEC_SCRATCH_ROWS = 64


def scratch_words(DD: int) -> int:
    """uint64 words of one thread's scratch row at DD device slots (the free
    set and a slot's match), 0 on the register path."""
    return 2 * ((DD + 63) // 64) if DD > REG_DD else 0


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------


def dra_tables(pods, name_to_idx, n_cap: int, p_cap: int, slices, device_classes, claims_by_key, device="cpu"):
    """Pack the batch's DRA surface into tensors on ``device``.

    ``slices`` is the scheduler's ResourceSlice list in lister order (the
    enumeration order the greedy take shares with the plugin's serial
    allocator), ``device_classes`` maps name to DeviceClass and
    ``claims_by_key`` maps "ns/name" to the WHOLE claim-cache view (assumed
    versions included), not only the claims the batch references: ``free0``
    must exclude the devices ANY allocated claim holds, as the plugin's
    _allocated_devices does.  Request slots are built for the referenced
    claims only; a pre-allocated claim on a node outside the snapshot pins
    to ``n_cap`` (no node).

    Returns None when no pod references a claim that exists, else a dict:

      dev_key/dev_val  i32 [N, DD, DA]   device attribute pairs (-1 pad)
      dev_valid        bool [N, DD]
      free0            bool [N, DD]      not held by any allocated claim
      sel_key/sel_op   i32 [P, DQ, DS]   packed selector requirements
      sel_vals         i32 [P, DQ, DS, DV]
      req_count        i32 [P, DQ]       ExactCount count
      req_all          bool [P, DQ]      AllocationMode=All
      req_cl           i32 [P, DQ]       owning claim slot (-1 pad)
      req_bad          bool [P, DQ]      device class missing: never fits
      q_valid          bool [P, DQ]
      ref_cl           i32 [P, CQ]       claim slots the pod references
      claim_node0      i32 [CL]          pre-batch allocation node (-1 none)
      claim_keys       [CL] list         slot to "ns/name" (host bookkeeping)
      has_claims       bool [P] numpy    host-side routing bit
    """
    referenced = []  # claim keys in first-reference order
    ref_idx = {}
    per_pod_claims = []
    for pod in pods:
        keys = []
        for name in pod.resource_claims:
            key = f"{pod.namespace}/{name}"
            if key not in ref_idx:
                if claims_by_key.get(key) is None:
                    continue  # PreFilter rejected the pod already: no slot
                ref_idx[key] = len(referenced)
                referenced.append(key)
            keys.append(ref_idx[key])
        per_pod_claims.append(keys)
    if not referenced:
        return None

    # the attribute vocabulary over slice devices and selector keys / values
    key_ids: dict = {}
    val_ids: dict = {}

    def _k(s):
        return key_ids.setdefault(s, len(key_ids))

    def _v(s):
        return val_ids.setdefault(s, len(val_ids))

    # node-grouped slices in lister order; devices flatten per node
    per_node = [[] for _ in range(n_cap)]
    for sl in slices:
        idx = name_to_idx.get(sl.node_name)
        if idx is None or idx >= n_cap:
            continue
        for dev in sl.devices:
            per_node[idx].append((sl.driver, sl.pool, dev))
    dd_need = max((len(devs) for devs in per_node), default=1) or 1
    da_need = 1
    for devs in per_node:
        for _, _, dev in devs:
            da_need = max(da_need, len(dev.attributes))

    # selectors: the class's first, then the request's (the AND over them
    # does not depend on the order, but the reference's is kept)
    def _sels(req):
        cls = device_classes.get(req.device_class_name)
        if cls is None:
            return None  # a missing class: the slot never fits
        return tuple(cls.selectors) + tuple(req.selectors)

    per_pod_slots = []  # [(claim slot, count, is_all, selectors or None)]
    dq_need, ds_need, dv_need, cq_need = 1, 1, 1, 1
    for cl_slots in per_pod_claims:
        slots = []
        for cl in cl_slots:
            claim = claims_by_key[referenced[cl]]
            if claim.allocation is not None:
                continue  # an allocated claim takes nothing new
            for req in claim.requests:
                sels = _sels(req)
                slots.append((cl, int(req.count), req.allocation_mode == ALLOCATION_MODE_ALL, sels))
                if sels is not None:
                    ds_need = max(ds_need, len(sels))
                    for s in sels:
                        dv_need = max(dv_need, len(s.values))
        per_pod_slots.append(slots)
        dq_need = max(dq_need, len(slots))
        cq_need = max(cq_need, len(cl_slots))

    DD = bucket_cap(dd_need, 1)
    DA = bucket_cap(da_need, 1)
    DQ = bucket_cap(dq_need, 1)
    DS = bucket_cap(ds_need, 1)
    DV = bucket_cap(dv_need, 1)
    CQ = bucket_cap(cq_need, 1)
    CL = bucket_cap(len(referenced), 1)

    dev_key = np.full((n_cap, DD, DA), ABSENT, np.int32)
    dev_val = np.full((n_cap, DD, DA), ABSENT, np.int32)
    dev_valid = np.zeros((n_cap, DD), bool)
    dev_ident = {}  # (driver, pool, device name) to (node, slot)
    for n, devs in enumerate(per_node):
        for d, (driver, pool, dev) in enumerate(devs[:DD]):
            dev_valid[n, d] = True
            dev_ident[(driver, pool, dev.name)] = (n, d)
            for a, (k, v) in enumerate(dev.attributes[:DA]):
                dev_key[n, d, a] = _k(k)
                dev_val[n, d, a] = _v(v)

    # the devices any allocated claim of the cache view holds are taken
    free0 = dev_valid.copy()
    for claim in claims_by_key.values():
        if claim.allocation is None:
            continue
        for r in claim.allocation.results:
            pos = dev_ident.get((r.driver, r.pool, r.device))
            if pos is not None:
                free0[pos] = False

    sel_key = np.full((p_cap, DQ, DS), PAD, np.int32)
    sel_op = np.full((p_cap, DQ, DS), PAD, np.int32)
    sel_vals = np.full((p_cap, DQ, DS, DV), PAD, np.int32)
    req_count = np.zeros((p_cap, DQ), np.int32)
    req_all = np.zeros((p_cap, DQ), bool)
    req_cl = np.full((p_cap, DQ), -1, np.int32)
    req_bad = np.zeros((p_cap, DQ), bool)
    q_valid = np.zeros((p_cap, DQ), bool)
    ref_cl = np.full((p_cap, CQ), -1, np.int32)
    has_claims = np.zeros((p_cap,), bool)
    for i, (slots, cl_slots) in enumerate(zip(per_pod_slots, per_pod_claims)):
        has_claims[i] = bool(cl_slots)
        for c, cl in enumerate(cl_slots[:CQ]):
            ref_cl[i, c] = cl
        for q, (cl, count, is_all, sels) in enumerate(slots[:DQ]):
            q_valid[i, q] = True
            req_cl[i, q] = cl
            req_count[i, q] = count
            req_all[i, q] = is_all
            if sels is None:
                req_bad[i, q] = True
                continue
            for s, sel in enumerate(sels[:DS]):
                # an unseen key or value still interns: it matches no device
                # (Exists on an unknown key is never true)
                sel_key[i, q, s] = _k(sel.attribute)
                sel_op[i, q, s] = _SEL_OPS.get(sel.operator, PAD)
                for v, val in enumerate(sel.values[:DV]):
                    sel_vals[i, q, s, v] = _v(val)

    claim_node0 = np.full((CL,), -1, np.int32)
    for cl, key in enumerate(referenced):
        claim = claims_by_key[key]
        if claim.allocation is not None and claim.allocation.node_name:
            claim_node0[cl] = name_to_idx.get(claim.allocation.node_name, n_cap)

    arrays = dict(dev_key=dev_key, dev_val=dev_val, dev_valid=dev_valid, free0=free0, sel_key=sel_key, sel_op=sel_op,
                  sel_vals=sel_vals, req_count=req_count, req_all=req_all, req_cl=req_cl, req_bad=req_bad,
                  q_valid=q_valid, ref_cl=ref_cl, claim_node0=claim_node0)
    out = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    out["claim_keys"] = list(referenced)
    out["has_claims"] = has_claims
    return out


# ---------------------------------------------------------------------------
# K13: selector_match
# ---------------------------------------------------------------------------


def selector_match(dev_key, dev_val, dev_valid, sel_key, sel_op, sel_vals):
    """``[P, DQ, N, DD]`` bool: device slot (n, d) is valid and satisfies
    every selector requirement of request slot (p, q).  K13 on CUDA
    tensors, its plain version on CPU."""
    if dev_key.device.type == "cpu":
        return selector_match_plain(dev_key, dev_val, dev_valid, sel_key, sel_op, sel_vals)
    return _selector_match_cuda(dev_key, dev_val, dev_valid, sel_key, sel_op, sel_vals)


def selector_match_plain(dev_key, dev_val, dev_valid, sel_key, sel_op, sel_vals):
    """Plain version of K13: the reference's formula (ops/dra.py:275), one
    [P, DQ, N, DD] plane per requirement slot."""
    P, DQ, DS = sel_key.shape
    DV = sel_vals.shape[3]
    N, DD, DA = dev_key.shape
    dev = dev_key.device
    ok = torch.ones((P, DQ, N, DD), dtype=BOOL, device=dev)
    for s in range(DS):
        key = sel_key[:, :, s][:, :, None, None]  # [P, DQ, 1, 1]
        op = sel_op[:, :, s][:, :, None, None]
        present = torch.zeros((P, DQ, N, DD), dtype=BOOL, device=dev)
        val_at = torch.full((P, DQ, N, DD), ABSENT, dtype=I32, device=dev)
        for a in range(DA):
            k_a = dev_key[:, :, a]  # [N, DD]
            hit = (k_a[None, None] == key) & (k_a >= 0)[None, None]
            present = present | hit
            val_at = torch.where(hit, dev_val[:, :, a][None, None], val_at)
        in_any = torch.zeros((P, DQ, N, DD), dtype=BOOL, device=dev)
        for v in range(DV):
            sv = sel_vals[:, :, s, v][:, :, None, None]
            in_any = in_any | (present & (val_at == sv) & (sv >= 0))
        res = torch.where(op == OP_IN, in_any,
                          torch.where(op == OP_NOT_IN, ~in_any,  # NotIn admits absent attributes
                                      torch.where(op == OP_EXISTS, present, ~present)))
        ok = ok & torch.where(op == PAD, True, res)  # a padded requirement slot passes
    return ok & dev_valid[None, None]


def _selector_match_cuda(dev_key, dev_val, dev_valid, sel_key, sel_op, sel_vals):
    dev = dev_key.device
    lib = _build.load()
    P, DQ, DS = sel_key.shape
    DV = sel_vals.shape[3]
    N, DD, DA = dev_key.shape
    c = _build.check_cuda
    out = torch.empty((P, DQ, N, DD), dtype=BOOL, device=dev)
    rc = lib.ktpu_dra_selector_match(
        c("dev_key", dev_key, dev, I32, (N, DD, DA)), c("dev_val", dev_val, dev, I32, (N, DD, DA)),
        c("dev_valid", dev_valid, dev, BOOL, (N, DD)), c("sel_key", sel_key, dev, I32, (P, DQ, DS)),
        c("sel_op", sel_op, dev, I32, (P, DQ, DS)), c("sel_vals", sel_vals, dev, I32, (P, DQ, DS, DV)),
        out.data_ptr(), P, DQ, DS, DV, N, DD, DA, _build.stream_handle(dev))
    _build.check_launch(lib, rc, "dra_selector_match")
    _build.launches["dra_selector_match"] += 1
    return out


# ---------------------------------------------------------------------------
# The per-node verdict and the commit (plain versions; K11 and K14 run them
# on the card)
# ---------------------------------------------------------------------------


def node_feasible_plain(match_p, free, claim_node, req_count_p, req_all_p, req_cl_p, q_valid_p, req_bad_p,
                        ref_cl_p):
    """One pod's DRA verdict per node and its greedy take, against the
    allocation state (free [N, DD], claim_node [CL]); ``match_p`` is the
    pod's [DQ, N, DD] plane.  Returns (ok bool [N], take bool [N, DD]): the
    reference's node_feasible (ops/dra.py:319)."""
    DQ, N, DD = match_p.shape
    CL = claim_node.shape[0]
    CQ = ref_cl_p.shape[0]
    dev = match_p.device
    n_ids = torch.arange(N, dtype=I32, device=dev)
    none = torch.tensor(-1, dtype=I32, device=dev)
    ok = torch.ones((N,), dtype=BOOL, device=dev)
    for c in range(CQ):
        cl = ref_cl_p[c]
        pin = torch.where(cl >= 0, claim_node[cl.clamp(0, CL - 1).long()], none)
        ok = ok & ((pin < 0) | (pin == n_ids))
    free_sim = free
    take_acc = torch.zeros((N, DD), dtype=BOOL, device=dev)
    for q in range(DQ):
        cl = req_cl_p[q]
        unalloc = (cl >= 0) & (claim_node[cl.clamp(0, CL - 1).long()] < 0)
        active = q_valid_p[q] & unalloc
        m = match_p[q] & free_sim  # [N, DD]
        cnt = m.to(I32).sum(dim=1)
        total_m = match_p[q].to(I32).sum(dim=1)
        # AllocationMode=All needs EVERY matching device allocatable
        # (structured/allocator.go:530-552): one in use fails the node
        ok_all = (total_m > 0) & (cnt == total_m)
        ok_q = torch.where(req_all_p[q], ok_all, cnt >= req_count_p[q]) & ~req_bad_p[q]
        ok = ok & torch.where(active, ok_q, True)
        rank = torch.cumsum(m.to(I32), dim=1)
        take = m & torch.where(req_all_p[q], True, rank <= req_count_p[q]) & active
        free_sim = free_sim & ~take
        take_acc = take_acc | take
    return ok, take_acc


def dra_commit_plain(free, claim_node, choice, take_p, ref_cl_p):
    """Commit one pod's placement into the allocation carries: the chosen
    node's take row leaves ``free`` and every referenced still-unallocated
    claim pins to the chosen node.  Returns (free, claim_node): the
    reference's dra_commit (ops/dra.py:378)."""
    N = free.shape[0]
    CL = claim_node.shape[0]
    dev = free.device
    choice = torch.as_tensor(choice, dtype=I32, device=dev)
    committed = choice >= 0
    row = (torch.arange(N, dtype=I32, device=dev) == choice) & committed
    new_free = free & ~(take_p & row[:, None])
    newly = torch.zeros((CL,), dtype=BOOL, device=dev)
    cl_ids = torch.arange(CL, dtype=I32, device=dev)
    for c in range(ref_cl_p.shape[0]):
        newly = newly | ((cl_ids == ref_cl_p[c]) & (claim_node < 0))  # a negative slot matches none
    return new_free, torch.where(newly & committed, choice, claim_node)


# ---------------------------------------------------------------------------
# K14: dra_spec_mask
# ---------------------------------------------------------------------------


def dra_spec_mask(match, free0, claim_node0, req_count, req_all, req_cl, q_valid, req_bad, ref_cl):
    """``[P, N]`` bool: each pod's DRA verdict against the pre-batch state,
    the workloads speculation's lane (the reference's spec_one,
    ops/coscheduling.py:287-293).  K14 on CUDA tensors, its plain version
    on CPU."""
    args = (match, free0, claim_node0, req_count, req_all, req_cl, q_valid, req_bad, ref_cl)
    if match.device.type == "cpu":
        return dra_spec_mask_plain(*args)
    return _dra_spec_mask_cuda(*args)


def dra_spec_mask_plain(match, free0, claim_node0, req_count, req_all, req_cl, q_valid, req_bad, ref_cl):
    """Plain version of K14: node_feasible_plain per pod."""
    rows = [node_feasible_plain(match[p], free0, claim_node0, req_count[p], req_all[p], req_cl[p], q_valid[p],
                                req_bad[p], ref_cl[p])[0] for p in range(match.shape[0])]
    if not rows:
        return torch.zeros((0, match.shape[2]), dtype=BOOL, device=match.device)
    return torch.stack(rows)


def _dra_spec_mask_cuda(match, free0, claim_node0, req_count, req_all, req_cl, q_valid, req_bad, ref_cl):
    dev = match.device
    lib = _build.load()
    P, DQ, N, DD = match.shape
    CL, CQ = claim_node0.shape[0], ref_cl.shape[1]
    c = _build.check_cuda
    out = torch.empty((P, N), dtype=BOOL, device=dev)
    rows = min(P, SPEC_SCRATCH_ROWS) if DD > REG_DD else 0
    scratch = torch.empty((max(rows * N * scratch_words(DD), 1),), dtype=torch.int64, device=dev)
    rc = lib.ktpu_dra_spec_mask(
        c("match", match, dev, BOOL, (P, DQ, N, DD)), c("free0", free0, dev, BOOL, (N, DD)),
        c("claim_node0", claim_node0, dev, I32, (CL,)), c("req_count", req_count, dev, I32, (P, DQ)),
        c("req_all", req_all, dev, BOOL, (P, DQ)), c("req_cl", req_cl, dev, I32, (P, DQ)),
        c("q_valid", q_valid, dev, BOOL, (P, DQ)), c("req_bad", req_bad, dev, BOOL, (P, DQ)),
        c("ref_cl", ref_cl, dev, I32, (P, CQ)), out.data_ptr(), scratch.data_ptr(), P, DQ, N, DD, CL, CQ, rows,
        _build.stream_handle(dev))
    _build.check_launch(lib, rc, "dra_spec_mask")
    _build.launches["dra_spec_mask"] += 1
    return out
