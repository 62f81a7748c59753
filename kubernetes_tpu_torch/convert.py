"""Carry the JAX package's packed state into the port's tensors.

The tests feed the same packed inputs to the JAX root and to the port's
counterpart: the reference's ``NodeTensors`` / ``ExistingPodTensors`` /
``PodBatch`` (numpy arrays), its ``GangStatics``, its stacked signature rows,
its ``FastCommitter`` usage rows, its ``_vol_tables`` output, its ``dra_tables`` output,
its ``pack_forks`` planes, its storage objects (PV, PVC, StorageClass) and its DRA objects
(DeviceClass, ResourceSlice, ResourceClaim) become the port's containers here, dtype for
dtype and shape for shape, with no reordering.  The arguments are duck-typed (any object with the reference's
attribute names), so this module imports nothing of the JAX package; the
port itself never calls it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from kubernetes_tpu_torch.api import dra
from kubernetes_tpu_torch.api import storage as st
from kubernetes_tpu_torch.api import types as T
from kubernetes_tpu_torch.ops import wire
from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster, DTable
from kubernetes_tpu_torch.ops.counterfactual import ForkPlanes
from kubernetes_tpu_torch.ops.gang import GangStatics
from kubernetes_tpu_torch.snapshot.interner import Vocab
from kubernetes_tpu_torch.snapshot.schema import pack_existing_pods


def cluster_from_numpy(nt, *, name_key: int, unsched_key: int, empty_val: int, device, ep=None) -> DeviceCluster:
    """A reference NodeTensors (and ExistingPodTensors; none placed when
    omitted) plus its vocabulary's scalar ids → DeviceCluster."""
    if ep is None:
        ep = pack_existing_pods([], {}, Vocab(), k_cap=np.asarray(nt.label_vals).shape[1])
    host = DeviceCluster.from_arrays(nt, ep, name_key=name_key, unsched_key=unsched_key, empty_val=empty_val)
    return wire.device_put_packed(host, device)


def batch_from_numpy(pb, device) -> DeviceBatch:
    """A reference PodBatch → DeviceBatch."""
    return wire.device_put_packed(DeviceBatch.host_tree(pb), device)


def statics_from_numpy(g, device) -> GangStatics:
    """A reference GangStatics (any object with its field names, leaves
    convertible by numpy) → the port's GangStatics, dtype for dtype."""
    return GangStatics(*(torch.as_tensor(np.array(getattr(g, f)), device=device) for f in GangStatics._fields))


def sig_stack_from_numpy(req, nz, az, ok, img, device) -> Dict[str, torch.Tensor]:
    """Stacked signature rows ([S, R] i64, [S, 2] i64, [S] bool, [S, N] bool,
    [S, N] i64) → tensors keyed as sig_scan's arguments."""
    return {
        "sig_req": torch.as_tensor(np.asarray(req, np.int64), device=device),
        "sig_nz": torch.as_tensor(np.asarray(nz, np.int64), device=device),
        "sig_allzero": torch.as_tensor(np.asarray(az, bool), device=device),
        "sig_ok": torch.as_tensor(np.asarray(ok, bool), device=device),
        "sig_img": torch.as_tensor(np.asarray(img, np.int64), device=device),
    }


def usage_from_committer(fc, device) -> Dict[str, torch.Tensor]:
    """A reference FastCommitter's usage rows → sig_scan's state tensors."""
    return {
        "alloc": torch.as_tensor(np.asarray(fc.alloc_rows, np.int64), device=device),
        "allowed": torch.as_tensor(np.asarray(fc.allowed, np.int32), device=device),
        "used": torch.as_tensor(np.asarray(fc.used_rows, np.int64), device=device),
        "nz0": torch.as_tensor(np.asarray(fc.nz0, np.int64), device=device),
        "nz1": torch.as_tensor(np.asarray(fc.nz1, np.int64), device=device),
        "num_pods": torch.as_tensor(np.asarray(fc.num_pods, np.int32), device=device),
    }


def wave_tables_from_numpy(wt, device) -> dict:
    """A reference wave_tables dict (arrays and static ints) → the port's:
    arrays become tensors, dtype for dtype; the ints and flags stay."""
    return {k: torch.as_tensor(np.array(v), device=device) if np.ndim(v) else v for k, v in wt.items()}


def gang_arrays_from_numpy(gang_arrays, device) -> dict:
    """The reference's workloads/gang.py ``gang_arrays`` output (gang_id,
    gang_first, gang_last, gang_need, g_cap, slot_keys) → the workloads
    dispatch's keyword arguments: the four [P] rows as tensors, dtype for
    dtype, and g_cap as it is."""
    gid, first, last, need, g_cap = gang_arrays[:5]
    rows = dict(gang_id=gid, gang_first=first, gang_last=last, gang_need=need)
    out = {k: torch.as_tensor(np.array(v), device=device) for k, v in rows.items()}
    out["g_cap"] = int(g_cap)
    return out


def vol_tables_from_numpy(volt, device) -> dict:
    """The reference scheduler's ``_vol_tables`` output (vol_table, a DTable
    of arrays [P, PV2, T, R(, V)], vol_valid [P, PV2], vol_bad [P]) → the
    workloads dispatch's keyword arguments, dtype for dtype."""
    t = volt["vol_table"]
    table = DTable(*(torch.as_tensor(np.array(getattr(t, f)), device=device)
                     for f in ("req_key", "req_op", "req_vals", "req_rhs", "term_valid")))
    return dict(vol_table=table, vol_valid=torch.as_tensor(np.array(volt["vol_valid"]), device=device),
                vol_bad=torch.as_tensor(np.array(volt["vol_bad"]), device=device))


def fork_planes_from_numpy(planes, device):
    """The reference's planner/forks.py ``pack_forks`` planes (a dict of
    fk_* numpy arrays) → the port's ForkPlanes, dtype for dtype."""
    return ForkPlanes.from_host({k: np.array(v) for k, v in planes.items()}, device)


def _node_selector(sel):
    if sel is None:
        return None
    return T.NodeSelector(tuple(
        T.NodeSelectorTerm(
            match_expressions=tuple(T.NodeSelectorRequirement(r.key, r.operator, tuple(r.values))
                                    for r in term.match_expressions),
            match_fields=tuple(T.NodeSelectorRequirement(r.key, r.operator, tuple(r.values))
                               for r in term.match_fields))
        for term in sel.node_selector_terms))


def pv_from_reference(pv) -> st.PersistentVolume:
    """A reference PersistentVolume → the port's (node affinity rebuilt in
    the port's selector types)."""
    ref = pv.claim_ref
    return st.PersistentVolume(
        name=pv.name, labels=dict(pv.labels), capacity=pv.capacity, access_modes=tuple(pv.access_modes),
        storage_class_name=pv.storage_class_name, node_affinity=_node_selector(pv.node_affinity),
        claim_ref=None if ref is None else st.ObjectRef(ref.namespace, ref.name, ref.uid), phase=pv.phase,
        volume_mode=pv.volume_mode, source_kind=pv.source_kind, source_id=pv.source_id, csi_driver=pv.csi_driver,
        read_only=pv.read_only, resource_version=pv.resource_version)


def pvc_from_reference(pvc) -> st.PersistentVolumeClaim:
    """A reference PersistentVolumeClaim → the port's (a label selector on
    the claim is for binding, which the port does not port: it must be
    None)."""
    if pvc.selector is not None:
        raise NotImplementedError("a claim's volume selector belongs to static binding (ROADMAP A6b)")
    return st.PersistentVolumeClaim(
        name=pvc.name, namespace=pvc.namespace, labels=dict(pvc.labels), annotations=dict(pvc.annotations),
        storage_class_name=pvc.storage_class_name, access_modes=tuple(pvc.access_modes), request=pvc.request,
        volume_mode=pvc.volume_mode, volume_name=pvc.volume_name, phase=pvc.phase,
        deletion_timestamp=pvc.deletion_timestamp, resource_version=pvc.resource_version)


def storage_class_from_reference(sc) -> st.StorageClass:
    """A reference StorageClass → the port's (allowedTopologies only steer
    dynamic provisioning, which the port does not port)."""
    return st.StorageClass(name=sc.name, provisioner=sc.provisioner, volume_binding_mode=sc.volume_binding_mode,
                           resource_version=sc.resource_version)


def dra_tables_from_numpy(dt, device) -> dict:
    """The reference's ops/dra.py ``dra_tables`` output → the port's: the
    arrays become tensors, dtype for dtype; claim_keys and the host-side
    has_claims row stay as they are."""
    return {k: v if k in ("claim_keys", "has_claims") else torch.as_tensor(np.array(v), device=device)
            for k, v in dt.items()}


def _selectors(sels):
    return tuple(dra.DeviceSelector(s.attribute, s.operator, tuple(s.values)) for s in sels)


def device_class_from_reference(cls) -> dra.DeviceClass:
    return dra.DeviceClass(name=cls.name, selectors=_selectors(cls.selectors),
                           resource_version=cls.resource_version)


def resource_slice_from_reference(sl) -> dra.ResourceSlice:
    return dra.ResourceSlice(name=sl.name, node_name=sl.node_name, driver=sl.driver, pool=sl.pool,
                             devices=tuple(dra.Device(d.name, tuple((k, v) for k, v in d.attributes))
                                           for d in sl.devices),
                             resource_version=sl.resource_version)


def resource_claim_from_reference(c) -> dra.ResourceClaim:
    """A reference ResourceClaim, its allocation and reservedFor included."""
    alloc = None
    if c.allocation is not None:
        alloc = dra.AllocationResult(
            results=tuple(dra.DeviceRequestAllocationResult(r.request, r.driver, r.pool, r.device)
                          for r in c.allocation.results),
            node_name=c.allocation.node_name)
    return dra.ResourceClaim(
        name=c.name, namespace=c.namespace,
        requests=tuple(dra.DeviceRequest(name=r.name, device_class_name=r.device_class_name, count=r.count,
                                         allocation_mode=r.allocation_mode, selectors=_selectors(r.selectors))
                       for r in c.requests),
        allocation=alloc, reserved_for=tuple(c.reserved_for), deallocation_requested=c.deallocation_requested,
        deletion_timestamp=c.deletion_timestamp, resource_version=c.resource_version)
