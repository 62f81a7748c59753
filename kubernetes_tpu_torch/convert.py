"""Carry the JAX package's packed state into the port's tensors.

The tests feed the same packed inputs to the JAX root and to the port's
counterpart: the reference's ``NodeTensors`` / ``PodBatch`` (numpy arrays),
its stacked signature rows and its ``FastCommitter`` usage rows become the
port's containers here, dtype for dtype and shape for shape, with no
reordering.  The arguments are duck-typed (any object with the reference's
attribute names), so this module imports nothing of the JAX package; the
port itself never calls it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from kubernetes_tpu_torch.ops import wire
from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster, DTable


def _table(t) -> DTable:
    return DTable(
        req_key=np.asarray(t.req_key, np.int32),
        req_op=np.asarray(t.req_op, np.int32),
        req_vals=np.asarray(t.req_vals, np.int32),
        req_rhs=np.asarray(t.req_rhs, np.int32),
        term_valid=np.asarray(t.term_valid, bool),
    )


def cluster_from_numpy(nt, *, name_key: int, unsched_key: int, empty_val: int, device) -> DeviceCluster:
    """A reference NodeTensors (plus its vocabulary's scalar ids) → DeviceCluster."""
    host = DeviceCluster(
        allocatable=np.asarray(nt.allocatable, np.int32),
        allowed_pods=np.asarray(nt.allowed_pods, np.int32),
        node_labels=np.asarray(nt.label_vals, np.int32),
        val_ints=np.asarray(nt.val_ints, np.int32),
        taint_key=np.asarray(nt.taint_key, np.int32),
        taint_val=np.asarray(nt.taint_val, np.int32),
        taint_effect=np.asarray(nt.taint_effect, np.int32),
        unschedulable=np.asarray(nt.unschedulable, bool),
        node_valid=np.asarray(nt.valid, bool),
        img_sizes=np.asarray(nt.img_sizes, np.int64),
        name_key=int(name_key),
        unsched_key=int(unsched_key),
        empty_val=int(empty_val),
        n_valid_nodes=int(np.asarray(nt.valid).sum()),
    )
    return wire.device_put_packed(host, device)


def batch_from_numpy(pb, device) -> DeviceBatch:
    """A reference PodBatch → DeviceBatch."""
    host = DeviceBatch(
        valid=np.asarray(pb.valid, bool),
        node_sel=_table(pb.node_sel),
        pref_node=_table(pb.pref_node),
        pref_weight=np.asarray(pb.pref_weight, np.int32),
        tol_key=np.asarray(pb.tol_key, np.int32),
        tol_op=np.asarray(pb.tol_op, np.int32),
        tol_val=np.asarray(pb.tol_val, np.int32),
        tol_effect=np.asarray(pb.tol_effect, np.int32),
        target_name_val=np.asarray(pb.target_name_val, np.int32),
        img_ids=np.asarray(pb.img_ids, np.int32),
        n_containers=np.asarray(pb.n_containers, np.int32),
    )
    return wire.device_put_packed(host, device)


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
