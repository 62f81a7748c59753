"""Shared device containers and primitive evaluators (plain PyTorch).

Dataclasses of tensors take the place of the JAX package's registered
pytrees; the field names and dtypes are the reference's.  Fields no kernel
of the ported slice reads (placed pods, their terms, host ports, spread and
inter-pod batch rows) are added by the slice that reads them.  The scalar
vocabulary ids stay host ints: the kernels take them as launch arguments.

The conjunction-table evaluator is the vectorized analogue of
labels.Selector.Matches / nodeaffinity.RequiredNodeAffinity.Match.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from kubernetes_tpu_torch.ops import wire
from kubernetes_tpu_torch.snapshot.interner import ABSENT, INT_INVALID, PAD, Vocab
from kubernetes_tpu_torch.snapshot.schema import ConjunctionTable, NodeTensors, PodBatch
from kubernetes_tpu_torch.snapshot.selectors import (
    METADATA_NAME_KEY,
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_GT,
    OP_IN,
    OP_NOT_IN,
)

I32 = torch.int32
I64 = torch.int64


@dataclass
class DTable:
    """Device copy of a ConjunctionTable."""

    req_key: Any  # i32 [..., R]
    req_op: Any  # i32 [..., R]
    req_vals: Any  # i32 [..., R, V]
    req_rhs: Any  # i32 [..., R]
    term_valid: Any  # bool [...]

    @classmethod
    def host_tree(cls, t: ConjunctionTable) -> "DTable":
        return cls(
            req_key=np.asarray(t.req_key, np.int32),
            req_op=np.asarray(t.req_op, np.int32),
            req_vals=np.asarray(t.req_vals, np.int32),
            req_rhs=np.asarray(t.req_rhs, np.int32),
            term_valid=np.asarray(t.term_valid, bool),
        )


@dataclass
class DeviceCluster:
    """Device-resident node snapshot (the static half the fast path reads)."""

    allocatable: Any  # i32 [N, R]
    allowed_pods: Any  # i32 [N]
    node_labels: Any  # i32 [N, K]
    val_ints: Any  # i32 [V]
    taint_key: Any  # i32 [N, T]
    taint_val: Any  # i32 [N, T]
    taint_effect: Any  # i32 [N, T]
    unschedulable: Any  # bool [N]
    node_valid: Any  # bool [N]
    img_sizes: Any  # i64 [N, IMG]
    # scalar ids resolved from the vocab
    name_key: int  # label-key id of metadata.name
    unsched_key: int  # label-key id of node.kubernetes.io/unschedulable
    empty_val: int  # label-val id of ""
    n_valid_nodes: int  # number of real nodes

    @classmethod
    def host_tree(cls, nt: NodeTensors, vocab: Vocab) -> "DeviceCluster":
        return cls(
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
            name_key=int(vocab.label_keys.lookup(METADATA_NAME_KEY)),
            unsched_key=int(
                vocab.label_keys.lookup("node.kubernetes.io/unschedulable")
            ),
            empty_val=int(vocab.label_vals.lookup("")),
            n_valid_nodes=int(nt.valid.sum()),
        )

    @classmethod
    def from_host(cls, nt: NodeTensors, vocab: Vocab, device) -> "DeviceCluster":
        return wire.device_put_packed(cls.host_tree(nt, vocab), device)


@dataclass
class DeviceBatch:
    """Pending-pod batch on device (the fields static_eval reads)."""

    valid: Any  # bool [P]
    node_sel: DTable  # [P, T, ...]
    pref_node: DTable  # [P, PT, ...]
    pref_weight: Any  # i32 [P, PT]
    tol_key: Any  # i32 [P, TL]
    tol_op: Any  # i32 [P, TL]
    tol_val: Any  # i32 [P, TL]
    tol_effect: Any  # i32 [P, TL]
    target_name_val: Any  # i32 [P]
    img_ids: Any  # i32 [P, I]
    n_containers: Any  # i32 [P]

    @classmethod
    def host_tree(cls, pb: PodBatch) -> "DeviceBatch":
        return cls(
            valid=np.asarray(pb.valid, bool),
            node_sel=DTable.host_tree(pb.node_sel),
            pref_node=DTable.host_tree(pb.pref_node),
            pref_weight=np.asarray(pb.pref_weight, np.int32),
            tol_key=np.asarray(pb.tol_key, np.int32),
            tol_op=np.asarray(pb.tol_op, np.int32),
            tol_val=np.asarray(pb.tol_val, np.int32),
            tol_effect=np.asarray(pb.tol_effect, np.int32),
            target_name_val=np.asarray(pb.target_name_val, np.int32),
            img_ids=np.asarray(pb.img_ids, np.int32),
            n_containers=np.asarray(pb.n_containers, np.int32),
        )

    @classmethod
    def from_host(cls, pb: PodBatch, device) -> "DeviceBatch":
        return wire.device_put_packed(cls.host_tree(pb), device)


# ---------------------------------------------------------------------------
# Conjunction evaluation
# ---------------------------------------------------------------------------


def eval_table(table: DTable, label_vals, val_ints):
    """Evaluate every conjunction against every label row.

    table tensors have shape ``lead + (R,)`` / ``lead + (R, V)``;
    ``label_vals`` is ``[N, K]``.  Returns bool ``lead + (N,)`` with
    term_valid folded in (invalid/padding terms match nothing).

    Requirement semantics mirror labels.Requirement.Matches: NotIn also
    matches absent keys; Gt/Lt need both sides to parse as integers; a
    padded requirement slot passes.
    """
    R = table.req_key.shape[-1]
    V = table.req_vals.shape[-1]
    N, K = label_vals.shape
    cols = label_vals.T  # [K, N]
    n_ints = val_ints.shape[0]

    ok = None
    for r in range(R):
        key = table.req_key[..., r]  # lead
        op = table.req_op[..., r].unsqueeze(-1)
        rhs = table.req_rhs[..., r].unsqueeze(-1)
        val = gather_at(cols, key)  # lead+(N,)
        present = val >= 0

        in_any = torch.zeros_like(present)
        for v in range(V):
            rv = table.req_vals[..., r, v].unsqueeze(-1)
            in_any = in_any | (present & (val == rv) & (rv >= 0))

        iv = torch.where(
            present, val_ints[val.clamp(0, n_ints - 1).long()], INT_INVALID
        )
        int_ok = (iv != INT_INVALID) & (rhs != INT_INVALID)

        res = torch.where(
            op == OP_IN,
            in_any,
            torch.where(
                op == OP_NOT_IN,
                ~in_any,
                torch.where(
                    op == OP_EXISTS,
                    present,
                    torch.where(
                        op == OP_DOES_NOT_EXIST,
                        ~present,
                        torch.where(
                            op == OP_GT,
                            int_ok & (iv > rhs),
                            int_ok & (iv < rhs),  # OP_LT
                        ),
                    ),
                ),
            ),
        )
        res = res | (op == PAD)  # padded requirement slot
        ok = res if ok is None else (ok & res)
    return ok & table.term_valid.unsqueeze(-1)


def dnf_any(term_matches):
    """OR over the term axis (second-to-last): ``lead+(T, N)`` → ``lead+(N,)``."""
    return term_matches.any(dim=-2)


def gather_at(cols_t, key):
    """cols_t: [K, N]; key: lead → lead+(N,) of label values (ABSENT when the
    key id is out of range/padding)."""
    K = cols_t.shape[0]
    key = torch.as_tensor(key, device=cols_t.device)
    known = ((key >= 0) & (key < K)).unsqueeze(-1)
    safe = key.clamp(0, K - 1).long()
    return torch.where(known, cols_t[safe], ABSENT)


# ---------------------------------------------------------------------------
# The per-commit usage update (scalar form)
# ---------------------------------------------------------------------------


def usage_carry_update(rows, deltas, node, live):
    """One serial-recurrence commit, in place: every ``rows[k]`` ([N, ...])
    gains ``deltas[k]`` at row ``node`` when ``live``.  ``node`` and
    ``live`` are 0-d tensors, so no host sync happens; the rank-1 one-hot
    form is the reference's scatter-free update.  The JAX package donates
    the carried buffers; here the same tensors are updated in place."""
    N = next(iter(rows.values())).shape[0]
    onehot = (torch.arange(N, device=node.device) == node) & live
    for k, row in rows.items():
        oh = onehot.reshape((N,) + (1,) * (row.dim() - 1)).to(row.dtype)
        row.add_(oh * torch.as_tensor(deltas[k], dtype=row.dtype, device=row.device))
    return rows
