"""Shared device containers and primitive evaluators (plain PyTorch).

Dataclasses of tensors take the place of the JAX package's registered
pytrees; the field names and dtypes are the reference's.  The scalar
vocabulary ids stay host ints: the kernels take them as launch arguments.
``DeviceCluster.dom_ids`` (with ``dom_size`` and ``dom_off``, each key's
domain count and their prefix sums, and ``dom_vals``, each domain's label
value) has no counterpart there: the CUDA kernels of the gang path
accumulate per topology domain under these compact ids, where the reference
segments over the whole label-value vocabulary, and read a node's label
value for a key as the value of its domain (a node-major [K, N] row, where
``node_labels`` is node-minor).

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
from kubernetes_tpu_torch.snapshot.schema import (
    ConjunctionTable,
    ExistingPodTensors,
    NodeTensors,
    PodBatch,
    pack_existing_pods,
)
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


def log_table(n_cap: int) -> np.ndarray:
    """Fixed-point round(log(i + 2) * 2**32) for i in [0, n_cap + 2): the
    spread score's topologyNormalizingWeight, built on the host with the
    reference's expression (ops/common.py:135-137) and never on the device."""
    return np.round(np.log(np.arange(n_cap + 2, dtype=np.float64) + 2.0) * (1 << 32)).astype(np.int64)


def domain_ids(label_vals: np.ndarray):
    """Per label key, each node's compact domain id: the rank of its value id
    among the distinct values present in that column (-1 where absent), as
    gang.batch_tables numbers them.  Returns (ids i32 [K, N], counts [K],
    values i32 [sum(counts)]: each key's distinct value ids in rank order,
    key after key)."""
    lv = np.asarray(label_vals)
    N, K = lv.shape
    ids = np.full((K, N), -1, np.int32)
    counts, values = [], []
    for k in range(K):
        col = lv[:, k]
        pos = col >= 0
        n = 0
        if pos.any():
            uniq, inv = np.unique(col[pos], return_inverse=True)
            ids[k, pos] = inv.astype(np.int32)
            n = len(uniq)
            values.append(uniq.astype(np.int32))
        counts.append(n)
    return ids, tuple(counts), np.concatenate(values or [np.zeros(0, np.int32)]).astype(np.int32)


@dataclass
class DeviceCluster:
    """Device-resident cluster snapshot: nodes, placed pods, their terms."""

    # nodes
    allocatable: Any  # i32 [N, R]
    requested: Any  # i32 [N, R]
    nonzero_req: Any  # i32 [N, 2]
    num_pods: Any  # i32 [N]
    allowed_pods: Any  # i32 [N]
    node_labels: Any  # i32 [N, K]
    val_ints: Any  # i32 [V]
    taint_key: Any  # i32 [N, T]
    taint_val: Any  # i32 [N, T]
    taint_effect: Any  # i32 [N, T]
    unschedulable: Any  # bool [N]
    node_valid: Any  # bool [N]
    used_ppk: Any  # i32 [N, U]
    used_ip: Any  # i32 [N, U]
    used_wild: Any  # bool [N, U]
    img_sizes: Any  # i64 [N, IMG]
    # placed pods
    epod_node: Any  # i32 [E]
    epod_ns: Any  # i32 [E]
    epod_labels: Any  # i32 [E, K]
    epod_valid: Any  # bool [E]
    epod_deleting: Any  # bool [E]
    # flattened (anti-)affinity terms of placed pods
    term_pod: Any  # i32 [M]
    term_kind: Any  # i32 [M]
    term_topo: Any  # i32 [M]
    term_weight: Any  # i32 [M]
    term_table: DTable  # [M, 1, ...]
    term_ns_all: Any  # bool [M]
    term_ns_ids: Any  # i32 [M, NS]
    log_tab: Any  # i64 [N+2]  fixed-point round(log(i+2)·2^32)
    dom_ids: Any  # i32 [K, N]  compact per-key domain ids (domain_ids)
    dom_size: Any  # i32 [K]  distinct domains per key (dom_counts on the device)
    dom_off: Any  # i32 [K + 1]  prefix sums of dom_size
    dom_vals: Any  # i32 [sum(dom_size)]  each key's domains' label value ids, at dom_off[key] + domain id
    visit_rank: Any  # i32 [N]  zone-round-robin visit rank (-1: pad row)
    # scalar ids resolved from the vocab
    name_key: int  # label-key id of metadata.name
    unsched_key: int  # label-key id of node.kubernetes.io/unschedulable
    empty_val: int  # label-val id of ""
    n_valid_nodes: int  # number of real nodes
    dom_counts: tuple = ()  # distinct domains per key (host ints; dom_size on the device)

    @classmethod
    def host_tree(cls, nt: NodeTensors, vocab: Vocab, ep: ExistingPodTensors = None) -> "DeviceCluster":
        """numpy-leaved instance; without ``ep`` the placed-pod axes are
        empty (the fast path's static reads)."""
        if ep is None:
            ep = pack_existing_pods([], {}, vocab, k_cap=nt.k_cap)
        return cls.from_arrays(
            nt,
            ep,
            name_key=vocab.label_keys.lookup(METADATA_NAME_KEY),
            unsched_key=vocab.label_keys.lookup("node.kubernetes.io/unschedulable"),
            empty_val=vocab.label_vals.lookup(""),
        )

    @classmethod
    def from_arrays(cls, nt, ep, *, name_key: int, unsched_key: int, empty_val: int) -> "DeviceCluster":
        """numpy-leaved instance from packed node and placed-pod tensors (any
        objects with the schema's attribute names) and the scalar ids."""
        lv = np.asarray(nt.label_vals)
        if lv.size and int(lv.max()) >= np.asarray(nt.val_ints).shape[0]:
            # numeric selectors (Gt / Lt) read val_ints at node label value
            # ids, which must lie inside the table (the packers keep this)
            raise ValueError("node label value ids outrun the packed value table")
        ids, counts, values = domain_ids(lv)
        return cls(
            allocatable=np.asarray(nt.allocatable, np.int32),
            requested=np.asarray(nt.requested, np.int32),
            nonzero_req=np.asarray(nt.nonzero_req, np.int32),
            num_pods=np.asarray(nt.num_pods, np.int32),
            allowed_pods=np.asarray(nt.allowed_pods, np.int32),
            node_labels=np.asarray(nt.label_vals, np.int32),
            val_ints=np.asarray(nt.val_ints, np.int32),
            taint_key=np.asarray(nt.taint_key, np.int32),
            taint_val=np.asarray(nt.taint_val, np.int32),
            taint_effect=np.asarray(nt.taint_effect, np.int32),
            unschedulable=np.asarray(nt.unschedulable, bool),
            node_valid=np.asarray(nt.valid, bool),
            used_ppk=np.asarray(nt.used_ppk, np.int32),
            used_ip=np.asarray(nt.used_ip, np.int32),
            used_wild=np.asarray(nt.used_wild, bool),
            img_sizes=np.asarray(nt.img_sizes, np.int64),
            epod_node=np.asarray(ep.node_idx, np.int32),
            epod_ns=np.asarray(ep.ns_id, np.int32),
            epod_labels=np.asarray(ep.label_vals, np.int32),
            epod_valid=np.asarray(ep.valid, bool),
            epod_deleting=np.asarray(ep.deleting, bool),
            term_pod=np.asarray(ep.term_pod, np.int32),
            term_kind=np.asarray(ep.term_kind, np.int32),
            term_topo=np.asarray(ep.term_topo_key, np.int32),
            term_weight=np.asarray(ep.term_weight, np.int32),
            term_table=DTable.host_tree(ep.term_table),
            term_ns_all=np.asarray(ep.term_ns_all, bool),
            term_ns_ids=np.asarray(ep.term_ns_ids, np.int32),
            log_tab=log_table(np.asarray(nt.valid).shape[0]),
            dom_ids=ids,
            dom_size=np.asarray(counts, np.int32).reshape(-1),
            dom_off=np.concatenate([[0], np.cumsum(counts, dtype=np.int64)]).astype(np.int32),
            dom_vals=values,
            visit_rank=np.asarray(nt.visit_rank, np.int32),
            name_key=int(name_key),
            unsched_key=int(unsched_key),
            empty_val=int(empty_val),
            n_valid_nodes=int(np.asarray(nt.valid).sum()),
            dom_counts=counts,
        )

    @classmethod
    def from_host(cls, nt: NodeTensors, vocab: Vocab, device, ep: ExistingPodTensors = None) -> "DeviceCluster":
        return wire.device_put_packed(cls.host_tree(nt, vocab, ep), device)


@dataclass
class DeviceBatch:
    """Pending-pod batch on device."""

    requests: Any  # i32 [P, R]
    nonzero_req: Any  # i32 [P, 2]
    ns_id: Any  # i32 [P]
    priority: Any  # i32 [P]
    labels: Any  # i32 [P, K]
    valid: Any  # bool [P]
    node_sel: DTable  # [P, T, ...]
    pref_node: DTable  # [P, PT, ...]
    pref_weight: Any  # i32 [P, PT]
    tol_key: Any  # i32 [P, TL]
    tol_op: Any  # i32 [P, TL]
    tol_val: Any  # i32 [P, TL]
    tol_effect: Any  # i32 [P, TL]
    tsc_table: DTable  # [P, C, ...]
    tsc_topo: Any  # i32 [P, C]
    tsc_max_skew: Any  # i32 [P, C]
    tsc_hard: Any  # bool [P, C]
    tsc_min_domains: Any  # i32 [P, C]
    tsc_honor_affinity: Any  # bool [P, C]
    tsc_honor_taints: Any  # bool [P, C]
    aff_table: DTable  # [P, AT, ...]
    aff_kind: Any  # i32 [P, AT]
    aff_topo: Any  # i32 [P, AT]
    aff_weight: Any  # i32 [P, AT]
    aff_ns_all: Any  # bool [P, AT]
    aff_ns_ids: Any  # i32 [P, AT, NS]
    target_name_val: Any  # i32 [P]
    want_ppk: Any  # i32 [P, W]
    want_ip: Any  # i32 [P, W]
    want_wild: Any  # bool [P, W]
    img_ids: Any  # i32 [P, I]
    n_containers: Any  # i32 [P]

    @classmethod
    def host_tree(cls, pb: PodBatch) -> "DeviceBatch":
        return cls(
            requests=np.asarray(pb.requests, np.int32),
            nonzero_req=np.asarray(pb.nonzero_req, np.int32),
            ns_id=np.asarray(pb.ns_id, np.int32),
            priority=np.asarray(pb.priority, np.int32),
            labels=np.asarray(pb.label_vals, np.int32),
            valid=np.asarray(pb.valid, bool),
            node_sel=DTable.host_tree(pb.node_sel),
            pref_node=DTable.host_tree(pb.pref_node),
            pref_weight=np.asarray(pb.pref_weight, np.int32),
            tol_key=np.asarray(pb.tol_key, np.int32),
            tol_op=np.asarray(pb.tol_op, np.int32),
            tol_val=np.asarray(pb.tol_val, np.int32),
            tol_effect=np.asarray(pb.tol_effect, np.int32),
            tsc_table=DTable.host_tree(pb.tsc_table),
            tsc_topo=np.asarray(pb.tsc_topo_key, np.int32),
            tsc_max_skew=np.asarray(pb.tsc_max_skew, np.int32),
            tsc_hard=np.asarray(pb.tsc_hard, bool),
            tsc_min_domains=np.asarray(pb.tsc_min_domains, np.int32),
            tsc_honor_affinity=np.asarray(pb.tsc_honor_affinity, bool),
            tsc_honor_taints=np.asarray(pb.tsc_honor_taints, bool),
            aff_table=DTable.host_tree(pb.aff_table),
            aff_kind=np.asarray(pb.aff_kind, np.int32),
            aff_topo=np.asarray(pb.aff_topo_key, np.int32),
            aff_weight=np.asarray(pb.aff_weight, np.int32),
            aff_ns_all=np.asarray(pb.aff_ns_all, bool),
            aff_ns_ids=np.asarray(pb.aff_ns_ids, np.int32),
            target_name_val=np.asarray(pb.target_name_val, np.int32),
            want_ppk=np.asarray(pb.want_ppk, np.int32),
            want_ip=np.asarray(pb.want_ip, np.int32),
            want_wild=np.asarray(pb.want_wild, bool),
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
    cols = label_vals.T  # [K, N]
    return _eval_reqs(table, lambda key: gather_at(cols, key), val_ints)


def eval_table_self(table: DTable, labels, val_ints):
    """Each lead row's conjunctions against its OWN label row: table lead
    ``(P, T)`` and ``labels`` ``[P, K]`` → bool ``[P, T]`` (the reference's
    vmap of eval_table over the pod axis)."""
    K = labels.shape[1]

    def values(key):
        known = (key >= 0) & (key < K)
        got = torch.gather(labels, 1, key.clamp(0, K - 1).long().reshape(key.shape[0], -1)).reshape(key.shape)
        return torch.where(known, got, ABSENT).unsqueeze(-1)

    return _eval_reqs(table, values, val_ints)[..., 0]


def _eval_reqs(table: DTable, values, val_ints):
    """The requirement algebra of eval_table; ``values(key)`` maps lead-shaped
    key ids to lead+(N,) label value ids."""
    R = table.req_key.shape[-1]
    V = table.req_vals.shape[-1]
    n_ints = val_ints.shape[0]

    ok = None
    for r in range(R):
        key = table.req_key[..., r]  # lead
        op = table.req_op[..., r].unsqueeze(-1)
        rhs = table.req_rhs[..., r].unsqueeze(-1)
        val = values(key)  # lead+(N,)
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


def ns_member(ns_all, ns_ids, target_ns):
    """Namespace-set membership: ``lead`` bools / ``lead+(S,)`` ids vs ``[E]``
    namespaces → ``lead+(E,)``."""
    S = ns_ids.shape[-1]
    ok = ns_all.unsqueeze(-1).expand(ns_all.shape + (target_ns.shape[0],))
    for s in range(S):
        nid = ns_ids[..., s].unsqueeze(-1)
        ok = ok | ((nid >= 0) & (nid == target_ns))
    return ok


# ---------------------------------------------------------------------------
# Segment helpers (per-node and per-domain aggregation)
# ---------------------------------------------------------------------------


def per_node_counts(values_e, node_idx, n_nodes: int):
    """Sum values over placed pods grouped by their node: ``lead+(E,)`` →
    ``lead+(N,)``; rows with an invalid node index are dropped."""
    lead = values_e.shape[:-1]
    E = values_e.shape[-1]
    seg = torch.where((node_idx >= 0) & (node_idx < n_nodes), node_idx, n_nodes).long()
    flat = values_e.reshape(-1, E)
    out = torch.zeros((flat.shape[0], n_nodes + 1), dtype=flat.dtype, device=flat.device)
    out.scatter_add_(1, seg.unsqueeze(0).expand(flat.shape[0], E), flat)
    return out[:, :n_nodes].reshape(lead + (n_nodes,))


def domain_stats(count_n, present_n, dv, v_cap: int):
    """Aggregate per-node values by topology-domain id (label-value id, <0
    absent, ids >= v_cap treated as absent) and read them back per node.

    Returns (per_node_total, per_node_domain_present, min_over_present,
    n_domains); the min is INT32_MAX when no domain is present.
    """
    lead = count_n.shape[:-1]
    N = count_n.shape[-1]
    seg = torch.where((dv >= 0) & (dv < v_cap), dv, v_cap).long().reshape(-1, N)
    cnt = count_n.reshape(-1, N)
    pres = present_n.reshape(-1, N).to(torch.int32)
    rows = cnt.shape[0]
    tot = torch.zeros((rows, v_cap + 1), dtype=cnt.dtype, device=cnt.device).scatter_add_(1, seg, cnt)
    dpres = torch.zeros((rows, v_cap + 1), dtype=torch.int32, device=cnt.device).scatter_reduce_(
        1, seg, pres, reduce="amax"
    ) > 0
    dpres[:, v_cap] = False
    per_node_tot = torch.gather(tot, 1, seg)
    per_node_pres = torch.gather(dpres, 1, seg)
    big = torch.iinfo(torch.int32).max
    mn = torch.where(dpres, tot, torch.full_like(tot, big)).min(dim=1).values
    ndom = dpres.to(torch.int32).sum(dim=1)  # int64, as jnp.sum gives
    return (
        per_node_tot.reshape(lead + (N,)),
        per_node_pres.reshape(lead + (N,)),
        mn.reshape(lead),
        ndom.reshape(lead),
    )


def gather_at(cols_t, key):
    """cols_t: [K, N]; key: lead → lead+(N,) of label values (ABSENT when the
    key id is out of range/padding)."""
    K = cols_t.shape[0]
    key = torch.as_tensor(key, device=cols_t.device)
    known = ((key >= 0) & (key < K)).unsqueeze(-1)
    safe = key.clamp(0, K - 1).long()
    return torch.where(known, cols_t[safe], ABSENT)


# ---------------------------------------------------------------------------
# The per-commit usage update
# ---------------------------------------------------------------------------


def usage_carry_update(rows, deltas, node, live):
    """THE serial-recurrence commit, in place: every ``rows[k]`` ([N, ...])
    gains ``deltas[k]`` at row ``node`` when ``live``.

    ``node`` and ``live`` are 0-d tensors (one commit: the rank-1 one-hot
    form, no host sync) or [W] tensors (a resident round's window of
    commits: a scatter-add; within a round each walk position commits at
    most once, so the adds are disjoint and equal replaying the scalar form
    slot by slot).  The JAX package donates the carried buffers; here the
    same tensors are updated in place."""
    if node.dim() == 0:
        N = next(iter(rows.values())).shape[0]
        onehot = (torch.arange(N, device=node.device) == node) & live
        for k, row in rows.items():
            oh = onehot.reshape((N,) + (1,) * (row.dim() - 1)).to(row.dtype)
            row.add_(oh * torch.as_tensor(deltas[k], dtype=row.dtype, device=row.device))
        return rows
    idx = node.long()
    for k, row in rows.items():
        d = torch.as_tensor(deltas[k], dtype=row.dtype, device=row.device)
        gate = live.reshape(live.shape + (1,) * (row.dim() - 1)).to(row.dtype)
        row.index_add_(0, idx, d.expand(idx.shape + row.shape[1:]) * gate)
    return rows
