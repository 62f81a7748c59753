"""Packed tensor schema for the node snapshot and pending-pod batches.

The node and pod-batch half of the JAX package's schema, for the fields the
signature fast path reads:

  NodeTensors   per-node resources/labels/taints/flags/images      [N, …]
  PodBatch      per pending-pod requests + compiled node-selector,
                preferred-term, toleration and image rows          [P, …]

Conventions (identical to the reference schema, so one packing feeds both):
  - int32 everywhere (image sizes int64); ABSENT = -1 (missing label),
    PAD = -2 (unused slot).
  - resource lanes: 0=cpu millicores, 1=memory MiB, 2=ephemeral MiB, then one
    lane per extended resource (vocab.resources).  Requests round *up*,
    allocatable rounds *down*.
  - capacities are bucketed (bucket_cap) so recurring packs keep their shapes.

Placed-pod packing, spread, inter-pod terms and host ports belong to the
general path and are not packed here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api.resource import Resource
from kubernetes_tpu_torch.api.types import (
    Node,
    Pod,
    TAINT_NO_EXECUTE,
    TAINT_NO_SCHEDULE,
    TAINT_PREFER_NO_SCHEDULE,
    TOLERATION_OP_EXISTS,
)
from kubernetes_tpu_torch.snapshot.interner import ABSENT, INT_INVALID, PAD, Vocab
from kubernetes_tpu_torch.snapshot.selectors import (
    METADATA_NAME_KEY,
    CompiledRequirements,
    compile_match_labels_conjunction,
    compile_node_selector_dnf,
    compile_node_selector_term,
)

# Resource lanes
LANE_CPU = 0
LANE_MEM = 1
LANE_EPH = 2
N_FIXED_LANES = 3

MEM_UNIT = 1 << 20  # memory/ephemeral lane granularity: 1 MiB
_I32_MAX = 2**31 - 1


def _i32(v: int) -> int:
    return min(v, _I32_MAX)


# Taint effects
EFFECT_NO_SCHEDULE = 0
EFFECT_PREFER_NO_SCHEDULE = 1
EFFECT_NO_EXECUTE = 2
EFFECT_ALL = -1  # toleration with empty effect

_EFFECT_CODE = {
    TAINT_NO_SCHEDULE: EFFECT_NO_SCHEDULE,
    TAINT_PREFER_NO_SCHEDULE: EFFECT_PREFER_NO_SCHEDULE,
    TAINT_NO_EXECUTE: EFFECT_NO_EXECUTE,
}

TOL_OP_EQUAL = 0
TOL_OP_EXISTS = 1


def bucket_cap(n: int, minimum: int = 8) -> int:
    """Round up to a stable bucket: powers of two up to 2048, then multiples
    of 1024."""
    n = max(n, minimum, 1)
    if n <= 2048:
        return 1 << math.ceil(math.log2(n))
    return -(-n // 1024) * 1024


# ---------------------------------------------------------------------------
# Resource lanes
# ---------------------------------------------------------------------------


class ResourceLanes:
    """Maps Resource structs onto fixed int32 lanes (see module docstring)."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    @property
    def n_lanes(self) -> int:
        return N_FIXED_LANES + len(self.vocab.resources)

    def request_row(self, r: Resource, n_lanes: Optional[int] = None) -> np.ndarray:
        row = np.zeros(n_lanes or self.n_lanes, dtype=np.int32)
        row[LANE_CPU] = _i32(r.milli_cpu)
        row[LANE_MEM] = _i32(-(-r.memory // MEM_UNIT))  # ceil MiB
        row[LANE_EPH] = _i32(-(-r.ephemeral_storage // MEM_UNIT))
        for name, v in r.scalars.items():
            lane = N_FIXED_LANES + self.vocab.resources.intern(name)
            if lane < len(row):
                row[lane] = _i32(v)
        return row

    def allocatable_row(self, r: Resource, n_lanes: Optional[int] = None) -> np.ndarray:
        row = np.zeros(n_lanes or self.n_lanes, dtype=np.int32)
        row[LANE_CPU] = _i32(r.milli_cpu)
        row[LANE_MEM] = _i32(r.memory // MEM_UNIT)  # floor MiB
        row[LANE_EPH] = _i32(r.ephemeral_storage // MEM_UNIT)
        for name, v in r.scalars.items():
            lane = N_FIXED_LANES + self.vocab.resources.intern(name)
            if lane < len(row):
                row[lane] = _i32(v)
        return row


# ---------------------------------------------------------------------------
# Conjunction tables
# ---------------------------------------------------------------------------


@dataclass
class ConjunctionTable:
    """Padded DNF: [P, T] terms of [R] requirements with [V]-value sets.

    term_valid=False covers both padding and match-nothing terms.  A padded
    requirement slot (op == PAD) evaluates to True inside a valid term.
    """

    req_key: np.ndarray  # i32 [P, T, R]
    req_op: np.ndarray  # i32 [P, T, R]
    req_vals: np.ndarray  # i32 [P, T, R, V]
    req_rhs: np.ndarray  # i32 [P, T, R]
    term_valid: np.ndarray  # bool [P, T]


def pack_conjunction_table(
    per_row_terms: Sequence[Sequence[CompiledRequirements]],
    t_cap: Optional[int] = None,
    r_cap: Optional[int] = None,
    v_cap: Optional[int] = None,
) -> ConjunctionTable:
    p = len(per_row_terms)
    t_need = max((len(ts) for ts in per_row_terms), default=1) or 1
    r_need = max(
        (c.n_reqs for ts in per_row_terms for c in ts), default=1
    ) or 1
    v_need = max(
        (len(vs) for ts in per_row_terms for c in ts for vs in c.vals), default=1
    ) or 1
    T = t_cap or bucket_cap(t_need, 1)
    R = r_cap or bucket_cap(r_need, 1)
    V = v_cap or bucket_cap(v_need, 1)

    req_key = np.full((p, T, R), PAD, dtype=np.int32)
    req_op = np.full((p, T, R), PAD, dtype=np.int32)
    req_vals = np.full((p, T, R, V), PAD, dtype=np.int32)
    req_rhs = np.zeros((p, T, R), dtype=np.int32)
    term_valid = np.zeros((p, T), dtype=bool)

    for i, terms in enumerate(per_row_terms):
        for j, c in enumerate(terms[:T]):
            if c.match_nothing:
                continue
            term_valid[i, j] = True
            for k in range(min(c.n_reqs, R)):
                req_key[i, j, k] = c.keys[k]
                req_op[i, j, k] = c.ops[k]
                req_rhs[i, j, k] = c.rhs_int[k]
                for m, v in enumerate(c.vals[k][:V]):
                    req_vals[i, j, k, m] = v
    return ConjunctionTable(req_key, req_op, req_vals, req_rhs, term_valid)


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------


@dataclass
class NodeTensors:
    """Struct-of-arrays node snapshot (the device mirror of []NodeInfo)."""

    allocatable: np.ndarray  # i32 [N, R]
    requested: np.ndarray  # i32 [N, R]  (by scheduled+assumed pods)
    nonzero_req: np.ndarray  # i32 [N, 2] cpu,mem with spreading defaults
    num_pods: np.ndarray  # i32 [N]
    allowed_pods: np.ndarray  # i32 [N]
    label_vals: np.ndarray  # i32 [N, K]  val id or ABSENT
    val_ints: np.ndarray  # i32 [Vv]     label-val id → parsed int
    taint_key: np.ndarray  # i32 [N, T]
    taint_val: np.ndarray  # i32 [N, T]
    taint_effect: np.ndarray  # i32 [N, T]
    unschedulable: np.ndarray  # bool [N]
    valid: np.ndarray  # bool [N]
    # image id → size bytes present on node (NodeInfo.ImageStates)
    img_sizes: np.ndarray = None  # i64 [N, IMG]
    names: List[str] = field(default_factory=list)
    name_to_idx: Dict[str, int] = field(default_factory=dict)

    @property
    def n_cap(self) -> int:
        return self.allocatable.shape[0]

    @property
    def k_cap(self) -> int:
        return self.label_vals.shape[1]


def _node_label_row(node: Node, vocab: Vocab, k_cap: int) -> np.ndarray:
    row = np.full(k_cap, ABSENT, dtype=np.int32)
    for k, v in node.labels.items():
        ki, vi = vocab.intern_label(k, v)
        if ki < k_cap:
            row[ki] = vi
    ki, vi = vocab.intern_label(METADATA_NAME_KEY, node.name)
    if ki < k_cap:
        row[ki] = vi
    return row


def _padded_val_ints(vocab: Vocab) -> np.ndarray:
    """label-val id → parsed int, padded to the value-vocab bucket."""
    raw = np.asarray(vocab.val_ints(), dtype=np.int32)
    cap = bucket_cap(max(len(raw), 1))
    out = np.full(cap, INT_INVALID, dtype=np.int32)
    out[: len(raw)] = raw
    return out


def pack_nodes(
    nodes: Sequence[Node],
    vocab: Vocab,
    n_cap: Optional[int] = None,
    k_cap: Optional[int] = None,
    t_cap: Optional[int] = None,
) -> NodeTensors:
    # Intern everything first so capacities cover the content.
    for node in nodes:
        for k, v in node.labels.items():
            vocab.intern_label(k, v)
        vocab.intern_label(METADATA_NAME_KEY, node.name)
        for t in node.taints:
            vocab.label_keys.intern(t.key)
            vocab.intern_val(t.value)
        for name in node.allocatable.scalars:
            vocab.resources.intern(name)
        for img in node.images:
            vocab.images.intern(img)

    N = n_cap or bucket_cap(len(nodes))
    K = k_cap or bucket_cap(len(vocab.label_keys))
    T = t_cap or bucket_cap(max((len(n.taints) for n in nodes), default=1), 1)
    lanes = ResourceLanes(vocab)
    R = bucket_cap(lanes.n_lanes, 4)

    nt = NodeTensors(
        allocatable=np.zeros((N, R), dtype=np.int32),
        requested=np.zeros((N, R), dtype=np.int32),
        nonzero_req=np.zeros((N, 2), dtype=np.int32),
        num_pods=np.zeros(N, dtype=np.int32),
        allowed_pods=np.zeros(N, dtype=np.int32),
        label_vals=np.full((N, K), ABSENT, dtype=np.int32),
        val_ints=_padded_val_ints(vocab),
        taint_key=np.full((N, T), PAD, dtype=np.int32),
        taint_val=np.full((N, T), PAD, dtype=np.int32),
        taint_effect=np.full((N, T), PAD, dtype=np.int32),
        unschedulable=np.zeros(N, dtype=bool),
        valid=np.zeros(N, dtype=bool),
        img_sizes=np.zeros((N, bucket_cap(len(vocab.images), 1)), dtype=np.int64),
    )
    for i, node in enumerate(nodes[:N]):
        write_node_row(nt, i, node, vocab)
    return nt


def write_node_row(nt: NodeTensors, i: int, node: Node, vocab: Vocab) -> bool:
    """(Re)pack one node into row i.

    Returns False when any slot axis (labels, resource lanes, taints,
    images) truncated the node's content: the caller must repack at grown
    bucket sizes before scheduling against the snapshot.
    """
    fits = True
    lanes = ResourceLanes(vocab)
    R = nt.allocatable.shape[1]
    nt.allocatable[i] = lanes.allocatable_row(node.allocatable, R)
    if lanes.n_lanes > R:  # after allocatable_row interned new scalars
        fits = False
    nt.allowed_pods[i] = node.allocatable.allowed_pod_number or 110
    nt.label_vals[i] = _node_label_row(node, vocab, nt.k_cap)
    if any(
        vocab.intern_label(k, v)[0] >= nt.k_cap for k, v in node.labels.items()
    ):
        fits = False
    if len(vocab.label_vals) > nt.val_ints.shape[0]:
        # new label VALUE ids outrun the packed parsed-int table's bucket
        fits = False
    else:
        ints = vocab.val_ints()
        nt.val_ints[: len(ints)] = ints
    T = nt.taint_key.shape[1]
    if len(node.taints) > T:
        fits = False
    nt.taint_key[i] = PAD
    nt.taint_val[i] = PAD
    nt.taint_effect[i] = PAD
    for j, t in enumerate(node.taints[:T]):
        nt.taint_key[i, j] = vocab.label_keys.intern(t.key)
        nt.taint_val[i, j] = vocab.intern_val(t.value)
        nt.taint_effect[i, j] = _EFFECT_CODE.get(t.effect, EFFECT_NO_SCHEDULE)
    nt.unschedulable[i] = node.unschedulable
    nt.valid[i] = True
    IMG = nt.img_sizes.shape[1]
    nt.img_sizes[i] = 0
    for img, size in node.images.items():
        ii = vocab.images.intern(img)
        if ii < IMG:
            nt.img_sizes[i, ii] = size
        else:
            fits = False
    if i < len(nt.names):
        old = nt.names[i]
        if old in nt.name_to_idx and old != node.name:
            del nt.name_to_idx[old]
        nt.names[i] = node.name
    else:
        while len(nt.names) < i:
            nt.names.append("")
        nt.names.append(node.name)
    nt.name_to_idx[node.name] = i
    return fits


def write_usage_row(
    nt: NodeTensors,
    i: int,
    requested: Resource,
    non_zero_requested: Resource,
    n_pods: int,
    vocab: Vocab,
) -> None:
    """Node row i's usage columns from the cache's accounting."""
    R = nt.allocatable.shape[1]
    nt.requested[i] = ResourceLanes(vocab).request_row(requested, R)
    nt.nonzero_req[i, 0] = non_zero_requested.milli_cpu
    nt.nonzero_req[i, 1] = -(-non_zero_requested.memory // MEM_UNIT)
    nt.num_pods[i] = n_pods


# ---------------------------------------------------------------------------
# Pending-pod batch
# ---------------------------------------------------------------------------


@dataclass
class PodBatch:
    """One batch of pending pods, compiled for the static evaluation."""

    requests: np.ndarray  # i32 [P, R]
    nonzero_req: np.ndarray  # i32 [P, 2]
    ns_id: np.ndarray  # i32 [P]
    priority: np.ndarray  # i32 [P]
    label_vals: np.ndarray  # i32 [P, K]
    valid: np.ndarray  # bool [P]  (slot holds a real pod)
    # merged nodeSelector ∧ required node-affinity DNF
    node_sel: ConjunctionTable  # [P, T, R, V]
    # preferred node affinity
    pref_node: ConjunctionTable  # [P, PT, R, V]
    pref_weight: np.ndarray  # i32 [P, PT]
    # tolerations
    tol_key: np.ndarray  # i32 [P, TL]  (-1 wildcard, PAD unused)
    tol_op: np.ndarray  # i32 [P, TL]
    tol_val: np.ndarray  # i32 [P, TL]
    tol_effect: np.ndarray  # i32 [P, TL] (EFFECT_ALL=-1 or code; PAD unused)
    # spec.nodeName as an interned label-value id (ABSENT = unset)
    target_name_val: np.ndarray  # i32 [P]
    # container images for ImageLocality
    img_ids: np.ndarray  # i32 [P, I]
    n_containers: np.ndarray  # i32 [P]
    pods: List[Pod] = field(default_factory=list)

    @property
    def p_cap(self) -> int:
        return self.requests.shape[0]


def _merged_node_dnf(pod: Pod, vocab: Vocab) -> List[CompiledRequirements]:
    """spec.nodeSelector AND required node affinity, distributed into DNF."""
    base = compile_match_labels_conjunction(pod.node_selector, vocab)
    terms: List[CompiledRequirements] = []
    if pod.affinity and pod.affinity.node_affinity:
        req = pod.affinity.node_affinity.required_during_scheduling_ignored_during_execution
        if req is not None:
            terms = compile_node_selector_dnf(req, vocab)
    if not terms:
        return [base]
    merged = []
    for t in terms:
        if t.match_nothing:
            merged.append(t)
            continue
        merged.append(
            CompiledRequirements(
                keys=base.keys + t.keys,
                ops=base.ops + t.ops,
                vals=[list(v) for v in base.vals] + [list(v) for v in t.vals],
                rhs_int=base.rhs_int + t.rhs_int,
            )
        )
    return merged


def pack_pod_batch(
    pods: Sequence[Pod],
    vocab: Vocab,
    k_cap: int,
    p_cap: Optional[int] = None,
) -> PodBatch:
    """Pack fast-path pods (no spread, inter-pod terms or host ports: the
    scheduler refuses those before packing).  Interning order matches the
    reference packer, so both assign the same ids on the same input."""
    for pod in pods:
        for k, v in pod.labels.items():
            vocab.intern_label(k, v)
        vocab.namespaces.intern(pod.namespace)
        for name in pod.compute_requests().scalars:
            vocab.resources.intern(name)

    P = p_cap or bucket_cap(len(pods), 1)
    lanes = ResourceLanes(vocab)
    R = bucket_cap(lanes.n_lanes, 4)

    requests = np.zeros((P, R), dtype=np.int32)
    nonzero = np.zeros((P, 2), dtype=np.int32)
    ns_id = np.full(P, ABSENT, dtype=np.int32)
    priority = np.zeros(P, dtype=np.int32)
    label_vals = np.full((P, k_cap), ABSENT, dtype=np.int32)
    target_name_val = np.full(P, ABSENT, dtype=np.int32)
    n_containers = np.zeros(P, dtype=np.int32)

    node_dnfs: List[List[CompiledRequirements]] = []
    pref_terms: List[List[CompiledRequirements]] = []
    pref_weights: List[List[int]] = []
    tols: List[List[Tuple[int, int, int, int]]] = []
    img_rows: List[List[int]] = []

    for i, pod in enumerate(pods[:P]):
        req = pod.compute_requests()
        requests[i] = lanes.request_row(req, R)
        nz = req.non_zero_defaulted()
        nonzero[i] = (_i32(nz.milli_cpu), _i32(-(-nz.memory // MEM_UNIT)))
        ns_id[i] = vocab.namespaces.intern(pod.namespace)
        priority[i] = pod.priority
        for k, v in pod.labels.items():
            ki, vi = vocab.intern_label(k, v)
            if ki < k_cap:
                label_vals[i, ki] = vi
        if pod.node_name:
            target_name_val[i] = vocab.intern_val(pod.node_name)
        # image_locality.go: len(initContainers) + len(containers)
        n_containers[i] = max(len(pod.containers) + len(pod.init_containers), 1)
        img_rows.append([vocab.images.intern(img) for img in pod.images])

        node_dnfs.append(_merged_node_dnf(pod, vocab))

        pt: List[CompiledRequirements] = []
        pw: List[int] = []
        if pod.affinity and pod.affinity.node_affinity:
            for term in (
                pod.affinity.node_affinity.preferred_during_scheduling_ignored_during_execution
            ):
                pt.append(compile_node_selector_term(term.preference, vocab))
                pw.append(term.weight)
        pref_terms.append(pt)
        pref_weights.append(pw)

        trow: List[Tuple[int, int, int, int]] = []
        for tol in pod.tolerations:
            key = vocab.label_keys.intern(tol.key) if tol.key else ABSENT
            op = TOL_OP_EXISTS if tol.operator == TOLERATION_OP_EXISTS else TOL_OP_EQUAL
            # "" is interned like any other value so Equal("") == taint("").
            val = vocab.intern_val(tol.value)
            eff = _EFFECT_CODE.get(tol.effect, EFFECT_ALL) if tol.effect else EFFECT_ALL
            trow.append((key, op, val, eff))
        tols.append(trow)

    while len(node_dnfs) < P:
        node_dnfs.append([])
        pref_terms.append([])
        pref_weights.append([])
        tols.append([])
        img_rows.append([])

    I = bucket_cap(max((len(r) for r in img_rows), default=1), 1)
    img_ids = np.full((P, I), PAD, dtype=np.int32)
    for i, irow in enumerate(img_rows):
        for j, ii in enumerate(irow[:I]):
            img_ids[i, j] = ii

    node_sel = pack_conjunction_table(node_dnfs)
    pref_node = pack_conjunction_table(pref_terms)
    PT = pref_node.term_valid.shape[1]
    pref_weight = np.zeros((P, PT), dtype=np.int32)
    for i, ws in enumerate(pref_weights):
        for j, w in enumerate(ws[:PT]):
            pref_weight[i, j] = w

    TL = bucket_cap(max((len(t) for t in tols), default=1), 1)
    tol_key = np.full((P, TL), PAD, dtype=np.int32)
    tol_op = np.full((P, TL), PAD, dtype=np.int32)
    tol_val = np.full((P, TL), PAD, dtype=np.int32)
    tol_effect = np.full((P, TL), PAD, dtype=np.int32)
    for i, trow in enumerate(tols):
        for j, (k, o, v, e) in enumerate(trow[:TL]):
            tol_key[i, j] = k
            tol_op[i, j] = o
            tol_val[i, j] = v
            tol_effect[i, j] = e

    valid = np.zeros(P, dtype=bool)
    valid[: len(pods)] = True

    return PodBatch(
        requests=requests,
        nonzero_req=nonzero,
        ns_id=ns_id,
        priority=priority,
        label_vals=label_vals,
        valid=valid,
        node_sel=node_sel,
        pref_node=pref_node,
        pref_weight=pref_weight,
        tol_key=tol_key,
        tol_op=tol_op,
        tol_val=tol_val,
        tol_effect=tol_effect,
        target_name_val=target_name_val,
        img_ids=img_ids,
        n_containers=n_containers,
        pods=list(pods),
    )
