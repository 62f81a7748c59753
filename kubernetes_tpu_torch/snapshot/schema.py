"""Packed tensor schema for the cluster snapshot and pending-pod batches.

The JAX package's schema, for the fields the ported paths read:

  NodeTensors          per-node resources/labels/taints/flags/ports/images [N, …]
  ExistingPodTensors   per placed-pod labels/namespace/node index and the
                       flattened (anti-)affinity terms of placed pods     [E, …]
  PodBatch             per pending-pod requests + compiled node-selector,
                       preferred-term, toleration, spread, inter-pod,
                       host-port and image rows                           [P, …]

Conventions (identical to the reference schema, so one packing feeds both):
  - int32 everywhere (image sizes int64); ABSENT = -1 (missing label),
    PAD = -2 (unused slot).
  - resource lanes: 0=cpu millicores, 1=memory MiB, 2=ephemeral MiB, then one
    lane per extended resource (vocab.resources).  Requests round *up*,
    allocatable rounds *down*.
  - capacities are bucketed (bucket_cap) so recurring packs keep their shapes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api.resource import Resource
from kubernetes_tpu_torch.api import labels as k8slabels
from kubernetes_tpu_torch.api.labels import selector_from_label_selector
from kubernetes_tpu_torch.api.types import (
    DO_NOT_SCHEDULE,
    NODE_INCLUSION_HONOR,
    Node,
    Pod,
    TAINT_NO_EXECUTE,
    TAINT_NO_SCHEDULE,
    TAINT_PREFER_NO_SCHEDULE,
    TOLERATION_OP_EXISTS,
)
from kubernetes_tpu_torch.snapshot.interner import ABSENT, INT_INVALID, PAD, Vocab
from kubernetes_tpu_torch.util.nodetree import ZONE_LABEL, node_tree_order
from kubernetes_tpu_torch.snapshot.selectors import (
    METADATA_NAME_KEY,
    CompiledRequirements,
    compile_label_selector,
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

# Inter-pod affinity term kinds
TERM_REQUIRED_AFFINITY = 0
TERM_REQUIRED_ANTI = 1
TERM_PREFERRED_AFFINITY = 2
TERM_PREFERRED_ANTI = 3


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
    # host-port usage by placed pods: interned (proto:port) id, host-ip id,
    # and whether the ip is the 0.0.0.0 wildcard (NodeInfo.UsedPorts)
    used_ppk: np.ndarray = None  # i32 [N, U]
    used_ip: np.ndarray = None  # i32 [N, U]
    used_wild: np.ndarray = None  # bool [N, U]
    # image id → size bytes present on node (NodeInfo.ImageStates)
    img_sizes: np.ndarray = None  # i64 [N, IMG]
    # zone-round-robin visit rank (node_tree.go order; -1 for pad rows):
    # packed slots stay stable for delta uploads, and the sampling window,
    # its rotation and the compat first-max read this instead
    visit_rank: np.ndarray = None  # i32 [N]
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
        used_ppk=np.full((N, 1), PAD, dtype=np.int32),
        used_ip=np.full((N, 1), PAD, dtype=np.int32),
        used_wild=np.zeros((N, 1), dtype=bool),
        img_sizes=np.zeros((N, bucket_cap(len(vocab.images), 1)), dtype=np.int64),
        visit_rank=np.full(N, -1, dtype=np.int32),
    )
    for i, node in enumerate(nodes[:N]):
        write_node_row(nt, i, node, vocab)
    refresh_visit_rank(nt, nodes[:N])
    return nt


def refresh_visit_rank(nt: NodeTensors, nodes: Sequence[Node], slots: Optional[Sequence[int]] = None) -> None:
    """Recompute the zone-round-robin visit ranks (util/nodetree.py).
    ``slots[i]`` is node i's packed row (0..n-1 by default, the fresh-pack
    layout); a delta update passes the rows name_to_idx resolves."""
    nt.visit_rank[:] = -1
    order = node_tree_order([n.labels.get(ZONE_LABEL) for n in nodes])
    for rank, i in enumerate(order):
        nt.visit_rank[i if slots is None else slots[i]] = rank


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


# ---------------------------------------------------------------------------
# Existing (placed) pods
# ---------------------------------------------------------------------------


@dataclass
class ExistingPodTensors:
    """Placed pods (scheduled or assumed), the quadratic kernels' operand."""

    node_idx: np.ndarray  # i32 [E]  (ABSENT = empty slot)
    ns_id: np.ndarray  # i32 [E]
    label_vals: np.ndarray  # i32 [E, K]
    valid: np.ndarray  # bool [E]
    deleting: np.ndarray  # bool [E]  (deletionTimestamp set)
    # All (anti-)affinity terms of placed pods, flattened to rows (the
    # generalization of HavePodsWithAffinityList /
    # HavePodsWithRequiredAntiAffinityList, snapshot.go:34).  kind is TERM_*;
    # weight is nonzero for preferred terms.
    term_pod: np.ndarray  # i32 [M]  → index into E (ABSENT = padding)
    term_kind: np.ndarray  # i32 [M]  TERM_* or PAD
    term_topo_key: np.ndarray  # i32 [M]
    term_weight: np.ndarray  # i32 [M]
    term_table: ConjunctionTable  # [M, 1, R, V] label-selector conjunction
    term_ns_all: np.ndarray  # bool [M]  (empty namespaceSelector ⇒ all)
    term_ns_ids: np.ndarray  # i32 [M, NS]
    keys: List[str] = field(default_factory=list)

    @property
    def e_cap(self) -> int:
        return self.node_idx.shape[0]


def _pod_label_row(pod: Pod, vocab: Vocab, k_cap: int) -> np.ndarray:
    row = np.full(k_cap, ABSENT, dtype=np.int32)
    for k, v in pod.labels.items():
        ki, vi = vocab.intern_label(k, v)
        if ki < k_cap:
            row[ki] = vi
    return row


def resolve_term_namespaces(
    term, pod: Pod, vocab: Vocab, namespace_labels: Optional[Dict[str, Dict[str, str]]]
) -> Tuple[bool, List[int]]:
    """PodAffinityTerm namespace set → (all_namespaces, ns_id list).

    Defaults to the pod's own namespace when neither namespaces nor
    namespaceSelector are set; a present-but-empty namespaceSelector selects
    ALL namespaces.
    """
    ns_ids = [vocab.namespaces.intern(n) for n in (term.namespaces or ())]
    sel = term.namespace_selector
    if sel is not None:
        s = selector_from_label_selector(sel)
        if s.empty:
            return True, []
        for ns_name, labels in (namespace_labels or {}).items():
            if s.matches(labels):
                ns_ids.append(vocab.namespaces.intern(ns_name))
    if not ns_ids and sel is None:
        ns_ids = [vocab.namespaces.intern(pod.namespace)]
    return False, sorted(set(ns_ids))


def iter_pod_affinity_terms(pod: Pod, vocab: Vocab, namespace_labels):
    """Every (anti-)affinity term of a pod, flattened and compiled: yields
    (compiled_selector, kind, topo_key_id, weight, ns_all, ns_ids).  Used for
    both placed pods and pending batches (framework/types.go:350)."""
    if not pod.affinity:
        return
    groups = []
    if pod.affinity.pod_affinity:
        pa = pod.affinity.pod_affinity
        groups.append(
            (pa.required_during_scheduling_ignored_during_execution, TERM_REQUIRED_AFFINITY, False)
        )
        groups.append(
            (pa.preferred_during_scheduling_ignored_during_execution, TERM_PREFERRED_AFFINITY, True)
        )
    if pod.affinity.pod_anti_affinity:
        pa = pod.affinity.pod_anti_affinity
        groups.append(
            (pa.required_during_scheduling_ignored_during_execution, TERM_REQUIRED_ANTI, False)
        )
        groups.append(
            (pa.preferred_during_scheduling_ignored_during_execution, TERM_PREFERRED_ANTI, True)
        )
    for terms, kind, weighted in groups:
        for t in terms:
            term = t.pod_affinity_term if weighted else t
            compiled = compile_label_selector(term.label_selector, vocab)
            topo = vocab.label_keys.intern(term.topology_key)
            weight = t.weight if weighted else 0
            ns_all, ns_ids = resolve_term_namespaces(term, pod, vocab, namespace_labels)
            yield compiled, kind, topo, weight, ns_all, ns_ids


def pack_existing_pods(
    pods: Sequence[Pod],
    node_name_to_idx: Dict[str, int],
    vocab: Vocab,
    e_cap: Optional[int] = None,
    k_cap: Optional[int] = None,
    namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
    m_cap: Optional[int] = None,
) -> ExistingPodTensors:
    """``e_cap``/``m_cap`` pre-size the pod/term axes so a growing drain
    keeps one shape."""
    for pod in pods:
        for k, v in pod.labels.items():
            vocab.intern_label(k, v)
        vocab.namespaces.intern(pod.namespace)

    E = max(e_cap or 0, bucket_cap(len(pods)))
    K = k_cap or bucket_cap(len(vocab.label_keys))

    node_idx = np.full(E, ABSENT, dtype=np.int32)
    ns_id = np.full(E, ABSENT, dtype=np.int32)
    label_vals = np.full((E, K), ABSENT, dtype=np.int32)
    valid = np.zeros(E, dtype=bool)
    deleting = np.zeros(E, dtype=bool)
    keys: List[str] = []

    rows: List[CompiledRequirements] = []
    r_meta: List[Tuple[int, int, int, int, bool, List[int]]] = []
    for i, pod in enumerate(pods[:E]):
        node_idx[i] = node_name_to_idx.get(pod.node_name, ABSENT)
        ns_id[i] = vocab.namespaces.intern(pod.namespace)
        label_vals[i] = _pod_label_row(pod, vocab, K)
        valid[i] = node_idx[i] != ABSENT
        deleting[i] = pod.deletion_timestamp is not None
        keys.append(pod.key)
        for compiled, kind, topo, weight, ns_all, ns_ids_ in iter_pod_affinity_terms(
            pod, vocab, namespace_labels
        ):
            rows.append(compiled)
            r_meta.append((i, kind, topo, weight, ns_all, ns_ids_))

    M = max(m_cap or 0, bucket_cap(len(rows), 1))
    NS = bucket_cap(max((len(m[5]) for m in r_meta), default=1), 1)
    term_pod = np.full(M, ABSENT, dtype=np.int32)
    term_kind = np.full(M, PAD, dtype=np.int32)
    term_topo_key = np.full(M, PAD, dtype=np.int32)
    term_weight = np.zeros(M, dtype=np.int32)
    term_ns_all = np.zeros(M, dtype=bool)
    term_ns_ids = np.full((M, NS), PAD, dtype=np.int32)
    for j, (pi, kind, topo, weight, ns_all, ids) in enumerate(r_meta):
        term_pod[j] = pi
        term_kind[j] = kind
        term_topo_key[j] = topo
        term_weight[j] = weight
        term_ns_all[j] = ns_all
        for m, nsid in enumerate(ids[:NS]):
            term_ns_ids[j, m] = nsid
    table = pack_conjunction_table(
        [[c] for c in rows] + [[] for _ in range(M - len(rows))],
        t_cap=1,
    )
    return ExistingPodTensors(
        node_idx=node_idx,
        ns_id=ns_id,
        label_vals=label_vals,
        valid=valid,
        deleting=deleting,
        term_pod=term_pod,
        term_kind=term_kind,
        term_topo_key=term_topo_key,
        term_weight=term_weight,
        term_table=table,
        term_ns_all=term_ns_all,
        term_ns_ids=term_ns_ids,
        keys=keys,
    )


def append_existing_pods(
    ep: ExistingPodTensors,
    pods: Sequence[Pod],
    start_slot: int,
    term_start: int,
    node_name_to_idx: Dict[str, int],
    vocab: Vocab,
    namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
) -> Optional[int]:
    """Append rows for NEW placed pods in place (the placed-pod set only
    grows between full packs).  Returns the new term row count, or None when
    any axis would overflow (the caller repacks at grown buckets)."""
    E = ep.node_idx.shape[0]
    K = ep.label_vals.shape[1]
    if start_slot + len(pods) > E:
        return None
    # compile terms first so an overflow aborts before any mutation
    compiled = []
    for i, pod in enumerate(pods):
        if any(vocab.intern_label(k, v)[0] >= K for k, v in pod.labels.items()):
            return None
        for row in iter_pod_affinity_terms(pod, vocab, namespace_labels):
            compiled.append((start_slot + i, row))
    M = ep.term_pod.shape[0]
    NS = ep.term_ns_ids.shape[1]
    tbl = ep.term_table
    R = tbl.req_key.shape[2]
    V = tbl.req_vals.shape[3]
    if term_start + len(compiled) > M:
        return None
    for _, (c, kind, topo, weight, ns_all, ns_ids_) in compiled:
        if len(ns_ids_) > NS:
            return None
        if not c.match_nothing and (c.n_reqs > R or any(len(vs) > V for vs in c.vals)):
            return None

    for i, pod in enumerate(pods):
        s = start_slot + i
        ep.node_idx[s] = node_name_to_idx.get(pod.node_name, ABSENT)
        ep.ns_id[s] = vocab.namespaces.intern(pod.namespace)
        ep.label_vals[s] = _pod_label_row(pod, vocab, K)
        ep.valid[s] = ep.node_idx[s] != ABSENT
        ep.deleting[s] = pod.deletion_timestamp is not None
        if s < len(ep.keys):
            ep.keys[s] = pod.key
        else:
            while len(ep.keys) < s:
                ep.keys.append("")
            ep.keys.append(pod.key)
    for j, (slot, (c, kind, topo, weight, ns_all, ns_ids_)) in enumerate(compiled, start=term_start):
        ep.term_pod[j] = slot
        ep.term_kind[j] = kind
        ep.term_topo_key[j] = topo
        ep.term_weight[j] = weight
        ep.term_ns_all[j] = ns_all
        ep.term_ns_ids[j] = PAD
        for m, nsid in enumerate(ns_ids_[:NS]):
            ep.term_ns_ids[j, m] = nsid
        tbl.req_key[j, 0] = PAD
        tbl.req_op[j, 0] = PAD
        tbl.req_vals[j, 0] = PAD
        tbl.req_rhs[j, 0] = 0
        tbl.term_valid[j, 0] = False
        if not c.match_nothing:
            tbl.term_valid[j, 0] = True
            for k in range(min(c.n_reqs, R)):
                tbl.req_key[j, 0, k] = c.keys[k]
                tbl.req_op[j, 0, k] = c.ops[k]
                tbl.req_rhs[j, 0, k] = c.rhs_int[k]
                for m, v in enumerate(c.vals[k][:V]):
                    tbl.req_vals[j, 0, k, m] = v
    return term_start + len(compiled)


# ---------------------------------------------------------------------------
# Pending-pod batch
# ---------------------------------------------------------------------------


@dataclass
class PodBatch:
    """One batch of pending pods, compiled for device dispatch."""

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
    # topology spread constraints
    tsc_table: ConjunctionTable  # [P, C, R, V] selector per constraint
    tsc_topo_key: np.ndarray  # i32 [P, C]
    tsc_max_skew: np.ndarray  # i32 [P, C]
    tsc_hard: np.ndarray  # bool [P, C] (DoNotSchedule)
    tsc_min_domains: np.ndarray  # i32 [P, C] (0 = unset)
    tsc_honor_affinity: np.ndarray  # bool [P, C] nodeAffinityPolicy Honor
    tsc_honor_taints: np.ndarray  # bool [P, C] nodeTaintsPolicy Honor
    # inter-pod (anti-)affinity terms of the incoming pods
    aff_table: ConjunctionTable  # [P, AT, AR, AV]
    aff_kind: np.ndarray  # i32 [P, AT] TERM_* or PAD
    aff_topo_key: np.ndarray  # i32 [P, AT]
    aff_weight: np.ndarray  # i32 [P, AT]
    aff_ns_all: np.ndarray  # bool [P, AT]
    aff_ns_ids: np.ndarray  # i32 [P, AT, NS]
    # spec.nodeName as an interned label-value id (ABSENT = unset)
    target_name_val: np.ndarray  # i32 [P]
    # requested host ports (same encoding as NodeTensors.used_*)
    want_ppk: np.ndarray  # i32 [P, W]
    want_ip: np.ndarray  # i32 [P, W]
    want_wild: np.ndarray  # bool [P, W]
    # container images for ImageLocality
    img_ids: np.ndarray  # i32 [P, I]
    n_containers: np.ndarray  # i32 [P]
    pods: List[Pod] = field(default_factory=list)

    @property
    def p_cap(self) -> int:
        return self.requests.shape[0]


def encode_port(vocab: Vocab, p) -> Tuple[int, int, bool]:
    """ContainerPort → (proto:port id, host-ip id, ip-is-wildcard)."""
    ppk = vocab.ports.intern(f"{p.protocol}:{p.host_port}")
    ip = p.host_ip or "0.0.0.0"
    return ppk, vocab.ports.intern(ip), ip == "0.0.0.0"


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


def _spread_selector(tsc, pod: Pod, vocab: Vocab) -> CompiledRequirements:
    """Constraint selector with matchLabelKeys folded in (KEP-3243)."""
    c = compile_label_selector(tsc.label_selector, vocab)
    if c.match_nothing:
        return c
    for key in tsc.match_label_keys or ():
        if key in pod.labels:
            c.add(key, k8slabels.IN, (pod.labels[key],), vocab)
    return c


def pack_pod_batch(
    pods: Sequence[Pod],
    vocab: Vocab,
    k_cap: int,
    p_cap: Optional[int] = None,
    namespace_labels: Optional[Dict[str, Dict[str, str]]] = None,
) -> PodBatch:
    """Interning order matches the reference packer, so both assign the same
    ids on the same input."""
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
    tscs: List[List] = []
    tsc_sels: List[List[CompiledRequirements]] = []
    aff_terms: List[List[CompiledRequirements]] = []
    aff_meta: List[List[Tuple[int, int, int, bool, List[int]]]] = []
    port_rows: List[List[Tuple[int, int, bool]]] = []
    img_rows: List[List[int]] = []

    for i, pod in enumerate(pods[:P]):
        req = pod.compute_requests()
        requests[i] = lanes.request_row(req, R)
        nz = req.non_zero_defaulted()
        nonzero[i] = (_i32(nz.milli_cpu), _i32(-(-nz.memory // MEM_UNIT)))
        ns_id[i] = vocab.namespaces.intern(pod.namespace)
        priority[i] = pod.priority
        label_vals[i] = _pod_label_row(pod, vocab, k_cap)
        if pod.node_name:
            target_name_val[i] = vocab.intern_val(pod.node_name)
        # image_locality.go: len(initContainers) + len(containers)
        n_containers[i] = max(len(pod.containers) + len(pod.init_containers), 1)
        port_rows.append([encode_port(vocab, p) for p in pod.host_ports()])
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

        crow = []
        csel = []
        for tsc in pod.topology_spread_constraints:
            crow.append(tsc)
            csel.append(_spread_selector(tsc, pod, vocab))
            vocab.label_keys.intern(tsc.topology_key)
        tscs.append(crow)
        tsc_sels.append(csel)

        arow: List[CompiledRequirements] = []
        ameta: List[Tuple[int, int, int, bool, List[int]]] = []
        for compiled, kind, topo, w, all_ns, ids in iter_pod_affinity_terms(
            pod, vocab, namespace_labels
        ):
            arow.append(compiled)
            ameta.append((kind, topo, w, all_ns, ids))
        aff_terms.append(arow)
        aff_meta.append(ameta)

    while len(node_dnfs) < P:
        node_dnfs.append([])
        pref_terms.append([])
        pref_weights.append([])
        tols.append([])
        tscs.append([])
        tsc_sels.append([])
        aff_terms.append([])
        aff_meta.append([])
        port_rows.append([])
        img_rows.append([])

    W = bucket_cap(max((len(r) for r in port_rows), default=1), 1)
    want_ppk = np.full((P, W), PAD, dtype=np.int32)
    want_ip = np.full((P, W), PAD, dtype=np.int32)
    want_wild = np.zeros((P, W), dtype=bool)
    for i, prow in enumerate(port_rows):
        for j, (ppk, ip, wild) in enumerate(prow[:W]):
            want_ppk[i, j] = ppk
            want_ip[i, j] = ip
            want_wild[i, j] = wild

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

    tsc_table = pack_conjunction_table([list(cs) for cs in tsc_sels])
    C = tsc_table.term_valid.shape[1]
    tsc_topo_key = np.full((P, C), PAD, dtype=np.int32)
    tsc_max_skew = np.zeros((P, C), dtype=np.int32)
    tsc_hard = np.zeros((P, C), dtype=bool)
    tsc_min_domains = np.zeros((P, C), dtype=np.int32)
    tsc_honor_affinity = np.ones((P, C), dtype=bool)
    tsc_honor_taints = np.zeros((P, C), dtype=bool)
    for i, crow in enumerate(tscs):
        for j, tsc in enumerate(crow[:C]):
            tsc_topo_key[i, j] = vocab.label_keys.intern(tsc.topology_key)
            tsc_max_skew[i, j] = tsc.max_skew
            tsc_hard[i, j] = tsc.when_unsatisfiable == DO_NOT_SCHEDULE
            tsc_min_domains[i, j] = tsc.min_domains or 0
            tsc_honor_affinity[i, j] = tsc.node_affinity_policy == NODE_INCLUSION_HONOR
            tsc_honor_taints[i, j] = tsc.node_taints_policy == NODE_INCLUSION_HONOR

    aff_table = pack_conjunction_table(aff_terms)
    AT = aff_table.term_valid.shape[1]
    NS = bucket_cap(max((len(m[4]) for ms in aff_meta for m in ms), default=1), 1)
    aff_kind = np.full((P, AT), PAD, dtype=np.int32)
    aff_topo_key = np.full((P, AT), PAD, dtype=np.int32)
    aff_weight = np.zeros((P, AT), dtype=np.int32)
    aff_ns_all = np.zeros((P, AT), dtype=bool)
    aff_ns_ids = np.full((P, AT, NS), PAD, dtype=np.int32)
    for i, ms in enumerate(aff_meta):
        for j, (kind, topo, w, all_ns, ids) in enumerate(ms[:AT]):
            aff_kind[i, j] = kind
            aff_topo_key[i, j] = topo
            aff_weight[i, j] = w
            aff_ns_all[i, j] = all_ns
            for m, nsid in enumerate(ids[:NS]):
                aff_ns_ids[i, j, m] = nsid

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
        tsc_table=tsc_table,
        tsc_topo_key=tsc_topo_key,
        tsc_max_skew=tsc_max_skew,
        tsc_hard=tsc_hard,
        tsc_min_domains=tsc_min_domains,
        tsc_honor_affinity=tsc_honor_affinity,
        tsc_honor_taints=tsc_honor_taints,
        aff_table=aff_table,
        aff_kind=aff_kind,
        aff_topo_key=aff_topo_key,
        aff_weight=aff_weight,
        aff_ns_all=aff_ns_all,
        aff_ns_ids=aff_ns_ids,
        target_name_val=target_name_val,
        want_ppk=want_ppk,
        want_ip=want_ip,
        want_wild=want_wild,
        img_ids=img_ids,
        n_containers=n_containers,
        pods=list(pods),
    )
