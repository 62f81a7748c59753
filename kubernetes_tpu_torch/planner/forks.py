"""Fork specs and the fork packer over the mirror's packed snapshot.

Port of the JAX package's planner/forks.py.  A ``Fork`` names one
counterfactual mutation set over the live snapshot: nodes added (cloned
from an existing node), removed or cordoned, capacities scaled, placed pods
evicted, and the batch pods the fork simulates.  ``pack_forks`` turns a
list of forks into the [K, ...] fork planes ``ops.counterfactual``
consumes, built off the SnapshotMirror's packed tensors.

Exactness contract: every per-fork plane equals what packing the mutated
cluster from scratch would give at the same slots.

  * evictions recompute the touched node's usage rows from the remaining
    pods' Resources in the mirror's pack arithmetic (request_row and the
    MiB-ceiling non-zero totals): subtracting a quantized per-pod row would
    drift on the ceiling;
  * capacity scaling is defined in lane space (``row * num // den``), and
    ``scale_node_lanes`` builds the host Node the same way, so the serial
    oracle's byte-space view packs to exactly the scaled lanes;
  * clones are written by the mirror's own ``write_node_row``, from a cloned
    Node the serial oracle's forks share (``clone_node``);
  * removed (and not-added) slots are neutralized in the fork view
    (ops/counterfactual.fork_cluster_view), which the serial oracle mirrors
    by not materializing the node.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api.resource import Resource
from kubernetes_tpu_torch.api.types import Node
from kubernetes_tpu_torch.oracle.scores import HOSTNAME_LABEL
from kubernetes_tpu_torch.snapshot.interner import ABSENT, PAD
from kubernetes_tpu_torch.snapshot.schema import MEM_UNIT, ResourceLanes, bucket_cap, write_node_row

# the NodeTensors row planes a clone slot is written into
_ROW_PLANES = (
    ("allocatable", 0), ("requested", 0), ("nonzero_req", 0), ("num_pods", 0), ("allowed_pods", 0),
    ("label_vals", ABSENT), ("taint_key", PAD), ("taint_val", PAD), ("taint_effect", PAD),
    ("unschedulable", False), ("valid", False), ("used_ppk", PAD), ("used_ip", PAD), ("used_wild", False),
    ("img_sizes", 0), ("visit_rank", -1),
)


@dataclass(frozen=True)
class Fork:
    """One counterfactual: mutations and the batch pods it simulates.

    ``live`` is the uid set of batch pods this fork schedules (None: all);
    ``add`` entries are (template node name, clone name): clone slots are
    shared across forks by clone name, so a fork adding three clones of a
    node reuses the slots of a fork adding two of them, plus one more.
    """

    label: str = ""
    evict: Tuple[str, ...] = ()  # placed-pod uids
    cordon: Tuple[str, ...] = ()  # node names
    remove: Tuple[str, ...] = ()  # node names
    add: Tuple[Tuple[str, str], ...] = ()  # (template name, clone name)
    scale: Tuple[Tuple[str, int, int], ...] = ()  # (node name, num, den)
    live: Optional[Tuple[str, ...]] = None  # batch pod uids (None: all)
    meta: Tuple[Tuple[str, object], ...] = ()  # the planner's annotations


def clone_node(template: Node, name: str) -> Node:
    """A copy of ``template`` under a new identity: new name, its own
    hostname label, no usage.  The fork packer and the serial oracle's
    forks share it, so both pack the same row."""
    n = copy.deepcopy(template)
    n.name = name
    n.labels = dict(n.labels)
    if HOSTNAME_LABEL in n.labels:
        n.labels[HOSTNAME_LABEL] = name
    return n


def scale_node_lanes(node: Node, num: int, den: int) -> Node:
    """Capacity scaling in pack-lane space: milli-cpu, MiB memory and
    ephemeral lanes, and extended scalars each become ``v * num // den``, so
    the returned Node packs to exactly ``allocatable_row * num // den``."""
    r = node.allocatable
    scaled = Resource(
        milli_cpu=r.milli_cpu * num // den,
        memory=((r.memory // MEM_UNIT) * num // den) * MEM_UNIT,
        ephemeral_storage=((r.ephemeral_storage // MEM_UNIT) * num // den) * MEM_UNIT,
        allowed_pod_number=r.allowed_pod_number,
        scalars={k: v * num // den for k, v in r.scalars.items()},
    )
    n = copy.copy(node)
    n.labels = dict(node.labels)
    n.allocatable = scaled
    return n


@dataclass
class PackedForks:
    """The fork planes and the bookkeeping to read results back."""

    planes: Dict[str, np.ndarray]  # fk_* arrays, [K, ...]
    nt: object  # the extended NodeTensors (clone slots appended)
    clone_slots: Dict[str, int]  # clone name → node slot
    k_used: int  # real forks (the rest is padding)
    names: List[str]  # slot → node name


def _extend_node_tensors(nt, clones: Dict[str, Node], vocab):
    """A copy of ``nt`` with the clone rows appended (invalid in the base:
    each fork sets its own alive bits).  The node bucket grows only when the
    clones outrun the padding."""
    n_used = len(nt.name_to_idx)
    need = n_used + len(clones)
    ext = copy.copy(nt)
    if need <= nt.n_cap:
        for f, _ in _ROW_PLANES:
            setattr(ext, f, np.array(getattr(nt, f)))
    else:
        n_cap = bucket_cap(need)
        for f, fill in _ROW_PLANES:
            a = getattr(nt, f)
            out = np.full((n_cap,) + a.shape[1:], fill, a.dtype)
            out[: a.shape[0]] = a
            setattr(ext, f, out)
    ext.val_ints = np.array(nt.val_ints)
    ext.names = list(nt.names)
    ext.name_to_idx = dict(nt.name_to_idx)

    slots: Dict[str, int] = {}
    cursor = n_used
    for name, node in clones.items():
        write_node_row(ext, cursor, node, vocab)
        ext.valid[cursor] = False  # alive only in the forks that add it
        ext.visit_rank[cursor] = -1  # and never visited by a sampling walk
        slots[name] = cursor
        cursor += 1
    return ext, slots


def collect_clones(forks: Sequence[Fork], node_by_name) -> Dict[str, Node]:
    """Clone name → cloned Node, deduplicated across forks.  Raises on an
    unknown template or a clone name that collides with a real node."""
    out: Dict[str, Node] = {}
    for f in forks:
        for template, clone_name in f.add:
            if clone_name in out:
                continue
            tmpl = node_by_name.get(template)
            if tmpl is None:
                raise ValueError(f"fork {f.label!r}: unknown template node {template!r}")
            if clone_name in node_by_name:
                raise ValueError(f"fork {f.label!r}: clone name {clone_name!r} collides with a real node")
            out[clone_name] = clone_node(tmpl, clone_name)
    return out


def pack_forks(
    mirror,
    cache,
    forks: Sequence[Fork],
    batch_uids: Sequence[str],
    p_cap: int,
    k_cap: Optional[int] = None,
    clones: Optional[Dict[str, Node]] = None,
) -> PackedForks:
    """Build the [K, ...] fork planes off the mirror's packed snapshot.

    The caller has synced the mirror and interned every clone's labels
    before its repack (``collect_clones`` first, so a grown value bucket
    forces the full pack the mirror already does).  Padding forks (up to
    the fork bucket) are identity forks with no live pods.
    """
    vocab = mirror.vocab
    node_by_name = {cn.node.name: cn for cn in cache.real_nodes()}
    if clones is None:
        clones = collect_clones(forks, {n: cn.node for n, cn in node_by_name.items()})
    nt, clone_slots = _extend_node_tensors(mirror.nodes, clones, vocab)
    existing = mirror.existing
    epod_slot = {uid: slot for uid, (slot, _pod) in (mirror._epod_slots or {}).items()}
    epod_node = np.asarray(existing.node_idx)
    lanes = ResourceLanes(vocab)
    R = nt.allocatable.shape[1]

    K = len(forks)
    k_pad = k_cap or bucket_cap(max(K, 1), 1)
    N = nt.n_cap
    E = existing.valid.shape[0]

    fk_alive = np.broadcast_to(np.asarray(nt.valid, bool), (k_pad, N)).copy()
    fk_unsched = np.broadcast_to(np.asarray(nt.unschedulable, bool), (k_pad, N)).copy()
    fk_alloc = np.broadcast_to(nt.allocatable, (k_pad, N, R)).copy()
    fk_req = np.broadcast_to(nt.requested, (k_pad, N, R)).copy()
    fk_nz = np.broadcast_to(nt.nonzero_req, (k_pad, N, 2)).copy()
    fk_npods = np.broadcast_to(nt.num_pods, (k_pad, N)).copy()
    fk_epod_valid = np.broadcast_to(np.asarray(existing.valid, bool), (k_pad, E)).copy()
    fk_pod_live = np.zeros((k_pad, p_cap), bool)
    fk_pod_live[:K, : len(batch_uids)] = True  # padding forks: no live pods
    uid_pos = {uid: i for i, uid in enumerate(batch_uids)}

    def slot_of(f, name):
        slot = nt.name_to_idx.get(name)
        if slot is None:
            raise ValueError(f"fork {f.label!r}: unknown node {name!r}")
        return slot

    for k, f in enumerate(forks):
        for _template, clone_name in f.add:
            fk_alive[k, clone_slots[clone_name]] = True
        for name in f.remove:
            slot = slot_of(f, name)
            fk_alive[k, slot] = False
            fk_epod_valid[k] &= epod_node != slot
        for name in f.cordon:
            fk_unsched[k, slot_of(f, name)] = True
        for name, num, den in f.scale:
            slot = slot_of(f, name)
            fk_alloc[k, slot] = fk_alloc[k, slot].astype(np.int64) * num // den
        if f.evict:
            evicted = set(f.evict)
            touched: Dict[str, None] = {}
            for uid in f.evict:
                slot = epod_slot.get(uid)
                if slot is None:
                    raise ValueError(f"fork {f.label!r}: evicted pod {uid!r} is not placed")
                fk_epod_valid[k, slot] = False
                if 0 <= epod_node[slot] < len(nt.names):
                    touched[nt.names[epod_node[slot]]] = None
            # the touched nodes' usage rows from the remaining pods, in the
            # mirror's own formulas
            for node_name in touched:
                cn = node_by_name.get(node_name)
                slot = nt.name_to_idx[node_name]
                remaining = [p for p in cn.pods.values() if p.uid not in evicted]
                req = Resource()
                nz = Resource()
                for p in remaining:
                    pr = p.compute_requests()
                    req.add(pr)
                    nz.add(pr.non_zero_defaulted())
                fk_req[k, slot] = lanes.request_row(req, R)
                fk_nz[k, slot, 0] = nz.milli_cpu
                fk_nz[k, slot, 1] = -(-nz.memory // MEM_UNIT)
                fk_npods[k, slot] = len(remaining)
        if f.live is not None:
            fk_pod_live[k, :] = False
            for uid in f.live:
                pos = uid_pos.get(uid)
                if pos is not None:
                    fk_pod_live[k, pos] = True

    planes = dict(
        fk_alive=fk_alive,
        fk_unsched=fk_unsched,
        fk_alloc=fk_alloc.astype(np.int32),
        fk_req=fk_req.astype(np.int32),
        fk_nz=fk_nz.astype(np.int32),
        fk_npods=fk_npods.astype(np.int32),
        fk_epod_valid=fk_epod_valid,
        fk_nvalid=fk_alive.sum(axis=1).astype(np.int32),
        fk_pod_live=fk_pod_live,
    )
    return PackedForks(planes=planes, nt=nt, clone_slots=clone_slots, k_used=K, names=list(nt.names))
