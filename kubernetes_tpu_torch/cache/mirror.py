"""Incremental host mirror of the cache (UpdateSnapshot, cache.go:185).

Port of the JAX package's cache/mirror.py ``SnapshotMirror``.  The
reference walks its generation-ordered node list and copies only NodeInfos
newer than the snapshot's generation; the same delta discipline maintains
the packed tensors here:

  * node rows with ``generation > mirror.generation`` are repacked in place
    (write_node_row when the Node object changed, then the usage and
    host-port rows);
  * node additions within capacity append rows; removals and bucket
    overflows force a full repack at the next bucket size;
  * the placed-pod tensors are rebuilt lazily (``existing``) when the pod
    population changed, and pure additions APPEND rows in place.

The device half (cache/device_mirror.py) ships these tensors to the card.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from kubernetes_tpu_torch.cache.cache import Cache
from kubernetes_tpu_torch.snapshot.interner import PAD, Vocab
from kubernetes_tpu_torch.snapshot.schema import (
    MEM_UNIT,
    NodeTensors,
    ResourceLanes,
    append_existing_pods,
    bucket_cap,
    encode_port,
    pack_existing_pods,
    pack_nodes,
    refresh_visit_rank,
    write_node_row,
)

HOSTNAME_LABEL = "kubernetes.io/hostname"


def accumulate_node_usage(nt: NodeTensors, placed_pods, vocab: Vocab) -> None:
    """Fold placed pods into per-node requested / non-zero / pod-count /
    host-port accounting (NodeInfo.AddPodInfo, framework/types.go:829), as
    the reference's snapshot/cluster.py does at a full pack: the non-zero
    memory is the sum of each pod's MiB ceiling."""
    lanes = ResourceLanes(vocab)
    R = nt.allocatable.shape[1]
    nt.requested[:] = 0
    nt.nonzero_req[:] = 0
    nt.num_pods[:] = 0
    port_rows: Dict[int, list] = {}
    idxs, rows, nz_rows = [], [], []
    row_cache: Dict[int, tuple] = {}
    for pod in placed_pods:
        i = nt.name_to_idx.get(pod.node_name)
        if i is None:
            continue
        req = pod.compute_requests()
        ent = row_cache.get(id(req))
        if ent is None:
            nz = req.non_zero_defaulted()
            ent = row_cache[id(req)] = (lanes.request_row(req, R), (nz.milli_cpu, -(-nz.memory // MEM_UNIT)))
        idxs.append(i)
        rows.append(ent[0])
        nz_rows.append(ent[1])
        for p in pod.host_ports():
            port_rows.setdefault(i, []).append(encode_port(vocab, p))
    if idxs:
        ii = np.asarray(idxs, np.intp)
        np.add.at(nt.requested, ii, np.stack(rows))
        np.add.at(nt.nonzero_req, ii, np.asarray(nz_rows, nt.nonzero_req.dtype))
        np.add.at(nt.num_pods, ii, 1)
    U = bucket_cap(max((len(r) for r in port_rows.values()), default=1), 1)
    N = nt.n_cap
    nt.used_ppk = np.full((N, U), PAD, dtype=np.int32)
    nt.used_ip = np.full((N, U), PAD, dtype=np.int32)
    nt.used_wild = np.zeros((N, U), dtype=bool)
    for i, prow in port_rows.items():
        for j, (ppk, ip, wild) in enumerate(prow[:U]):
            nt.used_ppk[i, j] = ppk
            nt.used_ip[i, j] = ip
            nt.used_wild[i, j] = wild


class SnapshotMirror:
    def __init__(self, vocab: Optional[Vocab] = None):
        self.vocab = vocab or Vocab()
        self.generation = 0
        self.static_generation = 0  # max CachedNode.static_generation seen
        self.nodes: Optional[NodeTensors] = None
        self._existing = None
        self._existing_version = -1  # cache.pod_version it was built at
        self._full_packs = 0
        self._force_full = False
        self._cache = None  # last cache seen (lazy existing rebuild)
        self._ns_labels = None
        self._epod_slots = None  # uid → (slot, pod) in _existing
        self._eterm_count = 0
        # bumped whenever the placed-pod tensors are REBUILT (not appended):
        # the device mirror's invalidation signal
        self._existing_rebuilds = 0
        self._m_cap_max = 1  # sticky: the term axis never shrinks
        # expected total placed pods: pre-sizes the E/M axes for a drain
        self.e_cap_hint = 0
        self._hostnames_unique_memo = None

    @property
    def e_used(self) -> int:
        """Occupied placed-pod slots (append cursor)."""
        return len(self._epod_slots or {})

    @property
    def m_used(self) -> int:
        """Occupied term rows (append cursor)."""
        return self._eterm_count

    @property
    def existing(self):
        """Placed-pod tensors, materialized lazily; pure additions append
        rows in place instead of rebuilding."""
        if self._cache is not None and self._existing_version != self._cache.pod_version:
            self._rebuild_existing()
        return self._existing

    def _rebuild_existing(self) -> None:
        placed = self._cache.placed_pods()
        slots = self._epod_slots
        if (
            self._existing is not None
            and slots is not None
            # a raised capacity hint forces one rebuild at the final shape
            and self._existing.node_idx.shape[0] >= self._e_cap(len(placed))
        ):
            cur = {p.uid: p for p in placed}
            if len(cur) >= len(slots) and self._adopt_equivalent(cur, slots):
                new = [p for p in placed if p.uid not in slots]
                n_terms = append_existing_pods(
                    self._existing, new, len(slots), self._eterm_count, self.nodes.name_to_idx, self.vocab,
                    self._ns_labels,
                )
                if n_terms is not None:
                    base = len(slots)
                    for i, p in enumerate(new):
                        slots[p.uid] = (base + i, p)
                    self._eterm_count = n_terms
                    self._existing_version = self._cache.pod_version
                    return
        for p in placed:
            for k, v in p.labels.items():
                self.vocab.intern_label(k, v)
            self.vocab.namespaces.intern(p.namespace)
        self._existing = pack_existing_pods(
            placed, self.nodes.name_to_idx, self.vocab, e_cap=self._e_cap(len(placed)), k_cap=self.nodes.k_cap,
            namespace_labels=self._ns_labels, m_cap=self._m_cap_for(placed),
        )
        self._epod_slots = {p.uid: (i, p) for i, p in enumerate(placed)}
        self._eterm_count = int((self._existing.term_kind != PAD).sum())
        self._existing_version = self._cache.pod_version
        self._existing_rebuilds += 1

    @staticmethod
    def _adopt_equivalent(cur, slots) -> bool:
        """True when every slotted pod is still present with a pack-equivalent
        object (a confirmation replaces the object without changing any
        packed field), adopting the new objects."""
        adopted = []
        for uid, (slot, old) in slots.items():
            now = cur.get(uid)
            if now is None:
                return False
            if now is old:
                continue
            if (
                now.node_name == old.node_name
                and now.labels == old.labels
                and now.namespace == old.namespace
                and now.deletion_timestamp == old.deletion_timestamp
            ):
                adopted.append((uid, slot, now))
                continue
            return False
        for uid, slot, now in adopted:
            slots[uid] = (slot, now)
        return True

    def _e_cap(self, n_placed: int) -> int:
        return bucket_cap(max(self.e_cap_hint, n_placed))

    def _m_cap_for(self, placed) -> int:
        # scale the expected term rows by the same growth ratio as pods
        n = max(len(placed), 1)
        n_terms = sum(
            1
            for p in placed
            if p.affinity is not None and (p.affinity.pod_affinity or p.affinity.pod_anti_affinity)
        )
        est = self._e_cap(len(placed)) * (n_terms * 4) // n
        self._m_cap_max = max(self._m_cap_max, bucket_cap(max(est, 1), 1))
        return self._m_cap_max

    @property
    def hostnames_unique(self) -> bool:
        """True when no two nodes share a hostname label value: the
        precondition of the wave's factored algebra, which counts hostname
        topology domains per node.  Memoized on the static lineage (full
        packs, static generation, node population); usage churn never
        moves it, since hostname labels are static row content."""
        nt = self.nodes
        if nt is None:
            return True
        key = (self._full_packs, self.static_generation, len(nt.name_to_idx))
        memo = self._hostnames_unique_memo
        if memo is not None and memo[0] == key:
            return memo[1]
        hk = self.vocab.label_keys.lookup(HOSTNAME_LABEL)
        unique = True
        lv = nt.label_vals
        if 0 <= hk < lv.shape[1]:
            col = lv[:, hk]
            vals = col[col >= 0]
            unique = len(vals) == len(np.unique(vals))
        self._hostnames_unique_memo = (key, unique)
        return unique

    def apply_fast_usage(self, fc, cache: Cache) -> bool:
        """Vectorized usage refresh from a live FastCommitter whose lineage
        owns every usage change since the mirror's watermark (the caller
        checks the epoch); fast pods carry no host ports, so the port rows
        stay as they are.  False when shapes moved."""
        nt = self.nodes
        if nt is None or fc.n != nt.valid.shape[0] or fc.rn != nt.allocatable.shape[1]:
            return False
        nt.requested[:] = np.asarray(fc.used_rows, dtype=nt.requested.dtype)
        nt.nonzero_req[:, 0] = np.asarray(fc.nz0, dtype=nt.nonzero_req.dtype)
        nt.nonzero_req[:, 1] = np.asarray(fc.nz1, dtype=nt.nonzero_req.dtype)
        nt.num_pods[:] = np.asarray(fc.num_pods, dtype=nt.num_pods.dtype)
        self.generation = max((cn.generation for cn in cache.real_nodes()), default=self.generation)
        return True

    def update(self, cache: Cache, namespace_labels=None) -> None:
        """Bring the mirror up to date with the cache (incremental)."""
        self._cache = cache
        self._ns_labels = namespace_labels
        real = cache.real_nodes()
        names = [cn.node.name for cn in real]
        need_full = (
            self._force_full
            or self.nodes is None
            or len(real) > self.nodes.n_cap
            or bucket_cap(len(self.vocab.label_keys)) > self.nodes.k_cap
            # new label VALUES outran the packed parsed-int table
            or len(self.vocab.label_vals) > self.nodes.val_ints.shape[0]
        )
        order_dirty = False  # membership or zone changes move visit ranks
        if not need_full:
            known = set(self.nodes.name_to_idx)
            if known - set(names):
                need_full = True  # node removals compact slots: repack
            else:
                for cn in real:  # additions within capacity append rows
                    if cn.node.name in known:
                        continue
                    if not write_node_row(self.nodes, len(self.nodes.name_to_idx), cn.node, self.vocab):
                        need_full = True
                        break
                    order_dirty = True
        if need_full:
            self._force_full = False
            self._full_pack(cache, namespace_labels)
            return

        lanes = ResourceLanes(self.vocab)
        for cn in real:
            if cn.generation <= self.generation:
                continue
            i = self.nodes.name_to_idx[cn.node.name]
            if cn.static_generation > self.static_generation:
                # a zone label may have moved: the visit order refreshes
                if not write_node_row(self.nodes, i, cn.node, self.vocab):
                    self._force_full = True  # a slot axis truncated
                order_dirty = True
            self._write_usage_row(cn, i, lanes)
            if self._force_full:
                break
        if self._force_full:
            # a row overflowed its slots (e.g. host ports > U): repack at
            # grown buckets before this batch schedules against it
            self._force_full = False
            self._full_pack(cache, namespace_labels)
            return
        if order_dirty:
            refresh_visit_rank(self.nodes, [cn.node for cn in real], [self.nodes.name_to_idx[n] for n in names])
        self.generation = max((cn.generation for cn in real), default=self.generation)
        self.static_generation = max((cn.static_generation for cn in real), default=self.static_generation)

    def _write_usage_row(self, cn, i: int, lanes: ResourceLanes) -> None:
        nt = self.nodes
        R = nt.allocatable.shape[1]
        nt.requested[i] = lanes.request_row(cn.requested, R)
        nt.nonzero_req[i, 0] = cn.non_zero_requested.milli_cpu
        nt.nonzero_req[i, 1] = -(-cn.non_zero_requested.memory // MEM_UNIT)
        nt.num_pods[i] = len(cn.pods)
        U = nt.used_ppk.shape[1]
        nt.used_ppk[i] = PAD
        nt.used_ip[i] = PAD
        nt.used_wild[i] = False
        rows = [encode_port(self.vocab, hp) for pod in cn.pods.values() for hp in pod.host_ports()]
        if len(rows) > U:
            self._force_full = True  # port slots overflow: grow on a full pack
        for j, (ppk, ip, wild) in enumerate(rows[:U]):
            nt.used_ppk[i, j] = ppk
            nt.used_ip[i, j] = ip
            nt.used_wild[i, j] = wild

    def _full_pack(self, cache: Cache, namespace_labels) -> None:
        real = cache.real_nodes()
        placed = cache.placed_pods()
        for p in placed:
            for k, v in p.labels.items():
                self.vocab.intern_label(k, v)
            self.vocab.namespaces.intern(p.namespace)
        self.nodes = pack_nodes([cn.node for cn in real], self.vocab)
        accumulate_node_usage(self.nodes, placed, self.vocab)
        self._existing = pack_existing_pods(
            placed, self.nodes.name_to_idx, self.vocab, e_cap=self._e_cap(len(placed)), k_cap=self.nodes.k_cap,
            namespace_labels=namespace_labels, m_cap=self._m_cap_for(placed),
        )
        self._existing_version = cache.pod_version
        self._epod_slots = {p.uid: (i, p) for i, p in enumerate(placed)}
        self._eterm_count = int((self._existing.term_kind != PAD).sum())
        self._existing_rebuilds += 1
        self.generation = max((cn.generation for cn in real), default=0)
        self.static_generation = max((cn.static_generation for cn in real), default=0)
        self._full_packs += 1
