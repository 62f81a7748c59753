"""Device-resident cluster snapshot, kept current by row-range copies.

Port of the JAX package's cache/device_mirror.py ``DeviceClusterCache``
(jit root ``apply``).  The host SnapshotMirror is the source of truth; this
cache keeps one DeviceCluster alive across batches and ships only what
changed:

  * the node usage rows (requested / nonzero / num_pods / host ports),
    rewritten in place on every sync (they change with every commit), and
    the visit ranks, whose refresh rewrites the whole row;
  * the placed-pod and term rows appended since the last sync (the
    mirror's append cursors), ``copy_``-ed into the preallocated rows;
  * everything else only when the mirror's static key moves (static
    generation, full packs, placed-pod rebuilds, vocabulary sizes), by a
    fresh single-buffer upload (ops/wire.py).

This is data movement: the reference splices with dynamic_update_slice
inside one jitted call; here each range is one ``Tensor.copy_``.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.ops.common import DeviceCluster

_USAGE = {
    "requested": ("requested", np.int32),
    "nonzero_req": ("nonzero_req", np.int32),
    "num_pods": ("num_pods", np.int32),
    "used_ppk": ("used_ppk", np.int32),
    "used_ip": ("used_ip", np.int32),
    "used_wild": ("used_wild", bool),
    # a rank refresh rewrites the whole row (a node added or moved zone)
    "visit_rank": ("visit_rank", np.int32),
}

_EPOD_FIELDS = {
    "epod_node": ("node_idx", np.int32),
    "epod_ns": ("ns_id", np.int32),
    "epod_labels": ("label_vals", np.int32),
    "epod_valid": ("valid", bool),
    "epod_deleting": ("deleting", bool),
}

_TERM_FIELDS = {
    "term_pod": ("term_pod", np.int32),
    "term_kind": ("term_kind", np.int32),
    "term_topo": ("term_topo_key", np.int32),
    "term_weight": ("term_weight", np.int32),
    "term_ns_all": ("term_ns_all", bool),
    "term_ns_ids": ("term_ns_ids", np.int32),
}

_TABLE_FIELDS = ("req_key", "req_op", "req_vals", "req_rhs", "term_valid")


def _copy_rows(dst: torch.Tensor, src: np.ndarray, lo: int, hi: int, dt) -> None:
    if hi > lo:
        dst[lo:hi].copy_(torch.from_numpy(np.ascontiguousarray(src[lo:hi], dt)), non_blocking=False)


class DeviceClusterCache:
    """Keeps one DeviceCluster on the device, synced incrementally from the
    host mirror.  ``sync()`` returns the up-to-date snapshot."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._dc = None
        self._key = None
        self._e_done = 0
        self._m_done = 0
        self.full_uploads = 0
        self.delta_syncs = 0

    def invalidate(self) -> None:
        self._dc = None

    def sync(self, mirror, vocab) -> DeviceCluster:
        nt = mirror.nodes
        ep = mirror.existing  # materializes / append-updates the host tensors
        key = (
            mirror.static_generation,
            mirror._full_packs,
            mirror._existing_rebuilds,
            len(vocab.label_vals),
            len(vocab.label_keys),
        )
        if self._dc is None or key != self._key:
            self._dc = DeviceCluster.from_host(nt, vocab, self.device, ep)
            self._key = key
            self._e_done = mirror.e_used
            self._m_done = mirror.m_used
            self.full_uploads += 1
            return self._dc
        dc = self._dc
        for name, (host, dt) in _USAGE.items():
            src = getattr(nt, host)
            _copy_rows(getattr(dc, name), src, 0, src.shape[0], dt)
        e1, m1 = mirror.e_used, mirror.m_used
        for name, (host, dt) in _EPOD_FIELDS.items():
            _copy_rows(getattr(dc, name), getattr(ep, host), self._e_done, e1, dt)
        for name, (host, dt) in _TERM_FIELDS.items():
            _copy_rows(getattr(dc, name), getattr(ep, host), self._m_done, m1, dt)
        for f in _TABLE_FIELDS:
            dt = bool if f == "term_valid" else np.int32
            _copy_rows(getattr(dc.term_table, f), getattr(ep.term_table, f), self._m_done, m1, dt)
        self._e_done, self._m_done = e1, m1
        self.delta_syncs += 1
        return dc
