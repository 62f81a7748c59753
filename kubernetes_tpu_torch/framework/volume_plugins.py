"""VolumeZone, VolumeRestrictions and NodeVolumeLimits: host Filter plugins.

A copy of the JAX package's framework/volume_plugins.py.  Semantics are
those of

  * pkg/scheduler/framework/plugins/volumezone/volume_zone.go (:109
    PreFilter and its Skip, :188 Filter, :57 ErrReasonConflict);
  * volumerestrictions/volume_restrictions.go (:164 PreFilter, :308 Filter:
    single-attach disk conflicts and ReadWriteOncePod);
  * nodevolumelimits/csi.go (:152 PreFilter, :170 Filter, :234
    ErrReasonMaxVolumeCountExceeded).

On the port's volume route VolumeZone's zone-labelled PVs are folded into
the K12 mask (scheduler.py ``_vol_tables``), VolumeRestrictions is skipped
for every pod that reaches it (a ReadWriteOncePod claim or an inline
single-attach disk is refused), and NodeVolumeLimits' Filter is a constant
success while no CSINode is registered (a CSI volume beside a CSINode is
refused).  The Filters run on the host for the chosen node of every volume
pod the workloads dispatch places (``_wl_host_replay``), in the nominated-
node path and in the preemption dry run.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from kubernetes_tpu_torch.api import storage as st
from kubernetes_tpu_torch.api.types import Pod, Volume
from kubernetes_tpu_torch.framework.interface import (
    ActionType,
    ClusterEvent,
    ClusterEventWithHint,
    CycleState,
    EventResource,
    FilterPlugin,
    PreFilterPlugin,
    QueueingHint,
    Status,
)

REASON_ZONE_CONFLICT = "node(s) had no available volume zone"
REASON_DISK_CONFLICT = "node(s) had no available disk"
REASON_RWOP_CONFLICT = (
    "node has pod using PersistentVolumeClaim with the same name and ReadWriteOncePod access mode"
)
REASON_MAX_VOLUME_COUNT = "node(s) exceed max volume count"

# volume kinds under the single-attach conflict rule (volume_restrictions.go
# isVolumeConflict: GCE PD, AWS EBS, Azure disk, ISCSI, RBD)
SINGLE_ATTACH_KINDS = frozenset({"gce-pd", "aws-ebs", "azure-disk", "iscsi", "rbd"})


def zone_value_set(v: str) -> Set[str]:
    """A PV zone label may carry a __-separated set of zones
    (volumehelpers.LabelZonesToSet)."""
    return set(v.split("__"))


class VolumeZone(PreFilterPlugin, FilterPlugin):
    """PV topology labels against the node's topology labels."""

    name = "VolumeZone"
    _STATE_KEY = "VolumeZone"

    def maybe_relevant(self, pod: Pod) -> bool:
        return bool(pod.pvc_names())

    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        """Resolve each claim's PV topology once per pod (:109); Skip when no
        PV carries zone or region labels."""
        if not pod.pvc_names():
            return Status.skip()
        topologies, status = self._pv_topologies(pod)
        if status is not None:
            return status
        if not topologies:
            return Status.skip()
        state.write((self._STATE_KEY, pod.uid), topologies)
        return Status.success()

    def _pv_topologies(self, pod: Pod) -> Tuple[List[Tuple[str, Set[str]]], Optional[Status]]:
        out: List[Tuple[str, Set[str]]] = []
        for name in pod.pvc_names():
            pvc = self.handle.pvc_cache.get(f"{pod.namespace}/{name}")
            if pvc is None:
                return [], Status.unresolvable(f'persistentvolumeclaim "{name}" not found', plugin=self.name)
            if not pvc.volume_name:
                # unbound: a WaitForFirstConsumer claim is VolumeBinding's
                # (:151), an immediate one cannot be judged yet
                sc = self.handle.get_storage_class(pvc.storage_class_name or "")
                if sc is not None and sc.is_wait_for_first_consumer():
                    continue
                return [], Status.unresolvable(f'persistentvolumeclaim "{name}" is not bound', plugin=self.name)
            pv = self.handle.pv_cache.get(pvc.volume_name)
            if pv is None:
                return [], Status.unresolvable(f'persistentvolume "{pvc.volume_name}" not found', plugin=self.name)
            for key in st.VOLUME_TOPOLOGY_LABELS:
                if key in pv.labels:
                    out.append((key, zone_value_set(pv.labels[key])))
        return out, None

    def filter(self, state: CycleState, pod: Pod, node_state) -> Status:
        topologies = state.read((self._STATE_KEY, pod.uid))
        if not topologies:
            return Status.success()
        labels = node_state.node.labels
        for key, values in topologies:
            if labels.get(key) not in values:
                return Status.unresolvable(REASON_ZONE_CONFLICT, plugin=self.name)
        return Status.success()

    def events_to_register(self) -> List[ClusterEventWithHint]:
        return [
            ClusterEventWithHint(ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_LABEL)),
            ClusterEventWithHint(ClusterEvent(EventResource.PVC, ActionType.ADD | ActionType.UPDATE)),
            ClusterEventWithHint(ClusterEvent(EventResource.PV, ActionType.ADD | ActionType.UPDATE)),
            ClusterEventWithHint(ClusterEvent(EventResource.STORAGE_CLASS, ActionType.ADD)),
        ]


def _pod_deleted(pod: Pod, old, new) -> QueueingHint:
    """A deleted pod frees a conflicting disk or claim."""
    return QueueingHint.QUEUE if old is not None else QueueingHint.SKIP


class VolumeRestrictions(PreFilterPlugin, FilterPlugin):
    """Single-attach disk conflicts and ReadWriteOncePod exclusivity."""

    name = "VolumeRestrictions"
    _STATE_KEY = "VolumeRestrictions"

    def maybe_relevant(self, pod: Pod) -> bool:
        return bool(pod.pvc_names()) or any(v.source_kind in SINGLE_ATTACH_KINDS for v in pod.volumes)

    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        needs_check = any(v.source_kind in SINGLE_ATTACH_KINDS for v in pod.volumes)
        if not needs_check and not pod.pvc_names():
            return Status.skip()
        rwop: Set[str] = set()
        for name in pod.pvc_names():
            pvc = self.handle.pvc_cache.get(f"{pod.namespace}/{name}")
            if pvc is None:
                return Status.unresolvable(f'persistentvolumeclaim "{name}" not found', plugin=self.name)
            if st.RWOP in pvc.access_modes:
                rwop.add(name)
        if not needs_check and not rwop:
            return Status.skip()
        state.write((self._STATE_KEY, pod.uid), rwop)
        return Status.success()

    @staticmethod
    def _inline_conflict(vol: Volume, existing: Volume) -> bool:
        """isVolumeConflict: the same single-attach disk conflicts, unless
        both mounts are read-only for a multi-reader kind (:104-140)."""
        if vol.source_kind != existing.source_kind:
            return False
        if vol.source_id != existing.source_id or not vol.source_id:
            return False
        if vol.source_kind in ("gce-pd", "iscsi", "rbd") and vol.read_only and existing.read_only:
            return False
        return True

    def filter(self, state: CycleState, pod: Pod, node_state) -> Status:
        rwop = state.read((self._STATE_KEY, pod.uid)) or set()
        own_inline = [v for v in pod.volumes if v.source_kind in SINGLE_ATTACH_KINDS]
        for existing_pod in node_state.pods:
            for ev in existing_pod.volumes:
                for v in own_inline:
                    if self._inline_conflict(v, ev):
                        return Status.unschedulable(REASON_DISK_CONFLICT, plugin=self.name)
                if ev.pvc_name and ev.pvc_name in rwop and existing_pod.namespace == pod.namespace:
                    return Status.unschedulable(REASON_RWOP_CONFLICT, plugin=self.name)
        return Status.success()

    def events_to_register(self) -> List[ClusterEventWithHint]:
        return [
            ClusterEventWithHint(ClusterEvent(EventResource.ASSIGNED_POD, ActionType.DELETE), _pod_deleted),
            ClusterEventWithHint(ClusterEvent(EventResource.PVC, ActionType.ADD)),
            ClusterEventWithHint(ClusterEvent(EventResource.NODE, ActionType.ADD)),
        ]


class NodeVolumeLimits(PreFilterPlugin, FilterPlugin):
    """CSI attachable-volume count limits per driver (nodevolumelimits/csi.go);
    in-tree single-attach kinds count under their own kind name."""

    name = "NodeVolumeLimits"

    def maybe_relevant(self, pod: Pod) -> bool:
        return bool(pod.pvc_names()) or any(v.source_kind == "csi" and v.driver for v in pod.volumes)

    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        if not self.maybe_relevant(pod):
            return Status.skip()
        return Status.success()

    def _volume_driver_handles(self, pod: Pod) -> Dict[str, Set[str]]:
        """Driver name → the unique volume handles the pod attaches; inline
        CSI volumes count too (csi.go:314)."""
        out: Dict[str, Set[str]] = {}
        for v in pod.volumes:
            if v.source_kind == "csi" and v.driver:
                out.setdefault(v.driver, set()).add(v.source_id or f"{pod.key}/{v.name}")
        for name in pod.pvc_names():
            pvc = self.handle.pvc_cache.get(f"{pod.namespace}/{name}")
            if pvc is None:
                continue
            driver, handle = self._driver_of(pvc)
            if driver:
                out.setdefault(driver, set()).add(handle)
        return out

    def _driver_of(self, pvc: st.PersistentVolumeClaim) -> Tuple[str, str]:
        """getCSIDriverInfo: a bound claim's PV driver and handle; an unbound
        one's storage-class provisioner and a synthetic handle (:355, :408)."""
        if pvc.volume_name:
            pv = self.handle.pv_cache.get(pvc.volume_name)
            if pv is not None:
                if pv.csi_driver:
                    return pv.csi_driver, pv.source_id or pv.name
                if pv.source_kind in SINGLE_ATTACH_KINDS:
                    return pv.source_kind, pv.source_id or pv.name
                return "", ""
        sc = self.handle.get_storage_class(pvc.storage_class_name or "")
        if sc is not None and sc.provisioner != st.NO_PROVISIONER:
            return sc.provisioner, f"{sc.provisioner}-{pvc.key}"
        return "", ""

    def filter(self, state: CycleState, pod: Pod, node_state) -> Status:
        csinode = self.handle.get_csinode(node_state.node.name)
        if csinode is None:
            return Status.success()  # no limits advertised
        new_volumes = self._volume_driver_handles(pod)
        if not new_volumes:
            return Status.success()
        attached: Dict[str, Set[str]] = {}
        for p in node_state.pods:
            for drv, handles in self._volume_driver_handles(p).items():
                if drv:
                    attached.setdefault(drv, set()).update(handles)
        for drv, handles in new_volumes.items():
            d = csinode.driver(drv)
            if d is None or d.allocatable_count is None:
                continue
            if len(attached.get(drv, set()) | handles) > d.allocatable_count:
                return Status.unschedulable(REASON_MAX_VOLUME_COUNT, plugin=self.name)
        return Status.success()

    def events_to_register(self) -> List[ClusterEventWithHint]:
        return [
            ClusterEventWithHint(ClusterEvent(EventResource.ASSIGNED_POD, ActionType.DELETE)),
            ClusterEventWithHint(ClusterEvent(EventResource.CSI_NODE, ActionType.ADD | ActionType.UPDATE)),
            ClusterEventWithHint(ClusterEvent(EventResource.PVC, ActionType.ADD)),
            ClusterEventWithHint(ClusterEvent(EventResource.NODE, ActionType.ADD)),
        ]
