"""VolumeBinding and its VolumeBinder: the bound-claims half.

A copy of the part of the JAX package's framework/volumebinding.py that a
pod whose claims are all bound reaches.  Semantics are those of
pkg/scheduler/framework/plugins/volumebinding/volume_binding.go (:322
PreFilter, :394 Filter, :476 Reserve, :501 PreBind) and binder.go
(GetPodVolumeClaims :825, checkBoundClaims :868).

For bound claims the Filter's verdict is the PV's node affinity (the K12
mask computes it for a whole batch; this Filter runs for the chosen node in
the host replay), and Reserve and PreBind have nothing to bind.  Static
binding of WaitForFirstConsumer claims, dynamic provisioning and the
VolumeCapacityPriority score are ROADMAP A6b: the scheduler refuses the
pods that would need them, and ``find_pod_volumes`` raises for them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from kubernetes_tpu_torch.api import storage as st
from kubernetes_tpu_torch.api.types import Node, Pod, node_selector_matches
from kubernetes_tpu_torch.framework.interface import (
    ActionType,
    ClusterEvent,
    ClusterEventWithHint,
    CycleState,
    EventResource,
    FilterPlugin,
    PreBindPlugin,
    PreFilterPlugin,
    QueueingHint,
    ReservePlugin,
    Status,
)

# conflict reasons (binder.go:66-74)
REASON_NODE_CONFLICT = "node(s) had volume node affinity conflict"
REASON_PV_NOT_EXIST = "node(s) unavailable due to one or more pvc(s) bound to non-existent pv(s)"


@dataclass
class PodVolumeClaims:
    """GetPodVolumeClaims' output (binder.go:205)."""

    bound_claims: List[st.PersistentVolumeClaim] = field(default_factory=list)
    claims_to_bind: List[st.PersistentVolumeClaim] = field(default_factory=list)
    unbound_claims_immediate: List[st.PersistentVolumeClaim] = field(default_factory=list)


def pv_node_affinity_matches(pv: st.PersistentVolume, node: Node) -> bool:
    """CheckVolumeNodeAffinity: a nil affinity matches every node."""
    return pv.node_affinity is None or node_selector_matches(pv.node_affinity, node)


class VolumeBinder:
    """SchedulerVolumeBinder (binder.go:152) over the assume caches;
    ``handle`` supplies pv_cache, pvc_cache and get_storage_class."""

    def __init__(self, handle):
        self.handle = handle

    def get_pod_volume_claims(self, pod: Pod) -> Tuple[Optional[PodVolumeClaims], Optional[Status]]:
        claims = PodVolumeClaims()
        for name in pod.pvc_names():
            pvc = self.handle.pvc_cache.get(f"{pod.namespace}/{name}")
            if pvc is None:
                return None, Status.unresolvable(f'persistentvolumeclaim "{name}" not found',
                                                 plugin=VolumeBinding.name)
            if pvc.deletion_timestamp is not None:
                return None, Status.unresolvable(f'persistentvolumeclaim "{name}" is being deleted',
                                                 plugin=VolumeBinding.name)
            if pvc.is_fully_bound():
                claims.bound_claims.append(pvc)
                continue
            sc = self.handle.get_storage_class(pvc.storage_class_name or "")
            if sc is not None and sc.is_wait_for_first_consumer():
                claims.claims_to_bind.append(pvc)
            else:
                claims.unbound_claims_immediate.append(pvc)
        return claims, None

    def find_pod_volumes(self, pod: Pod, claims: PodVolumeClaims, node: Node) -> List[str]:
        """FindPodVolumes (binder.go:281) for bound claims: every PV exists
        and its node affinity admits the node.  Returns the conflict reasons."""
        if claims.claims_to_bind:
            raise NotImplementedError(
                f"pod {pod.key}: binding WaitForFirstConsumer claims is ROADMAP A6b, which the port has not ported")
        for pvc in claims.bound_claims:
            pv = self.handle.pv_cache.get(pvc.volume_name)
            if pv is None:
                return [REASON_PV_NOT_EXIST]
            if not pv_node_affinity_matches(pv, node):
                return [REASON_NODE_CONFLICT]
        return []


class VolumeBinding(PreFilterPlugin, FilterPlugin, ReservePlugin, PreBindPlugin):
    """volume_binding.go: the plugin over VolumeBinder."""

    name = "VolumeBinding"
    _STATE_KEY = "VolumeBinding"

    def __init__(self, handle=None):
        super().__init__(handle)
        self.binder = VolumeBinder(handle)

    def maybe_relevant(self, pod: Pod) -> bool:
        return bool(pod.pvc_names())

    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        if not pod.pvc_names():
            return Status.skip()
        claims, status = self.binder.get_pod_volume_claims(pod)
        if status is not None:
            return status
        if claims.unbound_claims_immediate:
            return Status.unresolvable("pod has unbound immediate PersistentVolumeClaims", plugin=self.name)
        state.write((self._STATE_KEY, pod.uid), {"claims": claims, "nodes": set()})
        return Status.success()

    def filter(self, state: CycleState, pod: Pod, node_state) -> Status:
        data = state.read((self._STATE_KEY, pod.uid))
        if data is None:  # PreFilter skipped: no claims
            return Status.success()
        reasons = self.binder.find_pod_volumes(pod, data["claims"], node_state.node)
        if reasons:
            # UnschedulableAndUnresolvable (volume_binding.go:414): no eviction
            # fixes a PV's node affinity, so the preemption dry run skips it
            return Status.unresolvable(*reasons, plugin=self.name)
        data["nodes"].add(node_state.node.name)
        return Status.success()

    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """AssumePodVolumes (binder.go:441): bound claims leave nothing to
        assume; a node the Filter never passed is an error, as there."""
        data = state.read((self._STATE_KEY, pod.uid))
        if data is None:
            return Status.success()
        if node_name not in data["nodes"]:
            return Status.error(f"no volume decisions recorded for node {node_name}", plugin=self.name)
        data["reserved_node"] = node_name
        return Status.success()

    def pre_bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        """BindPodVolumes (binder.go:512): every claim is bound already."""
        return Status.success()

    def events_to_register(self) -> List[ClusterEventWithHint]:
        def pvc_hint(pod: Pod, old, new) -> QueueingHint:
            # only this pod's own claims matter (:159)
            if new is None or new.namespace != pod.namespace:
                return QueueingHint.SKIP
            return QueueingHint.QUEUE if new.name in pod.pvc_names() else QueueingHint.SKIP

        return [
            ClusterEventWithHint(ClusterEvent(EventResource.PVC, ActionType.ADD | ActionType.UPDATE), pvc_hint),
            ClusterEventWithHint(ClusterEvent(EventResource.PV, ActionType.ADD | ActionType.UPDATE)),
            ClusterEventWithHint(ClusterEvent(EventResource.STORAGE_CLASS, ActionType.ADD | ActionType.UPDATE)),
            ClusterEventWithHint(ClusterEvent(EventResource.CSI_NODE, ActionType.ADD | ActionType.UPDATE)),
            ClusterEventWithHint(ClusterEvent(EventResource.NODE, ActionType.ADD)),
        ]
