"""The default profile's PostFilter and the plugins' queueing hints.

From the JAX package's framework/plugins.py, the parts the port runs:

  * ``DefaultPreemption`` (default_preemption.go), the PostFilter shim over
    the evaluator.  It reads the K10 shortlist the scheduler's batched
    narrow wrote into the CycleState under ("preemption_potential", uid);
    an empty shortlist proves preemption cannot help.
  * ``DEFAULT_PLUGINS``: the default profile's host-backed plugins
    (VolumeRestrictions, NodeVolumeLimits, VolumeBinding, VolumeZone, in
    the reference's order), which framework/runtime.py runs, and
    ``default_plugins``, which adds DynamicResources after them under the
    DynamicResourceAllocation gate; the device-backed ones are kernel names
    in framework/config.py ``DEFAULT_ENABLED``.
  * ``QUEUEING_HINTS``: each plugin's EventsToRegister and
    the Coscheduling gate's PodGroup events (the reference registers them
    beside its profiles' hints), the
    event filter of the scheduling queue (an event requeues an
    unschedulable pod only when a plugin that rejected it registered a
    matching event whose hint says QUEUE).
"""

from __future__ import annotations

from typing import Dict, List

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.framework.dynamicresources import DynamicResources
from kubernetes_tpu_torch.framework.interface import (
    ActionType,
    ClusterEvent,
    ClusterEventWithHint,
    EventResource,
    QueueingHint,
    Status,
)
from kubernetes_tpu_torch.framework.preemption import Evaluator
from kubernetes_tpu_torch.framework.volume_plugins import NodeVolumeLimits, VolumeRestrictions, VolumeZone
from kubernetes_tpu_torch.framework.volumebinding import VolumeBinding

DEFAULT_PLUGINS = (VolumeRestrictions, NodeVolumeLimits, VolumeBinding, VolumeZone)


def default_plugins(feature_gates) -> tuple:
    """A profile's host plugins under the feature gates (the reference's
    default_plugins): DynamicResources joins after VolumeZone, before where
    DefaultBinder stands, when DynamicResourceAllocation is on."""
    if feature_gates.get("DynamicResourceAllocation"):
        return DEFAULT_PLUGINS + (DynamicResources,)
    return DEFAULT_PLUGINS


def _node_event(action: ActionType) -> ClusterEventWithHint:
    return ClusterEventWithHint(ClusterEvent(EventResource.NODE, action))


def _assigned_pod_event(action: ActionType, hint=None) -> ClusterEventWithHint:
    return ClusterEventWithHint(ClusterEvent(EventResource.ASSIGNED_POD, action), hint)


def _ports_freed(pod: Pod, old, new) -> QueueingHint:
    """NodePorts: a deleted pod frees host ports only if it used one the
    pod wants."""
    if isinstance(old, Pod):
        used = {(p.protocol, p.host_port) for p in old.host_ports()}
        want = {(p.protocol, p.host_port) for p in pod.host_ports()}
        return QueueingHint.QUEUE if used & want else QueueingHint.SKIP
    return QueueingHint.QUEUE


def _resources_freed(pod: Pod, old, new) -> QueueingHint:
    """NodeResourcesFit: deleted or scaled-down pods free resources."""
    return QueueingHint.QUEUE


_POD_TERMS = ActionType.ADD | ActionType.DELETE | ActionType.UPDATE_POD_LABEL

QUEUEING_HINTS: Dict[str, List[ClusterEventWithHint]] = {
    "NodeName": [_node_event(ActionType.ADD)],
    "NodeUnschedulable": [_node_event(ActionType.ADD | ActionType.UPDATE_NODE_TAINT)],
    "TaintToleration": [_node_event(ActionType.ADD | ActionType.UPDATE_NODE_TAINT)],
    "NodeAffinity": [_node_event(ActionType.ADD | ActionType.UPDATE_NODE_LABEL)],
    "NodePorts": [_assigned_pod_event(ActionType.DELETE, _ports_freed), _node_event(ActionType.ADD)],
    "NodeResourcesFit": [
        _assigned_pod_event(ActionType.DELETE | ActionType.UPDATE_POD_SCALE_DOWN, _resources_freed),
        _node_event(ActionType.ADD | ActionType.UPDATE_NODE_ALLOCATABLE),
    ],
    "InterPodAffinity": [
        _assigned_pod_event(_POD_TERMS),
        _node_event(ActionType.ADD | ActionType.UPDATE_NODE_LABEL),
    ],
    "PodTopologySpread": [
        _assigned_pod_event(_POD_TERMS),
        _node_event(
            ActionType.ADD | ActionType.DELETE | ActionType.UPDATE_NODE_LABEL | ActionType.UPDATE_NODE_TAINT
        ),
    ],
    # victim deletion is what unblocks a nominated preemptor
    "DefaultPreemption": [_assigned_pod_event(ActionType.DELETE)],
    # a gang's rejections (waiting for members, rolled back, timed out)
    # requeue on PodGroup events; the scheduler fires a synthetic UPDATE
    # when a pending member arrives
    "Coscheduling": [ClusterEventWithHint(ClusterEvent(EventResource.POD_GROUP, ActionType.ADD | ActionType.UPDATE))],
    **{cls.name: cls().events_to_register() for cls in DEFAULT_PLUGINS + (DynamicResources,)},
}


class DefaultPreemption:
    name = "DefaultPreemption"

    def __init__(self, handle, percentage: int = 10, min_candidates: int = 100):
        self.evaluator = Evaluator(self.name, handle, percentage=percentage, min_candidates=min_candidates)

    def post_filter(self, state, pod: Pod):
        """(nominated node name or "" or None, Status)."""
        potential = state.read(("preemption_potential", pod.uid))
        if potential is not None and not potential:
            # K10 proved no node can host the pod even after removing every
            # lower-priority victim
            return "", Status.unschedulable("preemption is not helpful for scheduling", plugin=self.name)
        return self.evaluator.preempt(pod, shortlist=potential)
