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
  * ``NodeResourcesFit``'s scoring-strategy args (noderesources/fit.go):
    LeastAllocated, MostAllocated or RequestedToCapacityRatio with its
    shape, the resource weights, and the host ``score`` the one-pod cycle
    uses.  A strategy that weighs resources beyond cpu and memory scores on
    the host only (``device_score`` False): the kernels' fit score reads the
    cpu and memory lanes.
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
from kubernetes_tpu_torch.oracle import scores as OS
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


class NodeResourcesFit:
    """NodeResourcesFit's Score half with its args (noderesources/fit.go):
    the three scoring strategies (LeastAllocated by default, MostAllocated,
    RequestedToCapacityRatio, requested_to_capacity_ratio.go:32).  The
    strategy reaches the kernels as ``fit_strategy()`` = (id, shape,
    (w_cpu, w_mem)); a resource spec beyond cpu and memory sets
    ``device_score`` False, and the scheduler scores such pods on the host
    (``score``) instead of diverging on the device."""

    name = "NodeResourcesFit"
    STRATEGY_IDS = {"LeastAllocated": 0, "MostAllocated": 1, "RequestedToCapacityRatio": 2}
    # config.MaxCustomPriorityScore: shape scores are 0-10, scaled to 0-100
    MAX_CUSTOM_PRIORITY_SCORE = 10

    def __init__(self, args=None):
        ss = (args or {}).get("scoringStrategy", {}) or {}
        self.strategy = ss.get("type", "LeastAllocated")
        if self.strategy not in self.STRATEGY_IDS:
            raise ValueError(f"unknown scoringStrategy {self.strategy!r}")
        res = ss.get("resources") or [{"name": "cpu", "weight": 1}, {"name": "memory", "weight": 1}]
        w = {r["name"]: int(r.get("weight", 1)) for r in res}
        self.fit_res_weights = (w.get("cpu", 0), w.get("memory", 0))
        self.device_score = all(name in ("cpu", "memory") for name in w)
        scale = 100 // self.MAX_CUSTOM_PRIORITY_SCORE
        raw_shape = ss.get("requestedToCapacityRatio", {}).get(
            "shape", [{"utilization": 0, "score": 0}, {"utilization": 100, "score": 10}]
        )
        # apis/config/validation: utilization strictly increasing in
        # [0, 100], score in [0, MaxCustomPriorityScore]
        prev = -1
        for pt in raw_shape:
            u, sc = int(pt["utilization"]), int(pt["score"])
            if not 0 <= u <= 100:
                raise ValueError(f"shape utilization {u} outside [0, 100]")
            if u <= prev:
                raise ValueError("shape utilization must be strictly increasing")
            if not 0 <= sc <= self.MAX_CUSTOM_PRIORITY_SCORE:
                raise ValueError(f"shape score {sc} outside [0, {self.MAX_CUSTOM_PRIORITY_SCORE}]")
            prev = u
        self.fit_shape = tuple((int(pt["utilization"]), int(pt["score"]) * scale) for pt in raw_shape)
        self.fit_resources = tuple((name, weight) for name, weight in w.items() if weight)

    def fit_strategy(self) -> tuple:
        """(strategy id, shape, (w_cpu, w_mem)): the kernels' form
        (ops/gang.py DEFAULT_FIT_STRATEGY)."""
        shape = self.fit_shape if self.strategy == "RequestedToCapacityRatio" else ()
        return (self.STRATEGY_IDS[self.strategy], shape, self.fit_res_weights)

    def score(self, pod: Pod, ns) -> int:
        """The strategy's score of ``pod`` on the host node ``ns``."""
        if self.strategy == "MostAllocated":
            return OS.score_most_allocated(pod, ns, self.fit_resources)
        if self.strategy == "RequestedToCapacityRatio":
            return OS.score_requested_to_capacity_ratio(pod, ns, self.fit_shape, self.fit_resources)
        return OS.score_least_allocated(pod, ns, self.fit_resources)
