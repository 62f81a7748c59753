"""Status codes, per-cycle state, plugin bases and cluster events (the
parts of pkg/scheduler/framework/interface.go the port runs).

A copy of the subset of the JAX package's framework/interface.py that the
host plugins (framework/runtime.py), the preemption evaluator, the
DefaultPreemption PostFilter and the scheduling queue's event filter read:
``Code`` and ``Status`` (interface.go:190-244), ``CycleState``
(cycle_state.go:44, keyed by (key, pod uid) because one state serves a
whole batch, with the per-pod filter-skip set PreFilter's Skip fills), the
PreFilter / Filter / Reserve / PreBind plugin bases the volume plugins
implement, and ``ClusterEvent`` with its queueing hints (types.go:145).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod


class Code(enum.IntEnum):
    """Status codes (interface.go:190)."""

    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3
    WAIT = 4
    SKIP = 5
    PENDING = 6


@dataclass
class Status:
    code: Code = Code.SUCCESS
    reasons: Tuple[str, ...] = ()
    plugin: str = ""

    @classmethod
    def success(cls) -> "Status":
        return cls()

    @classmethod
    def unschedulable(cls, *reasons: str, plugin: str = "") -> "Status":
        return cls(Code.UNSCHEDULABLE, tuple(reasons), plugin)

    @classmethod
    def unresolvable(cls, *reasons: str, plugin: str = "") -> "Status":
        return cls(Code.UNSCHEDULABLE_AND_UNRESOLVABLE, tuple(reasons), plugin)

    @classmethod
    def error(cls, msg: str, plugin: str = "") -> "Status":
        return cls(Code.ERROR, (msg,), plugin)

    @classmethod
    def skip(cls) -> "Status":
        return cls(Code.SKIP)

    @property
    def ok(self) -> bool:
        return self.code == Code.SUCCESS

    def merge_reason(self) -> str:
        return "; ".join(self.reasons)


class CycleState:
    """Per-scheduling-cycle scratch space; one serves a whole batch, so
    per-pod entries are keyed by (key, pod uid), and so is the set of
    Filter plugins whose PreFilter returned Skip for a pod."""

    def __init__(self) -> None:
        self._data: Dict[Any, Any] = {}
        self.skip_filter_plugins: set = set()  # (pod uid, plugin name)

    def write(self, key: Any, value: Any) -> None:
        self._data[key] = value

    def read(self, key: Any) -> Any:
        return self._data.get(key)

    def delete(self, key: Any) -> None:
        self._data.pop(key, None)

    def mark_skip_filter(self, pod_uid: str, plugin: str) -> None:
        self.skip_filter_plugins.add((pod_uid, plugin))

    def is_filter_skipped(self, pod_uid: str, plugin: str) -> bool:
        return (pod_uid, plugin) in self.skip_filter_plugins

    def clone(self) -> "CycleState":
        """cycle_state.go Clone: values with a clone() are cloned, the rest
        shared (the preemption dry run takes one per node)."""
        cs = CycleState()
        cs._data = {k: (v.clone() if hasattr(v, "clone") else v) for k, v in self._data.items()}
        cs.skip_filter_plugins = set(self.skip_filter_plugins)
        return cs


class Plugin:
    """Base: every plugin has a name (interface.go:443) and reads the
    scheduler through its ``handle``."""

    name: str = ""

    def __init__(self, handle=None):
        self.handle = handle


class PreFilterPlugin(Plugin):
    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        """Status.skip() turns the plugin's Filter off for this pod; a
        rejection fails the pod for the whole cycle."""
        return Status.success()


class FilterPlugin(Plugin):
    """A host-backed per-(pod, node) filter."""

    def filter(self, state: CycleState, pod: Pod, node_state) -> Status:
        raise NotImplementedError

    def maybe_relevant(self, pod: Pod) -> bool:
        """Spec-only: could the Filter act on the pod?  A superset of
        "PreFilter would not Skip", asked before PreFilter runs."""
        return True


class ReservePlugin(Plugin):
    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        return Status.success()

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        pass


class PreBindPlugin(Plugin):
    def pre_bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        return Status.success()


class ActionType(enum.IntFlag):
    ADD = 1
    DELETE = 2
    UPDATE_NODE_ALLOCATABLE = 4
    UPDATE_NODE_LABEL = 8
    UPDATE_NODE_TAINT = 16
    UPDATE_NODE_CONDITION = 32
    UPDATE_NODE_ANNOTATION = 64
    UPDATE_POD_LABEL = 128
    UPDATE_POD_SCALE_DOWN = 256
    UPDATE_POD_TOLERATIONS = 512
    UPDATE_POD_SCHEDULING_GATES = 1024
    UPDATE = (
        UPDATE_NODE_ALLOCATABLE
        | UPDATE_NODE_LABEL
        | UPDATE_NODE_TAINT
        | UPDATE_NODE_CONDITION
        | UPDATE_NODE_ANNOTATION
        | UPDATE_POD_LABEL
        | UPDATE_POD_SCALE_DOWN
        | UPDATE_POD_TOLERATIONS
        | UPDATE_POD_SCHEDULING_GATES
    )
    ALL = ADD | DELETE | UPDATE


class EventResource(str, enum.Enum):
    ASSIGNED_POD = "AssignedPod"
    UNSCHEDULED_POD = "UnscheduledPod"
    NODE = "Node"
    PVC = "PersistentVolumeClaim"
    PV = "PersistentVolume"
    STORAGE_CLASS = "StorageClass"
    CSI_NODE = "CSINode"
    POD_GROUP = "PodGroup"
    RESOURCE_CLAIM = "ResourceClaim"
    RESOURCE_SLICE = "ResourceSlice"
    DEVICE_CLASS = "DeviceClass"
    WILDCARD = "*"


@dataclass(frozen=True)
class ClusterEvent:
    resource: EventResource
    action: ActionType

    def match(self, other: "ClusterEvent") -> bool:
        res_ok = (
            self.resource == EventResource.WILDCARD
            or other.resource == EventResource.WILDCARD
            or self.resource == other.resource
        )
        return res_ok and bool(self.action & other.action)


class QueueingHint(enum.IntEnum):
    """QueueingHintFn result (types.go:145)."""

    SKIP = 0
    QUEUE = 1


@dataclass
class ClusterEventWithHint:
    event: ClusterEvent
    # hint_fn(pod, old_obj, new_obj) -> QueueingHint; None always queues
    hint_fn: Optional[Callable[[Pod, Any, Any], QueueingHint]] = None
