"""Status codes, per-cycle state and cluster events (the parts of
pkg/scheduler/framework/interface.go the port's PostFilter and queue use).

A copy of the subset of the JAX package's framework/interface.py that the
preemption evaluator, the DefaultPreemption PostFilter and the scheduling
queue's event filter read: ``Code`` and ``Status`` (interface.go:190-244),
``CycleState`` (cycle_state.go:44, keyed by (key, pod uid) because one
state serves a whole batch), and ``ClusterEvent`` with its queueing hints
(types.go:145).
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

    @property
    def ok(self) -> bool:
        return self.code == Code.SUCCESS

    def merge_reason(self) -> str:
        return "; ".join(self.reasons)


class CycleState:
    """Per-scheduling-cycle scratch space; one serves a whole batch, so
    per-pod entries are keyed by (key, pod uid)."""

    def __init__(self) -> None:
        self._data: Dict[Any, Any] = {}

    def write(self, key: Any, value: Any) -> None:
        self._data[key] = value

    def read(self, key: Any) -> Any:
        return self._data.get(key)

    def delete(self, key: Any) -> None:
        self._data.pop(key, None)


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
    POD_GROUP = "PodGroup"
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
