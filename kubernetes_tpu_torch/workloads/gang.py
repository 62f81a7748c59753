"""PodGroups and the gang batch planner: the host half of the workloads tier.

A copy of the JAX package's workloads/gang.py.  It mirrors the
scheduler-plugins coscheduling surface (sigs.k8s.io scheduler-plugins
pkg/coscheduling): a ``PodGroup`` names a gang with a ``minMember`` quorum
and a ``scheduleTimeoutSeconds`` budget; pods join by spec field
(``Pod.pod_group``) or by the conventional label.  The reference plugin
holds members at a Permit barrier until minMember of them have reserved.
Here the barrier is one batched admission pass (ops/coscheduling.py): the
planner lays each gang's members out contiguously in the batch, the kernel
snapshots and restores its carried state around the member run, and a gang
whose members cannot cover the remaining quorum in this batch rolls back
whole.

``plan_batch`` defines the canonical member order that the kernel and the
serial oracle (oracle/workloads.py) both replay, so their agreement is an
ordering contract.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from kubernetes_tpu_torch.snapshot.schema import bucket_cap

# the conventional membership label (scheduler-plugins
# pkg/apis/scheduling/v1alpha1, pod-group.scheduling.sigs.k8s.io/name)
GROUP_LABEL = "pod-group.scheduling.sigs.k8s.io/name"

# PermitWaitingTimeSeconds default of the reference coscheduling plugin
DEFAULT_SCHEDULE_TIMEOUT_S = 600.0


@dataclass
class PodGroup:
    """scheduling.x-k8s.io/v1alpha1 PodGroup, scheduler-relevant fields."""

    name: str
    namespace: str = "default"
    min_member: int = 1
    schedule_timeout_s: float = DEFAULT_SCHEDULE_TIMEOUT_S
    resource_version: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


def group_key_of(pod) -> Optional[str]:
    """Namespace-scoped gang key of a pod, or None for ordinary pods."""
    name = getattr(pod, "pod_group", "") or pod.labels.get(GROUP_LABEL, "")
    if not name:
        return None
    return f"{pod.namespace}/{name}"


class GangDirectory:
    """PodGroup registry and per-gang admission bookkeeping.

    ``bound`` holds the member uids placed (assumed or bound) per gang, as
    sets, so a double notification cannot count twice.  ``first_attempt``
    opens a gang's scheduling window at its first admission attempt; the
    window closes on admission or on timeout (the members are rejected and
    a later event retries afresh)."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.groups: Dict[str, PodGroup] = {}
        self.bound: Dict[str, Set[str]] = {}
        self.first_attempt: Dict[str, float] = {}

    def upsert(self, pg: PodGroup) -> None:
        self.groups[pg.key] = pg

    def delete(self, key: str) -> None:
        self.groups.pop(key, None)
        self.first_attempt.pop(key, None)

    def get(self, key: str) -> Optional[PodGroup]:
        return self.groups.get(key)

    def note_placed(self, pod) -> None:
        key = group_key_of(pod)
        if key is not None:
            self.bound.setdefault(key, set()).add(pod.uid)

    def note_removed(self, pod) -> None:
        key = group_key_of(pod)
        if key is not None:
            s = self.bound.get(key)
            if s is not None:
                s.discard(pod.uid)

    def bound_count(self, key: str) -> int:
        s = self.bound.get(key)
        return len(s) if s else 0

    def note_attempt(self, key: str) -> None:
        self.first_attempt.setdefault(key, self.clock())

    def timed_out(self, key: str) -> bool:
        pg = self.groups.get(key)
        if pg is None or pg.schedule_timeout_s <= 0:
            return False
        start = self.first_attempt.get(key)
        return start is not None and self.clock() - start > pg.schedule_timeout_s

    def close_window(self, key: str) -> None:
        self.first_attempt.pop(key, None)


def plan_batch(pods: Sequence, group_of=group_key_of) -> Tuple[List[int], Dict[str, List[int]]]:
    """The canonical workloads order: walk the batch in queue order and, at
    the FIRST member of each gang, splice in every member of that gang
    present in the batch (members keep their relative queue order);
    ordinary pods keep their places between gangs.  Returns (order,
    gang_positions): ``order[i]`` is the original index scheduled at
    position i, ``gang_positions[key]`` the positions (in the new order) of
    that gang's members, contiguous by construction."""
    members: Dict[str, List[int]] = {}
    for i, pod in enumerate(pods):
        key = group_of(pod)
        if key is not None:
            members.setdefault(key, []).append(i)
    order: List[int] = []
    gang_positions: Dict[str, List[int]] = {}
    emitted: Set[str] = set()
    for i, pod in enumerate(pods):
        key = group_of(pod)
        if key is None:
            order.append(i)
            continue
        if key in emitted:
            continue
        emitted.add(key)
        gang_positions[key] = list(range(len(order), len(order) + len(members[key])))
        order.extend(members[key])
    return order, gang_positions


def gang_arrays(p_cap: int, gang_positions: Dict[str, List[int]], needs: Dict[str, int]):
    """The planner's output as the kernel's per-slot gang arrays (numpy).
    Returns (gang_id i32 [p_cap] (-1: no gang), gang_first bool, gang_last
    bool, gang_need i32, g_cap, slot_keys), where slot_keys maps a gang
    slot id to its group key."""
    gang_id = np.full(p_cap, -1, np.int32)
    gang_first = np.zeros(p_cap, bool)
    gang_last = np.zeros(p_cap, bool)
    gang_need = np.zeros(p_cap, np.int32)
    slot_keys: List[str] = []
    for key, positions in gang_positions.items():
        gid = len(slot_keys)
        slot_keys.append(key)
        for pos in positions:
            gang_id[pos] = gid
            gang_need[pos] = needs.get(key, 0)
        gang_first[positions[0]] = True
        gang_last[positions[-1]] = True
    g_cap = bucket_cap(max(len(slot_keys), 1), 1)
    return gang_id, gang_first, gang_last, gang_need, g_cap, slot_keys
