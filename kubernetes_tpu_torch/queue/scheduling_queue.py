"""The active queue of pending pods (pkg/scheduler/backend/queue), the part
the signature fast path needs.

Pods pop in PrioritySort order (priority descending, then enqueue order),
in batches, with ``pop_batch_while`` extending a batch from the queue head
while a predicate holds — queue order, and so the decision sequence, is
unchanged.  A pod that failed to schedule is parked as unschedulable until a
cluster event moves it back.  Backoff timers, gating and per-plugin event
filtering are not ported yet (ROADMAP A5).
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Callable, Dict, List

from kubernetes_tpu_torch.api.types import Pod


@dataclass
class QueuedPodInfo:
    pod: Pod
    seq: int  # enqueue order (the reference's timestamp tie-break)
    attempts: int = 0


class SchedulingQueue:
    def __init__(self):
        self._active: list = []  # heap of ((-priority, seq), qp)
        self._uids: set = set()  # pods in the active heap
        self.unschedulable: Dict[str, QueuedPodInfo] = {}
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._uids) + len(self.unschedulable)

    def _push(self, qp: QueuedPodInfo) -> None:
        heapq.heappush(self._active, ((-qp.pod.priority, qp.seq), qp))
        self._uids.add(qp.pod.uid)

    def add(self, pod: Pod) -> None:
        if pod.uid in self._uids or pod.uid in self.unschedulable:
            return
        self._push(QueuedPodInfo(pod, next(self._seq)))

    def _pop(self) -> QueuedPodInfo:
        _, qp = heapq.heappop(self._active)
        self._uids.discard(qp.pod.uid)
        qp.attempts += 1
        return qp

    def pop_batch(self, k: int) -> List[QueuedPodInfo]:
        """Up to k pods in queue order."""
        out = []
        while len(out) < k and self._active:
            out.append(self._pop())
        return out

    def pop_batch_while(self, k: int, predicate: Callable[[QueuedPodInfo], bool]) -> List[QueuedPodInfo]:
        """Up to k MORE pods in queue order, stopping (without popping) at
        the first pod the predicate rejects."""
        out = []
        while len(out) < k and self._active and predicate(self._active[0][1]):
            out.append(self._pop())
        return out

    def push_back(self, batch: List[QueuedPodInfo]) -> None:
        """Return popped pods unscheduled (their original order is kept)."""
        for qp in batch:
            qp.attempts -= 1
            self._push(qp)

    def mark_unschedulable(self, qp: QueuedPodInfo) -> None:
        self.unschedulable[qp.pod.uid] = qp

    def move_all_to_active(self) -> None:
        """A cluster event (a node added or changed) may make parked pods
        schedulable: retry them all."""
        for qp in self.unschedulable.values():
            self._push(qp)
        self.unschedulable.clear()
