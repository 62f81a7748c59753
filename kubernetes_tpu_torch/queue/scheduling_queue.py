"""The scheduling queue (pkg/scheduler/backend/queue/scheduling_queue.go).

A copy of the JAX package's queue/scheduling_queue.py without PreEnqueue
gating (ROADMAP A5) and without custom QueueSort plugins:

  * the active queue, a heap in PrioritySort order (priority descending,
    then first-enqueue time on the queue's clock, then push order);
  * the backoff queue, a heap by expiry: a failed pod waits
    2^(attempts-1) seconds, at most 10 (:1230-1266), and ``pop_batch``
    flushes the expired ones to the active queue first;
  * the unschedulable pods, parked until a cluster event that one of the
    plugins which rejected them registered (``framework/plugins.py``
    QUEUEING_HINTS) moves them to the backoff or active queue, or until
    they have waited five minutes (flushed every 30 s of the clock).

Popped pods stay in flight until their attempt concludes (``done`` or
``add_unschedulable``); events arriving meanwhile are replayed when the pod
fails, so a victim deleted during its preemptor's own attempt still
requeues the preemptor (active_queue.go:74-126).  ``pop_batch`` returns up
to k pods in queue order and ``pop_batch_while`` extends a batch from the
queue head while a predicate holds; ``pop_siblings`` pulls a gang's other
active members out of the heap (the reference's :384).
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.framework.interface import ClusterEvent, ClusterEventWithHint, QueueingHint

POD_INITIAL_BACKOFF = 1.0
POD_MAX_BACKOFF = 10.0
UNSCHEDULABLE_TIMEOUT = 5 * 60.0
UNSCHEDULABLE_FLUSH_INTERVAL = 30.0  # scheduling_queue.go:356


@dataclass
class QueuedPodInfo:
    """framework.QueuedPodInfo (types.go:234)."""

    pod: Pod
    timestamp: float = 0.0  # first enqueue time on the queue's clock
    attempts: int = 0
    unschedulable_plugins: set = field(default_factory=set)
    last_failure_time: float = 0.0


class SchedulingQueue:
    def __init__(
        self,
        queueing_hints: Optional[Dict[str, List[ClusterEventWithHint]]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.hints = queueing_hints or {}
        self.clock = clock
        self._seq = itertools.count()
        self._active: List[Tuple[Any, int, QueuedPodInfo]] = []  # heap
        self._backoff: List[Tuple[float, int, QueuedPodInfo]] = []  # heap
        self.unschedulable: Dict[str, QueuedPodInfo] = {}
        self._in_queue: Dict[str, str] = {}  # uid → "active" / "backoff" / "unschedulable"
        # uid → the live heap entry's id: a pod re-entering a heap never
        # resurrects a stale earlier entry (lazy deletion)
        self._live: Dict[str, int] = {}
        self._items: Dict[str, QueuedPodInfo] = {}
        # in-flight pods and the events seen while they were popped
        self._in_flight: Dict[str, List[Tuple[ClusterEvent, Any, Any]]] = {}
        self._last_unsched_flush = self.clock()

    def __len__(self) -> int:
        return len(self._in_queue)

    # ----- heaps ------------------------------------------------------------

    def _push_active(self, qp: QueuedPodInfo) -> None:
        eid = next(self._seq)
        heapq.heappush(self._active, ((-qp.pod.priority, qp.timestamp), eid, qp))
        self._in_queue[qp.pod.uid] = "active"
        self._live[qp.pod.uid] = eid
        self._items[qp.pod.uid] = qp

    def _push_backoff(self, qp: QueuedPodInfo) -> None:
        eid = next(self._seq)
        heapq.heappush(self._backoff, (self._backoff_expiry(qp), eid, qp))
        self._in_queue[qp.pod.uid] = "backoff"
        self._live[qp.pod.uid] = eid
        self._items[qp.pod.uid] = qp

    def _entry_live(self, qp: QueuedPodInfo, eid: int, location: str) -> bool:
        uid = qp.pod.uid
        return self._in_queue.get(uid) == location and self._live.get(uid) == eid

    def _backoff_expiry(self, qp: QueuedPodInfo) -> float:
        """1 s · 2^(attempts-1), at most 10 s (scheduling_queue.go:1230)."""
        d = POD_INITIAL_BACKOFF * (2 ** max(qp.attempts - 1, 0))
        return qp.last_failure_time + min(d, POD_MAX_BACKOFF)

    def _take(self, qp: QueuedPodInfo) -> None:
        """Pop bookkeeping: the pod leaves the queue and is in flight."""
        uid = qp.pod.uid
        del self._in_queue[uid]
        self._live.pop(uid, None)
        self._items.pop(uid, None)
        qp.attempts += 1
        self._in_flight[uid] = []

    def pending_pods(self) -> Dict[str, List[Pod]]:
        """PendingPods introspection (scheduling_queue.go:1146): the pods of
        each pool, the heaps in their array order."""
        return {
            "active": [qp.pod for _, eid, qp in self._active if self._entry_live(qp, eid, "active")],
            "backoff": [qp.pod for _, eid, qp in self._backoff if self._entry_live(qp, eid, "backoff")],
            "unschedulable": [qp.pod for qp in self.unschedulable.values()],
        }

    # ----- add / delete -----------------------------------------------------

    def add(self, pod: Pod) -> None:
        if pod.uid in self._in_queue or pod.uid in self._in_flight:
            return
        self._push_active(QueuedPodInfo(pod=pod, timestamp=self.clock()))

    def delete(self, pod: Pod) -> None:
        where = self._in_queue.pop(pod.uid, None)
        if where == "unschedulable":
            self.unschedulable.pop(pod.uid, None)
        self._live.pop(pod.uid, None)
        self._items.pop(pod.uid, None)
        self._in_flight.pop(pod.uid, None)

    # ----- pop --------------------------------------------------------------

    def _flush_backoff(self) -> None:
        now = self.clock()
        while self._backoff:
            expiry, eid, qp = self._backoff[0]
            if not self._entry_live(qp, eid, "backoff"):
                heapq.heappop(self._backoff)
                continue
            if expiry > now:
                break
            heapq.heappop(self._backoff)
            self._push_active(qp)

    def flush_unschedulable_leftover(self) -> None:
        """Pods unschedulable longer than the timeout move back
        (flushUnschedulablePodsLeftover, :802)."""
        now = self.clock()
        for uid in list(self.unschedulable):
            qp = self.unschedulable[uid]
            if now - qp.last_failure_time >= UNSCHEDULABLE_TIMEOUT:
                del self.unschedulable[uid]
                self._requeue(qp)

    def pop_batch(self, k: int) -> List[QueuedPodInfo]:
        """Up to k pods in queue order, after the periodic flushes."""
        now = self.clock()
        if now - self._last_unsched_flush >= UNSCHEDULABLE_FLUSH_INTERVAL:
            self._last_unsched_flush = now
            self.flush_unschedulable_leftover()
        self._flush_backoff()
        out: List[QueuedPodInfo] = []
        while len(out) < k and self._active:
            _, eid, qp = heapq.heappop(self._active)
            if not self._entry_live(qp, eid, "active"):
                continue  # a deleted or superseded entry
            self._take(qp)
            out.append(qp)
        return out

    def pop_batch_while(self, k: int, predicate: Callable[[QueuedPodInfo], bool]) -> List[QueuedPodInfo]:
        """Up to k MORE pods in queue order, stopping (without popping) at
        the first live entry the predicate rejects.  Call right after
        pop_batch (it shares its flushes)."""
        out: List[QueuedPodInfo] = []
        while len(out) < k and self._active:
            _, eid, qp = self._active[0]
            if not self._entry_live(qp, eid, "active"):
                heapq.heappop(self._active)
                continue
            if not predicate(qp):
                break
            heapq.heappop(self._active)
            self._take(qp)
            out.append(qp)
        return out

    def pop_siblings(self, match: Callable[[QueuedPodInfo], bool]) -> List[QueuedPodInfo]:
        """Pop every ACTIVE pod that ``match`` accepts, wherever it sits in
        the heap: the gang sibling-pull, so a gang split across popped
        batches is judged in one dispatch.  Pods in backoff or parked as
        unschedulable stay where they are.  The matched pods come out in
        queue order; every other entry keeps its place (stale heap entries
        are dropped lazily, as pop_batch drops them)."""
        picked = [e for e in self._active if self._entry_live(e[2], e[1], "active") and match(e[2])]
        picked.sort(key=lambda e: (e[0], e[1]))
        out: List[QueuedPodInfo] = []
        for _, eid, qp in picked:
            if not self._entry_live(qp, eid, "active"):
                continue
            self._take(qp)
            out.append(qp)
        return out

    def push_back(self, batch: Sequence[QueuedPodInfo]) -> None:
        """Return popped pods unscheduled, as if never popped."""
        for qp in batch:
            self._in_flight.pop(qp.pod.uid, None)
            qp.attempts -= 1
            self._push_active(qp)

    # ----- attempt outcomes -------------------------------------------------

    def done(self, uid: str) -> None:
        """The pod's attempt concluded (bound)."""
        self._in_flight.pop(uid, None)

    def add_unschedulable(self, qp: QueuedPodInfo, plugins) -> None:
        """AddUnschedulableIfNotPresent (:723): the failed pod parks with
        the plugins that rejected it, unless an event seen during its
        attempt already makes it worth retrying (then it backs off).  With
        no rejecting plugin it backs off (scheduling_queue.go:642-647)."""
        uid = qp.pod.uid
        if uid not in self._in_flight:
            return  # deleted mid-attempt: re-parking would leak a ghost
        qp.unschedulable_plugins = set(plugins or ())
        qp.last_failure_time = self.clock()
        events = self._in_flight.pop(uid)
        if not qp.unschedulable_plugins or any(
            self._is_worth_requeuing(qp, ev, old, new) for ev, old, new in events
        ):
            self._requeue(qp)
            return
        self.unschedulable[uid] = qp
        self._in_queue[uid] = "unschedulable"
        self._items[uid] = qp

    def activate(self, pods: Sequence[Pod]) -> None:
        """Move parked or backing-off pods straight to the active queue."""
        for pod in pods:
            where = self._in_queue.get(pod.uid)
            qp = self._items.get(pod.uid)
            if qp is None or where not in ("unschedulable", "backoff"):
                continue
            if where == "unschedulable":
                self.unschedulable.pop(pod.uid, None)
            self._push_active(qp)

    # ----- cluster events ---------------------------------------------------

    def move_all_on_event(self, event: ClusterEvent, old: Any = None, new: Any = None) -> int:
        """MoveAllToActiveOrBackoffQueue (:1014).  Returns the pods moved."""
        for events in self._in_flight.values():
            events.append((event, old, new))
        moved = 0
        for uid in list(self.unschedulable):
            qp = self.unschedulable[uid]
            if self._is_worth_requeuing(qp, event, old, new):
                del self.unschedulable[uid]
                self._requeue(qp)
                moved += 1
        return moved

    def _is_worth_requeuing(self, qp: QueuedPodInfo, event: ClusterEvent, old: Any, new: Any) -> bool:
        """isPodWorthRequeuing (:401): only the hints of the plugins that
        rejected the pod run, for matching events."""
        if not qp.unschedulable_plugins:
            return True
        for name in qp.unschedulable_plugins:
            for ewh in self.hints.get(name, ()):
                if not ewh.event.match(event):
                    continue
                if ewh.hint_fn is None or ewh.hint_fn(qp.pod, old, new) == QueueingHint.QUEUE:
                    return True
        return False

    def _requeue(self, qp: QueuedPodInfo) -> None:
        if self._backoff_expiry(qp) <= self.clock():
            self._push_active(qp)
        else:
            self._push_backoff(qp)
