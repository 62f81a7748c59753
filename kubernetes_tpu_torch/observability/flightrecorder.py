"""Per-pod flight recorder: a bounded ring of pod lifecycle events.

A copy of the JAX package's observability/flightrecorder.py: one queryable
ring of per-pod breadcrumbs in place of the reference scheduler's
Diagnosis, FailedScheduling events and logs.  The port's Scheduler records
the wave's ``wave_demoted`` (a pod the admission pass moved off its
speculative node, with the conflict's kind and term) and ``wave_upgraded``
(a pod placed although speculation found no node) events, which
``explain_pod`` reads back; the other lifecycle kinds (enqueue, pop,
assumed, bound, unschedulable, ...) come with device observability
(ROADMAP A11).

Every event carries a (wall, monotonic) clock pair.  One lock and one deque
append per event; the ring holds ``CAPACITY`` events and an overflow evicts
the oldest, counted.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

CAPACITY = 4096


class FlightRecorder:
    def __init__(self):
        self._mu = threading.Lock()
        self._ring: deque = deque()
        self._seq = 0
        self._evicted = 0

    def record(self, uid: str, kind: str, detail: Optional[dict] = None) -> None:
        self.record_many(((uid, kind, detail),))

    def record_many(self, events) -> None:
        """One clock read and one lock for a run of ``(uid, kind, detail)``
        events; they share the stamp and keep one sequence number each."""
        wall = time.time()
        mono = time.monotonic()
        with self._mu:
            for uid, kind, detail in events:
                self._seq += 1
                if len(self._ring) >= CAPACITY:
                    self._ring.popleft()
                    self._evicted += 1
                self._ring.append((self._seq, wall, mono, uid, kind, detail))

    # -- queries -------------------------------------------------------------

    def events_for(self, uid: str) -> List[dict]:
        """Every retained event of one pod uid, oldest first."""
        with self._mu:
            hits = [e for e in self._ring if e[3] == uid]
        return [self._as_dict(e) for e in hits]

    def stats(self) -> dict:
        with self._mu:
            return {
                "events": len(self._ring),
                "capacity": CAPACITY,
                "recorded_total": self._seq,
                "evicted_total": self._evicted,
            }

    @staticmethod
    def _as_dict(e) -> dict:
        seq, wall, mono, uid, kind, detail = e
        out = {"seq": seq, "ts": wall, "mono": mono, "pod": uid, "kind": kind}
        if detail:
            out["detail"] = detail
        return out
