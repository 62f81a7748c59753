"""Host half of the signature fast path: exact sequential-equivalent greedy.

Given per-signature static rows from ops.fastpath.static_eval, replays the
reference's one-pod-at-a-time argmax commit (schedule_one.go:65 ScheduleOne
→ selectHost first-max policy) in pure integer arithmetic identical to the
sig_scan kernel's formulas, so decisions bit-match it.  The committer is the
scheduler's committed truth: small batches run on it directly, and device
batches advance it by replaying the kernel's choices.

Data structure: one lazy heap per signature keyed (-score, node).  A commit
touches exactly one node; fresh entries for that node are pushed into every
ACTIVE signature heap, and stale entries are re-validated on pop.  Resource
infeasibility is monotone within a batch (usage only grows), so infeasible
pops are dropped permanently.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.snapshot.schema import (
    LANE_CPU,
    LANE_MEM,
    MEM_UNIT,
    N_FIXED_LANES,
    NodeTensors,
    ResourceLanes,
)

MAX = 100  # MaxNodeScore


def spec_key(pod: Pod):
    """Content-addressed identity of every spec field signature_key reads —
    pods stamped from the same template share one entry in the scheduler's
    spec→signature cache, so the full computation (quantity parsing, lane
    packing) runs once per distinct spec instead of once per pod.  Returns
    None when a spec field is unhashable (custom mappings) — callers fall
    back to the full computation."""
    try:
        out = (
            tuple(
                (
                    c.name,
                    tuple(sorted((c.requests or {}).items())),
                    c.ports,
                    c.restart_policy,
                )
                for c in pod.containers
            ),
            tuple(
                (
                    c.name,
                    tuple(sorted((c.requests or {}).items())),
                    c.ports,
                    c.restart_policy,
                )
                for c in pod.init_containers
            ),
            tuple(sorted((pod.overhead or {}).items())),
            pod.tolerations,
            tuple(sorted(pod.node_selector.items())),
            pod.affinity,
            pod.images,
            pod.node_name,
            bool(pod.nominated_node_name),
            bool(pod.topology_spread_constraints),
            pod.host_network,
        )
        hash(out)  # selectors etc. hold dicts — probe before caching on it
        return out
    except TypeError:
        return None


_SK_MISSING = object()


def spec_key_memo(pod: Pod):
    """spec_key memoized on the pod object: the tuple build itself costs
    ~µs and the hot paths ask several times per pod.  Safe because spec
    updates arrive as NEW Pod objects (the compute_requests memo
    contract), so the memo can never go stale."""
    d = pod.__dict__
    sk = d.get("_speckey_memo", _SK_MISSING)
    if sk is _SK_MISSING:
        sk = spec_key(pod)
        d["_speckey_memo"] = sk
    return sk


def signature_key(pod: Pod, lanes: ResourceLanes, n_lanes: int):
    """Hashable identity of everything that affects a pod's row in the
    resource-only pipeline; None when the pod is not fast-path eligible
    (spread / inter-pod terms / host ports / preset node / nomination)."""
    if pod.topology_spread_constraints:
        return None
    if pod.affinity is not None and (
        pod.affinity.pod_affinity is not None
        or pod.affinity.pod_anti_affinity is not None
    ):
        return None
    if pod.host_ports() or pod.nominated_node_name:
        return None
    req = pod.compute_requests()
    row = tuple(lanes.request_row(req, n_lanes).tolist())
    nz = req.non_zero_defaulted()
    node_aff = pod.affinity.node_affinity if pod.affinity is not None else None
    return (
        row,
        (nz.milli_cpu, -(-nz.memory // MEM_UNIT)),
        pod.tolerations,
        tuple(sorted(pod.node_selector.items())),
        node_aff,
        pod.images,
        pod.node_name,
    )


@dataclass
class Signature:
    req_row: Tuple[int, ...]
    nz0: int
    nz1: int
    all_zero: bool
    static_ok: np.ndarray  # bool [N]
    img: Optional[List[int]] = None  # i64 per node, None when unused
    sid: int = -1  # row in the device sig_scan stack (scheduler-assigned)
    remaining: int = 0  # pods of this signature still unplaced
    # NOTE: heap/known-score state lives on each FastCommitter (keyed by
    # id(sig)) because Signature objects are shared across committers.


class FastCommitter:
    """One batch's sequential greedy over host state (numpy mirror copy)."""

    def __init__(
        self,
        nodes: NodeTensors,
        weights: Tuple[int, ...],
        check_fit: bool = True,
    ):
        # weights in ops.scores.WEIGHT_ORDER
        (
            self.w_taint,
            self.w_naff,
            self.w_spread,
            self.w_ip,
            self.w_fit,
            self.w_bal,
            self.w_img,
        ) = weights
        self.check_fit = check_fit
        n = nodes.valid.shape[0]
        self.n = n
        self.rn = nodes.allocatable.shape[1]
        # python-int state columns (hot loop avoids numpy scalar overhead)
        self.alloc_rows = nodes.allocatable.tolist()
        self.used_rows = [list(r) for r in nodes.requested.tolist()]
        self.alloc0 = [r[LANE_CPU] for r in self.alloc_rows]
        self.alloc1 = [r[LANE_MEM] for r in self.alloc_rows]
        self.nz0 = [int(x) for x in nodes.nonzero_req[:, 0]]
        self.nz1 = [int(x) for x in nodes.nonzero_req[:, 1]]
        self.num_pods = [int(x) for x in nodes.num_pods.tolist()]
        self.allowed = [int(x) for x in nodes.allowed_pods.tolist()]
        # per-committer lazy-heap state, keyed id(sig): Signature objects
        # can be SHARED across committers, so the heaps must live here — a heap built against one committer's usage
        # is stale-LOW for another's, which breaks the argmax
        self._heaps: Dict[int, list] = {}
        self._known: Dict[int, List[int]] = {}

    def invalidate_heaps(self) -> None:
        """Drop all per-signature heaps — required after the committer's
        state advanced by REPLAY (device-batch harvests) rather than by its
        own run(): replayed commits can RAISE node scores, which the lazy
        heaps would otherwise never see."""
        self._heaps.clear()
        self._known.clear()

    # ----- integer feasibility — MUST match the sig_scan step -------------

    def feasible_int(self, n: int, sig: Signature) -> bool:
        if not self.check_fit:
            return True
        if self.num_pods[n] + 1 > self.allowed[n]:
            return False
        if sig.all_zero:
            return True
        used = self.used_rows[n]
        alloc = self.alloc_rows[n]
        rn = self.rn
        for r, v in enumerate(sig.req_row):
            if r >= N_FIXED_LANES and v == 0:
                continue
            avail = (alloc[r] - used[r]) if r < rn else 0
            if v > avail:
                return False
        return True

    # ----- the greedy -------------------------------------------------------

    def _build_heap(self, sig: Signature) -> list:
        # vectorized initial scores (numpy), exact-int formulas
        a0 = np.asarray(self.alloc0, dtype=np.int64)
        a1 = np.asarray(self.alloc1, dtype=np.int64)
        total = np.zeros(self.n, dtype=np.int64)
        if self.w_fit:
            nz0 = np.asarray(self.nz0, dtype=np.int64) + sig.nz0
            nz1 = np.asarray(self.nz1, dtype=np.int64) + sig.nz1
            f0 = np.where(nz0 > a0, 0, (a0 - nz0) * MAX // np.maximum(a0, 1))
            f1 = np.where(nz1 > a1, 0, (a1 - nz1) * MAX // np.maximum(a1, 1))
            h0 = a0 > 0
            h1 = a1 > 0
            w = h0.astype(np.int64) + h1
            least = np.where(
                w > 0,
                (np.where(h0, f0, 0) + np.where(h1, f1, 0)) // np.maximum(w, 1),
                0,
            )
            total += self.w_fit * least
        if self.w_bal:
            u0 = np.asarray([r[LANE_CPU] for r in self.used_rows], np.int64)
            u1 = np.asarray([r[LANE_MEM] for r in self.used_rows], np.int64)
            r0 = np.minimum(u0 + sig.req_row[LANE_CPU], a0)
            r1 = np.minimum(u1 + sig.req_row[LANE_MEM], a1)
            d = np.abs(r0 * a1 - r1 * a0)
            den = np.maximum(a0 * a1, 1)
            bal = np.where(
                (a0 > 0) & (a1 > 0), MAX - (50 * d + den - 1) // den, MAX
            )
            total += self.w_bal * bal
        if self.w_img and sig.img is not None:
            total += self.w_img * np.asarray(sig.img, dtype=np.int64)
        self._known[id(sig)] = total.tolist()
        idx = np.nonzero(sig.static_ok)[0]
        heap = list(zip((-total[idx]).tolist(), idx.tolist()))
        heapq.heapify(heap)
        return heap

    def run(self, pod_sigs: Sequence[Signature]) -> List[int]:
        """pod_sigs[i] is pod i's signature (shared objects).  Returns the
        chosen node index per pod (-1 unschedulable), in batch order.

        The argmax pop-revalidation and the post-commit push-update walk
        inline feasible_int and the score formulas with hoisted locals, so per-visit
        work is a handful of integer ops instead of bound-method calls
        (the formulas are byte-for-byte the same)."""
        for sig in pod_sigs:
            sig.remaining += 1
        active = {id(s): s for s in pod_sigs}
        act_list = list(active.values())
        committed_any = False  # drives the end-of-run stale-heap eviction
        choices: List[int] = []
        heaps = self._heaps
        known_map = self._known
        alloc0 = self.alloc0
        alloc1 = self.alloc1
        alloc_rows = self.alloc_rows
        used_rows = self.used_rows
        nz0l = self.nz0
        nz1l = self.nz1
        num_pods = self.num_pods
        allowed = self.allowed
        rn = self.rn
        check_fit = self.check_fit
        w_fit = self.w_fit
        w_bal = self.w_bal
        w_img = self.w_img
        heappop = heapq.heappop
        heapreplace = heapq.heapreplace
        heappush = heapq.heappush
        for sig in pod_sigs:
            sid = id(sig)
            heap = heaps.get(sid)
            if heap is None:
                heap = heaps[sid] = self._build_heap(sig)
            known = known_map[sid]
            choice = -1
            s_nz0 = sig.nz0
            s_nz1 = sig.nz1
            s_req = sig.req_row
            s_az = sig.all_zero
            while heap:
                negsc, n = heap[0]
                # ---- feasible_int, inlined ----
                if check_fit:
                    if num_pods[n] + 1 > allowed[n]:
                        heappop(heap)  # monotone: never feasible again
                        continue
                    if not s_az:
                        used = used_rows[n]
                        alloc = alloc_rows[n]
                        bad = False
                        for r, v in enumerate(s_req):
                            if r >= N_FIXED_LANES and v == 0:
                                continue
                            avail = (alloc[r] - used[r]) if r < rn else 0
                            if v > avail:
                                bad = True
                                break
                        if bad:
                            heappop(heap)
                            continue
                # ---- revalidate: _known IS the current score (the
                # push-update walk below maintains it for every feasible
                # node under every seen signature after every commit) ----
                total = known[n]
                if -total == negsc:
                    choice = n
                    break
                heapreplace(heap, (-total, n))  # stale → re-rank
            sig.remaining -= 1
            choices.append(choice)
            if choice < 0:
                continue
            # ---- commit: one node touched; hoist its state once ----
            n = choice
            used = used_rows[n]
            for r, v in enumerate(s_req):
                if r < rn:
                    used[r] += v
            nz0l[n] += s_nz0
            nz1l[n] += s_nz1
            num_pods[n] += 1
            committed_any = True
            # Invariant: heap keys never stale-LOW.  Score decreases are
            # healed by pop-time revalidation; only INCREASES need a fresh
            # push (and only into still-active heaps).
            a0 = alloc0[n]
            a1 = alloc1[n]
            h0 = a0 > 0
            h1 = a1 > 0
            nzn0 = nz0l[n]
            nzn1 = nz1l[n]
            u0 = used[LANE_CPU]
            u1 = used[LANE_MEM]
            den = a0 * a1
            fit_w = (1 if h0 else 0) + (1 if h1 else 0)
            # usage is monotone within a lineage, so a node that no
            # longer fits a signature never fits it again — its heap
            # entries drain via pop-and-drop and no fresh push (or known
            # update) is ever needed.  One pod-count compare skips the
            # whole walk on full nodes (the drain-tail regime).
            node_open = not check_fit or num_pods[n] < allowed[n]
            alloc = alloc_rows[n]
            for other in act_list:
                oid = id(other)
                oheap = heaps.get(oid)
                # NOTE: no remaining-count skip — _known must stay current
                # for every RETAINED heap through the whole run or the
                # read-based revalidation would rank with stale scores
                # (heaps of signatures absent from this run are evicted
                # below, so every retained heap is walked here).
                # Signatures with no heap yet rebuild _known from scratch
                # on first use (_build_heap), so skipping them is safe.
                if oheap is None or not other.static_ok[n]:
                    continue
                if check_fit:
                    if not node_open:
                        continue
                    if not other.all_zero:
                        bad = False
                        for r, v in enumerate(other.req_row):
                            if r >= N_FIXED_LANES and v == 0:
                                continue
                            avail = (alloc[r] - used[r]) if r < rn else 0
                            if v > avail:
                                bad = True
                                break
                        if bad:
                            continue
                total = 0
                if w_fit:
                    s = 0
                    if h0:
                        nzc = nzn0 + other.nz0
                        s += 0 if nzc > a0 else (a0 - nzc) * MAX // a0
                    if h1:
                        nzc = nzn1 + other.nz1
                        s += 0 if nzc > a1 else (a1 - nzc) * MAX // a1
                    total += w_fit * (s // fit_w if fit_w else 0)
                if w_bal:
                    if h0 and h1:
                        oreq = other.req_row
                        r0 = u0 + oreq[LANE_CPU]
                        r1 = u1 + oreq[LANE_MEM]
                        if r0 > a0:
                            r0 = a0
                        if r1 > a1:
                            r1 = a1
                        d = r0 * a1 - r1 * a0
                        if d < 0:
                            d = -d
                        total += w_bal * (MAX - (50 * d + den - 1) // den)
                    else:
                        total += w_bal * MAX
                if w_img and other.img is not None:
                    total += w_img * other.img[n]
                oknown = known_map[oid]
                if total > oknown[n]:
                    heappush(oheap, (-total, n))
                oknown[n] = total
        # Evict heaps of signatures NOT in this run: they were not walked,
        # so their _known went stale the moment anything committed — a
        # later run must rebuild them from current state (_build_heap).
        # This also bounds heap/known memory by the live signature mix
        # instead of every signature the committer ever saw.  Retained
        # heaps (this run's) were walked on every commit, so the
        # read-based revalidation contract holds at the next run's start.
        if committed_any:
            for sid in [s for s in heaps if s not in active]:
                del heaps[sid]
                known_map.pop(sid, None)
        return choices

    # ----- failure diagnosis (per signature, lazy) --------------------------

    def diagnose(self, sig: Signature, masks: Dict[str, np.ndarray], node_valid: np.ndarray) -> Dict[str, int]:
        """Per-kernel rejected-node counts at CURRENT sim state, first-
        failure attribution in chain order (the reference's diagnosis order
        semantics for the static plugins + NodeResourcesFit).  ``masks``
        holds this signature's [N] per-kernel mask rows."""
        remaining = node_valid.copy()
        out: Dict[str, int] = {}
        for name, key in (
            ("NodeUnschedulable", "m_unsched"),
            ("NodeName", "m_nodename"),
            ("TaintToleration", "m_taints"),
            ("NodeAffinity", "m_nodeaff"),
        ):
            m = masks[key]
            rej = int(np.sum(remaining & ~m))
            if rej:
                out[name] = rej
            remaining &= m
        if self.check_fit:
            fit = np.fromiter(
                (self.feasible_int(n, sig) for n in range(self.n)),
                dtype=bool,
                count=self.n,
            )
            rej = int(np.sum(remaining & ~fit))
            if rej:
                out["NodeResourcesFit"] = rej
        return out
