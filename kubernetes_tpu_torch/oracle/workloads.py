"""Serial gang oracle: the one-pod-at-a-time replay that the workloads
dispatch (ops/coscheduling.py) must match.

A copy of the gang and volume halves of the JAX package's
oracle/workloads.py: one pod at a time in the canonical planner order
(workloads/gang.py ``plan_batch``), each pod's verdict is the host
pipeline's (oracle/pipeline.py) narrowed to the nodes its bound PVs admit
(``_vol_ok``: each PV's node affinity and, for a zone-labelled PV, every
topology label), and each gang's member run executes under an undo log.  If
the members placed cannot cover the gang's remaining minMember need, every
placement of the gang is rolled back before the next pod runs: the kernel's
checkpoint and restore.  Not ported: the DRA claim allocation (ROADMAP A8),
whose pods the port's Scheduler still refuses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from kubernetes_tpu_torch.api import storage as st
from kubernetes_tpu_torch.api.storage import PersistentVolume, PersistentVolumeClaim
from kubernetes_tpu_torch.framework.volume_plugins import zone_value_set
from kubernetes_tpu_torch.framework.volumebinding import pv_node_affinity_matches
from kubernetes_tpu_torch.oracle.pipeline import feasible_nodes, prioritize, select_host
from kubernetes_tpu_torch.oracle.state import OracleState
from kubernetes_tpu_torch.workloads.gang import PodGroup, group_key_of, plan_batch


@dataclass
class WorkloadResult:
    placements: Dict[str, Optional[str]] = field(default_factory=dict)
    rolled_back: Set[str] = field(default_factory=set)  # pod names
    gang_admitted: Dict[str, bool] = field(default_factory=dict)


@dataclass
class WorkloadOracle:
    """Mutable serial replay state over an OracleState."""

    state: OracleState
    groups: Dict[str, PodGroup] = field(default_factory=dict)
    bound: Dict[str, int] = field(default_factory=dict)
    pvs: Dict[str, PersistentVolume] = field(default_factory=dict)  # by name
    pvcs: Dict[str, PersistentVolumeClaim] = field(default_factory=dict)  # by namespace/name

    def _vol_ok(self, pod, node_name: str) -> bool:
        """Every claim is bound, its PV exists, the PV's node affinity admits
        the node and, for a zone- or region-labelled PV, the node carries
        every such label with a value in the PV's set (volume_zone.go:109)."""
        for name in pod.pvc_names():
            pvc = self.pvcs.get(f"{pod.namespace}/{name}")
            if pvc is None or not pvc.is_fully_bound():
                return False  # an unbound claim never reaches the kernel route
            pv = self.pvs.get(pvc.volume_name)
            ns = self.state.nodes.get(node_name)
            if pv is None or ns is None or not pv_node_affinity_matches(pv, ns.node):
                return False
            for key in st.VOLUME_TOPOLOGY_LABELS:
                if key in pv.labels and ns.node.labels.get(key) not in zone_value_set(pv.labels[key]):
                    return False
        return True

    def _schedule_pod(self, pod) -> Optional[str]:
        fit = feasible_nodes(pod, self.state)
        narrowed = [n for n in fit.feasible if self._vol_ok(pod, n)]
        if not narrowed:
            return None
        return select_host(prioritize(pod, self.state, narrowed))

    def schedule(self, pods) -> WorkloadResult:
        """Replay the batch in canonical planner order with gang undo."""
        out = WorkloadResult()

        def group_of(pod):
            # pods naming an UNREGISTERED group schedule as ordinary pods,
            # as the scheduler's _workloads_group_of has it
            key = group_key_of(pod)
            return key if key is not None and key in self.groups else None

        order, gang_positions = plan_batch(pods, group_of=group_of)
        pos_to_key: Dict[int, str] = {}
        for key, positions in gang_positions.items():
            for pos in positions:
                pos_to_key[pos] = key

        undo: List = []
        landed = 0
        for pos, idx in enumerate(order):
            pod = pods[idx]
            key = pos_to_key.get(pos)
            if key is not None and pos == gang_positions[key][0]:
                undo = []
                landed = 0
            node = self._schedule_pod(pod)
            out.placements[pod.name] = node
            if node is not None:
                pod.node_name = node
                self.state.place(pod)
                undo.append(pod)
                landed += 1 if key is not None else 0
            if key is not None and pos == gang_positions[key][-1]:
                pg = self.groups.get(key)
                need = max(0, (pg.min_member if pg else 0) - self.bound.get(key, 0))
                if landed < need:
                    for placed in reversed(undo):
                        self.state.unplace(placed)
                        placed.node_name = ""
                        out.placements[placed.name] = None
                        out.rolled_back.add(placed.name)
                    out.gang_admitted[key] = False
                else:
                    out.gang_admitted[key] = True
                    self.bound[key] = self.bound.get(key, 0) + landed
                undo = []
        return out
