"""Serial gang / DRA / volume oracle: the one-pod-at-a-time replay that the
workloads dispatch (ops/coscheduling.py) must match.

A copy of the JAX package's oracle/workloads.py: one pod at a time in the
canonical planner order (workloads/gang.py ``plan_batch``), each pod's
verdict is the host pipeline's (oracle/pipeline.py) narrowed by

  * DRA claim allocation: the structured allocator's greedy walk in slice /
    device enumeration order (framework/dynamicresources.py
    ``allocate_on_node``, which the DynamicResources Filter runs too:
    DeviceClass and request selectors must all admit, ExactCount takes the
    first ``count`` free matches, All needs every match free, one pod's
    earlier requests shadow its later ones);
  * volume topology (``_vol_ok``: each bound PV's node affinity and, for a
    zone-labelled PV, every topology label).

Placements commit into the oracle state and the allocation ledger (claims
pin to their node, granted devices join the taken set), so in-batch
contention resolves in queue order, and each gang's member run executes
under an undo log: if the members placed cannot cover the gang's remaining
minMember need, every placement, claim grant and taken device of the gang
is rolled back before the next pod runs, the kernel's checkpoint and
restore.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from kubernetes_tpu_torch.api import dra
from kubernetes_tpu_torch.api import storage as st
from kubernetes_tpu_torch.api.storage import PersistentVolume, PersistentVolumeClaim
from kubernetes_tpu_torch.framework.dynamicresources import allocate_on_node
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
    # claim key → the node the replay allocated it to
    claim_nodes: Dict[str, str] = field(default_factory=dict)


@dataclass
class WorkloadOracle:
    """Mutable serial replay state over an OracleState and the allocation
    ledger."""

    state: OracleState
    groups: Dict[str, PodGroup] = field(default_factory=dict)
    bound: Dict[str, int] = field(default_factory=dict)
    pvs: Dict[str, PersistentVolume] = field(default_factory=dict)  # by name
    pvcs: Dict[str, PersistentVolumeClaim] = field(default_factory=dict)  # by namespace/name
    slices: List[dra.ResourceSlice] = field(default_factory=list)  # in lister order
    device_classes: Dict[str, dra.DeviceClass] = field(default_factory=dict)  # by name
    claims: Dict[str, dra.ResourceClaim] = field(default_factory=dict)  # by namespace/name

    def __post_init__(self):
        # working copies: the replay allocates claims
        self.claims = {k: copy.deepcopy(c) for k, c in self.claims.items()}
        self.taken: Set[Tuple[str, str, str]] = set()
        for c in self.claims.values():
            if c.allocation is not None:
                for r in c.allocation.results:
                    self.taken.add((r.driver, r.pool, r.device))
        self._slices_by_node: Dict[str, List[dra.ResourceSlice]] = {}
        for sl in self.slices:
            self._slices_by_node.setdefault(sl.node_name, []).append(sl)

    def _dra_ok(self, pod, node_name: str) -> bool:
        """Feasibility against a throwaway copy of the taken set."""
        sim_taken = set(self.taken)
        for name in pod.resource_claims:
            claim = self.claims.get(f"{pod.namespace}/{name}")
            if claim is None:
                return False
            if claim.allocation is not None:
                if claim.allocation.node_name and claim.allocation.node_name != node_name:
                    return False
                continue
            if allocate_on_node(claim, node_name, self._slices_by_node.get(node_name, []), self.device_classes,
                                sim_taken) is None:
                return False
        return True

    def _dra_commit(self, pod, node_name: str, undo: List) -> None:
        for name in pod.resource_claims:
            claim = self.claims.get(f"{pod.namespace}/{name}")
            if claim is None or claim.allocation is not None:
                continue
            alloc = allocate_on_node(claim, node_name, self._slices_by_node.get(node_name, []),
                                     self.device_classes, self.taken)
            assert alloc is not None, f"oracle DRA commit lost {claim.key}"  # _dra_ok proved it fits
            claim.allocation = alloc
            undo.append(("claim", claim, [(r.driver, r.pool, r.device) for r in alloc.results]))

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
        narrowed = [n for n in fit.feasible
                    if (not pod.resource_claims or self._dra_ok(pod, n)) and self._vol_ok(pod, n)]
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

        def rollback() -> None:
            for kind, obj, keys in reversed(undo):
                if kind == "place":
                    self.state.unplace(obj)
                    obj.node_name = ""
                    out.placements[obj.name] = None
                    out.rolled_back.add(obj.name)
                else:  # a claim the gang allocated
                    obj.allocation = None
                    for k in keys:
                        self.taken.discard(k)

        for pos, idx in enumerate(order):
            pod = pods[idx]
            key = pos_to_key.get(pos)
            if key is not None and pos == gang_positions[key][0]:
                undo = []
                landed = 0
            node = self._schedule_pod(pod)
            out.placements[pod.name] = node
            if node is not None:
                self._dra_commit(pod, node, undo)
                pod.node_name = node
                self.state.place(pod)
                undo.append(("place", pod, None))
                landed += 1 if key is not None else 0
            if key is not None and pos == gang_positions[key][-1]:
                pg = self.groups.get(key)
                need = max(0, (pg.min_member if pg else 0) - self.bound.get(key, 0))
                if landed < need:
                    rollback()
                    out.gang_admitted[key] = False
                else:
                    out.gang_admitted[key] = True
                    self.bound[key] = self.bound.get(key, 0) + landed
                undo = []
        for k, c in self.claims.items():
            if c.allocation is not None and c.allocation.node_name:
                out.claim_nodes[k] = c.allocation.node_name
        return out
