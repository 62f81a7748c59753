"""Host scheduling pipeline for one pod: filter → score → select.

A copy of the JAX package's oracle/pipeline.py (findNodesThatFitPod /
prioritizeNodes / selectHost, schedule_one.go:408-917) with the default
plugin set and weights.  The port schedules a single pod on the host only
on the nominated-node path and its one-pod fall-through, which run with
neither adaptive sampling nor a seeded tie-break, so the sampling walk of
the reference copy is left out: every node is visited in snapshot order and
ties go to the first maximum.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.oracle import filters as F
from kubernetes_tpu_torch.oracle import scores as S
from kubernetes_tpu_torch.oracle.state import OracleState

DEFAULT_SCORE_WEIGHTS = {
    "TaintToleration": 3,
    "NodeAffinity": 2,
    "PodTopologySpread": 2,
    "InterPodAffinity": 2,
    "NodeResourcesFit": 1,
    "NodeResourcesBalancedAllocation": 1,
    "ImageLocality": 1,
}

ALL_FILTERS = frozenset(
    {
        "NodeName",
        "NodeUnschedulable",
        "TaintToleration",
        "NodeAffinity",
        "NodePorts",
        "NodeResourcesFit",
        "InterPodAffinity",
        "PodTopologySpread",
    }
)


@dataclass
class FitResult:
    feasible: List[str]
    # node name → list of reasons (Diagnosis.NodeToStatusMap analogue)
    reasons: Dict[str, List[str]] = field(default_factory=dict)


def feasible_nodes(
    pod: Pod,
    state: OracleState,
    enabled: frozenset = ALL_FILTERS,
    allowed: Optional[frozenset] = None,
) -> FitResult:
    """Filter plugins in the reference's iteration shape (every node, all
    reasons collected).  ``enabled`` limits evaluation to a profile's
    enabled plugin set; ``allowed`` narrows the node list by name first."""
    spread_counts = F.spread_pair_counts(pod, state) if "PodTopologySpread" in enabled else None
    checks = [
        ("NodeName", lambda ns: F.filter_node_name(pod, ns)),
        ("NodeUnschedulable", lambda ns: F.filter_node_unschedulable(pod, ns)),
        ("TaintToleration", lambda ns: F.filter_taints(pod, ns)),
        ("NodeAffinity", lambda ns: F.filter_node_affinity(pod, ns)),
        ("NodePorts", lambda ns: F.filter_node_ports(pod, ns)),
        ("InterPodAffinity", lambda ns: F.filter_interpod_affinity(pod, ns, state)),
        ("PodTopologySpread", lambda ns: F.filter_topology_spread(pod, ns, state, spread_counts)),
    ]
    checks = [c for c in checks if c[0] in enabled]
    check_resources = "NodeResourcesFit" in enabled
    feasible: List[str] = []
    reasons: Dict[str, List[str]] = {}
    names = list(state.nodes)
    if allowed is not None:
        names = [n for n in names if n in allowed]
    for name in names:
        ns = state.nodes[name]
        rs: List[str] = []
        for _, fn in checks:
            r = fn(ns)
            if r:
                rs.append(r)
        if check_resources:
            rs.extend(F.filter_node_resources(pod, ns))
        if rs:
            reasons[name] = rs
        else:
            feasible.append(name)
    return FitResult(feasible=feasible, reasons=reasons)


def prioritize(
    pod: Pod,
    state: OracleState,
    feasible: Sequence[str],
    weights: Optional[Dict[str, int]] = None,
) -> Dict[str, int]:
    """Weighted sum of normalized plugin scores per feasible node
    (prioritizeNodes, schedule_one.go:752), NodeResourcesFit scoring with
    LeastAllocated (the port's only fit strategy)."""
    w = dict(DEFAULT_SCORE_WEIGHTS if weights is None else weights)
    nodes = [state.nodes[n] for n in feasible]
    totals = {n: 0 for n in feasible}

    def accumulate(name: str, scores: List[int]):
        weight = w.get(name, 0)
        for node_name, s in zip(feasible, scores):
            totals[node_name] += s * weight

    if w.get("TaintToleration"):
        raw = [S.score_taint_toleration(pod, ns) for ns in nodes]
        accumulate("TaintToleration", S.normalize_taint_toleration(raw))
    if w.get("NodeAffinity"):
        raw = [S.score_node_affinity(pod, ns) for ns in nodes]
        accumulate("NodeAffinity", S.normalize_node_affinity(raw))
    if w.get("PodTopologySpread"):
        raw = S.score_topology_spread_all(pod, state, list(feasible))
        accumulate("PodTopologySpread", S.normalize_topology_spread(raw))
    if w.get("InterPodAffinity"):
        raw = S.score_interpod_affinity_all(pod, state, list(feasible))
        accumulate("InterPodAffinity", S.normalize_interpod_affinity(raw))
    if w.get("NodeResourcesFit"):
        accumulate("NodeResourcesFit", [S.score_least_allocated(pod, ns) for ns in nodes])
    if w.get("NodeResourcesBalancedAllocation"):
        accumulate("NodeResourcesBalancedAllocation", [S.score_balanced_allocation(pod, ns) for ns in nodes])
    if w.get("ImageLocality"):
        accumulate("ImageLocality", [S.score_image_locality(pod, ns, state) for ns in nodes])
    return totals


def select_host(totals: Dict[str, int]) -> Optional[str]:
    """Max score; ties go to the first node in snapshot order."""
    if not totals:
        return None
    best = max(totals.values())
    return next(n for n, s in totals.items() if s == best)
