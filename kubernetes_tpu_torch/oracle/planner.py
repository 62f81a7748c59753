"""The serial forked-snapshot oracle: the replay every planner fork must
match exactly.

Port of the JAX package's oracle/planner.py.  Each fork is applied to the
host objects the way the real cluster mutation would land: removed nodes
(and their pods) vanish, cordons set ``unschedulable``, capacities scale in
lane space (planner/forks.py ``scale_node_lanes``, the arithmetic of the
kernel planes), clones materialize through ``clone_node``, and evicted pods
are not placed.  The fork's live batch pods then replay through a
``WorkloadOracle`` in the shared canonical order (workloads/gang.py
``plan_batch``), gang undo logs included: the engine the workloads dispatch
is already held against, so planner parity reduces to fork application.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

from kubernetes_tpu_torch.api.resource import Resource
from kubernetes_tpu_torch.oracle.pipeline import feasible_nodes
from kubernetes_tpu_torch.oracle.state import OracleState
from kubernetes_tpu_torch.oracle.workloads import WorkloadOracle
from kubernetes_tpu_torch.planner.forks import Fork, clone_node, scale_node_lanes
from kubernetes_tpu_torch.snapshot.schema import MEM_UNIT

# the density readout's fixed-point scale: ops/counterfactual.DENSITY_SCALE
DENSITY_SCALE = 1_000_000


def fork_cluster_host(nodes, placed, fork: Fork):
    """Apply one fork to host objects: (nodes', placed'), with new Node
    objects where mutated and the original pods filtered (never mutated)."""
    by_name = {n.name: n for n in nodes}
    removed = set(fork.remove)
    cordoned = set(fork.cordon)
    scaled = {name: (num, den) for name, num, den in fork.scale}
    out_nodes = []
    for n in nodes:
        if n.name in removed:
            continue
        if n.name in scaled:
            n = scale_node_lanes(n, *scaled[n.name])
        if n.name in cordoned:
            n = copy.copy(n)
            n.labels = dict(n.labels)
            n.unschedulable = True
        out_nodes.append(n)
    for template, clone_name in fork.add:
        tmpl = by_name.get(template)
        if tmpl is None:
            raise ValueError(f"fork {fork.label!r}: unknown template {template!r}")
        if not any(n.name == clone_name for n in out_nodes):
            out_nodes.append(clone_node(tmpl, clone_name))
    evicted = set(fork.evict)
    out_placed = [p for p in placed if p.uid not in evicted and p.node_name not in removed]
    return out_nodes, out_placed


def host_density_ppm(state: OracleState) -> int:
    """fork_density in host space: the mean cpu and memory utilization
    over nodes with capacity, in the pack-lane units (milli-cpu; MiB-ceiling
    requested against MiB-floor allocatable)."""
    total = 0
    n = 0
    for ns in state.nodes.values():
        a_cpu = ns.node.allocatable.milli_cpu
        a_mem = ns.node.allocatable.memory // MEM_UNIT
        if a_cpu <= 0 or a_mem <= 0:
            continue
        req = Resource()
        for p in ns.pods:
            req.add(p.compute_requests())
        u_cpu = req.milli_cpu
        u_mem = -(-req.memory // MEM_UNIT)
        total += (u_cpu * DENSITY_SCALE // max(a_cpu, 1) + u_mem * DENSITY_SCALE // max(a_mem, 1)) // 2
        n += 1
    return total // max(n, 1)


def _oracle(state, pvs, pvcs, groups, bound=None) -> WorkloadOracle:
    return WorkloadOracle(state=state, pvs=dict(_items(pvs)), pvcs=dict(_items(pvcs)), groups=dict(groups),
                          bound=dict(bound or {}))


def serial_plan(
    nodes,
    placed,
    pods: Sequence,
    forks: Sequence[Fork],
    groups: Optional[Dict] = None,
    needs: Optional[Dict[str, int]] = None,
    pvs=None,
    pvcs=None,
    namespace_labels=None,
    target_node: Optional[str] = None,
) -> List[dict]:
    """Replay every fork through a fresh WorkloadOracle.  One dict per fork:
    placements (live pods only), admitted and unschedulable counts,
    density_ppm, gang_admitted and, with ``target_node``, each live pod's
    feasibility at the target."""
    groups = groups or {}
    out: List[dict] = []
    for fork in forks:
        f_nodes, f_placed = fork_cluster_host(nodes, placed, fork)
        state = OracleState.build(f_nodes, f_placed, namespace_labels=namespace_labels)
        # the kernel's gang_need carries the remaining need, so the oracle's
        # window starts from the same quorum arithmetic
        bound = {}
        for key, pg in groups.items():
            if needs is not None and pg is not None:
                bound[key] = max(0, pg.min_member - needs.get(key, pg.min_member))
        oracle = _oracle(state, pvs, pvcs, groups, bound)
        live = set(fork.live) if fork.live is not None else {p.uid for p in pods}
        # non-live pods are inert in the kernel's pass (they commit and
        # affect nothing), so replaying the live ones in order is the same
        batch = [copy.deepcopy(p) for p in pods if p.uid in live]
        live_names = {p.name for p in batch}
        res = oracle.schedule(batch)
        placements = {name: node for name, node in res.placements.items() if name in live_names}
        admitted = sum(1 for v in placements.values() if v)
        fork_out = {
            "label": fork.label,
            "placements": placements,
            "admitted": admitted,
            "unschedulable": len(placements) - admitted,
            "density_ppm": host_density_ppm(state),
            "gang_admitted": {k: (1 if v else 0) for k, v in res.gang_admitted.items()},
        }
        if target_node is not None:
            # feasibility at the target is judged against the forked initial
            # state (the one-pod what-if contract)
            f2_nodes, f2_placed = fork_cluster_host(nodes, placed, fork)
            st2 = OracleState.build(f2_nodes, f2_placed, namespace_labels=namespace_labels)
            probe = _oracle(st2, pvs, pvcs, groups)
            t_ok = {}
            for p in pods:
                if p.uid not in live:
                    continue
                fit = feasible_nodes(p, st2)
                t_ok[p.name] = bool(target_node in fit.feasible and probe._vol_ok(p, target_node))
            fork_out["target_ok"] = t_ok
        out.append(fork_out)
    return out


def _items(cache):
    """Items of a mapping or of an AssumeCache-style object (none for None)."""
    if cache is None:
        return ()
    if hasattr(cache, "items"):
        return cache.items()
    if hasattr(cache, "list"):
        return ((getattr(o, "key", getattr(o, "name", None)), o) for o in cache.list())
    return ()
