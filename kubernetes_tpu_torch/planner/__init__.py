"""The counterfactual planner tier (planner/plan.py, planner/forks.py)."""

from kubernetes_tpu_torch.planner.forks import Fork, PackedForks, clone_node, collect_clones, pack_forks, scale_node_lanes
from kubernetes_tpu_torch.planner.plan import (
    PLANNERS,
    SimResult,
    backlog_pods,
    plan_autoscale,
    plan_deschedule,
    plan_preempt_cost,
    run_planner,
    simulate_forks,
    whatif_after_evictions,
)

__all__ = [
    "Fork",
    "PackedForks",
    "PLANNERS",
    "SimResult",
    "backlog_pods",
    "clone_node",
    "collect_clones",
    "pack_forks",
    "plan_autoscale",
    "plan_deschedule",
    "plan_preempt_cost",
    "run_planner",
    "scale_node_lanes",
    "simulate_forks",
    "whatif_after_evictions",
]
