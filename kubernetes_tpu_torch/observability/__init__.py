"""Observability: the flight recorder and explain mode.

  * ``FlightRecorder``: a bounded ring of per-pod events, queryable by uid;
    the Scheduler's ``flight`` (the wave's demotions and upgrades).
  * ``explain_pod`` / ``oracle_explain``: per-node, per-plugin rejection
    reasons from the explain masks (ops/explain.py, K17 on CUDA), checked
    against the serial host oracle.
  * ``explain_whatif``: the preemption what-if on one node, the evaluator's
    dry run beside the one-fork planner.

The reference serves these at /debug/flightrecorder and /debug/explain;
the port has no server yet (ROADMAP A12), so they are functions on the
Scheduler, run in the caller's thread.
"""

from kubernetes_tpu_torch.observability.explain import (
    DIAG_PLUGINS,
    explain_pod,
    explain_whatif,
    find_pod,
    oracle_explain,
    reason_to_plugin,
)
from kubernetes_tpu_torch.observability.flightrecorder import FlightRecorder

__all__ = [
    "FlightRecorder",
    "explain_pod",
    "explain_whatif",
    "find_pod",
    "oracle_explain",
    "reason_to_plugin",
    "DIAG_PLUGINS",
]
