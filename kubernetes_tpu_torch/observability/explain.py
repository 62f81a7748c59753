"""Explain mode: per-node, per-plugin rejection reasons for a pod.

A copy of the JAX package's observability/explain.py on the port's
Scheduler.  ``explain_pod`` renders the per-plugin masks of
``ops.explain.explain_buffer`` (the gang precompute, then K17 on CUDA) as
per-node plugin verdicts, merged with the host Filter plugins' verdicts (the
volume plugins and DynamicResources, which have no kernels) and the
PreFilter result's node narrowing.  ``explain_whatif`` answers which
victims would free one node for a pod: the preemption evaluator's dry run on
that node, then the one-fork planner (``planner.whatif_after_evictions``,
K15 / K16 and the workloads engine), with the dry run as its parity
reference.

Nothing here runs on the scheduling hot path.  ``explain_pod`` packs the pod
as scheduling it would (its labels interned into the shared vocabulary),
uploads a fresh ``DeviceCluster`` (the hot loop's device cluster, chained
state and fast lineage are never touched) and fetches the stack and the
combined mask in one device-to-host copy.  The port has no scheduler lock
and no server: both functions run in the caller's thread, between drains.

``oracle_explain`` gives the same node → rejecting-plugins map from the
serial host oracle (``oracle.pipeline.feasible_nodes``), the check on the
masks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.oracle import filters as OF
from kubernetes_tpu_torch.oracle.pipeline import feasible_nodes

# gang.DIAG_KERNELS row order: kernel index → plugin name
DIAG_PLUGINS = (
    "NodeUnschedulable",
    "NodeName",
    "TaintToleration",
    "NodeAffinity",
    "NodePorts",
    "HostFilters",
    "NodeResourcesFit",
    "PodTopologySpread",
    "InterPodAffinity",
)

# oracle reason string → plugin name (exact matches; prefixes below)
_REASON_PLUGIN_EXACT = {
    OF.REASON_NODE_NAME: "NodeName",
    OF.REASON_UNSCHEDULABLE: "NodeUnschedulable",
    OF.REASON_AFFINITY: "NodeAffinity",
    OF.REASON_PORTS: "NodePorts",
    OF.REASON_PODS_LIMIT: "NodeResourcesFit",
    OF.REASON_EXISTING_ANTI: "InterPodAffinity",
    OF.REASON_POD_AFFINITY: "InterPodAffinity",
    OF.REASON_POD_ANTI: "InterPodAffinity",
    OF.REASON_SPREAD: "PodTopologySpread",
    OF.REASON_SPREAD_LABEL: "PodTopologySpread",
}
_REASON_PLUGIN_PREFIX = (
    (OF.REASON_TAINT, "TaintToleration"),
    ("Insufficient ", "NodeResourcesFit"),
)


def reason_to_plugin(reason: str) -> str:
    """Map an oracle Filter reason string to its plugin (kernel) name."""
    hit = _REASON_PLUGIN_EXACT.get(reason)
    if hit is not None:
        return hit
    for prefix, plugin in _REASON_PLUGIN_PREFIX:
        if reason.startswith(prefix):
            return plugin
    return reason  # host-plugin reasons pass through verbatim


def oracle_explain(pod: Pod, state, enabled: frozenset) -> Dict[str, Set[str]]:
    """node name → rejecting-plugin set, from the serial host oracle."""
    fit = feasible_nodes(pod, state, enabled=enabled)
    return {node: {reason_to_plugin(r) for r in reasons} for node, reasons in fit.reasons.items()}


def find_pod(sched, ref: str) -> Optional[Pod]:
    """A pod by uid, key or bare name, in the scheduling queue's pools and
    then the cache."""
    for pods in sched.queue.pending_pods().values():
        for p in pods:
            if ref in (p.uid, p.name, p.key):
                return p
    p = sched.cache.pod_states.get(ref)
    if p is not None:
        return p
    for p in sched.cache.pod_states.values():
        if ref in (p.name, p.key):
            return p
    return None


def _profile(sched, pod: Pod):
    return sched.profiles.get(pod.scheduler_name, next(iter(sched.profiles.values())))


def explain_pod(sched, pod: Pod, max_nodes: int = 500) -> dict:
    """Per-node, per-plugin verdicts for ``pod`` against the scheduler's
    current snapshot: one explain dispatch and one device-to-host copy.
    ``max_nodes`` caps the per-node detail; the summary counts cover every
    node."""
    from kubernetes_tpu_torch.framework.interface import CycleState
    from kubernetes_tpu_torch.ops import explain as ops_explain
    from kubernetes_tpu_torch.ops import gang
    from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster
    from kubernetes_tpu_torch.snapshot.interner import PAD
    from kubernetes_tpu_torch.snapshot.schema import bucket_cap, pack_pod_batch

    assert DIAG_PLUGINS == gang.DIAG_KERNELS, "DIAG_PLUGINS diverged from gang.DIAG_KERNELS"
    profile = _profile(sched, pod)
    fwk = sched.frameworks[profile.scheduler_name]
    out: dict = {
        "pod": {"uid": pod.uid, "name": pod.name, "namespace": pod.namespace},
        "profile": profile.scheduler_name,
    }
    vocab = sched.vocab
    for k, v in pod.labels.items():
        vocab.intern_label(k, v)
    sched._repack_mirror()
    nt = sched.mirror.nodes
    if nt is None or not any(nt.valid):
        out["error"] = "no nodes in snapshot"
        return out

    state = CycleState()
    s = sched.run_pre_filter(profile, state, [pod]).get(pod.uid)
    if s is not None:
        out["pre_filter"] = {"plugin": s.plugin, "reasons": list(s.reasons)}
        out["nodes"] = {}
        out["summary"] = {s.plugin or "PreFilter": int(np.sum(nt.valid))}
        out["feasible"] = []
        out["n_feasible"] = 0
        return out
    allowed = state.read(("pre_filter_result", pod.uid))

    enabled = profile.enabled
    pb = pack_pod_batch([pod], vocab, k_cap=nt.k_cap, p_cap=bucket_cap(1, 1))
    tables = gang.batch_tables(pb.tsc_topo_key, pb.aff_topo_key, nt.label_vals, sched._hostname_key())
    tables.pop("d_cap")
    has_interpod = bool((pb.aff_kind != PAD).any() or (sched.mirror.existing.term_kind != PAD).any())
    has_spread = bool((pb.tsc_topo_key != PAD).any())
    has_ports = bool((pb.want_ppk != PAD).any() or (nt.used_ppk != PAD).any())
    # a fresh device view, apart from the hot loop's device cluster
    dc = DeviceCluster.from_host(nt, vocab, sched.device, ep=sched.mirror.existing)
    db = DeviceBatch.from_host(pb, sched.device)
    v_cap = bucket_cap(len(vocab.label_vals))

    # the host Filter plugins (no kernels) judged on the host, in place of
    # the stack's all-true HostFilters row
    host_active = [p for p in fwk.host_filter_plugins()
                   if not state.is_filter_skipped(pod.uid, p.name) and p.maybe_relevant(pod)]
    host_verdicts: Dict[str, List[str]] = {}
    if host_active:
        for name, ns in sched.oracle_view().nodes.items():
            hs = fwk.run_host_filters(state, pod, ns)
            if not hs.ok:
                host_verdicts[name] = [hs.plugin or "HostFilters"]
    names = list(nt.names)
    valid = np.asarray(nt.valid).copy()

    buf = ops_explain.explain_buffer(dc, db, sched._hostname_key(), v_cap, has_interpod=has_interpod,
                                     has_spread=has_spread, has_ports=has_ports, enabled=enabled,
                                     check_fit="NodeResourcesFit" in enabled, **tables)
    fetched = buf.cpu().numpy()  # the stack and the combined mask in one copy
    stack = fetched[: gang.N_DIAG, 0, :]  # [N_DIAG, N]
    feasible = fetched[gang.N_DIAG, 0]  # [N]

    allowed_set = frozenset(allowed) if allowed is not None else None
    nodes: Dict[str, List[str]] = {}
    summary: Dict[str, int] = {}
    feasible_names: List[str] = []
    n_rejected = 0
    hf_row = DIAG_PLUGINS.index("HostFilters")
    for ni, name in enumerate(names):
        if ni >= valid.shape[0] or not valid[ni]:
            continue
        rejecting: List[str] = []
        if allowed_set is not None and name not in allowed_set:
            rejecting.append("PreFilterResult")
        for k, plugin in enumerate(DIAG_PLUGINS):
            if k == hf_row:
                continue  # replaced by host_verdicts
            if not stack[k, ni]:
                rejecting.append(plugin)
        rejecting.extend(host_verdicts.get(name, ()))
        if rejecting:
            n_rejected += 1
            if len(nodes) < max_nodes:
                nodes[name] = rejecting
            for plugin in rejecting:
                summary[plugin] = summary.get(plugin, 0) + 1
        elif feasible[ni]:
            feasible_names.append(name)
    out["nodes"] = nodes
    out["truncated"] = n_rejected > len(nodes)
    out["summary"] = summary
    out["n_feasible"] = len(feasible_names)
    out["feasible"] = feasible_names[:max_nodes]

    # the wave's history: a pod whose speculative placement the admission
    # pass invalidated carries wave_demoted events
    demotions = [
        {
            "kind": e.get("detail", {}).get("kind"),
            "term": e.get("detail", {}).get("term"),
            "spec_node": e.get("detail", {}).get("spec_node"),
            "node": e.get("detail", {}).get("node"),
        }
        for e in sched.flight.events_for(pod.uid)
        if e.get("kind") == "wave_demoted"
    ]
    if demotions:
        last = demotions[-1]
        out["wave"] = {
            "demoted": True,
            "reason": "demoted by wave conflict",
            "conflict_kind": last["kind"],
            "conflict_term": last["term"],
            "events": demotions[-8:],
        }
    return out


def explain_whatif(sched, pod: Pod, node_name: str) -> dict:
    """Preemption what-if: which victims would free ``node_name`` for
    ``pod``.  The preemption evaluator's SelectVictimsOnNode, the code
    PostFilter runs, restricted to one node on a working copy (nothing is
    nominated, evicted or requeued), then the one-fork planner run after
    those evictions, whose verdict the answer reports beside the dry run's
    (``parity``).  The PreFilter-extension branch of the dry run is not
    ported (ROADMAP A6b); a planner error that is a ValueError (racy state)
    comes back as ``kernel.error``, any other raises."""
    from kubernetes_tpu_torch.framework.interface import CycleState
    from kubernetes_tpu_torch.planner.plan import whatif_after_evictions

    profile = _profile(sched, pod)
    fwk = sched.frameworks[profile.scheduler_name]
    out: dict = {
        "pod": {"uid": pod.uid, "name": pod.name, "namespace": pod.namespace},
        "node": node_name,
    }
    pf = sched.post_filter(profile)
    ev = getattr(pf, "evaluator", None)
    if ev is None:
        out["error"] = "profile has no preemption evaluator"
        return out
    state = sched.oracle_view()
    if node_name not in state.nodes:
        out["error"] = f"unknown node {node_name!r}"
        return out
    ok, msg = ev.pod_eligible(pod, state)
    out["eligible"] = ok
    if not ok:
        out["reason"] = msg
        return out
    cs = CycleState()
    s = sched.run_pre_filter(profile, cs, [pod]).get(pod.uid)
    if s is not None:
        out["eligible"] = False
        out["reason"] = "; ".join(s.reasons) or "PreFilter rejected"
        return out
    # the host-filter context preempt() arms, saved and restored so that a
    # live PostFilter's state never leaks
    prev = (ev._hf_fwk, ev._hf_state, ev._fast_fit)
    ev._hf_fwk = ev._hf_state = None
    ev._fast_fit = False  # one node: always the full fit check
    if fwk.has_host_filters() and fwk.active_host_filters(cs, [pod]):
        ev._hf_fwk, ev._hf_state = fwk, cs
    try:
        victims = ev.select_victims_on_node(pod, state, node_name, sched.pdb_lister())
    finally:
        ev._hf_fwk, ev._hf_state, ev._fast_fit = prev
    lower_uids = [p.uid for p in state.nodes[node_name].pods if p.priority < pod.priority]
    out["lower_priority_pods"] = len(lower_uids)
    if victims is None:
        out["feasible_after_preemption"] = False
        out["reason"] = ("no lower-priority pods on the node" if not lower_uids
                         else "pod still does not fit after removing every lower-priority pod")
        evict_uids = lower_uids
    else:
        out["feasible_after_preemption"] = True
        out["num_pdb_violations"] = victims.num_pdb_violations
        out["victims"] = [{"uid": v.uid, "name": v.name, "namespace": v.namespace, "priority": v.priority}
                          for v in victims.pods]
        evict_uids = [v.uid for v in victims.pods]

    # the one-fork planner on the same engine as the batched planners; the
    # host dry run above is its parity reference.  A debug answer: any
    # failure of the planner is reported as the answer's error, as the
    # reference does, and then the answer has no verdict and no parity
    try:
        k = whatif_after_evictions(sched, pod, node_name, evict_uids)
    except Exception as e:  # noqa: BLE001
        k = {"error": str(e)}
    out["kernel"] = k
    if "feasible" in k:
        host_verdict = out["feasible_after_preemption"]
        out["feasible_after_preemption"] = k["feasible"]
        out["host_feasible_after_preemption"] = host_verdict
        out["parity"] = k["feasible"] == host_verdict
    return out
