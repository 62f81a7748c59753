"""The counterfactual fleet planners: the questions Kubernetes users put to
cluster-autoscaler and the descheduler, as K forked snapshots of one
``counterfactual_run``.

Port of the JAX package's planner/plan.py.  ``simulate_forks`` is the
shared engine: pack K forked snapshots off the mirror (planner/forks.py),
run them through ops/counterfactual.py (K15, the workloads engine per fork,
K16) and read every fork's outcome back in one copy.  The planners on top
differ in the forks they make and how they read them:

  * ``plan_autoscale``    which node shape admits the unschedulable backlog
                          most cheaply (forks: candidate shapes × counts,
                          and one removal fork per empty node for
                          scale-down);
  * ``plan_deschedule``   which node drains raise bin-packing density
                          (forks: cordon a node, evict its pods, re-place
                          them);
  * ``plan_preempt_cost`` the preemption cascade per pending priority class
                          (fork pairs: the class's backlog with and without
                          every lower-priority placed pod evicted);
  * ``whatif_after_evictions``  the one-fork what-if: is a pod feasible on
                          a node once given pods are evicted.

Everything is read-only: the planners change no cache, queue or chained
device state (a fresh DeviceCluster off the extended node tensors).  They
intern clone names and labels into the shared vocabulary and repack the
mirror, which later scheduling reads as it would without them.  With
``plannerKernel: false``, with two nodes sharing a hostname, or when the
batch has no wave tables, the same fork specs replay through the serial
forked-snapshot oracle (oracle/planner.py).  The port's Scheduler has no
serving loop to lock against, so the planners run unlocked; it has no
extenders, host Score plugins or sampling, so those eligibility checks of
the reference find nothing here; a failed launch raises.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.ops import counterfactual as cf_ops
from kubernetes_tpu_torch.ops import gang as ops_gang
from kubernetes_tpu_torch.ops import wave as ops_wave
from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster
from kubernetes_tpu_torch.oracle import planner as oracle_planner
from kubernetes_tpu_torch.planner.forks import Fork, collect_clones, pack_forks
from kubernetes_tpu_torch.snapshot.interner import PAD
from kubernetes_tpu_torch.snapshot.schema import bucket_cap, pack_pod_batch
from kubernetes_tpu_torch.workloads import gang as wlg

# The target-node bonus: larger than any weighted sum of normalized scores,
# small enough that score + bonus stays inside int64.
_TARGET_BONUS = 1 << 40
# wave_tables' rows, in workloads_run's positional order
_WAVE_ROWS = ("tid_sp", "rep_sp_p", "rep_sp_c", "tid_ip", "rep_ip_p", "rep_ip_u", "ip_cdv_tab")


@dataclass
class SimResult:
    """One simulate_forks run: per-fork outcomes and what was left out."""

    engine: str  # "kernel" | "serial" | "none"
    k: int
    dispatches: int  # counterfactual_run calls (kernel: 1)
    batch: List[str] = field(default_factory=list)  # pod names, canonical order
    skipped: Dict[str, str] = field(default_factory=dict)  # pod → reason
    forks: List[dict] = field(default_factory=list)
    wall_s: float = 0.0

    def to_json(self) -> dict:
        return {
            "engine": self.engine,
            "k": self.k,
            "dispatches": self.dispatches,
            "batch": self.batch,
            "skipped": self.skipped,
            "forks": self.forks,
            "wall_s": round(self.wall_s, 4),
        }


def _profile(sched):
    return next(iter(sched.profiles.values()))


def _pod_ineligible(sched, pod) -> Optional[str]:
    """Why a pod cannot ride the planner (None: it can): the workloads
    dispatch's spec-level disqualifiers, and DRA claims (the fork planes do
    not carry the allocation state)."""
    if pod.nominated_node_name:
        return "nominated"
    if pod.host_ports():
        return "host_ports"
    if pod.resource_claims:
        return "resource_claims"
    if pod.pvc_names() and not sched._vol_kernel_ok(pod):
        return "volume_shape"
    return None


def backlog_pods(sched, max_pods: int = 256) -> Tuple[list, Dict[str, str]]:
    """The pending backlog the planners simulate: unschedulable pods first
    (they are the autoscaler's trigger), then backoff, then active, capped
    at ``max_pods``.  Returns (eligible pods, skipped pod → reason)."""
    pools = sched.queue.pending_pods()
    seen = set()
    ordered = []
    for pool in ("unschedulable", "backoff", "active"):
        for p in pools.get(pool, ()):
            if p.uid not in seen:
                seen.add(p.uid)
                ordered.append(p)
    eligible, skipped = [], {}
    for p in ordered:
        why = _pod_ineligible(sched, p)
        if why is None:
            if len(eligible) < max_pods:
                eligible.append(p)
        else:
            skipped[p.name] = why
    return eligible, skipped


def simulate_forks(
    sched,
    forks: Sequence[Fork],
    pods: Sequence,
    target_node: Optional[str] = None,
    planner: str = "custom",
    use_kernel: Optional[bool] = None,
) -> SimResult:
    """K forked snapshots × one pod batch → per-fork outcomes.

    The kernel engine packs the fork planes off the mirror and makes one
    ``counterfactual_run`` and one readback; the serial engine replays the
    same fork specs through oracle/planner.py.  ``target_node`` (one-pod
    batches only) steers the pod toward that node with a dominating score
    bonus, so ``chosen == target`` exactly when the pod is feasible there.
    ``planner`` names the caller, as in the reference's signature.
    """
    t0 = time.perf_counter()
    profile = _profile(sched)
    kernel_ok = sched.config.planner_kernel if use_kernel is None else use_kernel
    forks = list(forks)
    pods = list(pods)
    if target_node is not None and len(pods) != 1:
        # the kernel engine judges steered pods in sequence (earlier ones
        # commit usage at the target), the serial one against the initial
        # state: only the one-pod what-if is the same on both
        raise ValueError(f"target_node requires a single-pod batch (the K=1 what-if contract); got {len(pods)} pods")
    skipped: Dict[str, str] = {}
    live_pods = []
    for p in pods:
        why = _pod_ineligible(sched, p)
        if why is None:
            live_pods.append(p)
        else:
            skipped[p.name] = why
    pods = live_pods

    vocab = sched.vocab
    for p in pods:
        for k, v in p.labels.items():
            vocab.intern_label(k, v)
    sched._sync_mirror_external()
    clones = collect_clones(forks, {cn.node.name: cn.node for cn in sched.cache.real_nodes()})
    sched._intern_node_labels(clones.values())
    sched._repack_mirror()
    if sched.mirror.nodes is None or not any(sched.mirror.nodes.valid):
        return SimResult(engine="none", k=0, dispatches=0, skipped={"__cluster__": "no nodes in snapshot"})
    if kernel_ok and not sched.mirror.hostnames_unique:
        kernel_ok = False
        sched.metrics["plan_serial_dup_hostname"] += 1

    # the canonical order: each gang's members contiguous (the oracle
    # replays it)
    order, gang_positions = wlg.plan_batch(pods, group_of=sched._workloads_group_of)
    ordered = [pods[i] for i in order]
    needs = {}
    for key in gang_positions:
        pg = sched.gangs.get(key)
        needs[key] = max(0, (pg.min_member if pg else 0) - sched.gangs.bound_count(key))

    wt = None
    if kernel_ok:
        p_cap = bucket_cap(max(len(ordered), 1), 1)
        pf = pack_forks(sched.mirror, sched.cache, forks, [p.uid for p in ordered], p_cap, clones=clones)
        pb = pack_pod_batch(ordered, vocab, k_cap=pf.nt.k_cap, p_cap=p_cap)
        hk = sched._hostname_key()
        wt = ops_wave.wave_tables(pb, pf.nt.label_vals, hk, hostnames_unique=True, device=sched.device)
        if wt is None:
            sched.metrics["plan_serial_wave_tables"] += 1
    if wt is None:
        sim = _simulate_serial(sched, forks, ordered, needs, target_node, gang_positions)
        sim.skipped.update(skipped)
        sim.wall_s = time.perf_counter() - t0
        _observe(sched, sim)
        return sim

    dev = sched.device
    # the tables off the extended, un-neutralized label rows, shared by
    # every fork
    tables = ops_gang.batch_tables(pb.tsc_topo_key, pb.aff_topo_key, pf.nt.label_vals, hk)
    d_cap = tables.pop("d_cap")
    tables = {k: torch.as_tensor(v, device=dev) for k, v in tables.items()}
    gid, gfirst, glast, gneed, g_cap, slot_keys = wlg.gang_arrays(p_cap, gang_positions, needs)
    rows = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        gang_id=gid, gang_first=gfirst, gang_last=glast, gang_need=gneed).items()}
    volt = sched._vol_tables(ordered, p_cap) or {}
    flags = dict(
        has_interpod=bool((pb.aff_kind != PAD).any() or (sched.mirror.existing.term_kind != PAD).any()),
        has_spread=bool((pb.tsc_topo_key != PAD).any()),
        has_images=bool((pb.img_ids >= 0).any()),
    )
    # a fresh device view off the extended node tensors, apart from the
    # scheduling path's resident cluster
    dc = DeviceCluster.from_host(pf.nt, vocab, dev, ep=sched.mirror.existing)
    db = DeviceBatch.from_host(pb, dev)
    v_cap = bucket_cap(len(vocab.label_vals))
    extra_score = None
    target_slot = None
    if target_node is not None:
        target_slot = pf.nt.name_to_idx.get(target_node)
        if target_slot is None:
            target_slot = pf.clone_slots.get(target_node)
        if target_slot is not None:
            es = np.zeros((p_cap, pf.nt.n_cap), np.int64)
            es[:, target_slot] = _TARGET_BONUS
            extra_score = torch.from_numpy(es).to(dev)
    planes = cf_ops.ForkPlanes.from_host(pf.planes, dev)
    out = cf_ops.counterfactual_run(
        dc, db, hk, v_cap, g_cap, *(wt[k] for k in _WAVE_ROWS), **rows, **planes.kwargs(), **volt,
        enabled=profile.enabled, weights=profile.weights(), fit_strategy=profile.fit_strategy(),
        extra_score=extra_score, d_cap=d_cap,
        d2_cap=wt["d2_cap"], **flags, **tables)
    fetched = cf_ops.readback(out)

    sim = SimResult(engine="kernel", k=len(forks), dispatches=1, batch=[p.name for p in ordered], skipped=skipped)
    names = pf.names
    diag = list(ops_gang.DIAG_KERNELS)
    for k, f in enumerate(forks):
        chosen = fetched["chosen"][k]
        live_row = pf.planes["fk_pod_live"][k]
        placements = {}
        target_ok = {}
        for i, p in enumerate(ordered):
            if not live_row[i]:
                continue
            c = int(chosen[i])
            placements[p.name] = names[c] if 0 <= c < len(names) else None
            if target_slot is not None:
                target_ok[p.name] = c == target_slot
        fork_out = {
            "label": f.label,
            "placements": placements,
            "admitted": int(fetched["admitted"][k]),
            "unschedulable": int(fetched["unschedulable"][k]),
            "density_ppm": int(fetched["density_ppm"][k]),
            "reasons": {name: int(v) for name, v in zip(diag, fetched["reasons"][k]) if int(v)},
            "gang_admitted": {key: int(fetched["gang_admit"][k][slot]) for slot, key in enumerate(slot_keys)},
            "meta": dict(f.meta),
        }
        if target_slot is not None:
            fork_out["target_ok"] = target_ok
        sim.forks.append(fork_out)
    sim.wall_s = time.perf_counter() - t0
    _observe(sched, sim)
    return sim


def _observe(sched, sim: SimResult) -> None:
    m = sched.metrics
    m["plan_runs"] += 1
    m["plan_forks"] += sim.k
    m["plan_seconds"] += sim.wall_s


def _simulate_serial(sched, forks, ordered, needs, target_node, gang_positions) -> SimResult:
    """The serial engine: the same fork specs through the forked-snapshot
    oracle, over the cache's nodes, placed pods, PodGroups and volumes."""
    outcomes = oracle_planner.serial_plan(
        nodes=[cn.node for cn in sched.cache.real_nodes()],
        placed=sched.cache.placed_pods(),
        pods=ordered,
        forks=forks,
        groups={key: sched.gangs.get(key) for key in gang_positions if sched.gangs.get(key) is not None},
        needs=needs,
        pvs={o.key: o for o in sched.pv_cache.list()},
        pvcs={o.key: o for o in sched.pvc_cache.list()},
        target_node=target_node,
    )
    sim = SimResult(engine="serial", k=len(forks), dispatches=0, batch=[p.name for p in ordered])
    for f, o in zip(forks, outcomes):
        fork_out = {
            "label": f.label,
            "placements": o["placements"],
            "admitted": o["admitted"],
            "unschedulable": o["unschedulable"],
            "density_ppm": o["density_ppm"],
            "reasons": {},
            "gang_admitted": o["gang_admitted"],
            "meta": dict(f.meta),
        }
        if target_node is not None:
            fork_out["target_ok"] = o.get("target_ok", {})
        sim.forks.append(fork_out)
    return sim


# ---------------------------------------------------------------------------
# The planners
# ---------------------------------------------------------------------------


def _distinct_shapes(sched, max_shapes: int = 4) -> List[str]:
    """One node per distinct (cpu, memory, pods) allocatable."""
    seen = {}
    for cn in sched.cache.real_nodes():
        r = cn.node.allocatable
        seen.setdefault((r.milli_cpu, r.memory, r.allowed_pod_number), cn.node.name)
    return list(seen.values())[:max_shapes]


def plan_autoscale(sched, shapes: Optional[Sequence[str]] = None, max_count: int = 3, max_backlog: int = 256) -> dict:
    """Scale-up and scale-down: which node shape admits the unschedulable
    backlog most cheaply (cost: clones × the template's milli-cpu), and
    which empty nodes can go without admitting less of it."""
    pods, skipped = backlog_pods(sched, max_pods=max_backlog)
    if not pods:
        return {"planner": "autoscale", "error": "no eligible pending backlog to plan for", "skipped": skipped}
    shapes = list(shapes) if shapes else _distinct_shapes(sched)
    node_alloc = {cn.node.name: cn.node.allocatable.milli_cpu for cn in sched.cache.real_nodes()}
    empty = [cn.node.name for cn in sched.cache.real_nodes() if not cn.pods]
    forks = [Fork(label="baseline")]
    for s in shapes:
        for m in range(1, max_count + 1):
            forks.append(Fork(label=f"add:{s}x{m}", add=tuple((s, f"{s}~cf{i}") for i in range(m)),
                              meta=(("shape", s), ("count", m), ("cost_milli", node_alloc.get(s, 0) * m))))
    scale_down_considered = empty[:16]
    for name in scale_down_considered:
        forks.append(Fork(label=f"remove:{name}", remove=(name,), meta=(("scale_down", name),)))
    sim = simulate_forks(sched, forks, pods, planner="autoscale")
    out = {"planner": "autoscale", "backlog": len(pods), "shapes": shapes, "result": sim.to_json()}
    base = next((f for f in sim.forks if f["label"] == "baseline"), None)
    if base is not None:
        best = None
        for f in sim.forks:
            meta = f.get("meta", {})
            if "shape" not in meta:
                continue
            gain = f["admitted"] - base["admitted"]
            key = (-f["admitted"], meta.get("cost_milli", 0))
            if gain > 0 and (best is None or key < best[0]):
                best = (key, f, gain)
        if best is not None:
            _, f, gain = best
            out["recommendation"] = {"action": "scale_up", "shape": f["meta"]["shape"], "count": f["meta"]["count"],
                                     "newly_schedulable": gain, "cost_milli": f["meta"]["cost_milli"]}
        else:
            out["recommendation"] = {"action": "none", "reason": "no candidate shape admits more of the backlog"}
        out["scale_down"] = [f["meta"]["scale_down"] for f in sim.forks
                             if "scale_down" in f.get("meta", {}) and f["admitted"] >= base["admitted"]]
        # empty nodes past the candidate budget were not simulated, and do
        # not read as not removable
        out["scale_down_considered"] = scale_down_considered
        out["scale_down_unevaluated"] = empty[16:]
    return out


def plan_deschedule(sched, max_candidates: int = 8) -> dict:
    """Defragmentation: cordon a lightly loaded node, evict its pods, and
    see whether they re-place elsewhere and what that does to bin-packing
    density: the descheduler's question as K forks."""
    candidates = sorted((cn for cn in sched.cache.real_nodes() if cn.pods),
                        key=lambda cn: (len(cn.pods), cn.node.name))[:max_candidates]
    cand = []
    for cn in candidates:
        pods = [p for p in cn.pods.values() if _pod_ineligible(sched, p) is None]
        if pods and len(pods) == len(cn.pods):
            cand.append((cn.node.name, pods))
    if not cand:
        return {"planner": "deschedule", "error": "no drainable candidate nodes (occupied + eligible)"}
    batch = []
    forks = [Fork(label="baseline", live=())]
    for name, pods in cand:
        copies = []
        for p in pods:
            c = copy.deepcopy(p)
            c.node_name = ""
            copies.append(c)
        batch.extend(copies)
        forks.append(Fork(label=f"drain:{name}", cordon=(name,), evict=tuple(p.uid for p in pods),
                          live=tuple(c.uid for c in copies), meta=(("node", name), ("pods", len(pods)))))
    sim = simulate_forks(sched, forks, batch, planner="deschedule")
    out = {"planner": "deschedule", "candidates": [name for name, _ in cand], "result": sim.to_json()}
    base = next((f for f in sim.forks if f["label"] == "baseline"), None)
    drains = []
    for f in sim.forks:
        meta = f.get("meta", {})
        if "node" not in meta:
            continue
        drains.append({
            "node": meta["node"],
            "evicted": meta["pods"],
            "replaced": f["admitted"],
            "fully_drainable": f["admitted"] == meta["pods"],
            "density_ppm": f["density_ppm"],
            "density_gain_ppm": f["density_ppm"] - base["density_ppm"] if base is not None else None,
        })
    drains.sort(key=lambda d: (not d["fully_drainable"], -(d["density_gain_ppm"] or 0)))
    out["drains"] = drains
    best = next((d for d in drains if d["fully_drainable"]), None)
    out["recommendation"] = (
        {"action": "drain", "node": best["node"], "density_gain_ppm": best["density_gain_ppm"]}
        if best is not None
        else {"action": "none", "reason": "no candidate drains fully re-place"}
    )
    return out


def plan_preempt_cost(sched, max_backlog: int = 256, max_classes: int = 8) -> dict:
    """The preemption cost per pending priority class: how many of the
    class's pods become schedulable if every placed pod of strictly lower
    priority were evicted (the cascade's upper bound), against none."""
    pods, skipped = backlog_pods(sched, max_pods=max_backlog)
    if not pods:
        return {"planner": "preempt_cost", "error": "no eligible pending backlog", "skipped": skipped}
    classes: Dict[int, list] = {}
    for p in pods:
        classes.setdefault(p.priority, []).append(p)
    prios = sorted(classes, reverse=True)[:max_classes]
    placed = sched.cache.placed_pods()
    forks = []
    for c in prios:
        victims = tuple(p.uid for p in placed if p.priority < c)
        live = tuple(p.uid for p in classes[c])
        forks.append(Fork(label=f"class:{c}:base", live=live, meta=(("priority", c), ("kind", "base"))))
        forks.append(Fork(label=f"class:{c}:preempt", evict=victims, live=live,
                          meta=(("priority", c), ("kind", "preempt"), ("victims", len(victims)))))
    sim = simulate_forks(sched, forks, pods, planner="preempt_cost")
    by_label = {f["label"]: f for f in sim.forks}
    per_class = []
    for c in prios:
        base = by_label.get(f"class:{c}:base")
        pre = by_label.get(f"class:{c}:preempt")
        if base is None or pre is None:
            continue
        per_class.append({
            "priority": c,
            "pending": len(classes[c]),
            "schedulable_now": base["admitted"],
            "schedulable_with_max_preemption": pre["admitted"],
            "cascade_upper_bound": pre["admitted"] - base["admitted"],
            "victims_considered": pre["meta"].get("victims", 0),
        })
    return {"planner": "preempt_cost", "classes": per_class, "result": sim.to_json()}


def whatif_after_evictions(sched, pod, node_name: str, victim_uids) -> dict:
    """The one-fork what-if: evict ``victim_uids`` and ask whether ``pod``
    is then feasible on ``node_name`` (the target bonus makes ``chosen ==
    target`` exactly feasibility there).  The same engine and fork packer
    as the batched planners."""
    if pod.nominated_node_name:
        # a live preemptor is usually nominated already; the what-if asks
        # about the pod without its nomination (the caller names the
        # evictions), so it simulates a cleared copy
        pod = copy.deepcopy(pod)
        pod.nominated_node_name = ""
    fork = Fork(label=f"whatif:{node_name}", evict=tuple(victim_uids))
    sim = simulate_forks(sched, [fork], [pod], target_node=node_name, planner="whatif")
    out = {"engine": sim.engine, "dispatches": sim.dispatches}
    if pod.name in sim.skipped:
        out["skipped_reason"] = sim.skipped[pod.name]
        return out
    if not sim.forks:
        out["error"] = "simulation unavailable"
        return out
    f0 = sim.forks[0]
    t_ok = f0.get("target_ok", {}).get(pod.name)
    if t_ok is None:
        out["error"] = f"unknown node {node_name!r}"
        return out
    out["feasible"] = bool(t_ok)
    out["placement"] = f0["placements"].get(pod.name)
    return out


PLANNERS = {
    "autoscale": plan_autoscale,
    "deschedule": plan_deschedule,
    "preempt_cost": plan_preempt_cost,
}


def run_planner(sched, name: str, params: Optional[dict] = None) -> dict:
    """A planner by name with string parameters (a debug endpoint's query)
    → JSON.  Malformed parameters and racy state (a victim unbinding between
    the planner's snapshot and the fork pack) come back as an ``error``
    field, not an exception."""
    params = params or {}
    if name == "list":
        return {"planners": sorted(PLANNERS), "kernel": bool(sched.config.planner_kernel)}
    fn = PLANNERS.get(name)
    if fn is None:
        return {"error": f"unknown planner {name!r}", "planners": sorted(PLANNERS)}
    kw = {}
    try:
        if name == "autoscale":
            if params.get("shapes"):
                kw["shapes"] = [s for s in str(params["shapes"]).split(",") if s]
            if params.get("max_count"):
                kw["max_count"] = int(params["max_count"])
        elif name == "deschedule":
            if params.get("max_candidates"):
                kw["max_candidates"] = int(params["max_candidates"])
    except ValueError as e:
        return {"error": f"bad parameter: {e}"}
    try:
        return fn(sched, **kw)
    except ValueError as e:
        return {"error": str(e), "planner": name}
