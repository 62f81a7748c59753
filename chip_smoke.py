#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubernetes_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each (several for 2 and 4):
  1. card and build: the card's name and power limit (nvidia-smi), and the
     time to build the CUDA kernels from csrc/ (one nvcc per source, all
     started together);
  2. each kernel against its plain PyTorch version on the card, exact
     equality of every output (all outputs are integer or bool, so the
     tolerance is zero), at the slice's shapes: K1 static_eval at S=16 over
     the 10k-node bucket, K2 sig_scan at P=4096 with 16 and with 512
     signatures (its trees' launches, its step floor), K3 usage_checksum on K2's
     final state, and K4 resident_run at config0's shape (P=16384, N=10240,
     S=16 with the nine north-star signatures, W=2048) in both tail modes,
     on the north-star feed, on an interleaved feed that makes the adaptive
     stop fire, and on a one-signature feed of full windows, and on the
     north-star feed over config0's empty cluster with each score term
     switched off in turn; with the kernel's, the plain version's and (K3)
     a torch.sum's time;
  3. the transport: ops/wire.py's single-buffer upload of config0's usage
     state, and the device mirror's delta sync (the usage rows and the
     appended placed pods at config4's shape, one copy per row range),
     timed with and without the mirror's host append;
  4. drains through Scheduler() on cuda, each held pod for pod against the
     same workload on the port's host FastCommitter alone (device="cpu",
     every batch on the committer), with no node over its allocatable, and
     the launches of each kernel in that drain, each of which must be > 0
     for the kernels of its route: config0 (10k nodes, 100k pending pods)
     with residentDrain false (K1, K2, K3) and under the default
     configuration (K1, K4 with its host tail, K3), DRAIN_REPEATS times
     each in turns (once: cut from twice for time), with their spread;
     config0 once with residentSerialTail (K1, K4,
     K2 for its tail, K3); a mixed drain (1k nodes, 10k pods: NoSchedule
     taints, tolerations, nodeSelector, required node affinity, images) on
     the first two routes and with residentSerialTail;
  5. the gang path: K5 gang_scan, K6 gang_spread_statics and K7
     gang_interpod_statics against their plain versions on the card, exact on
     every GangStatics field and every scan output, at config4's shape
     (N=5000 in 8 zones, P=512, 45,000 placed spread pods), config3's (N=1000,
     P=512, 4,500 placed anti-affinity pods) and a tests/gen.py-style mixed
     batch at N=5000 with 500 placed pods, with each kernel's, its plain version's and (K7) a
     float64 torch.matmul's time, K6's and K7's spans (each of their
     kernels' first block's start to last block's end), K7's placed terms
     alone (the terms kernel and ext) with their own bound beside the
     matmul, K7's ports-only launch (every config4 batch's) against
     port_masks_plain, exact, with its time, and K5's cluster (its CTAs, exchanges and
     microseconds a pod) and K5 at 8 CTAs, exact, with its time; then drains through Scheduler(): config4
     (5k nodes, 50k spread pods) and config3 (1k nodes, 5k anti-affinity
     pods) under waveDispatch: false, with their zone-skew and
     anti-affinity checks, and 20k preferred-affinity pods on config0's 10k
     tiered nodes under the default configuration (its first 512
     placements against the CPU's); and a parity drain of 1,152 mixed
     gang-path pods on 250 nodes (three batches; cut from 1,536 for time),
     on cuda and on the CPU, whose placements and diagnoses must be
     identical;
  6. the wave: K8 wave_speculate and K9 wave_admit against their plain
     versions, exact on every output, and K9 against K5 on the same
     statics, at config4's and config3's shapes, a port-contended batch and
     a mixed batch without ports, with each kernel's, its plain version's
     and K5's time; K9's cluster size, exchanges and microseconds a pod,
     K9 / K5, its leader's cycles a phase, and K9 at 8 CTAs and with its
     planes unstaged, exact, with their times; then config4 and config3 under the default
     configuration (every batch on the wave), placed pod for pod as their
     waveDispatch: false drains above; a port-contended drain (1k nodes,
     4,096 pods, every batch a direct wave with the port carry) against the
     same drain on the gang scan; and the parity drain again under the
     default configuration;
  7. preemption: K10 narrow_candidates against its plain version, exact,
     at config0's node count (N=10,240, 20,000 placed pods at priorities
     0 / 10 / 50, 512 failed pods in four priority groups, 512 batch
     peers), with its time, the plain version's and the library's
     index_add_ segment sums of its kept plane; K5, K8 and K9 with 64 open
     nominations against their plain versions at config4's and the mixed
     shape (inside phases 5 and 6); bench.py bench_preemption's drain (500
     nodes of 4 cpu each holding two priority-0 victims, 500 preemptors of
     3 cpu at priority 100, a manual clock +30 s per round, at most 12
     rounds, victims evicted through on_pod_delete) on cuda and on the CPU
     with identical bindings, evictions and nominations, every preemptor
     bound, each node emptied of exactly its two victims, no node over its
     allocatable; the same drain at 5,000 nodes with 250 preemptors on
     cuda; and a gang-path drain with priorities (120 nodes, 360 placed
     priority-0 pods, 480 spread and anti-affinity pods (cut from 500 /
     1,500 / 2,000 for time) at priorities 0 /
     50 / 100, some too big to fit before a preemption) in two rounds on
     cuda and on the CPU, identical (K10 narrows this drain's gang-path
     harvests; the fast harvests of bench_preemption reach PostFilter
     unnarrowed, as in the reference, so K10 must not launch there);
  8. gang coscheduling: K11 workloads_admit against its plain version,
     exact on every output, and with the gang rows cleared against K9 on
     the same statics, at config10's batch (N=1,000 in 8 zones, 64 gangs
     of 8, C = AT = 0), config4's shape with gangs of 8 laid over the batch
     (every fourth rolling back after placing members) and the mixed shape
     (AT = 4, 64 open nominations), with K11's time, its plain version's,
     K9's with the gangs cleared (the checkpoint's cost) and its bound;
     bench.py bench_gang's drain (config10: 1,000 nodes, 20,000 pods in
     2,500 PodGroups of 8, minMember 8) on cuda, every pod placed, every
     gang whole, one K11 launch per workloads batch; and a contended gang
     drain (250 nodes, 100 seeded gangs of 4-12 with spread or
     anti-affinity among their members, 200 plain pods, about 125 % of the
     cluster's cpu asked) on cuda and on the CPU, identical in outcomes and
     in the gang metrics, with gangs rolled back;
  9. bound volumes: K12 volume_topology_mask against its plain version,
     exact, at config4's node set (N=5,000 in 8 zones) and P=512 pods with
     two PV slots (one- and two-term zone affinities, zone labels and zone
     sets, nil affinities, pods whose PV is missing), and K1 with K12's
     mask as its extra lane against K1's plain version, with times and
     bounds; a StatefulSet drain (10,000 pods with one bound PVC each on
     config4's 5,000 nodes: 60 % zone affinity, 20 % zone label, 15 % nil,
     5 % pinned to a zone no node carries) on cuda, every placed pod in its
     PV's zone, the 5 % unplaced with the volume node affinity conflict,
     one K12 launch per workloads batch; and a parity drain (600 nodes,
     648 volume, gang and spread pods in one batch; cut from 1,000 /
     1,080 for time) on cuda, on the CPU
     and against the serial WorkloadOracle with volumes, identical;
 10. DRA claims: K13 dra_selector_match and K14 dra_spec_mask against their
     plain versions, exact, K8 with K14's mask as its port lane against
     wave_speculate_plain with the same lane, exact, and K11's DRA mode
     (the allocation carries in
     the admission and the gang checkpoint) against workloads_admit_plain,
     exact on every output with claim_node, at config4's node set (N=5,000
     in 8 zones, 8 devices of 4 attributes per node, P=512, DQ=2, DS=3 in a
     bucket of 4, DV=2, All mode, shared, pre-allocated and held claims,
     gangs of 8 of which every fourth rolls back), with each kernel's time,
     its plain version's and its bound, and K11 with the claims cleared;
     bench.py bench_dra's drain (config11: 500 nodes of 4 devices, 2,000
     pods with one ExactCount claim each) on cuda with the
     DynamicResourceAllocation gate on: every pod placed, no device granted
     twice, every claim on its pod's node, K13, K14 and K11 launched, and
     the host seconds of its parts; and a parity drain
     (tools/paritycheck.py's _dra_workload, 200 nodes, 600 pods, one batch)
     on cuda, on the CPU and against the serial WorkloadOracle, identical
     in placements and claim pins;
 11. the counterfactual planner: K15 fork_view and K16 fork_summary
     against their plain versions, exact, at 64 forks over config4's node
     set (N=5,120) with P=256, with each kernel's time, its plain
     version's, its bound and (K15) one torch.where over the stacked node
     planes; K8 and K11 with a target extra_score against their plain
     versions with it, exact, and K11's time with and without it; bench.py
     bench_plan (config14: 300 nodes in 4 zones, 1,500 placed pods, 96
     backlog pods, 64 mixed forks of clone adds, cordons, evictions and
     scales) on the kernel engine (K15, K1, K7, K8, K11 per fork, K16),
     the first 8 forks (cut from 16 for time) equal to the serial engine's (plannerKernel off)
     and to the kernel engine of a device="cpu" scheduler (the plain
     versions) on those forks, and every fork equal to the same fork run
     alone, with the wall times and launches of the
     batched run and of the 64 one-fork runs; and, at full width (5,000
     nodes in 8 zones and four shapes, 9,936 placed pods, 256
     unschedulable pods of 10 cpu: plain, zone-spread and a gang of 32),
     plan_autoscale (K=29), plan_deschedule (K=9) and plan_preempt_cost
     (K=4) on the kernel engine with their wall times and launches, and a
     64-fork run whose 8 sampled forks equal the same forks alone;
 12. explain and the independent pipeline: K17 explain_stack against its
     plain version, exact on the [10, P, N] stack and combined mask, at
     config4's shape (N=5,000 in 8 zones, P=512, 45,000 placed spread pods)
     and at the mixed shape with a host-filter lane (all nine rows failing
     somewhere); K18 pipeline_score against its plain version, exact on
     chosen, feasible, totals and n_feasible, at 10,240 tests/gen.py-style
     nodes with images, 102 placed pods and 512 mixed pods, and the CUDA
     pipeline route (K1, K6, K7, K17, K18) against pipeline_plain (the
     reference's all_masks and all_scores) on the card; K14 and K11's DRA
     mode at 320 device slots per node (the scratch-row path) beside 8,
     exact, at N=1,000, P=128, DQ=2, with times; the main path, its launch
     counts reset before it: explain_pod for four pods (spread,
     hostname anti-affinity, larger than every node, nodeName) on config4's
     cluster, explain_whatif for a bench_preemption preemptor and
     schedule_independent at the K18 shape on cuda, the first two equal to
     a device="cpu" Scheduler's dicts (the what-if's parity True), the last
     equal to the plain pipeline; a DRA drain of 900 pods with one
     ExactCount=10 claim each on 30 nodes of 300 devices (cut from 1,500 /
     50 for time), on cuda and on
     the CPU, identical in bindings and claim pins, no device granted twice;
 13. the sampling window, the seeded tie-break and the fit strategies: K5,
     K8 and K9 against their plain versions, exact on every output (the
     advanced cursor in the tallies too), at config4's node set
     (basic_nodes(5000, zones=3), N bucket 5,120, P=512 spread pods over
     4,500 placed ones) in five modes (compat sampling with the adaptive
     window, 500 of 5,000, and tie_break_seed 7; the same window with no
     seed; the window over all 5,000 nodes with no seed; MostAllocated;
     RequestedToCapacityRatio with a three-point shape), each timed beside
     the default branch; K11 under MostAllocated at config10's shape; K19
     tie_bits for 512 attempts over N=10,240 and for one over the host
     cycle's 500 nodes; then drains on those 5,000 nodes: 10,240 spread
     pods under reference_sampling_compat with the tie seed (every batch a
     direct wave), 10,240 plain pods under MostAllocated (the chained scan;
     the first batch's placements equal to the CPU's), 128 GPU pods on 500
     nodes whose strategy weighs the GPU (the one-pod host cycle, K19 once
     per pod, equal to the CPU's drain), and reference_sampling_compat with
     no seed on 1,000 and on 90 nodes added zone by zone (a wave and a scan
     batch of 256 each, equal to the CPU's drains); and port
     copies of tools/paritycheck.py check_compat_vs_oracle (600 nodes, 900
     pods; cut from 2,000 / 3,000) and check_compat_wave_vs_oracle (200 /
     400; cut from 800 / 1,600) against the port's serial oracle loop with
     K19's bits, 0 diffs;
 14. the kernels line (K8 named as the workloads speculation too, K19 as
     the parity copies' draw, the redesigns of K2, K5, K6, K7, K9 and K15
     under "design").

The second-to-last line is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Any failed phase exits non-zero.  Without
CUDA, or without the package beside this script, it exits 2 and prints no
result.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the scalar (non
# tensor-core) float32 rate, 67 TFLOP/s = 132 SMs x 128 lanes x 2 (an FMA
# is two flops) x 1.98 GHz.  The kernels' work is integer, one lane
# operation each: at most 128 a clock per SM, half the flop rate
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12
PEAK_ISSUE_OPS_S = PEAK_FP32_FLOP_S / 2
# config0 drains per route (taken in turns when more than one, to show the
# host clock's spread; one keeps the script within its time)
DRAIN_REPEATS = 1


_START = time.perf_counter()


def log(**kw) -> None:
    """One JSON line; ``at_s`` is the seconds since the script started, so
    consecutive lines give each phase's wall time."""
    print(json.dumps(dict(kw, at_s=time.perf_counter() - _START), sort_keys=True), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_ISSUE_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def time_ms(torch, fn, reps: int, setup=None) -> float:
    """Mean device time of fn over reps calls: CUDA events around each call,
    with the card kept busy (a ~1 ms spin) while the host enqueues it, so the
    events bracket device work, not the host's launch overhead — unless the
    host takes longer than the spin, as the plain versions' loops do.  setup
    runs outside the timed window."""
    if setup is not None:
        setup()
    fn()  # warm-up
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


# ---------------------------------------------------------------------------
# Workloads (the port's own copies of the reference bench templates)
# ---------------------------------------------------------------------------


def basic_nodes(n, zones=3):
    """bench.py _basic_nodes: 8 cpu, 32Gi, 110 pods, zone round-robin."""
    from kubernetes_tpu_torch.api import Node, Resource

    return [
        Node(
            name=f"node-{i}",
            labels={
                "topology.kubernetes.io/zone": f"zone-{i % zones}",
                "kubernetes.io/hostname": f"node-{i}",
            },
            capacity=Resource.from_map({"cpu": "8", "memory": "32Gi", "pods": 110}),
        )
        for i in range(n)
    ]


def north_star_pods(n_pods, prefix="ns", seed=4242):
    """bench.py _north_star_pods: app-sharded labels, 3 × 3 cpu/mem requests
    (the reference's tools/paritycheck.py _basic_pods with prefix "pp")."""
    from kubernetes_tpu_torch.api import Container, Pod

    rng = random.Random(seed)
    return [
        Pod(
            name=f"{prefix}-{i}",
            labels={"app": f"app-{i % 16}"},
            containers=[
                Container(
                    name="c",
                    requests={
                        "cpu": f"{rng.choice([100, 250, 500])}m",
                        "memory": f"{rng.choice([128, 256, 512])}Mi",
                    },
                )
            ],
        )
        for i in range(n_pods)
    ]


def mixed_nodes(n, seed=7):
    """Nodes with zones, disks, a numeric generation label, NoSchedule
    taints on a fifth, a few unschedulable, and container images."""
    from kubernetes_tpu_torch.api import Node, Resource, Taint

    rng = random.Random(seed)
    nodes = []
    for i in range(n):
        taints = ()
        if rng.random() < 0.2:
            taints = (Taint(key="dedicated", value=rng.choice(["a", "b"])),)
        images = {}
        if rng.random() < 0.4:
            images[rng.choice(["nginx:1", "redis:7", "pause:3"])] = rng.choice([50, 300, 900]) << 20
        nodes.append(
            Node(
                name=f"m{i:05d}",
                labels={
                    "kubernetes.io/hostname": f"m{i:05d}",
                    "zone": f"z{i % 3}",
                    "disk": rng.choice(["ssd", "hdd"]),
                    "gen": str(rng.randint(1, 8)),
                },
                capacity=Resource.from_map(
                    {
                        "cpu": rng.choice(["4", "8", "16"]),
                        "memory": rng.choice(["16Gi", "32Gi"]),
                        "pods": rng.choice([30, 110]),
                    }
                ),
                taints=taints,
                unschedulable=rng.random() < 0.02,
                images=images,
            )
        )
    return nodes


def mixed_pods(n, seed=11):
    """Fast-eligible pods from 48 templates whose static rows use
    tolerations, nodeSelector, required node affinity (In / NotIn / Gt /
    Exists) and images; every template shows up in the first batch, so the
    rest of the drain extends to device-sized batches."""
    import itertools

    from kubernetes_tpu_torch.api import (
        Affinity,
        Container,
        NodeAffinity,
        NodeSelector,
        NodeSelectorRequirement,
        NodeSelectorTerm,
        Pod,
        Toleration,
    )

    req_terms = [
        None,
        (NodeSelectorRequirement("zone", "In", ("z0", "z1")),),
        (NodeSelectorRequirement("gen", "Gt", ("4",)),),
        (NodeSelectorRequirement("disk", "NotIn", ("hdd",)), NodeSelectorRequirement("gen", "Exists")),
    ]
    templates = []
    for i, (tol, sel, term, cpu) in enumerate(
        itertools.product((None, "a"), (None, "ssd", "hdd"), req_terms, ("250m", "1"))
    ):
        kw = {}
        if tol:
            kw["tolerations"] = (Toleration(key="dedicated", operator="Equal", value=tol),)
        if sel:
            kw["node_selector"] = {"disk": sel}
        if term:
            kw["affinity"] = Affinity(
                node_affinity=NodeAffinity(
                    required_during_scheduling_ignored_during_execution=NodeSelector(
                        (NodeSelectorTerm(match_expressions=term),)
                    )
                )
            )
        if i % 4 == 0:
            kw["images"] = ("nginx:1",)
        templates.append((cpu, kw))
    rng = random.Random(seed)
    pods = []
    for i in range(n):
        cpu, kw = rng.choice(templates)
        pods.append(
            Pod(
                name=f"mp-{i}",
                containers=[Container(name="c", requests={"cpu": cpu, "memory": "512Mi"})],
                **kw,
            )
        )
    return pods


# ---------------------------------------------------------------------------
# Gang-path workloads (the port's copies of bench.py's config3 / config4
# generators and of the tests/gen.py mixed pods)
# ---------------------------------------------------------------------------

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"


def tier_nodes(n, zones=3):
    """basic_nodes with a tier label (gold / silver / bronze) for the
    preferred node-affinity drain."""
    nodes = basic_nodes(n, zones)
    for i, node in enumerate(nodes):
        node.labels["tier"] = ("gold", "silver", "bronze")[i % 3]
    return nodes


def spread_pods(n_pods, prefix="pod"):
    """bench.py bench_spread (config4): maxSkew 5 over zones, 20 apps."""
    from kubernetes_tpu_torch.api import Container, LabelSelector, Pod, TopologySpreadConstraint

    pods = []
    for i in range(n_pods):
        app = f"a{i % 20}"
        pods.append(Pod(
            name=f"{prefix}-{i}",
            labels={"app": app},
            topology_spread_constraints=(TopologySpreadConstraint(
                max_skew=5, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
                label_selector=LabelSelector(match_labels={"app": app})),),
            containers=[Container(name="c", requests={"cpu": "100m", "memory": "64Mi"})],
        ))
    return pods


def interpod_pods(n_pods, groups=50, prefix="pod"):
    """bench.py bench_interpod (config3): required anti-affinity on the
    hostname within each of 50 groups."""
    from kubernetes_tpu_torch.api import (
        Affinity, Container, LabelSelector, Pod, PodAffinityTerm, PodAntiAffinity,
    )

    pods = []
    for i in range(n_pods):
        group = f"g{i % groups}"
        anti = PodAntiAffinity(required_during_scheduling_ignored_during_execution=(
            PodAffinityTerm(topology_key=HOSTNAME, label_selector=LabelSelector(match_labels={"group": group})),))
        pods.append(Pod(
            name=f"{prefix}-{i}", labels={"group": group}, affinity=Affinity(pod_anti_affinity=anti),
            containers=[Container(name="c", requests={"cpu": "100m", "memory": "64Mi"})],
        ))
    return pods


def preferred_pods(n_pods):
    """Pods with one preferred node-affinity term each (a tier), so their
    static scores vary over their feasible nodes: the direct gang_run."""
    from kubernetes_tpu_torch.api import (
        Affinity, Container, NodeAffinity, NodeSelectorRequirement, NodeSelectorTerm, Pod,
        PreferredSchedulingTerm,
    )

    pods = []
    for i in range(n_pods):
        term = NodeSelectorTerm(match_expressions=(
            NodeSelectorRequirement("tier", "In", (("gold", "silver", "bronze")[i % 3],)),))
        na = NodeAffinity(preferred_during_scheduling_ignored_during_execution=(
            PreferredSchedulingTerm(weight=10 + i % 7, preference=term),))
        pods.append(Pod(
            name=f"pref-{i}", labels={"app": f"app-{i % 16}"}, affinity=Affinity(node_affinity=na),
            containers=[Container(name="c", requests={"cpu": "250m", "memory": "256Mi"})],
        ))
    return pods


def port_heavy_pods(n_pods, seed=5, apps=6, prefix="pt"):
    """The reference's port-contended mix (tools/paritycheck.py
    _port_heavy_pods): two of three pods race a host port (8080 or 9090,
    TCP or UDP, wildcard or one host IP) and every other pod spreads over
    zones with maxSkew 2.  Every batch of it takes the direct wave with the
    port-occupancy carry."""
    from kubernetes_tpu_torch.api import Container, ContainerPort, LabelSelector, Pod, TopologySpreadConstraint

    rng = random.Random(seed)
    pods = []
    for i in range(n_pods):
        kw = {"labels": {"app": f"srv-{i % apps}"}}
        containers = [Container(name="c", requests={"cpu": f"{rng.choice([100, 250])}m", "memory": "128Mi"})]
        if i % 3 != 2:
            containers.append(Container(name="srv", ports=(ContainerPort(
                container_port=8080, host_port=rng.choice([8080, 9090]), protocol=rng.choice(["TCP", "UDP"]),
                host_ip=rng.choice(["", "", "10.0.0.1"])),)))
        if i % 2 == 0:
            kw["topology_spread_constraints"] = (TopologySpreadConstraint(
                max_skew=2, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
                label_selector=LabelSelector(match_labels={"app": kw["labels"]["app"]})),)
        pods.append(Pod(name=f"{prefix}-{i}", containers=containers, **kw))
    return pods


_GEN_ZONES = ["zone-a", "zone-b", "zone-c"]
_GEN_APPS = ["web", "db", "cache", "batch"]
_GEN_NS = ["default", "prod", "dev"]
_GEN_TAINTS = ["dedicated", "gpu", "spot"]
_GEN_IMAGES = ["img/web:1", "img/db:2", "img/cache:3"]


def gen_node(rng, i):
    """tests/gen.py make_node: zones, regions, disks, numeric tiers, taints
    of every effect, unschedulable nodes and images."""
    from kubernetes_tpu_torch.api import Node, Resource, Taint

    labels = {ZONE: rng.choice(_GEN_ZONES), "topology.kubernetes.io/region": rng.choice(["r1", "r2"]),
              HOSTNAME: f"node-{i}"}
    if rng.random() < 0.5:
        labels["disk"] = rng.choice(["ssd", "hdd"])
    if rng.random() < 0.3:
        labels["tier"] = str(rng.randrange(1, 5))
    taints = ()
    if rng.random() < 0.2:
        taints = (Taint(key=rng.choice(_GEN_TAINTS), value=rng.choice(["", "true", "team-a"]),
                        effect=rng.choice(["NoSchedule", "PreferNoSchedule", "NoExecute"])),)
    images = {img: rng.randrange(50, 900) << 20 for img in _GEN_IMAGES if rng.random() < 0.4}
    return Node(
        name=f"node-{i}", labels=labels,
        capacity=Resource.from_map({"cpu": str(rng.choice([2, 4, 8, 16])), "memory": f"{rng.choice([4, 8, 16, 32])}Gi",
                                    "pods": rng.choice([16, 32, 110])}),
        taints=taints, unschedulable=rng.random() < 0.05, images=images,
    )


def _gen_selector(rng):
    from kubernetes_tpu_torch.api import LabelSelector, LabelSelectorRequirement

    r = rng.random()
    if r < 0.5:
        return LabelSelector(match_labels={"app": rng.choice(_GEN_APPS)})
    if r < 0.8:
        return LabelSelector(match_expressions=(LabelSelectorRequirement(
            "app", rng.choice(["In", "NotIn", "Exists", "DoesNotExist"]),
            tuple(rng.sample(_GEN_APPS, rng.randrange(1, 3)))),))
    return LabelSelector()


def _gen_term(rng):
    from kubernetes_tpu_torch.api import LabelSelector, PodAffinityTerm

    kw = dict(topology_key=rng.choice([ZONE, HOSTNAME]), label_selector=_gen_selector(rng))
    r = rng.random()
    if r < 0.2:
        kw["namespaces"] = tuple(rng.sample(_GEN_NS, rng.randrange(1, 3)))
    elif r < 0.3:
        kw["namespace_selector"] = LabelSelector()
    return PodAffinityTerm(**kw)


def gen_pod(rng, name, node_name="", ports=True):
    """tests/gen.py make_pod with every pod at priority 0 (preemption is not
    ported): node selectors, required / preferred node affinity,
    tolerations, required / preferred (anti-)affinity with namespace lists
    and selectors, hard / soft spread with minDomains and both inclusion
    policies, host ports, images."""
    from kubernetes_tpu_torch.api import (
        Affinity, Container, ContainerPort, NodeAffinity, NodeSelector, NodeSelectorRequirement,
        NodeSelectorTerm, Pod, PodAffinity, PodAntiAffinity, PreferredSchedulingTerm, Toleration,
        TopologySpreadConstraint, WeightedPodAffinityTerm,
    )

    labels = {"app": rng.choice(_GEN_APPS)}
    if rng.random() < 0.3:
        labels["tier"] = str(rng.randrange(1, 5))
    containers = [Container(name="c0", requests={"cpu": f"{rng.choice([0, 100, 250, 500, 1000])}m",
                                                 "memory": f"{rng.choice([0, 128, 256, 512, 1024])}Mi"})]
    kw = dict(name=name, namespace=rng.choice(_GEN_NS), labels=labels, node_name=node_name,
              containers=containers, images=tuple(rng.sample(_GEN_IMAGES, rng.randrange(0, 3))))
    if rng.random() < 0.35:
        kw["node_selector"] = {"disk": rng.choice(["ssd", "hdd"])} if rng.random() < 0.7 else \
            {ZONE: rng.choice(_GEN_ZONES)}
    node_aff = None
    if rng.random() < 0.35:
        req = None
        if rng.random() < 0.7:
            op = rng.choice(["In", "NotIn", "Exists", "Gt", "Lt"])
            key, vals = ("tier", (str(rng.randrange(1, 5)),)) if op in ("Gt", "Lt") else \
                ("disk", tuple(rng.sample(["ssd", "hdd"], rng.randrange(1, 3))))
            req = NodeSelector((NodeSelectorTerm(match_expressions=(NodeSelectorRequirement(key, op, vals),)),))
        pref = ()
        if rng.random() < 0.5:
            pref = (PreferredSchedulingTerm(weight=rng.randrange(1, 100), preference=NodeSelectorTerm(
                match_expressions=(NodeSelectorRequirement("disk", "In", (rng.choice(["ssd", "hdd"]),)),))),)
        node_aff = NodeAffinity(required_during_scheduling_ignored_during_execution=req,
                                preferred_during_scheduling_ignored_during_execution=pref)
        kw["affinity"] = Affinity(node_affinity=node_aff)
    if rng.random() < 0.3:
        kw["tolerations"] = (Toleration(key=rng.choice(_GEN_TAINTS + [""]), operator=rng.choice(["Exists", "Equal"]),
                                        value=rng.choice(["", "true"]),
                                        effect=rng.choice(["", "NoSchedule", "PreferNoSchedule"])),)
    if rng.random() < 0.3:
        groups = []
        for cls in (PodAffinity, PodAntiAffinity):
            g = None
            if rng.random() < 0.6:
                req_terms = (_gen_term(rng),) if rng.random() < 0.55 else ()
                pref_terms = ((WeightedPodAffinityTerm(weight=rng.randrange(1, 100), pod_affinity_term=_gen_term(rng)),)
                              if rng.random() < 0.6 else ())
                if req_terms or pref_terms:
                    g = cls(required_during_scheduling_ignored_during_execution=req_terms,
                            preferred_during_scheduling_ignored_during_execution=pref_terms)
            groups.append(g)
        if groups[0] or groups[1]:
            kw["affinity"] = Affinity(node_affinity=node_aff, pod_affinity=groups[0], pod_anti_affinity=groups[1])
    if rng.random() < 0.25:
        kw["topology_spread_constraints"] = (TopologySpreadConstraint(
            max_skew=rng.randrange(1, 3), topology_key=rng.choice([ZONE, HOSTNAME]),
            when_unsatisfiable=rng.choice(["DoNotSchedule", "ScheduleAnyway"]), label_selector=_gen_selector(rng),
            min_domains=rng.choice([None, 2]), node_affinity_policy=rng.choice(["Honor", "Ignore"]),
            node_taints_policy=rng.choice(["Honor", "Ignore"])),)
    if rng.random() < 0.15 and ports:
        kw["containers"] = containers + [Container(name="c1", ports=(ContainerPort(
            container_port=8080, host_port=rng.choice([8080, 9090])),))]
    return Pod(**kw)


def gen_cluster(seed, n_nodes, n_placed, n_pending, ports_from=0):
    """Nodes, placed pods and pending pods; pending pods before `ports_from`
    want no host ports (a batch with one port pod takes the direct scan)."""
    rng = random.Random(seed)
    nodes = [gen_node(rng, i) for i in range(n_nodes)]
    placed = [gen_pod(rng, f"placed-{j}", node_name=rng.choice(nodes).name) for j in range(n_placed)]
    pending = [gen_pod(rng, f"pend-{i}", ports=i >= ports_from) for i in range(n_pending)]
    return nodes, placed, pending


STATICS_WORLDS = ("preferred_anti", "dead_terms", "three_keys", "spread_keys", "namespaces")
REGION = "topology.kubernetes.io/region"


def statics_world(kind, seed, api=None):
    """(nodes, placed pods, pending pods, mutate) of one of K6's and K7's
    scenarios (STATICS_WORLDS), built with `api` (a module with the API
    types and Resource; the port's by default): preferred anti-affinity
    beside required and preferred affinity; placed terms of deleting pods,
    on nodes without the zone label and over a key no node carries (mutate
    marks every seventh placed row invalid in the packed arrays); terms over
    the hostname, the zone and the region; two or three spread constraints
    a pod with both inclusion policies, node affinity and tolerations over
    tainted nodes; namespace lists, namespace label selectors and
    all-namespace terms.  mutate(ep) edits the packed placed pods before
    any side reads them (None: no edit)."""
    if api is None:
        import kubernetes_tpu_torch.api as api
    rng = random.Random(seed * 31 + len(kind))
    apps, namespaces, keys = ("web", "db", "cache", "batch"), ("default", "prod", "dev"), (HOSTNAME, ZONE, REGION)

    def node(i, zone_frac=1.0, taint_frac=0.0):
        labels = {HOSTNAME: f"node-{i}", REGION: f"region-{i % 2}"}
        if rng.random() < zone_frac:
            labels[ZONE] = f"zone-{rng.randrange(4)}"
        if rng.random() < 0.5:
            labels["disk"] = rng.choice(("ssd", "hdd"))
        taints = (api.Taint(key="dedicated", value="infra", effect="NoSchedule"),) if rng.random() < taint_frac else ()
        return api.Node(name=f"node-{i}", labels=labels, taints=taints,
                        capacity=api.Resource.from_map({"cpu": "16", "memory": "64Gi", "pods": 110}))

    def sel():
        if rng.random() < 0.7:
            return api.LabelSelector(match_labels={"app": rng.choice(apps)})
        return api.LabelSelector(match_expressions=(
            api.LabelSelectorRequirement("app", rng.choice(("In", "NotIn")), tuple(rng.sample(apps, 2))),))

    def term(key, ns_modes):
        kw = dict(topology_key=key, label_selector=sel())
        mode = rng.choice(ns_modes)
        if mode == "list":
            kw["namespaces"] = tuple(rng.sample(namespaces, 2))
        elif mode == "all":
            kw["namespace_selector"] = api.LabelSelector()
        elif mode == "labels":
            kw["namespace_selector"] = api.LabelSelector(match_labels={"team": "core"})
        return api.PodAffinityTerm(**kw)

    def interpod(tkeys, ns_modes=("own",), required=True):
        def w(k):
            return api.WeightedPodAffinityTerm(weight=rng.randrange(1, 101), pod_affinity_term=term(k, ns_modes))

        req = (lambda: (term(rng.choice(tkeys), ns_modes),)) if required else (lambda: ())
        return api.Affinity(
            pod_affinity=api.PodAffinity(required_during_scheduling_ignored_during_execution=req(),
                                         preferred_during_scheduling_ignored_during_execution=tuple(
                                             w(k) for k in tkeys[:2])),
            pod_anti_affinity=api.PodAntiAffinity(required_during_scheduling_ignored_during_execution=req(),
                                                  preferred_during_scheduling_ignored_during_execution=tuple(
                                                      w(k) for k in tkeys)))

    def spread(skeys):
        return tuple(api.TopologySpreadConstraint(
            max_skew=rng.randrange(1, 4), topology_key=k,
            when_unsatisfiable=rng.choice(("DoNotSchedule", "ScheduleAnyway")), label_selector=sel(),
            min_domains=rng.choice((None, 2)) if k != HOSTNAME else None,
            node_affinity_policy=rng.choice(("Honor", "Ignore")), node_taints_policy=rng.choice(("Honor", "Ignore")))
            for k in skeys)

    def node_terms():
        na = api.NodeAffinity(required_during_scheduling_ignored_during_execution=api.NodeSelector((
            api.NodeSelectorTerm(match_expressions=(
                api.NodeSelectorRequirement("disk", "In", (rng.choice(("ssd", "hdd")),)),)),)))
        return dict(affinity=api.Affinity(node_affinity=na) if rng.random() < 0.5 else None,
                    tolerations=(api.Toleration(key="dedicated", operator="Exists", effect="NoSchedule"),)
                    if rng.random() < 0.5 else ())

    def pod(name, node_name="", ns="default", affinity=None, spread_on=(), **kw):
        return api.Pod(name=name, namespace=ns, node_name=node_name, labels={"app": rng.choice(apps)},
                       affinity=affinity, topology_spread_constraints=spread(spread_on),
                       containers=[api.Container(name="c", requests={"cpu": "100m", "memory": "64Mi"})], **kw)

    mutate = None
    if kind == "preferred_anti":
        nodes = [node(i) for i in range(16)]
        placed = [pod(f"pl-{j}", nodes[rng.randrange(16)].name, affinity=interpod(keys[:2])) for j in range(40)]
        pending = [pod(f"pe-{i}", affinity=interpod(keys[:2], required=i % 3 == 0)) for i in range(24)]
    elif kind == "dead_terms":
        nodes = [node(i, zone_frac=0.6) for i in range(16)]
        placed = [pod(f"pl-{j}", nodes[rng.randrange(16)].name, affinity=interpod((ZONE, "example.com/rack", HOSTNAME)),
                      deletion_timestamp=1.0 if j % 5 == 1 else None) for j in range(40)]
        pending = [pod(f"pe-{i}", affinity=interpod((ZONE, HOSTNAME)), spread_on=(ZONE,)) for i in range(24)]

        def mutate(ep):
            ep.valid[[i for i in range(ep.valid.shape[0]) if i % 7 == 3]] = False  # rows whose pod has gone

    elif kind == "three_keys":
        nodes = [node(i) for i in range(20)]
        placed = [pod(f"pl-{j}", nodes[rng.randrange(20)].name, affinity=interpod(keys)) for j in range(48)]
        pending = [pod(f"pe-{i}", affinity=interpod(keys)) for i in range(24)]
    elif kind == "spread_keys":
        nodes = [node(i, zone_frac=0.8, taint_frac=0.3) for i in range(20)]
        placed = [pod(f"pl-{j}", nodes[rng.randrange(20)].name, ns=rng.choice(namespaces)) for j in range(60)]
        pending = [pod(f"pe-{i}", ns=rng.choice(namespaces), spread_on=rng.sample(keys, 2 + i % 2), **node_terms())
                   for i in range(24)]
    elif kind == "namespaces":
        nodes = [node(i) for i in range(16)]
        modes = ("own", "list", "all", "labels")
        placed = [pod(f"pl-{j}", nodes[rng.randrange(16)].name, ns=rng.choice(namespaces),
                      affinity=interpod(keys[:2], modes)) for j in range(48)]
        pending = [pod(f"pe-{i}", ns=rng.choice(namespaces), affinity=interpod(keys[:2], modes), spread_on=(ZONE,))
                   for i in range(24)]
    else:
        raise ValueError(kind)
    return nodes, placed, pending, mutate


def _gang_pack(torch, device, nodes, placed, pending, P, mutate=None):
    """Pack a cluster with its placed pods and one pending batch through the
    port's packers, as the scheduler's mirror does, onto `device`; mutate
    (statics_world's) edits the packed placed pods first."""
    from kubernetes_tpu_torch.ops import gang
    from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster
    from kubernetes_tpu_torch.snapshot.schema import bucket_cap

    pc, pb = packed_snapshot(nodes, placed, pending, P)
    if mutate is not None:
        mutate(pc.existing)
    nt, ep, vocab = pc.nodes, pc.existing, pc.vocab
    hk = vocab.label_keys.lookup(HOSTNAME)
    tables = gang.batch_tables(pb.tsc_topo_key, pb.aff_topo_key, nt.label_vals, hk)
    d_cap = tables.pop("d_cap")
    kw = dict(hostname_key=hk, v_cap=bucket_cap(len(vocab.label_vals)),
              **{k: torch.as_tensor(v, device=device) for k, v in tables.items()})
    flags = dict(  # as the scheduler derives them (scheduler.py _gang_flags)
        has_interpod=bool((pb.aff_kind >= 0).any() or (ep.term_kind >= 0).any()),
        has_spread=bool((pb.tsc_topo_key >= 0).any()),
        has_images=bool((pb.img_ids >= 0).any()),
        has_ports=bool((pb.want_ppk >= 0).any() or (nt.used_ppk >= 0).any()),
    )
    dc = DeviceCluster.from_host(nt, vocab, device, ep)
    return dc, DeviceBatch.from_host(pb, device), kw, d_cap, flags, pb, nt


def gang_inputs(torch, device, nodes, placed, pending, P=512, mutate=None):
    """Pack a cluster with its placed pods and one pending batch through the
    port's packers, as the scheduler's mirror does, onto `device`.  Returns
    (dc, db, kwargs of precompute without the has_* flags, d_cap, flags)."""
    return _gang_pack(torch, device, nodes, placed, pending, P, mutate)[:5]


def wave_inputs(torch, device, nodes, placed, pending, P=512):
    """gang_inputs and the batch's wave tables (wave.wave_tables) on
    `device`."""
    from kubernetes_tpu_torch.ops import wave

    dc, db, kw, d_cap, flags, pb, nt = _gang_pack(torch, device, nodes, placed, pending, P)
    wt = wave.wave_tables(pb, nt.label_vals, kw["hostname_key"], device=device)
    if wt is None:
        raise AssertionError("the wave's inputs need unique hostnames")
    return dc, db, kw, d_cap, flags, wt


# ---------------------------------------------------------------------------
# Phase 2 inputs: K1's mixed cluster and signatures, K2's state
# ---------------------------------------------------------------------------


def k1_inputs(device, n_nodes=10000, seed=3):
    """A mixed cluster (NoSchedule / PreferNoSchedule / NoExecute taints,
    unschedulable nodes, numeric labels, images) and 16 signature
    representatives covering every toleration, NodeName, selector-op,
    preferred-term and image case."""
    from kubernetes_tpu_torch.api import (
        Affinity,
        Container,
        Node,
        NodeAffinity,
        NodeSelector,
        NodeSelectorRequirement as Req,
        NodeSelectorTerm as Term,
        Pod,
        PreferredSchedulingTerm,
        Resource,
        Taint,
        Toleration,
    )
    from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster
    from kubernetes_tpu_torch.snapshot.interner import Vocab
    from kubernetes_tpu_torch.snapshot.schema import pack_nodes, pack_pod_batch

    rng = random.Random(seed)
    effects = ["NoSchedule", "PreferNoSchedule", "NoExecute"]
    nodes = []
    for i in range(n_nodes):
        taints = tuple(
            Taint(key=rng.choice(["dedicated", "gpu", "spot"]), value=rng.choice(["a", "b", ""]),
                  effect=rng.choice(effects))
            for _ in range(rng.choice([0, 0, 1, 2]))
        )
        labels = {"kubernetes.io/hostname": f"k{i}", "zone": f"z{i % 4}", "gen": str(rng.randint(0, 9))}
        if rng.random() < 0.5:
            labels["disk"] = rng.choice(["ssd", "hdd"])
        if rng.random() < 0.1:
            labels["gen"] = "x"  # not an integer: Gt/Lt never match it
        images = {}
        for img in ("nginx:1", "redis:7", "pause:3"):
            if rng.random() < 0.3:
                images[img] = rng.choice([10, 200, 800, 1500]) << 20
        nodes.append(
            Node(
                name=f"k{i}",
                labels=labels,
                capacity=Resource.from_map({"cpu": "8", "memory": "32Gi", "pods": 110}),
                taints=taints,
                unschedulable=rng.random() < 0.05,
                images=images,
            )
        )

    def na(required=None, preferred=()):
        return Affinity(
            node_affinity=NodeAffinity(
                required_during_scheduling_ignored_during_execution=(
                    NodeSelector(tuple(required)) if required is not None else None
                ),
                preferred_during_scheduling_ignored_during_execution=tuple(preferred),
            )
        )

    c = [Container(name="c", requests={"cpu": "100m"})]
    pods = [
        Pod(name="plain", containers=c),
        Pod(name="tol-eq", containers=c, tolerations=(Toleration(key="dedicated", value="a"),)),
        Pod(name="tol-exists", containers=c, tolerations=(Toleration(key="gpu", operator="Exists"),)),
        Pod(name="tol-all", containers=c, tolerations=(Toleration(operator="Exists"),)),
        Pod(name="tol-pref", containers=c,
            tolerations=(Toleration(key="spot", operator="Exists", effect="PreferNoSchedule"),
                         Toleration(key="dedicated", value="b", effect="NoExecute"))),
        Pod(name="tol-unsched", containers=c,
            tolerations=(Toleration(key="node.kubernetes.io/unschedulable", operator="Exists",
                                    effect="NoSchedule"),)),
        Pod(name="nodename", containers=c, node_name="k17"),
        Pod(name="sel", containers=c, node_selector={"disk": "ssd"}),
        Pod(name="in-notin", containers=c,
            affinity=na([Term(match_expressions=(Req("zone", "In", ("z0", "z2")), Req("disk", "NotIn", ("hdd",))))])),
        Pod(name="exists-dne", containers=c,
            affinity=na([Term(match_expressions=(Req("disk", "Exists"),)),
                         Term(match_expressions=(Req("disk", "DoesNotExist"), Req("zone", "In", ("z1",))))])),
        Pod(name="gt-lt", containers=c,
            affinity=na([Term(match_expressions=(Req("gen", "Gt", ("3",)), Req("gen", "Lt", ("8",))))])),
        Pod(name="fields", containers=c,
            affinity=na([Term(match_fields=(Req("metadata.name", "In", ("k5",)),)),
                         Term(match_expressions=(Req("zone", "In", ("z3",)),))])),
        Pod(name="preferred", containers=c,
            affinity=na(preferred=[PreferredSchedulingTerm(5, Term(match_expressions=(Req("disk", "In", ("ssd",)),))),
                                   PreferredSchedulingTerm(3, Term(match_expressions=(Req("gen", "Gt", ("5",)),)))])),
        Pod(name="images", containers=c + [Container(name="d")], images=("nginx:1", "redis:7")),
        Pod(name="image-missing", containers=c, images=("busybox:1",)),
        Pod(name="everything", containers=c, node_selector={"zone": "z1"},
            tolerations=(Toleration(key="dedicated", operator="Exists"),),
            images=("pause:3",),
            affinity=na([Term(match_expressions=(Req("gen", "Lt", ("9",)),))],
                        [PreferredSchedulingTerm(7, Term(match_expressions=(Req("disk", "DoesNotExist"),)))])),
    ]
    vocab = Vocab()
    nt = pack_nodes(nodes, vocab)
    pb = pack_pod_batch(pods, vocab, k_cap=nt.k_cap, p_cap=16)
    return nt, DeviceCluster.from_host(nt, vocab, device), DeviceBatch.from_host(pb, device)


def k2_inputs(torch, device, nt, mask, P=4096, seed=5, S=None):
    """S signatures (one all-zero, one asking for an extended lane; by
    default one per row of K1's statics-feasible mask, more repeat its
    rows), a pod feed with -1 pads, and a usage state with overcommitted
    nodes."""
    g = torch.Generator().manual_seed(seed)
    N, R = nt.allocatable.shape
    S = mask.shape[0] if S is None else S
    mask = mask.cpu()[torch.arange(S) % mask.shape[0]]
    alloc = torch.as_tensor(nt.allocatable, dtype=torch.int64).clone()
    alloc[::7, R - 1] = 4  # an extended resource on every 7th node
    req = torch.zeros((S, R), dtype=torch.int64)
    req[:, 0] = torch.randint(0, 900, (S,), generator=g)
    req[:, 1] = torch.randint(0, 2048, (S,), generator=g)
    req[3] = 0  # all-zero signature
    req[5, R - 1] = 1  # extended lane
    nz = torch.stack([req[:, 0].clamp(min=100), req[:, 1].clamp(min=200)], dim=1)
    az = (req == 0).all(dim=1)
    used = (alloc * torch.randint(0, 60, (N, 1), generator=g)) // 100
    used[::11, 1] = alloc[::11, 1] + 1  # overcommitted memory
    used[::13, 2] = 5  # overcommitted ephemeral storage (allocatable 0)
    nz0 = used[:, 0].clamp(min=0).clone()
    nz1 = used[:, 1].clamp(min=0).clone()
    num_pods = torch.randint(0, 40, (N,), generator=g, dtype=torch.int32)
    img = torch.randint(0, 101, (S, N), generator=g)
    ids = torch.randint(0, S, (P,), generator=g, dtype=torch.int32)
    ids[torch.rand(P, generator=g) < 0.05] = -1
    ids[-64:] = -1
    allowed = torch.as_tensor(nt.allowed_pods, dtype=torch.int32)
    fixed = {
        "sig_ids": ids, "sig_req": req, "sig_nz": nz, "sig_allzero": az, "sig_ok": mask.cpu(),
        "sig_img": img, "alloc": alloc, "allowed": allowed,
    }
    state = {"used": used, "nz0": nz0, "nz1": nz1, "num_pods": num_pods}
    to = lambda d: {k: v.to(device).contiguous() for k, v in d.items()}  # noqa: E731
    return to(fixed), to(state)


def k4_inputs(torch, device, n_nodes=10000, P=16384, S=16, n_pads=384, seed=9):
    """config0's shape: bench.py's basic nodes in their 10240-node bucket, the
    nine north-star signatures (3 cpu x 3 memory requests) in a 16-row stack,
    a P-pod feed in the north-star order with a pad suffix, and a partly used
    cluster."""
    from kubernetes_tpu_torch.fastpath import signature_key
    from kubernetes_tpu_torch.snapshot.interner import Vocab
    from kubernetes_tpu_torch.snapshot.schema import ResourceLanes, pack_nodes

    vocab = Vocab()
    nt = pack_nodes(basic_nodes(n_nodes), vocab)
    N, R = nt.allocatable.shape
    lanes = ResourceLanes(vocab)
    sids, rows, ids = {}, [], []
    for pod in north_star_pods(P - n_pads):
        k = signature_key(pod, lanes, R)
        if k not in sids:
            sids[k] = len(rows)
            rows.append(k)
        ids.append(sids[k])
    ids += [-1] * n_pads
    req = torch.zeros((S, R), dtype=torch.int64)
    nz = torch.zeros((S, 2), dtype=torch.int64)
    ok = torch.zeros((S, N), dtype=torch.bool)
    for i, k in enumerate(rows):
        req[i] = torch.tensor(k[0])
        nz[i] = torch.tensor(k[1])
        ok[i] = torch.as_tensor(nt.valid)
    g = torch.Generator().manual_seed(seed)
    alloc = torch.as_tensor(nt.allocatable, dtype=torch.int64)
    used = torch.zeros_like(alloc)
    used[:, :2] = alloc[:, :2] * torch.randint(0, 60, (N, 1), generator=g) // 100
    fixed = {
        "sig_ids": torch.tensor(ids, dtype=torch.int32), "sig_req": req, "sig_nz": nz,
        "sig_allzero": (req == 0).all(dim=1), "sig_ok": ok,
        "sig_img": torch.zeros((S, N), dtype=torch.int64), "alloc": alloc,
        "allowed": torch.as_tensor(nt.allowed_pods, dtype=torch.int32),
    }
    state = {"used": used, "nz0": used[:, 0].clone(), "nz1": used[:, 1].clone(),
             "num_pods": torch.randint(0, 40, (N,), generator=g, dtype=torch.int32)}
    to = lambda d: {k: v.to(device).contiguous() for k, v in d.items()}  # noqa: E731
    return to(fixed), to(state)


def k4_interleaved(torch, fixed, P=4096, n_pads=64):
    """An adversarial feed over k4_inputs' cluster: two signatures on the
    even and the odd nodes, alternating, so the walk of each round follows
    the head's half and every round admits one pod until the adaptive stop
    hands the tail over."""
    fx = dict(fixed)
    ok = torch.zeros_like(fixed["sig_ok"])
    valid = fixed["sig_ok"][0]
    ok[0, 0::2] = valid[0::2]
    ok[1, 1::2] = valid[1::2]
    fx["sig_ok"] = ok
    ids = torch.arange(P, dtype=torch.int32, device=ok.device) % 2
    ids[P - n_pads :] = -1
    fx["sig_ids"] = ids
    return fx


def max_abs_err(torch, a, b) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def static_bound(dc, db, out, extra_bytes=0):
    """K1's bound_ms for one launch with outputs `out`: the cluster's and the
    batch's static tables (and `extra_bytes`, an extra-mask lane) read once,
    the outputs written once; operations, a
    full walk per (signature or pod, node) pair: taint × toleration
    compares for the filter and the score, each DNF requirement's value
    scan, the image terms."""
    S, N = out["mask"].shape
    in_bytes = nbytes(dc.node_labels, dc.val_ints, dc.taint_key, dc.taint_val, dc.taint_effect,
                      dc.unschedulable, dc.node_valid, dc.img_sizes, db.valid, db.pref_weight,
                      db.tol_key, db.tol_op, db.tol_val, db.tol_effect, db.target_name_val,
                      db.img_ids, db.n_containers,
                      *(getattr(t, f) for t in (db.node_sel, db.pref_node)
                        for f in ("req_key", "req_op", "req_vals", "req_rhs", "term_valid")))
    T, TL = dc.taint_key.shape[1], db.tol_key.shape[1]
    NT, NR, NV = db.node_sel.req_vals.shape[1:]
    PT, PR, PV = db.pref_node.req_vals.shape[1:]
    per_pair = 2 * T * TL * 8 + NT * NR * (NV + 8) + PT * PR * (PV + 8) + db.img_ids.shape[1] * 8 + 32
    return bound_ms(in_bytes + extra_bytes + nbytes(*out.values()), S * N * per_pair)


def precompute_static_bound(dc, db, has_images):
    """K1's bound_ms as the gang precompute launches it on a batch (every
    static plugin on)."""
    from kubernetes_tpu_torch.ops import fastpath as ops_fp

    every = frozenset({"NodeName", "NodeUnschedulable", "TaintToleration", "NodeAffinity"})
    return static_bound(dc, db, ops_fp.static_eval(dc, db, every, has_images))


def k2_row(torch, fixed, state0, w, reps, floor=True):
    """K2 against its plain version on one feed, exact on the choices and
    the final usage state, then the kernel's time, the plain version's, the
    bounds and (with `floor`) the step floor: the same launch over one
    node, so each step is only its fixed costs.  Logs and returns the row,
    and the kernel's final state."""
    from kubernetes_tpu_torch.ops import fastpath as ops_fp

    def fresh():
        return {k: v.clone() for k, v in state0.items()}

    def run(fn, st, fx=fixed):
        return fn(fx["sig_ids"], fx["sig_req"], fx["sig_nz"], fx["sig_allzero"], fx["sig_ok"], fx["sig_img"],
                  fx["alloc"], fx["allowed"], st["used"], st["nz0"], st["nz1"], st["num_pods"], **w)[0]

    scratch, st_p, plain_out = {}, fresh(), []

    def reset():
        for k, v in state0.items():
            scratch.setdefault(k, torch.empty_like(v)).copy_(v)

    # the plain version, timed once (host clock): its choices and state are
    # the check's
    out, plain_ms = timed_once(torch, lambda: run(ops_fp.sig_scan_plain, st_p))
    plain_out.append(out)
    st_k = fresh()
    ch_k = run(ops_fp.sig_scan, st_k)
    torch.cuda.synchronize() if ch_k.device.type == "cuda" else None
    err = max([max_abs_err(torch, ch_k, plain_out[-1])] + [max_abs_err(torch, st_k[k], st_p[k]) for k in st_k])
    if err:
        raise AssertionError("sig_scan kernel != plain version")
    ms = time_ms(torch, lambda: run(ops_fp.sig_scan, scratch), reps, setup=reset)
    # the scan's cycles a placed pod in the warp that repairs the pod's own
    # tree (the last, timed launch's): the chosen row, the keys, the
    # repairs, the barrier
    info = ops_fp.sig_scan_stats["info"].tolist()
    cycles = dict(zip(("row", "keys", "repairs", "barrier"), (round(c / max(info[0], 1)) for c in info[1:])))
    tree_smem = ops_fp.sig_scan_stats["tree_smem"]
    launches = ops_fp.sig_scan_stats["launches"]  # the kernels the timed call enqueued
    P = fixed["sig_ids"].shape[0]
    S = fixed["sig_req"].shape[0]
    live = int((fixed["sig_ids"] >= 0).sum().item())
    placed = int((ch_k >= 0).sum().item())
    trees = int(torch.unique(fixed["sig_ids"][fixed["sig_ids"] >= 0]).numel())
    Nn, R = fixed["alloc"].shape
    n1, _ = ops_fp.tree_entries(Nn)
    # bytes: each input read once, the usage state written once, the
    # choices; operations: a key (fit and score) is ~R * 4 + 40, and the
    # design needs one per (present signature, node) to build the trees,
    # one per present signature per placed pod, and the chosen tree's
    # re-reductions of its group (32 entries) and its root (n1), 4
    # operations an entry; a full re-score per pod, the reference's step,
    # is the upper count kept for comparison
    k2_bytes = nbytes(*fixed.values()) + 2 * nbytes(*state0.values()) + P * 4
    key_ops = R * 4 + 40
    bound, by = bound_ms(k2_bytes, (trees * Nn + placed * trees) * key_ops + placed * (32 + n1) * 4)
    full_bound, _ = bound_ms(k2_bytes, live * Nn * key_ops)
    row = dict(P=P, S=S, live_pods=live, trees=trees, N=Nn, placed=placed, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=by, us_per_placed_pod=ms * 1e3 / max(placed, 1),
               tree_smem=tree_smem, cycles_per_placed_pod=cycles, kernel_launches_per_call=launches)
    # computed, not measured: logged beside the row, kept out of the kernels line
    derived = dict(full_rescore_bound_ms=full_bound, bytes_bound_ms=k2_bytes / PEAK_BYTES_S * 1e3, tree_groups=n1)
    if floor:
        one = {k: (v[:, :1].contiguous() if k in ("sig_ok", "sig_img") else
                   v[:1].contiguous() if k in ("alloc", "allowed") else v) for k, v in fixed.items()}
        st1 = {k: v[:1].clone() for k, v in state0.items()}
        row["step_floor_ms"] = time_ms(torch, lambda: run(ops_fp.sig_scan, st1, one), reps)
    log(phase="kernel_check", kernel="sig_scan", **row, **derived)
    return row, st_k


def phase_kernels(torch, device, n_nodes=10000, reps=20):
    from kubernetes_tpu_torch.ops import fastpath as ops_fp
    from kubernetes_tpu_torch.ops import resident as ops_res

    enabled = frozenset({"NodeName", "NodeUnschedulable", "TaintToleration", "NodeAffinity"})
    nt, dc, db = k1_inputs(device, n_nodes)

    # K1 ------------------------------------------------------------------
    got = ops_fp.static_eval(dc, db, enabled, True)
    want = ops_fp.static_eval_plain(dc, db, enabled, True)
    k1_err = max(max_abs_err(torch, got[k], want[k]) for k in ops_fp.STATIC_KEYS)
    if k1_err:
        bad = [k for k in ops_fp.STATIC_KEYS if max_abs_err(torch, got[k], want[k])]
        raise AssertionError(f"static_eval kernel != plain version on {bad}")
    k1_ms = time_ms(torch, lambda: ops_fp.static_eval(dc, db, enabled, True), reps)
    k1_plain_ms = time_ms(torch, lambda: ops_fp.static_eval_plain(dc, db, enabled, True), 3)
    S, N = got["mask"].shape
    k1_bound, k1_by = static_bound(dc, db, got)
    log(phase="kernel_check", kernel="static_eval", shape=[S, N], max_abs_err=k1_err,
        ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound, bound_by=k1_by)

    # K2 ------------------------------------------------------------------
    w = dict(w_fit=1, w_bal=1, w_img=1, check_fit=True)
    k2, st_k = k2_row(torch, *k2_inputs(torch, device, nt, got["mask"]), w, reps)
    k2_wide, _ = k2_row(torch, *k2_inputs(torch, device, nt, got["mask"], S=512), w, reps, floor=False)
    Nn = st_k["used"].shape[0]

    # K3 ------------------------------------------------------------------
    args = (st_k["used"], st_k["nz0"], st_k["nz1"], st_k["num_pods"])
    k3 = ops_res.usage_checksum(*args)
    k3_plain = ops_res.usage_checksum_plain(*args)
    k3_err = max_abs_err(torch, k3.reshape(1), k3_plain.reshape(1))
    if k3_err:
        raise AssertionError("usage_checksum kernel != plain version")
    flat = torch.cat([a.reshape(-1).to(torch.int64) for a in args])
    if int(flat.sum().item()) != int(k3.item()):
        raise AssertionError("usage_checksum != torch.sum of the same values")
    k3_ms = time_ms(torch, lambda: ops_res.usage_checksum(*args), reps)
    k3_plain_ms = time_ms(torch, lambda: ops_res.usage_checksum_plain(*args), reps)
    k3_lib_ms = time_ms(torch, lambda: torch.sum(flat), reps)
    k3_bound, k3_by = bound_ms(nbytes(*args) + 8, sum(a.numel() for a in args))
    log(phase="kernel_check", kernel="usage_checksum", N=Nn, max_abs_err=k3_err, ms=k3_ms,
        plain_ms=k3_plain_ms, torch_sum_ms=k3_lib_ms, bound_ms=k3_bound, bound_by=k3_by)

    return {
        "static_eval": dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound,
                            bound_by=k1_by, library_ms=None),
        "sig_scan": dict(k2, max_abs_err=max(k2["max_abs_err"], k2_wide["max_abs_err"]), library_ms=None, s512=k2_wide),
        "usage_checksum": dict(max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound,
                               bound_by=k3_by, library_ms=k3_lib_ms),
    }


def phase_resident(torch, device, reps=5, n_nodes=10000, P=16384, P_adv=4096):
    """K4 against its plain version on the card, in both tail modes, on the
    config0-shaped run and on the interleaved feed that makes the adaptive
    stop fire; K4's time in the default (host-tail) mode."""
    from kubernetes_tpu_torch.ops import resident as ops_res

    fixed, state0 = k4_inputs(torch, device, n_nodes=n_nodes, P=P)
    N, R = fixed["alloc"].shape
    S = fixed["sig_req"].shape[0]
    W = min(2048, N)
    w = dict(w_fit=1, w_bal=1, w_img=0, check_fit=True, window=W)

    def run(fn, fx, st, serial_tail, wk=w):
        return fn(fx["sig_ids"], fx["sig_req"], fx["sig_nz"], fx["sig_allzero"], fx["sig_ok"],
                  fx["sig_img"], fx["alloc"], fx["allowed"], st["used"], st["nz0"], st["nz1"],
                  st["num_pods"], **wk, serial_tail=serial_tail)

    def check(label, fx, serial_tail, st0=state0, weights=None):
        wk = dict(w, **(weights or {}))
        outs = []
        for fn in (ops_res.resident_run, ops_res.resident_run_plain):
            st = {k: v.clone() for k, v in st0.items()}
            ch, _, stats = run(fn, fx, st, serial_tail, wk)
            outs.append((ch, st, stats))
        if device.type == "cuda":
            torch.cuda.synchronize()
        (ck, sk, tk), (cp, sp, tp) = outs
        err = max([max_abs_err(torch, ck, cp), max_abs_err(torch, tk, tp)]
                  + [max_abs_err(torch, sk[k], sp[k]) for k in sk])
        if err:
            raise AssertionError(f"resident_run kernel != plain version ({label}, serial_tail={serial_tail})")
        rounds, q, tail_left = tk.tolist()
        row = dict(case=label, P=int(fx["sig_ids"].shape[0]), N=N, S=S, W=W, serial_tail=serial_tail,
                   rounds=rounds, resolved=q, tail_left=tail_left,
                   unresolved=int((ck == ops_res.UNRESOLVED).sum()), placed=int((ck >= 0).sum()),
                   nodes_written=int((sk["num_pods"] != st0["num_pods"]).sum()), max_abs_err=err,
                   **{k: wk[k] for k in ("w_fit", "w_bal", "w_img")})
        log(phase="kernel_check", kernel="resident_run", **row)
        return row

    adv = k4_interleaved(torch, fixed, P=P_adv)
    one = dict(fixed, sig_ids=fixed["sig_ids"].clamp(max=0))  # one signature: full windows
    rows = [check("config0", fixed, st) for st in (False, True)]
    rows += [check("interleaved", adv, st) for st in (False, True)]
    rows += [check("one_signature", one, st) for st in (False, True)]
    if not all(r["tail_left"] for r in rows[2:4]):
        raise AssertionError("the interleaved feed did not stop the fixed point early")
    # why north-star runs stop early: the same feed on config0's empty
    # cluster (the drain's first run) with each score term switched off
    empty = {k: torch.zeros_like(v) for k, v in state0.items()}
    for wf, wb in ((1, 1), (1, 0), (0, 1), (0, 0)):
        check("config0_empty", fixed, False, st0=empty, weights=dict(w_fit=wf, w_bal=wb))

    scratch = {}

    def reset():
        for k, v in state0.items():
            scratch.setdefault(k, torch.empty_like(v)).copy_(v)

    def bounds(fx, row):
        """K4's bound for one run: (once, per_round).  Bytes: each input
        that this run's data needs read once (the rows of the signatures in
        the feed; sig_img only when ImageLocality is scored), the choices
        written once and the committed nodes' usage rows written once;
        per_round also reads the static rows and the usage state again in
        every round, as one [S, N] key pass per round does.  Operations:
        per round the key formulas for the live signatures over N nodes and
        over the W window slots, plus a sort's N log2 N compares."""
        ids = fx["sig_ids"]
        s_live = int(ids[ids >= 0].unique().numel())
        row_bytes = s_live * N * (fx["sig_ok"].element_size()
                                  + (fx["sig_img"].element_size() if w["w_img"] else 0))
        sig_bytes = s_live * (R * 8 + 2 * 8 + 1)
        static = row_bytes + sig_bytes + nbytes(fx["alloc"], fx["allowed"])
        state = nbytes(*state0.values())
        out = ids.numel() * 4 + row["nodes_written"] * (R * 8 + 8 + 8 + 4) + 3 * 8
        ops = row["rounds"] * ((s_live * N + W * s_live) * (R * 4 + 40) + N * max(1, N.bit_length()))
        once = bound_ms(nbytes(ids) + static + state + out, ops)
        per_round = bound_ms(nbytes(ids) + row["rounds"] * (static + state) + out, ops)
        return once, per_round

    ms = time_ms(torch, lambda: run(ops_res.resident_run, fixed, scratch, False), reps, setup=reset)
    plain_ms = time_ms(torch, lambda: run(ops_res.resident_run_plain, fixed, scratch, False), 1, setup=reset)
    # full windows: the one-signature feed resolves the whole run in rounds
    one_ms = time_ms(torch, lambda: run(ops_res.resident_run, one, scratch, False), reps, setup=reset)
    one_plain_ms = time_ms(torch, lambda: run(ops_res.resident_run_plain, one, scratch, False), 1, setup=reset)
    (bound, by), (round_bound, round_by) = bounds(fixed, rows[0])
    (one_bound, one_by), (one_round_bound, one_round_by) = bounds(one, rows[4])
    log(phase="kernel_time", kernel="resident_run", case="config0", serial_tail=False, rounds=rows[0]["rounds"],
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, round_bound_ms=round_bound,
        round_bound_by=round_by, library_ms=None)
    log(phase="kernel_time", kernel="resident_run", case="one_signature", serial_tail=False,
        rounds=rows[4]["rounds"], ms=one_ms, plain_ms=one_plain_ms, bound_ms=one_bound, bound_by=one_by,
        round_bound_ms=one_round_bound, round_bound_by=one_round_by)
    return dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
                rounds=rows[0]["rounds"], round_bound_ms=round_bound, round_bound_by=round_by,
                one_signature_ms=one_ms, one_signature_rounds=rows[4]["rounds"],
                one_signature_bound_ms=one_bound)


def place_round_robin(pods, nodes):
    """Bind `pods` to `nodes` in turn (the placed pods of a kernel check)."""
    for i, p in enumerate(pods):
        p.node_name = nodes[i % len(nodes)].name
    return pods


def gang_shapes(n_config4=5000, n_config3=1000, n_mixed=5000, n_preferred=10000, P=512):
    """The four full-width shapes of the gang kernel checks: (name, nodes,
    placed pods, pending pods).  Placed pods are bound round-robin.  The
    last is the first batch of the preferred-affinity drain: config0's
    nodes with tier labels and no placed pods (K1, K7's port masks, K5)."""
    place = place_round_robin
    c4 = basic_nodes(n_config4, zones=8)
    c3 = basic_nodes(n_config3)
    # a tenth as many placed pods as nodes: their required anti-affinity
    # over three zones would otherwise leave no node for most pods
    mixed = gen_cluster(5, n_mixed, n_mixed // 10, P)
    return [
        ("config4", c4, place(spread_pods(9 * n_config4, prefix="placed"), c4), spread_pods(P, prefix="new")),
        ("config3", c3, place(interpod_pods(9 * n_config3 // 2, prefix="placed"), c3),
         interpod_pods(P, prefix="new")),
        ("mixed", *mixed),
        ("preferred", tier_nodes(n_preferred), [], preferred_pods(P)),
    ]


# The GangStatics fields each kernel of the gang precompute writes (the
# rest are torch expressions of the batch's own fields).
K1_FIELDS = ("static_mask", "sc_taint", "sc_nodeaff", "sc_image", "d_nodename", "d_unsched", "d_taints",
             "d_nodeaff")
K6_FIELDS = ("sp_dv", "sp_te", "sp_dom_cnt", "sp_dom_pres", "sp_ndom", "sp_self", "sp_bmatch", "sp_counting",
             "sp_node_cnt", "sp_sc_dom", "sp_all_keys", "sp_cdv")
K7_FIELDS = ("ip_dv", "ip_dom_cnt", "ip_viol_existing", "ip_sym", "ip_any_static", "ip_self_all", "ip_bmatch",
             "d_ports", "port_b")


def _live(t) -> int:
    return int((t >= 0).sum().item())


def k5_bytes(torch, dc, db, g, chosen, n_feas, weights) -> int:
    """The bytes gang_schedule must move for this run's data, each read
    once: the [P, N] rows of the valid pods at the valid nodes; a spread
    slot's rows (sp_node_cnt for a hostname constraint, sp_sc_dom for the
    others) and an inter-pod slot's only where the slot is live; the score
    rows only at each pod's feasible nodes; sp_counting only at the nodes
    of the matching committed peers; the batch-peer match rows only at
    committed peers j < p; one compact-domain row per topology key in use;
    the cluster's usage rows once; the outputs once."""
    P, N = g.static_mask.shape
    C, AT, JP = g.sp_dv.shape[1], g.ip_dv.shape[1], g.port_b.shape[1]
    valid = db.valid
    n_live = int(dc.node_valid.sum().item())
    p_live = int(valid.sum().item())
    placed = chosen >= 0
    idx = torch.arange(P, device=valid.device)
    peers = (idx[None, :] < idx[:, None]) & placed[None, :] & valid[:, None]  # [p, j]: j < p, committed
    n_peers = peers.sum(1)
    sp_live = (db.tsc_topo[:, :C] >= 0) & valid[:, None]
    ip_live = (db.aff_kind[:, :AT] >= 0) & valid[:, None]
    b = p_live * n_live * 7  # static_mask and the six d_* rows
    b += int(n_feas.sum().item()) * (8 * (weights[0] != 0) + 8 * (weights[1] != 0) + 8 * (weights[6] != 0)
                                    + (1 if C else 0))  # sc_taint, sc_nodeaff, sc_image, sp_all_keys
    b += int(sp_live.sum().item()) * n_live * (1 + 1 + 4 + 4)  # sp_te, sp_dom_pres, sp_dom_cnt, one count row
    b += int((sp_live * n_peers[:, None]).sum().item())  # sp_bmatch at committed peers
    m = g.sp_bmatch & peers[:, None, :] & (sp_live & ~g.sp_is_host)[:, :, None]
    pc, j = m.reshape(P * C, P).nonzero(as_tuple=True)
    b += int(torch.unique(pc.long() * N + chosen[j].long()).numel())  # sp_counting at the peers' nodes
    b += int(ip_live.sum().item()) * n_live * 4  # ip_dom_cnt
    b += int((ip_live * n_peers[:, None]).sum().item())  # ip_bmatch rows at committed peers
    b += int((peers.sum(0) * ip_live.sum(1)).sum().item())  # the peers' own terms against later pods
    if AT:
        b += p_live * n_live * (1 + 8)  # ip_viol_existing, ip_sym
    if JP:
        b += int(n_peers.sum().item())  # port_b at committed peers
    keys = torch.cat([db.tsc_topo[:, :C][sp_live], db.aff_topo[:, :AT][ip_live]])
    b += int(torch.unique(keys).numel()) * n_live * 4  # dom_ids rows
    b += nbytes(g.sp_hard, g.sp_soft, g.sp_ndom, g.sp_self, g.sp_is_host, g.ip_any_static, g.ip_self_all,
                g.ip_is_aff, g.ip_is_anti, g.ip_pref_w, g.ip_sym_w, g.ip_key_idx, db.requests, db.nonzero_req,
                db.valid) + P * C * 8  # per-pod and per-slot values, max_skew, min_domains
    Rn = dc.allocatable.shape[1]
    b += n_live * (2 * Rn * 4 + 8 + 4 + 4 + 1)  # allocatable, requested, nonzero, num_pods, allowed, valid
    b += P * (4 + 8 + 9 * 8) + int(placed.sum().item()) * (Rn * 4 + 12)  # outputs and the commits
    return b


def gang_bounds(torch, dc, db, g, chosen, n_feas, weights):
    """(K6, K7, K5) bound_ms from this run's inputs: each input read once,
    each output written once, over the card's memory rate, against the
    integer operations these inputs need over its integer issue rate.  Operation
    counts: a selector evaluation costs R * (V + 4) compares per live
    requirement table; only valid placed pods, live terms and live
    constraint slots are counted."""
    N, K = dc.node_labels.shape
    P, C = db.tsc_topo.shape
    AT = db.aff_kind.shape[1]
    e_live = int(dc.epod_valid.sum().item())
    m_live = _live(dc.term_kind)
    c_live = _live(db.tsc_topo)
    at_live = _live(db.aff_kind)
    _, _, R, V = db.tsc_table.req_vals.shape
    _, _, AR, AV = db.aff_table.req_vals.shape
    _, _, TR, TV = dc.term_table.req_vals.shape
    epods = nbytes(dc.epod_node, dc.epod_ns, dc.epod_labels, dc.epod_valid, dc.epod_deleting)
    sp_out = nbytes(*(getattr(g, f) for f in K6_FIELDS))
    k6 = bound_ms(nbytes(dc.node_labels, dc.dom_ids, db.labels, db.tsc_topo, db.tsc_hard) + epods
                  + nbytes(*(getattr(db.tsc_table, f) for f in ("req_key", "req_op", "req_vals", "req_rhs")))
                  + 2 * P * N + sp_out,
                  c_live * (e_live + P) * (R * (V + 4) + 8) + P * C * N * (4 * C + 20))
    ip_out = nbytes(*(getattr(g, f) for f in K7_FIELDS))
    terms = nbytes(dc.term_pod, dc.term_kind, dc.term_topo, dc.term_weight, dc.term_ns_all, dc.term_ns_ids,
                   *(getattr(dc.term_table, f) for f in ("req_key", "req_op", "req_vals", "req_rhs")))
    k_live = sum(1 for c in dc.dom_counts if c)
    W, U = db.want_ppk.shape[1], dc.used_ppk.shape[1]
    k7 = bound_ms(nbytes(dc.node_labels, dc.dom_ids, db.labels, db.aff_kind, db.aff_topo, db.want_ppk,
                         dc.used_ppk) + epods + terms + ip_out,
                  P * m_live * (TR * (TV + 4) + 12) + at_live * (e_live + P) * (AR * (AV + 4) + 12)
                  + P * N * (4 * k_live + W * U * 6) + P * P * W * W * 6)
    p_live = int(db.valid.sum().item())
    n_live = int(dc.node_valid.sum().item())
    KD2 = g.ip_key_cols.shape[0]
    Rp = db.requests.shape[1]
    slots = int(((db.tsc_topo[:, :g.sp_dv.shape[1]] >= 0) & db.valid[:, None]).sum().item())
    terms_live = int(((db.aff_kind[:, :g.ip_dv.shape[1]] >= 0) & db.valid[:, None]).sum().item())
    k5_ops = n_live * (p_live * (KD2 * 4 + Rp * 3 + 80) + (slots + terms_live) * 12) \
        + p_live * p_live // 2 * (C + 2 * AT) * 6
    return k6, k7, bound_ms(k5_bytes(torch, dc, db, g, chosen, n_feas, weights), k5_ops)


def ext_bound(dc, db, out):
    """K7's placed terms against the batch (the terms kernel and ext) as
    bound_ms: the bytes of its outputs (ip_viol_existing, ip_sym) and of the
    live placed terms' records and tables read once, against the
    operations of the term selectors (R * (V + 4) + 12 per live term and
    pod) and of the node sums (4 per node, pod and used key)."""
    P = db.valid.shape[0]
    N = dc.node_labels.shape[0]
    m_live = _live(dc.term_kind)
    _, _, TR, TV = dc.term_table.req_vals.shape
    live = dc.term_kind >= 0
    keys = int(dc.term_topo[live].unique().numel())
    terms = m_live * (4 * 4 + 4 * (3 * TR + TR * TV) + 1 + 4 * dc.term_ns_ids.shape[1])
    return bound_ms(nbytes(out["ip_viol_existing"], out["ip_sym"]) + terms,
                    P * m_live * (TR * (TV + 4) + 12) + P * N * 4 * keys)


def ports_bound(db, dc, out):
    """K7's port kernel as bound_ms: d_ports and port_b written once, the
    wanted and used port tables read once, against 6 operations per
    (wanted, used) pair of every (pod, node) and (pod, peer)."""
    P, W = db.want_ppk.shape
    N, U = dc.used_ppk.shape
    return bound_ms(nbytes(out["d_ports"], out["port_b"], db.want_ppk, db.want_ip, db.want_wild, dc.used_ppk,
                           dc.used_ip, dc.used_wild), P * N * W * U * 6 + P * P * W * W * 6)


def k5_cluster(torch, db, ms):
    """K5's cluster beside its time `ms` (its last launch was the timed
    one): the CTAs, the cluster-wide exchanges per valid pod (mbarrier
    exchanges, or cluster barriers where the exchange slab lies in global
    memory), the microseconds per valid pod, whether the pods' planes were
    staged in shared memory, and the rank-0 leader's cycles per pod in each
    phase: for each of the pod's exchanges (with spread slots the
    min-match, the filter's counts, the spread normalizers, the argmax;
    without them the counts and the argmax; the window's after the counts)
    the work before it, its pushes and its wait, then the commit (last)."""
    from kubernetes_tpu_torch.ops import gang

    torch.cuda.synchronize()
    pods = max(int(db.valid.sum().item()), 1)
    info = gang.scan_stats["info"].tolist()
    return dict(cluster=info[0], exchanges_per_pod=info[1] / pods, us_per_pod=ms * 1e3 / pods,
                staged=gang.scan_stats["staged"], leader_cycles_per_pod=[round(16 * c / pods) for c in info[2:]])


def k5_capped(torch, fn, cap):
    """fn() with K5's cluster capped at `cap` CTAs; (its result, the CTAs
    its last K5 launch took)."""
    from kubernetes_tpu_torch.ops import gang

    old = gang.SCAN_CLUSTER_CAP
    gang.SCAN_CLUSTER_CAP = cap
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, gang.scan_stats["cluster"]
    finally:
        gang.SCAN_CLUSTER_CAP = old


def without_own_terms(db):
    """`db` with its pods' own inter-pod term axis cut to width 0 (AT = 0):
    K7 then launches ext_kernel alone (the placed pods' terms against the
    pods), whose outputs do not read that axis."""
    import dataclasses

    def cut(t):
        return t[:, :0].contiguous()

    tab = db.aff_table
    tab = dataclasses.replace(tab, **{f.name: cut(getattr(tab, f.name)) for f in dataclasses.fields(tab)})
    return dataclasses.replace(db, aff_table=tab, **{k: cut(getattr(db, k)) for k in (
        "aff_kind", "aff_topo", "aff_weight", "aff_ns_all", "aff_ns_ids")})


def phase_gang_kernels(torch, device, reps=5, shapes=None, wave_on=("config4", "config3"), nominated=("config4",)):
    """K5, K6 and K7 against their plain versions on the card: precompute
    (K1 + K6 + K7) against precompute_plain on every one of the 39
    GangStatics fields, and gang_schedule (K5) against its plain loop on
    chosen, n_feas, the reason counts and the tallies, all exact.  Then each
    kernel's time, its plain version's, its bound, and (K7) the float64
    torch.matmul of interpod_weighted_ext's product at the same shapes.  On
    the shapes named in `wave_on`, also K8 and K9 (wave_row) on the same
    packed inputs and plain statics, beside K5's outputs and time; on those
    also named in `nominated`, K5, K8 and K9 with 64 open nominations
    (nominated_row, kept in the wave row under "nominated").  Returns (gang
    rows, wave rows) by shape name."""
    from kubernetes_tpu_torch.ops import fastpath as ops_fp
    from kubernetes_tpu_torch.ops import filters as F
    from kubernetes_tpu_torch.ops import gang, wave

    rows, waves = {}, {}
    for name, nodes, placed, pending in (shapes or gang_shapes()):
        dc, db, kw, d_cap, flags, pb, nt = _gang_pack(torch, device, nodes, placed, pending, 512)
        hk, v_cap = kw["hostname_key"], kw["v_cap"]
        tab = {k: kw[k] for k in ("sp_keys", "sp_cdv_tab", "ip_keys")}
        got = gang.precompute(dc, db, **kw, **flags)
        want = gang.precompute_plain(dc, db, hk, v_cap, hard_pod_affinity_weight=1, enabled=gang.ALL_FILTER_KERNELS,
                                     **flags, **tab)
        errs = {f: max_abs_err(torch, getattr(got, f), getattr(want, f)) for f in gang.GangStatics._fields}
        if any(errs.values()):
            raise AssertionError(f"{name}: precompute kernels != plain on {[f for f, e in errs.items() if e]}")
        ck, nk, rk, tk = gang.gang_schedule(dc, db, want, v_cap, d_cap=d_cap)
        (cp, np_, rp, tp), k5_plain_ms = timed_once(torch, lambda: gang.gang_schedule_plain(dc, db, want, v_cap,
                                                                                             d_cap=d_cap))
        k5_err = max([max_abs_err(torch, ck, cp), max_abs_err(torch, nk, np_), max_abs_err(torch, rk, rp)]
                     + [max_abs_err(torch, tk[k], tp[k]) for k in tk])
        if k5_err:
            raise AssertionError(f"{name}: gang_scan kernel != plain")
        st = ops_fp.static_eval_plain(dc, db, frozenset({"TaintToleration", "NodeAffinity"}), False)
        naff, taints = st["m_nodeaff"], st["m_taints"]
        row = dict(shape=name, N=int(dc.node_valid.sum().item()), P=int(db.valid.sum().item()),
                   placed=int(dc.epod_valid.sum().item()), terms=_live(dc.term_kind),
                   scheduled=int((ck >= 0).sum().item()), k1_err=max(errs[f] for f in K1_FIELDS),
                   k6_err=max(errs[f] for f in K6_FIELDS), k7_err=max(errs[f] for f in K7_FIELDS),
                   k5_err=k5_err, **flags)
        (b6, by6), (b7, by7), (b5, by5) = gang_bounds(torch, dc, db, want, cp, np_, gang.DEFAULT_WEIGHTS)
        # the composites' parts: K1 and K7 as the precompute launches them
        row["static_eval_bound_ms"] = precompute_static_bound(dc, db, flags["has_images"])[0]
        row["k6_bound_ms"], row["k7_bound_ms"] = b6, b7
        k5 = lambda: gang.gang_schedule(dc, db, want, v_cap, d_cap=d_cap)  # noqa: E731
        k5_ms = time_ms(torch, k5, reps)
        row["gang_scan"] = dict(
            ms=k5_ms, plain_ms=k5_plain_ms,
            bound_ms=b5, bound_by=by5, library_ms=None, **k5_cluster(torch, db, k5_ms))
        # the same statics on a cluster of 8 CTAs, exact too
        (c8, n8, r8, t8), ctas = k5_capped(torch, k5, 8)
        err8 = max([max_abs_err(torch, c8, cp), max_abs_err(torch, n8, np_), max_abs_err(torch, r8, rp)]
                   + [max_abs_err(torch, t8[k], tp[k]) for k in tp])
        if err8 or ctas != 8:
            raise AssertionError(f"{name}: K5 ({ctas} CTAs) differs from its plain version by {err8}")
        ms8, _ = k5_capped(torch, lambda: time_ms(torch, k5, reps), 8)
        row["gang_scan"]["cluster8"] = dict(k5_cluster(torch, db, ms8), ms=ms8, max_abs_err=err8)
        if flags["has_spread"]:
            k6_ms = time_ms(torch, lambda: gang.spread_statics(dc, db, naff, taints, hk), reps)
            row["gang_spread_statics"] = dict(
                ms=k6_ms, span_us=gang.statics_spans("spread"),
                plain_ms=time_ms(torch, lambda: gang.spread_statics_plain(dc, db, naff, taints, hk, v_cap,
                                                                          tab["sp_keys"], tab["sp_cdv_tab"]), 1),
                bound_ms=b6, bound_by=by6, library_ms=None)
        # the launch every config4 batch makes (NodePorts on, no inter-pod
        # terms): K7's port kernel alone
        ports = lambda: gang.interpod_statics(dc, db, do_interpod=False, do_ports=True)  # noqa: E731
        got_p = ports()
        want_p = gang.port_masks_plain(dc, db)
        ports_err = max(max_abs_err(torch, got_p[k], w) for k, w in zip(("d_ports", "port_b"), want_p))
        if ports_err:
            raise AssertionError(f"{name}: K7's ports-only launch differs from port_masks_plain ({ports_err})")
        row["k7_err"] = max(row["k7_err"], ports_err)
        row["k7_ports_only"] = dict(ms=time_ms(torch, ports, reps), span_us=gang.statics_spans("interpod")["ports"],
                                    bound_ms=ports_bound(db, dc, got_p)[0], max_abs_err=ports_err)
        if flags["has_interpod"]:
            pre = F.interpod_precompute(dc, db)
            w = torch.ones_like(dc.term_kind, dtype=torch.float64)
            lhs = (pre.ext_match.to(torch.float64) * w[:, None]).T.contiguous()
            rhs = pre.ext_topo_eq.to(torch.float64).contiguous()
            # ext alone (inter-pod on, AT = 0, ports off: the terms kernel and
            # ext): the part of K7 that computes what the matmul does, exact
            # against the full launch's ip_viol_existing and ip_sym
            db0 = without_own_terms(db)
            ext = gang.interpod_statics(dc, db0, do_interpod=True, do_ports=False)
            full = gang.interpod_statics(dc, db, do_interpod=True, do_ports=True)
            torch.cuda.synchronize()
            ext_err = max(max_abs_err(torch, ext[k], full[k]) for k in ("ip_viol_existing", "ip_sym"))
            if ext_err:
                raise AssertionError(f"{name}: ext_kernel alone differs from the full K7 launch ({ext_err})")
            k7_ms = time_ms(torch, lambda: gang.interpod_statics(dc, db, do_interpod=True, do_ports=True), reps)
            k7_span = gang.statics_spans("interpod")
            ext_ms = time_ms(torch, lambda: gang.interpod_statics(dc, db0, do_interpod=True, do_ports=False), reps)
            ext_span = gang.statics_spans("interpod")
            be, bye = ext_bound(dc, db, full)
            row["gang_interpod_statics"] = dict(
                ms=k7_ms, span_us=k7_span,
                plain_ms=time_ms(torch, lambda: (gang.interpod_statics_plain(dc, db, v_cap, tab["ip_keys"]),
                                                 gang.port_masks_plain(dc, db)), 1),
                bound_ms=b7, bound_by=by7, library_ms=time_ms(torch, lambda: torch.matmul(lhs, rhs), reps),
                library_call=f"torch.matmul float64 [{lhs.shape[0]}, {lhs.shape[1]}] x [{rhs.shape[0]}, {rhs.shape[1]}]",
                ext_kernel_alone_ms=ext_ms, ext_kernel_alone_span_us=ext_span, ext_kernel_alone_bound_ms=be,
                ext_kernel_alone_bound_by=bye, ext_kernel_alone_err=ext_err)
        log(phase="gang_kernel_check", **row)
        rows[name] = row
        if name in wave_on:
            wt = wave.wave_tables(pb, nt.label_vals, hk, device=device)
            if wt is None or wt["has_ports"] or flags["has_ports"]:
                raise AssertionError(f"{name}: a wave check on the gang inputs needs unique hostnames, no ports")
            waves[name] = wave_row(torch, name, dc, db, kw, d_cap, flags, wt, reps, g=want,
                                   k5=(ck, nk, rk, row["gang_scan"]["ms"]))
            if name in nominated:
                waves[name]["nominated"] = nominated_row(torch, name, dc, db, kw, d_cap, want, wt, reps)
    return rows, waves


def wave_shapes(n_ports=1000, n_mixed=5000, P=512):
    """The wave kernel checks' shapes beyond config4's and config3's (those
    run in phase_gang_kernels on its own inputs): (name, nodes, placed pods,
    pending pods).  A port-contended batch over placed port holders (Tpt >
    0), and a tests/gen.py-style mixed batch without host ports, on which K9
    must also equal K5."""
    cp = basic_nodes(n_ports, zones=4)
    return [
        ("ports", cp, place_round_robin(port_heavy_pods(n_ports, seed=3, prefix="placed"), cp),
         port_heavy_pods(P, seed=7)),
        ("mixed", *gen_cluster(5, n_mixed, n_mixed // 10, P, ports_from=P)),
    ]


WAVE_TABLES = ("tid_sp", "rep_sp_p", "rep_sp_c", "tid_ip", "rep_ip_p", "rep_ip_u", "ip_cdv_tab")


# Lane operations counted for one int64 floor division: the card has no
# integer divide instruction, and the shortest sequence the compiler emits
# for one (both operands in 32 bits, as the scores' are) is a float
# reciprocal estimate and its integer fix-ups, about 20 instructions (I2F,
# MUFU.RCP, F2I, five IMADs, the compares and corrections).  A convention
# for the bound, not a measurement.
DIV64_OPS = 20


def k8_ops(db, g, spec_feas, weights):
    """K8's integer operations from this run's inputs: per (live pod, live
    node) the filter's compares and ANDs (mask, port lane, the pod count
    and 3 per request lane, 8 per live spread slot and per live inter-pod
    term); per speculatively feasible node the normalizers' counts (12),
    the spread raw (6 + 4 per live slot) and the weighted total with its
    argmax (30) plus its int64 floor divisions: one each for the taint,
    node-affinity, spread and inter-pod scores when weighted, three for
    LeastAllocated (a lane's fraction each, their mean) and one for
    BalancedAllocation.  Returns (operations, divisions)."""
    C, AT = g.sp_dv.shape[1], g.ip_dv.shape[1]
    valid = db.valid
    sp_live = ((db.tsc_topo[:, :C] >= 0) & valid[:, None]).sum(1)
    ip_live = ((db.aff_kind[:, :AT] >= 0) & valid[:, None]).sum(1)
    n_live = int(g.static_mask.shape[1])
    Rp = db.requests.shape[1]
    divs = (int(weights[0] != 0) + int(weights[1] != 0) + int(weights[2] != 0 and C > 0) + int(weights[3] != 0 and AT > 0)
            + 3 * int(weights[4] != 0) + int(weights[5] != 0))
    per_pair = (valid.long() * (6 + 3 * Rp) + 8 * (sp_live + ip_live)) * n_live
    per_feas = spec_feas * (12 + 6 + 4 * sp_live + 30 + divs * DIV64_OPS)
    return int((per_pair + per_feas).sum().item()), int((spec_feas * divs).sum().item())


def wave_bounds(torch, dc, db, g, wt, c0, spec_feas, chosen, n_feas, weights):
    """(K8, K9) bound_ms from this run's inputs, and K8's bytes bound
    alone.  K8's only output is c0:
    it must read static_mask (already the AND of the diagnosis masks) at
    every valid (pod, node); each live spread slot's eligibility and domain
    count rows there too (the min-match runs over every eligible node); a
    live slot's presence row, each live inter-pod term's count row and
    ip_viol_existing only at the pod's statically feasible nodes; the score
    rows (sc_taint, sc_nodeaff, sc_image by weight, ip_sym, one spread count
    row per live slot, sp_all_keys) only at its speculatively feasible
    nodes; one compact-domain row per topology key in use, at the nodes
    some pod finds statically feasible; the usage rows once; c0.  The
    diagnosis masks feed only reason counts, which K8 does not emit.  K9:
    K5's k5_bytes for the same statics and placements (reason counts
    included), plus the wave tables, the stats, and one pass over the live
    carry rows ([T, N] int32).  Operations: K8's k8_ops; K9's ~80 + 3 Rp
    integer operations per (pod, node), 12 more per live slot."""
    P, N = g.static_mask.shape
    C, AT = g.sp_dv.shape[1], g.ip_dv.shape[1]
    valid = db.valid
    n_live = int(dc.node_valid.sum().item())
    p_live = int(valid.sum().item())
    sp_live = (db.tsc_topo[:, :C] >= 0) & valid[:, None]
    ip_live = (db.aff_kind[:, :AT] >= 0) & valid[:, None]
    slots, terms = int(sp_live.sum().item()), int(ip_live.sum().item())
    stat = g.static_mask & valid[:, None] & dc.node_valid[None, :]
    n_stat = stat.sum(1)  # [P] statically feasible nodes
    Rn, Rp = dc.allocatable.shape[1], db.requests.shape[1]
    b8 = p_live * n_live + slots * n_live * (1 + 4)  # static_mask; sp_te, sp_dom_cnt
    b8 += int((n_stat * (sp_live.sum(1) + 4 * ip_live.sum(1) + (1 if AT else 0))).sum().item())
    per_feas = (8 * (weights[0] != 0) + 8 * (weights[1] != 0) + 8 * (weights[6] != 0) + (8 if AT else 0)
                + (1 if C else 0))  # sc_taint, sc_nodeaff, sc_image, ip_sym, sp_all_keys
    b8 += int((spec_feas * (per_feas + 4 * sp_live.sum(1))).sum().item())  # and one count row per slot
    keys = torch.cat([db.tsc_topo[:, :C][sp_live], db.aff_topo[:, :AT][ip_live]])
    b8 += int(torch.unique(keys).numel()) * int(stat.any(0).sum().item()) * 4  # dom_ids rows
    b8 += n_live * (2 * Rn * 4 + 8 + 4 + 4 + 1) + nbytes(db.requests, db.nonzero_req, db.valid) + P * 4
    ops = n_live * (p_live * (Rp * 3 + 80) + (slots + terms) * 12)
    t_live = _live(wt["rep_sp_p"]) + 2 * _live(wt["rep_ip_p"]) + (int(wt["port_conf"].any(1).sum().item())
                                                                   if wt["has_ports"] else 0)
    b9 = k5_bytes(torch, dc, db, g, chosen, n_feas, weights) + nbytes(*(wt[k] for k in WAVE_TABLES[:6]))
    b9 += nbytes(wt["tid_pt"], wt["port_conf"], c0) + 2 * P * 4 + t_live * n_live * 4
    return (bound_ms(b8, k8_ops(db, g, spec_feas, weights)[0]), bound_ms(b9, ops + t_live * n_live * 2),
            b8 / PEAK_BYTES_S * 1e3)


def wave_check(torch, dc, db, kw, d_cap, flags, wt, g=None, k5=None):
    """K8 and K9 against their plain versions on one packed batch, on the
    plain statics without ports `g` (made here when None; K1/K6/K7 are held
    against theirs by the gang phase), and K9 against K5 (the same
    placements, feasible counts and reasons, by the admission invariant):
    `k5` is K5's (chosen, n_feas, reason counts) on these statics when the
    caller has them (a batch without ports), else K5 runs here on the
    statics with ports.  K9 runs on the plain version's c0, so it is checked
    apart from K8.  Returns (g, K5's statics, plain c0, speculatively
    feasible counts, the plain versions' host-clock ms {"k8", "k9"} (one
    run each, the checked one), plain admission outputs, errors)."""
    from kubernetes_tpu_torch.ops import gang, wave

    hk, v_cap = kw["hostname_key"], kw["v_cap"]
    tab = {k: kw[k] for k in ("sp_keys", "sp_cdv_tab", "ip_keys")}
    plain = dict(hard_pod_affinity_weight=1, enabled=gang.ALL_FILTER_KERNELS, **tab)
    if g is None:
        g = gang.precompute_plain(dc, db, hk, v_cap, **dict(flags, has_ports=False), **plain)
    g = gang.GangStatics(*(t.contiguous() for t in g))  # as the kernels' precompute returns them
    targs = [wt[k] for k in WAVE_TABLES]
    tkw = dict(d_cap=d_cap, d2_cap=wt["d2_cap"], has_ports=wt["has_ports"], tid_pt=wt["tid_pt"],
               port_conf=wt["port_conf"])
    spec_feas = torch.zeros((db.valid.shape[0],), dtype=torch.int64, device=dc.node_valid.device)
    c0, k8_plain = timed_once(torch, lambda: wave.wave_speculate_plain(dc, db, g, d_cap=d_cap, n_feas=spec_feas))
    c0_k = wave.wave_speculate(dc, db, g, d_cap=d_cap)
    adm, k9_plain = timed_once(torch, lambda: wave.wave_admit_plain(dc, db, g, hk, c0, *targs, **tkw))
    adm_k = wave.wave_admit(dc, db, g, hk, c0, *targs, **tkw)
    g5 = g if not wt["has_ports"] else gang.precompute_plain(dc, db, hk, v_cap, **flags, **plain)
    ck, nk, rk = k5 if k5 is not None else gang.gang_schedule(dc, db, g5, v_cap, d_cap=d_cap)[:3]
    torch.cuda.synchronize()
    (ca, na, ra, ta, ka, xa), (cb, nb, rb, tb, kb, xb) = adm_k, adm
    errs = dict(k8_err=max_abs_err(torch, c0_k, c0),
                k9_err=max([max_abs_err(torch, u, v) for u, v in ((ca, cb), (na, nb), (ra, rb), (ka, kb), (xa, xb))]
                           + [max_abs_err(torch, ta[k], tb[k]) for k in ta]),
                k9_vs_k5=max(max_abs_err(torch, ck, ca), max_abs_err(torch, nk, na), max_abs_err(torch, rk, ra)))
    return g, g5, c0, spec_feas, dict(k8=k8_plain, k9=k9_plain), adm, errs


# the phases of K9's leader clocks (admit_stats["info"][2:]): for each of
# a pod's exchanges (pod_tables' sums with the min-match, the filter's
# counts, the spread score's normalizers, the argmax), the work before it,
# the CTA-local combine and the pushes, the wait for every CTA's part and
# the combine; then the commit
K9_PHASES = tuple(f"{name}{part}" for name in ("tables", "filter", "spread", "argmax")
                  for part in ("", "_push", "_exchange"))


# K8's phase clocks (wave.spec_stats["info"]): per reduction kind, the pass
# before it and the reduction (a group barrier)
K8_PHASES = tuple(f"{name}{part}" for name in ("min", "counts", "window", "spread", "argmax")
                  for part in ("", "_reduce"))


def k8_clocks(torch, db):
    """K8's last launch: the group thread 0's cycles per pod in each phase,
    its groups' mean time, the span from the first group's start to the
    last one's end and the mean number of groups in flight (globaltimer)."""
    from kubernetes_tpu_torch.ops import wave

    torch.cuda.synchronize()
    info = wave.spec_stats["info"][db.valid].double()
    dur = info[:, 1] - info[:, 0]
    span = float(info[:, 1].max() - info[:, 0].min())
    cycles = info[:, 2:].mean(0).tolist()
    return dict(group_us=float(dur.mean()) / 1e3, span_us=span / 1e3,
                groups_in_flight=float(dur.sum()) / span,
                leader_cycles_per_pod={k: round(c) for k, c in zip(K8_PHASES, cycles)})


def k9_cluster(torch, db, ms, k5_ms):
    """K9's cluster beside its time `ms` (its last launch was the timed
    one): the CTAs, the cluster barriers it counted per valid pod, the
    microseconds per valid pod, K9 / K5 on the same statics, whether the
    pods' planes were staged in shared memory, and the rank-0 leader's
    cycles per pod in each phase (the exchanges include the wait for the
    slowest CTA; in sampling mode the window's exchange comes after the
    tables' and shifts the later names by one).  "barriers_per_pod" counts
    the cluster-wide synchronizations: mbarrier exchanges, or cluster
    barriers where the exchange slab lies in global memory."""
    from kubernetes_tpu_torch.ops import wave

    torch.cuda.synchronize()
    pods = max(int(db.valid.sum().item()), 1)
    info = wave.admit_stats["info"].tolist()
    cycles = [16 * c / pods for c in info[2:]]
    phases = dict(zip(K9_PHASES, (round(c) for c in cycles)), commit=round(cycles[-1]))
    return dict(cluster=info[0], barriers_per_pod=info[1] / pods, us_per_pod=ms * 1e3 / pods, k9_over_k5=ms / k5_ms,
                staged=wave.admit_stats["staged"], leader_cycles_per_pod=phases)


def k9_variant(torch, fn, cap=16, stage=True):
    """fn() with K9's cluster capped at `cap` CTAs and its planes staged or
    not; (its result, the CTAs its last K9 launch took)."""
    from kubernetes_tpu_torch.ops import wave

    old = wave.ADMIT_CLUSTER_CAP, wave.ADMIT_STAGE
    wave.ADMIT_CLUSTER_CAP, wave.ADMIT_STAGE = cap, stage
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, wave.admit_stats["cluster"]
    finally:
        wave.ADMIT_CLUSTER_CAP, wave.ADMIT_STAGE = old


def wave_row(torch, name, dc, db, kw, d_cap, flags, wt, reps, g=None, k5=None):
    """wave_check, exact on every output (c0; chosen, n_feas, the reason
    counts, the tallies, kinds, conflicting terms), then each kernel's time,
    its plain version's, K5's on the same statics (the fourth entry of `k5`
    when the caller timed it), and the bounds; K9 with its cluster (k9_cluster)
    and, capped at 8 CTAs and with its planes read from global memory,
    exact against the plain version too, with their times.  Returns the
    row."""
    from kubernetes_tpu_torch.ops import gang, wave

    g, g5, c0, spec_feas, plain_ms, adm, errs = wave_check(torch, dc, db, kw, d_cap, flags, wt, g=g,
                                                  k5=k5[:3] if k5 is not None else None)
    if any(errs.values()):
        raise AssertionError(f"{name}: wave kernels differ: {errs}")
    hk, v_cap = kw["hostname_key"], kw["v_cap"]
    targs = [wt[k] for k in WAVE_TABLES]
    tkw = dict(d_cap=d_cap, d2_cap=wt["d2_cap"], has_ports=wt["has_ports"], tid_pt=wt["tid_pt"],
               port_conf=wt["port_conf"])
    chosen, n_feas = adm[0], adm[1]
    (b8, by8), (b9, by9), bytes8_ms = wave_bounds(torch, dc, db, g, wt, c0, spec_feas, chosen, n_feas,
                                                   gang.DEFAULT_WEIGHTS)
    ops8, divs8 = k8_ops(db, g, spec_feas, gang.DEFAULT_WEIGHTS)
    ops8_ms = ops8 / PEAK_ISSUE_OPS_S * 1e3
    row = dict(shape=name, N=int(dc.node_valid.sum().item()), P=int(db.valid.sum().item()),
               placed=int(dc.epod_valid.sum().item()), terms=wt["n_terms"], has_ports=wt["has_ports"],
               Tsp=_live(wt["rep_sp_p"]), Tip=_live(wt["rep_ip_p"]),
               Tpt=int(wt["port_conf"].shape[0]) if wt["has_ports"] else 0,
               scheduled=int((chosen >= 0).sum().item()),
               admitted=int(((chosen == c0) & (chosen >= 0)).sum().item()),
               demoted=int((chosen != c0).sum().item()), **errs)
    row["wave_speculate"] = dict(
        ms=time_ms(torch, lambda: wave.wave_speculate(dc, db, g, d_cap=d_cap), reps),
        plain_ms=plain_ms["k8"],
        bound_ms=b8, bound_by=by8, library_ms=None, ops_bound_ms=ops8_ms,
        bytes_bound_ms=bytes8_ms, int64_divisions=divs8, div64_ops=DIV64_OPS)
    wave.wave_speculate(dc, db, g, d_cap=d_cap)
    row["wave_speculate"].update(k8_clocks(torch, db))
    row["wave_admit"] = dict(
        ms=time_ms(torch, lambda: wave.wave_admit(dc, db, g, hk, c0, *targs, **tkw), reps),
        plain_ms=plain_ms["k9"],
        bound_ms=b9, bound_by=by9, library_ms=None)
    row["gang_scan_ms_same_statics"] = (k5[3] if k5 is not None else
                                        time_ms(torch, lambda: gang.gang_schedule(dc, db, g5, v_cap, d_cap=d_cap),
                                                reps))
    row["wave_admit"].update(k9_cluster(torch, db, row["wave_admit"]["ms"], row["gang_scan_ms_same_statics"]))
    k9 = lambda: wave.wave_admit(dc, db, g, hk, c0, *targs, **tkw)  # noqa: E731
    for key, cap, stage in (("cluster8", 8, True), ("unstaged", 16, False)):
        out, ctas = k9_variant(torch, k9, cap, stage)
        err = max([max_abs_err(torch, u, v) for u, v in zip(out[:3] + out[4:], adm[:3] + adm[4:])]
                  + [max_abs_err(torch, out[3][k], adm[3][k]) for k in adm[3]])
        ms, _ = k9_variant(torch, lambda: time_ms(torch, k9, reps), cap, stage)
        if err or ctas != cap:
            raise AssertionError(f"{name}: K9 ({key}, {ctas} CTAs) differs from its plain version by {err}")
        row["k9_err"] = max(row["k9_err"], err)
        row["wave_admit"][key] = dict(k9_cluster(torch, db, ms, row["gang_scan_ms_same_statics"]), ms=ms,
                                      max_abs_err=err)
    log(phase="wave_kernel_check", **row)
    return row


def phase_wave_kernels(torch, device, reps=5, shapes=None, nominated=("mixed",)):
    """wave_row on the wave-only shapes (wave_shapes): the port-contended
    batch and the port-free mixed batch; on the shapes named in `nominated`
    (without ports), also K5, K8 and K9 with 64 open nominations
    (nominated_row, in the row under "nominated").  Returns the rows by
    shape name."""
    from kubernetes_tpu_torch.ops import gang

    rows = {}
    for name, nodes, placed, pending in (shapes or wave_shapes()):
        dc, db, kw, d_cap, flags, wt = wave_inputs(torch, device, nodes, placed, pending)
        g = None
        if name in nominated:
            tab = {k: kw[k] for k in ("sp_keys", "sp_cdv_tab", "ip_keys")}
            g = gang.precompute_plain(dc, db, kw["hostname_key"], kw["v_cap"], hard_pod_affinity_weight=1,
                                      enabled=gang.ALL_FILTER_KERNELS, **dict(flags, has_ports=False), **tab)
        rows[name] = wave_row(torch, name, dc, db, kw, d_cap, flags, wt, reps, g=g)
        if name in nominated:
            rows[name]["nominated"] = nominated_row(torch, name, dc, db, kw, d_cap, g, wt, reps)
    return rows


def phase_transport(torch, device, reps=20, n_nodes=10000):
    """The single-buffer upload (ops/wire.py, the port of the transport root
    _unpacker.run) of config0's usage state: host clock around
    device_put_packed and a synchronize.  Bound: the packed bytes read once
    and written once into their typed leaves at the card's memory rate."""
    import numpy as np

    from kubernetes_tpu_torch.ops import wire
    from kubernetes_tpu_torch.scheduler import UsageState

    fixed, state0 = k4_inputs(torch, torch.device("cpu"), n_nodes=n_nodes, P=64, n_pads=0)
    us = UsageState(alloc=fixed["alloc"].numpy(), allowed=fixed["allowed"].numpy(),
                    **{k: v.numpy() for k, v in state0.items()})
    buf, _ = wire.pack_tree(us)
    wire.device_put_packed(us, device)
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        out = wire.device_put_packed(us, device)
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    if not np.array_equal(out.used.cpu().numpy(), us.used):
        raise AssertionError("device_put_packed changed the usage rows")
    ms = total / reps * 1e3
    bound, by = bound_ms(2 * buf.nbytes, 0)
    delta = delta_sync_times(torch, device)
    log(phase="transport", root="ops/wire.py:77 _unpacker.run", bytes=int(buf.nbytes), ms=ms,
        bound_ms=bound, bound_by=by, device_mirror_delta=delta)
    return dict(ms=ms, bound_ms=bound, bound_by=by, bytes=int(buf.nbytes))


def delta_sync_times(torch, device, n_nodes=5000, n_placed=4500, rounds=10, per_round=512):
    """DeviceClusterCache.sync's delta path (the port of the transport root
    cache/device_mirror.py:62 apply) at config4's shape: 5,000 nodes in 8
    zones holding 4,500 placed spread pods, then `rounds` times 512 more
    placed pods arrive (informer adds) and the mirror appends them on the
    host (timed apart, `host_append_ms`); one sync then copies the usage
    rows and the appended rows, one copy_ per changed row range (`ms`), and
    `with_host_append_ms` is the two together, the whole cost of the sync a
    workloads batch waits for.  Host clock between synchronizes."""
    from kubernetes_tpu_torch.framework.config import SchedulerConfiguration
    from kubernetes_tpu_torch.scheduler import Scheduler

    sched = Scheduler(SchedulerConfiguration(), device=device)
    nodes = basic_nodes(n_nodes, zones=8)
    for n in nodes:
        sched.on_node_add(n)
    pods = spread_pods(n_placed + rounds * per_round, prefix="placed")
    for i, p in enumerate(pods):
        p.node_name = nodes[i % n_nodes].name
    sched.mirror.e_cap_hint = len(pods) + 64
    for p in pods[:n_placed]:
        sched.on_pod_add(p)
    sched._repack_mirror()
    cache, m = sched._dc_cache, sched.mirror
    cache.sync(m, sched.vocab)
    rows = {"ms": [], "host_append_ms": [], "with_host_append_ms": [], "bytes": []}
    full0 = cache.full_uploads

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    for r in range(rounds):
        for p in pods[n_placed + r * per_round: n_placed + (r + 1) * per_round]:
            sched.on_pod_add(p)
        sched._repack_mirror()
        ms_host, _ = clock(lambda: m.existing)
        e0, m0 = cache._e_done, cache._m_done
        ms, dc = clock(lambda: cache.sync(m, sched.vocab))
        ranges, moved = delta_ranges(dc, (e0, cache._e_done), (m0, cache._m_done))
        for k, v in (("ms", ms), ("host_append_ms", ms_host), ("with_host_append_ms", ms + ms_host),
                     ("bytes", moved)):
            rows[k].append(v)
    if cache.full_uploads != full0:
        raise AssertionError("the delta-sync measurement forced a full upload")
    out = {k: statistics.median(v) for k, v in rows.items()}
    out.update(syncs=rounds, appended_pods_per_sync=per_round, ranges=ranges, mean_ms=statistics.mean(rows["ms"]),
               max_ms=max(rows["ms"]), bound_ms=bound_ms(out["bytes"], 0)[0], bound_by="bytes")
    return out


def delta_ranges(dc, e, t):
    """(row ranges, bytes) a delta sync copies: the usage rows whole, the
    placed-pod rows [e0, e1) and the term rows [m0, m1) of every field
    DeviceClusterCache syncs."""
    from kubernetes_tpu_torch.cache import device_mirror as dm

    parts = [getattr(dc, n) for n in dm._USAGE]
    parts += [getattr(dc, n)[e[0]:e[1]] for n in dm._EPOD_FIELDS]
    parts += [getattr(dc, n)[t[0]:t[1]] for n in dm._TERM_FIELDS]
    parts += [getattr(dc.term_table, f)[t[0]:t[1]] for f in dm._TABLE_FIELDS]
    parts = [x for x in parts if x.shape[0]]
    return len(parts), sum(x.numel() * x.element_size() for x in parts)


def drain(device, nodes, pods, host_only=False, **cfg_over):
    """One drain through the port's entry points; returns (placements,
    seconds, scheduler)."""
    from kubernetes_tpu_torch.framework.config import SchedulerConfiguration
    from kubernetes_tpu_torch.scheduler import Scheduler

    cfg = SchedulerConfiguration(**cfg_over)
    if host_only:
        cfg.fast_device_min = 1 << 62  # every batch on the host FastCommitter
    sched = Scheduler(cfg, device=device)
    bound = {}

    def sink_many(pairs):
        for pod, node in pairs:
            bound[pod.uid] = node
        return [None] * len(pairs)

    sched.binding_sink_many = sink_many
    for n in nodes:
        sched.on_node_add(n)
    for p in pods:
        sched.on_pod_add(p)
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sched.schedule_pending()
    dt = time.perf_counter() - t0
    placements = {o.pod.name: o.node for o in out}
    if len(placements) != len(pods):
        raise AssertionError(f"{len(placements)} outcomes for {len(pods)} pods")
    for o in out:
        if o.node is not None and bound.get(o.pod.uid) != o.node:
            raise AssertionError(f"pod {o.pod.name} placed on {o.node} but not bound there")
    return placements, dt, sched


def check_capacity(sched) -> None:
    for cn in sched.cache.real_nodes():
        a = cn.node.allocatable
        if (cn.requested.milli_cpu > a.milli_cpu or cn.requested.memory > a.memory
                or len(cn.pods) > (a.allowed_pod_number or 110)):
            raise AssertionError(f"node {cn.node.name} is over its allocatable")


def phase_drain(torch, name, device, make_nodes, make_pods, kernels, want=None, **cfg):
    """One drain on the card under SchedulerConfiguration(**cfg), held pod
    for pod against the port's host committer alone (computed here, or
    `want` from an earlier drain of the same workload: the committer's
    choices do not depend on the batch boundaries).  Every kernel in
    `kernels` must have launched in this drain.  Returns (launches, want,
    drain seconds)."""
    from kubernetes_tpu_torch.ops import _build

    _build.reset_launches()
    got, dt, sched = drain(device, make_nodes(), make_pods(), **cfg)
    launches = dict(_build.launches)
    dt_host = None
    if want is None:
        want, dt_host, _ = drain(torch.device("cpu"), make_nodes(), make_pods(), host_only=True)
    diff = [k for k in want if want[k] != got.get(k)]
    if diff:
        raise AssertionError(f"{name}: {len(diff)} placements differ from the host committer, "
                             f"first {diff[0]}: {got.get(diff[0])} vs {want[diff[0]]}")
    check_capacity(sched)
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: the drain never launched {missing}: {launches}")
    placed = sum(v is not None for v in got.values())
    log(phase="drain", name=name, config=cfg, nodes=len(sched.cache.real_nodes()), pods=len(got),
        placed=placed, drain_s=dt, pods_per_s=len(got) / dt, host_committer_drain_s=dt_host,
        launches=launches, metrics=sched.metrics, identical_to_host_committer=True)
    return launches, want, dt


def zone_skew_ok(sched, placements, max_skew=5) -> int:
    """The largest zone skew over config4's apps; raises above maxSkew."""
    zone = {cn.node.name: cn.node.labels[ZONE] for cn in sched.cache.real_nodes()}
    counts = {}
    for name, node in placements.items():
        if node is not None:
            app = f"a{int(name.rsplit('-', 1)[1]) % 20}"
            counts.setdefault(app, {}).setdefault(zone[node], 0)
            counts[app][zone[node]] += 1
    zones = sorted(set(zone.values()))
    worst = max(max(c.get(z, 0) for z in zones) - min(c.get(z, 0) for z in zones) for c in counts.values())
    if worst > max_skew:
        raise AssertionError(f"config4: a zone skew of {worst} > maxSkew {max_skew}")
    return worst


def anti_affinity_ok(placements, groups=50) -> int:
    """config3: no two pods of one group on one node; returns the pairs
    checked."""
    seen = set()
    for name, node in placements.items():
        if node is None:
            continue
        key = (int(name.rsplit("-", 1)[1]) % groups, node)
        if key in seen:
            raise AssertionError(f"config3: two pods of group g{key[0]} share node {node}")
        seen.add(key)
    return len(seen)


def first_pods_match_cpu(torch, nodes, pods):
    """A drain check: the drain's placements of `pods` (its first pods)
    against a drain of `nodes` and those pods alone with device="cpu" (the
    plain versions).  Batches are popped in arrival order, so those pods
    form the same batches, on the same cluster state, in both drains."""
    def check(sched, got):
        want, dt, _ = drain(torch.device("cpu"), nodes, pods)
        diff = [k for k in want if want[k] != got.get(k)]
        if diff:
            raise AssertionError(f"{len(diff)} of the first {len(want)} placements differ from device=cpu, "
                                 f"first {diff[0]}: {got.get(diff[0])} vs {want[diff[0]]}")
        return dict(compared_with_cpu=len(want), cpu_drain_s=dt)
    return check


WAVE_METRICS = ("wave_batches", "wave_pods", "wave_admitted", "wave_groups", "wave_conflicts",
                "wave_fallback_dup_hostname", "wave_fallback_kill_switch")


def _tensor_bytes(obj) -> int:
    """Bytes of every tensor in a (nested) dataclass of tensors."""
    import dataclasses

    import torch

    total = 0
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif dataclasses.is_dataclass(v):
            total += _tensor_bytes(v)
    return total


class SyncTimer:
    """Times every DeviceClusterCache.sync (the port of the transport root
    cache/device_mirror.py:62 apply) while installed: host clock around the
    call between two synchronizes, and the bytes it moved to the card (the
    whole snapshot on a full upload; on a delta sync the usage rows and the
    appended placed-pod and term rows)."""

    def __init__(self, torch):
        from kubernetes_tpu_torch.cache import device_mirror as dm

        self.torch, self.cls, self.records = torch, dm.DeviceClusterCache, []
        self._orig = self.cls.sync
        timer = self

        def sync(cache, mirror, vocab):
            e0, m0, full0 = cache._e_done, cache._m_done, cache.full_uploads
            timer.torch.cuda.synchronize()
            t0 = time.perf_counter()
            dc = timer._orig(cache, mirror, vocab)
            timer.torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if cache.full_uploads != full0:
                moved, kind = _tensor_bytes(dc), "full"
            else:
                usage = nbytes(dc.requested, dc.nonzero_req, dc.num_pods, dc.used_ppk, dc.used_ip, dc.used_wild)
                epod = sum(t[0].numel() * t.element_size() for t in (dc.epod_node, dc.epod_ns, dc.epod_labels,
                                                                      dc.epod_valid, dc.epod_deleting))
                tt = dc.term_table
                term = sum(t[0].numel() * t.element_size() for t in (
                    dc.term_pod, dc.term_kind, dc.term_topo, dc.term_weight, dc.term_ns_all, dc.term_ns_ids,
                    tt.req_key, tt.req_op, tt.req_vals, tt.req_rhs, tt.term_valid))
                moved = usage + (cache._e_done - e0) * epod + (cache._m_done - m0) * term
                kind = "delta"
            timer.records.append((kind, ms, moved))
            return dc

        self.cls.sync = sync

    def close(self) -> dict:
        self.cls.sync = self._orig
        out = {}
        for kind in ("full", "delta"):
            rs = [r for r in self.records if r[0] == kind]
            if rs:
                ms = [r[1] for r in rs]
                b = statistics.mean(r[2] for r in rs)
                out[kind] = dict(syncs=len(rs), mean_ms=statistics.mean(ms), median_ms=statistics.median(ms),
                                 max_ms=max(ms), mean_bytes=b, bound_ms=b / PEAK_BYTES_S * 1e3, bound_by="bytes")
        return out


def phase_gang_drain(torch, name, device, nodes, pods, kernels, check=None, want=None, wave_batches=None,
                     **cfg):
    """One gang-path drain through Scheduler() on the card: every pod gets an
    outcome and every placement is bound, no node ends over its allocatable,
    `check` (the workload's constraint check) passes, and every kernel in
    `kernels` launched in this drain.  With `want` (the placements of a
    drain of the same workload on another route), the placements must equal
    it pod for pod; with `wave_batches`, that many batches must have taken
    the wave and none the scan.  Returns (launches, placements)."""
    from kubernetes_tpu_torch.ops import _build

    _build.reset_launches()
    timer = SyncTimer(torch)
    try:
        got, dt, sched = drain(device, nodes, pods, **cfg)
    finally:
        syncs = timer.close()
    launches = dict(_build.launches)
    check_capacity(sched)
    checked = check(sched, got) if check is not None else None
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: the drain never launched {missing}: {launches}")
    m = sched.metrics
    if wave_batches is not None and (m["wave_batches"] != wave_batches or m["scan_batches"] or m["chain_batches"]):
        raise AssertionError(f"{name}: {m['wave_batches']} wave batches of {wave_batches}, "
                             f"{m['scan_batches']} scan, {m['chain_batches']} chain")
    if want is not None:
        diff = [k for k in want if want[k] != got.get(k)]
        if diff or len(want) != len(got):
            raise AssertionError(f"{name}: {len(diff)} placements differ from the other route's drain, "
                                 f"first {diff[:1]}")
    placed = sum(v is not None for v in got.values())
    log(phase="gang_drain", name=name, config=cfg, nodes=len(sched.cache.real_nodes()), pods=len(got),
        placed=placed, drain_s=dt, pods_per_s=len(got) / dt, launches=launches,
        scan_batches=m["scan_batches"], chain_batches=m["chain_batches"], fast_batches=m["fast_batches"],
        **{k: m[k] for k in WAVE_METRICS}, constraint_check=checked, capacity_ok=True,
        equal_to_other_route=want is not None, device_mirror_syncs=syncs)
    return launches, got


def phase_gang_parity(torch, device, n_nodes=250, n_pods=1536, n_placed=200, wave=False):
    """The same mixed gang-path drain on the card and with device="cpu" (the
    plain versions): placements, FitError messages and diagnoses must be
    identical.  Host ports only in the last batch, so the first batch takes
    the direct route, the middle ones the chained route, the last the
    direct route with ports: the gang scan under waveDispatch: false, the
    wave under the default configuration (`wave`).  The card's machine has
    no JAX, so this is the end-to-end check there."""
    from kubernetes_tpu_torch.framework.config import SchedulerConfiguration
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.scheduler import Scheduler

    def run(dev):
        last = n_pods % 512 or 512  # the default batch size
        nodes, placed, pending = gen_cluster(11, n_nodes, n_placed, n_pods, ports_from=n_pods - last)
        sched = Scheduler(SchedulerConfiguration(wave_dispatch=wave), device=dev)
        for n in nodes:
            sched.on_node_add(n)
        for p in placed + pending:
            sched.on_pod_add(p)
        t0 = time.perf_counter()
        out = sched.schedule_pending()
        return {o.pod.name: (o.node, o.reason, o.diagnosis) for o in out}, time.perf_counter() - t0, sched

    _build.reset_launches()
    got, dt, sched = run(device)
    launches = dict(_build.launches)
    want, dt_cpu, _ = run(torch.device("cpu"))
    diff = [k for k in want if want[k] != got.get(k)]
    if diff or len(got) != len(want):
        raise AssertionError(f"parity: {len(diff)} outcomes differ between cuda and cpu, first {diff[:1]}")
    route = ("wave_speculate", "wave_admit") if wave else ("gang_scan",)
    for k in ("static_eval", "gang_spread_statics", "gang_interpod_statics") + route:
        if launches[k] <= 0:
            raise AssertionError(f"parity: the cuda drain never launched {k}")
    m = sched.metrics
    if wave and (m["scan_batches"] or m["chain_batches"] or not m["wave_batches"]):
        raise AssertionError(f"parity: a batch left the wave: {m}")
    log(phase="gang_parity", wave_dispatch=wave, wave_batches=m["wave_batches"], nodes=n_nodes, pods=n_pods,
        placed_before=n_placed,
        placed=sum(v[0] is not None for v in got.values()), unschedulable=sum(v[0] is None for v in got.values()),
        identical=True, cuda_drain_s=dt, cpu_drain_s=dt_cpu, launches=launches, scan_batches=m["scan_batches"],
        chain_batches=m["chain_batches"], fast_batches=m["fast_batches"])


# ---------------------------------------------------------------------------
# Phase 7: preemption
# ---------------------------------------------------------------------------

# the failed pods' four priority groups in K10's check, and the placed pods'
# priorities (all lower than every group's)
PREEMPT_GROUPS = (20, 60, 100, 200)
PLACED_PRIOS = (0, 10, 50)


def k10_inputs(torch, device, n_nodes=10000, E=20000, P=512, B2=512, seed=13):
    """K10's inputs at config0's node count: the mixed cluster (NoSchedule
    taints, unschedulable nodes, labels) packed as the scheduler's static
    snapshot; E placed pods at priorities {0, 10, 50} with config0's
    request mix on seeded nodes; P failed mixed pods (tolerations,
    nodeSelector, required node affinity) in four priority groups; B2
    committed batch peers on seeded nodes (a twentieth of them pads) at
    priorities just below, at and just above the groups'.  Returns (dc, db,
    the victim / group rows, the batch-peer rows), all on `device`."""
    import numpy as np

    from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster
    from kubernetes_tpu_torch.snapshot.interner import Vocab
    from kubernetes_tpu_torch.snapshot.schema import ResourceLanes, pack_nodes, pack_pod_batch

    rng = np.random.default_rng(seed)
    nodes = mixed_nodes(n_nodes, seed=seed)
    pods = mixed_pods(P, seed=seed + 1)
    for i, p in enumerate(pods):
        p.priority = PREEMPT_GROUPS[i % len(PREEMPT_GROUPS)]
    vocab = Vocab()
    for p in pods:
        for k, v in p.labels.items():
            vocab.intern_label(k, v)
    nt = pack_nodes(nodes, vocab)
    pb = pack_pod_batch(pods, vocab, k_cap=nt.k_cap, p_cap=P)
    R = nt.allocatable.shape[1]
    lanes = ResourceLanes(vocab)
    n_real = len(nodes)
    vreq = np.zeros((E, R), np.int32)
    vreq[:, 0] = rng.choice([100, 250, 500, 1000], size=E)
    vreq[:, 1] = rng.choice([128, 256, 512, 1024], size=E)
    breq = np.zeros((B2, R), np.int32)
    breq[:, 0] = rng.choice([100, 250, 500], size=B2)
    breq[:, 1] = rng.choice([128, 256, 512], size=B2)
    bnode = rng.integers(0, n_real, size=B2).astype(np.int32)
    bnode[rng.random(B2) < 0.05] = -1
    groups = np.asarray(PREEMPT_GROUPS, np.int32)
    assert lanes.n_lanes >= 2
    rows = dict(
        victim_node=rng.integers(0, n_real, size=E).astype(np.int32),
        victim_prio=rng.choice(PLACED_PRIOS, size=E).astype(np.int32),
        victim_req=vreq,
        prio_groups=groups,
        pod_group=(np.arange(P) % len(groups)).astype(np.int32),
    )
    peers = dict(batch_node=bnode,
                 batch_prio=rng.choice(sorted({g + d for g in groups for d in (-1, 0, 1)}), size=B2).astype(np.int32),
                 batch_req=breq)
    to = lambda d: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in d.items()}  # noqa: E731
    return DeviceCluster.from_host(nt, vocab, device), DeviceBatch.from_host(pb, device), to(rows), to(peers)


def k10_bound(torch, dc, db, rows, peers, mask):
    """K10's least time: bytes (the victim, group and peer rows, the nodes'
    static tables, allocatable and pod limits, and the pods' tables read
    once; the [P, N] mask written once) against operations (per group and
    row, the comparison and R + 2 adds; per (pod, node), the static filters'
    compares — taint slots × toleration slots, affinity requirement slots —
    and 3 per resource lane)."""
    G = rows["prio_groups"].shape[0]
    E, R = rows["victim_req"].shape
    B2 = peers["batch_node"].shape[0]
    P, N = mask.shape
    T, TL = dc.taint_key.shape[1], db.tol_key.shape[1]
    _, NT, NR = db.node_sel.req_key.shape
    ins = nbytes(*rows.values(), *peers.values(), dc.node_labels, dc.val_ints, dc.taint_key, dc.taint_val,
                 dc.taint_effect, dc.unschedulable, dc.node_valid, dc.allocatable, dc.allowed_pods, db.valid,
                 db.requests, db.tol_key, db.tol_op, db.tol_val, db.tol_effect, db.target_name_val,
                 *(getattr(db.node_sel, f) for f in ("req_key", "req_op", "req_vals", "req_rhs", "term_valid")))
    ops = G * (E + B2) * (R + 3) + P * N * (T * TL + NT * NR + 3 * R + 6)
    return bound_ms(ins + nbytes(mask), ops)


def phase_preempt_kernels(torch, device, reps=20, **size):
    """K10 against narrow_candidates_plain on the card, exactly, with and
    without batch peers, at config0's node count (k10_inputs); its time, the
    plain version's, its bound, and the library call for its kept plane:
    the G × 3 index_add_ segment sums (requests, counts, victims) of the
    plain version, on the same rows, the per-group row masks made outside
    the timed window.  Returns the row."""
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import preemption as pre

    dc, db, rows, peers = k10_inputs(torch, device, **size)
    n0 = _build.launches["narrow_candidates"]
    errs = []
    for kw in ({}, peers):
        got = pre.narrow_candidates(dc, db, *rows.values(), **kw)
        want = pre.narrow_candidates_plain(dc, db, *rows.values(), **kw)
        torch.cuda.synchronize()
        errs.append(max_abs_err(torch, got, want))
    if any(errs) or _build.launches["narrow_candidates"] != n0 + 2:
        raise AssertionError(f"narrow_candidates kernel != plain version (errors {errs})")
    # the kept plane by the library: one index_add_ per group and plane
    N, R = dc.allocatable.shape
    seg = torch.where(rows["victim_node"] >= 0, rows["victim_node"], N).long()
    per_group = []
    for thr in rows["prio_groups"].tolist():
        lower = rows["victim_prio"] < thr
        keep = (~lower).to(torch.int32)
        per_group.append((rows["victim_req"] * keep[:, None], keep, lower.to(torch.int32)))
    bufs = [(torch.zeros((N + 1, R), dtype=torch.int32, device=device),
             torch.zeros((N + 1,), dtype=torch.int32, device=device),
             torch.zeros((N + 1,), dtype=torch.int32, device=device)) for _ in per_group]

    def zero():
        for b in bufs:
            for t in b:
                t.zero_()

    def library():
        for (req, cnt, vic), (br, bc, bv) in zip(per_group, bufs):
            br.index_add_(0, seg, req)
            bc.index_add_(0, seg, cnt)
            bv.index_add_(0, seg, vic)

    b, by = k10_bound(torch, dc, db, rows, peers, got)
    row = dict(
        N=N, P=int(db.valid.sum().item()), E=rows["victim_node"].shape[0], G=rows["prio_groups"].shape[0],
        B2=peers["batch_node"].shape[0], candidates=int(got.sum().item()), max_abs_err=max(errs),
        ms=time_ms(torch, lambda: pre.narrow_candidates(dc, db, *rows.values(), **peers), reps),
        plain_ms=time_ms(torch, lambda: pre.narrow_candidates_plain(dc, db, *rows.values(), **peers), 3),
        bound_ms=b, bound_by=by, library_ms=time_ms(torch, library, reps, setup=zero),
        library_call=f"{3 * len(per_group)} x index_add_ of [{seg.shape[0]}, {R}] rows into [{N + 1}, {R}]",
    )
    log(phase="preempt_kernel_check", **row)
    return row


def nominations(torch, dc, db, n=64, seed=17):
    """`n` open nominations on seeded valid nodes at priorities just below,
    at and just above the batch's highest, each asking 90 % to 105 % of its
    node's free cpu (so the charge leaves most of those nodes without room
    for a pod it gates) and a tenth to a half of its memory."""
    import numpy as np

    rng = np.random.default_rng(seed)
    valid = dc.node_valid.nonzero().flatten().cpu().numpy()
    base = int(db.priority[db.valid].max().item())
    node = rng.choice(valid, size=n).astype(np.int32)
    alloc = dc.allocatable.cpu().numpy()
    free = alloc[node, 0] - dc.requested.cpu().numpy()[node, 0]
    req = np.zeros((n, alloc.shape[1]), np.int32)
    req[:, 0] = np.maximum(free * rng.uniform(0.9, 1.05, size=n), 0).astype(np.int32)
    req[:, 1] = (alloc[node, 1] * rng.uniform(0.1, 0.5, size=n)).astype(np.int32)
    prio = rng.choice([base - 1, base, base + 1], size=n).astype(np.int32)
    dev = dc.node_valid.device
    return dict(nom_node=torch.from_numpy(node).to(dev), nom_prio=torch.from_numpy(prio).to(dev),
                nom_req=torch.from_numpy(req).to(dev))


def timed_once(torch, fn):
    """(fn's result, its host-clock ms between two synchronizes): one run of
    a plain version, which is host-bound, checked and timed at once."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def nominated_row(torch, name, dc, db, kw, d_cap, g, wt, reps, n=64):
    """K5, and with wave tables K8 and K9, with `n` open nominations
    (nominations()) against their plain versions on the same statics `g`,
    exactly, and K9 against K5 with them; the pods whose feasible-node
    count the charge changed (K5 with against without; none raises: the
    charge would be untested) and those it moved; each kernel's time and
    its plain version's (one run, host clock).  Returns the row."""
    from kubernetes_tpu_torch.ops import gang, wave

    nom = nominations(torch, dc, db, n)
    v_cap, hk = kw["v_cap"], kw["hostname_key"]
    ck, nk, rk, tk = gang.gang_schedule(dc, db, g, v_cap, d_cap=d_cap, **nom)
    (cp, np_, rp, tp), k5_plain_ms = timed_once(
        torch, lambda: gang.gang_schedule_plain(dc, db, g, v_cap, d_cap=d_cap, **nom))
    base, base_feas = gang.gang_schedule(dc, db, g, v_cap, d_cap=d_cap)[:2]
    torch.cuda.synchronize()
    k5 = max([max_abs_err(torch, a, b) for a, b in ((ck, cp), (nk, np_), (rk, rp))]
             + [max_abs_err(torch, tk[k], tp[k]) for k in tk])
    row = dict(shape=name, nominations=n, k5_nom_err=k5, moved_by_nominations=int((base != ck).sum().item()),
               feas_changed_by_nominations=int((base_feas != nk).sum().item()),
               scheduled=int((ck >= 0).sum().item()))
    if not row["feas_changed_by_nominations"]:
        raise AssertionError(f"{name}: the nominations changed no pod's feasible nodes")
    row["gang_scan"] = dict(ms=time_ms(torch, lambda: gang.gang_schedule(dc, db, g, v_cap, d_cap=d_cap, **nom), reps),
                            plain_ms=k5_plain_ms)
    if wt is not None:
        targs = [wt[k] for k in WAVE_TABLES]
        tkw = dict(d_cap=d_cap, d2_cap=wt["d2_cap"], has_ports=wt["has_ports"], tid_pt=wt["tid_pt"],
                   port_conf=wt["port_conf"], **nom)
        c0, k8_plain_ms = timed_once(torch, lambda: wave.wave_speculate_plain(dc, db, g, d_cap=d_cap, **nom))
        c0_k = wave.wave_speculate(dc, db, g, d_cap=d_cap, **nom)
        adm, k9_plain_ms = timed_once(torch, lambda: wave.wave_admit_plain(dc, db, g, hk, c0, *targs, **tkw))
        adm_k = wave.wave_admit(dc, db, g, hk, c0, *targs, **tkw)
        torch.cuda.synchronize()
        row["k8_nom_err"] = max_abs_err(torch, c0_k, c0)
        row["k9_nom_err"] = max([max_abs_err(torch, u, v) for u, v in zip(adm_k[:3] + adm_k[4:], adm[:3] + adm[4:])]
                                + [max_abs_err(torch, adm_k[3][k], adm[3][k]) for k in adm[3]])
        row["k9_vs_k5_nom"] = max(max_abs_err(torch, adm[0], ck), max_abs_err(torch, adm[1], nk),
                                  max_abs_err(torch, adm[2], rk))
        row["wave_speculate"] = dict(
            ms=time_ms(torch, lambda: wave.wave_speculate(dc, db, g, d_cap=d_cap, **nom), reps),
            plain_ms=k8_plain_ms)
        row["wave_admit"] = dict(
            ms=time_ms(torch, lambda: wave.wave_admit(dc, db, g, hk, c0, *targs, **tkw), reps),
            plain_ms=k9_plain_ms)
        row["wave_admit"].update(k9_cluster(torch, db, row["wave_admit"]["ms"], row["gang_scan"]["ms"]))
    bad = {k: v for k, v in row.items() if k.endswith("_err") or k == "k9_vs_k5_nom"}
    if any(bad.values()):
        raise AssertionError(f"{name}: kernels with nominations differ from their plain versions: {bad}")
    log(phase="nominated_kernel_check", **row)
    return row


def preemption_world(n_nodes, n_preemptors):
    """bench.py bench_preemption's cluster: nodes of 4 cpu / 16Gi, each with
    two priority-0 victims of 1500m / 2Gi, and preemptors of 3 cpu / 4Gi at
    priority 100.  Returns (nodes, victims, preemptors)."""
    from kubernetes_tpu_torch.api import Container, Node, Pod, Resource

    nodes = [Node(name=f"node-{i}", labels={HOSTNAME: f"node-{i}"},
                  capacity=Resource.from_map({"cpu": "4", "memory": "16Gi"})) for i in range(n_nodes)]
    victims = [Pod(name=f"victim-{i}-{v}", node_name=f"node-{i}", priority=0,
                   containers=[Container(requests={"cpu": "1500m", "memory": "2Gi"})])
               for i in range(n_nodes) for v in range(2)]
    preemptors = [Pod(name=f"hi-{i}", priority=100, containers=[Container(requests={"cpu": "3", "memory": "4Gi"})])
                  for i in range(n_preemptors)]
    return nodes, victims, preemptors


def preemption_drain(torch, device, nodes, placed, pending, rounds=12, advance=30.0, **cfg):
    """A drain in rounds through Scheduler() with a manual clock that moves
    `advance` seconds between rounds (the preemptors' backoff), victims
    evicted through ``pod_deleter = on_pod_delete``, until every pending pod
    is bound or `rounds` ran.  Returns (record, seconds, scheduler,
    launches): the record holds the bindings, the evictions in order, every
    nomination in the order it was made, and the rounds taken."""
    from kubernetes_tpu_torch.framework.config import SchedulerConfiguration
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.scheduler import Scheduler

    now = [1000.0]
    sched = Scheduler(SchedulerConfiguration(**cfg), device=device, clock=lambda: now[0])
    rec = dict(bindings={}, evictions=[], nominations=[], rounds=0)
    sched.binding_sink = lambda pod, node: rec["bindings"].__setitem__(pod.name, node)
    sched.status_patcher = lambda pod: rec["nominations"].append((pod.name, pod.nominated_node_name))

    def evict(pod):
        rec["evictions"].append(pod.name)
        sched.on_pod_delete(pod)

    sched.pod_deleter = evict
    for n in nodes:
        sched.on_node_add(n)
    for p in placed + pending:
        sched.on_pod_add(p)
    _build.reset_launches()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(rounds):
        sched.schedule_pending()
        rec["rounds"] = r + 1
        if all(p.name in rec["bindings"] for p in pending):
            break
        now[0] += advance
    return rec, time.perf_counter() - t0, sched, dict(_build.launches)


def check_evictions(rec, n_nodes, n_preemptors):
    """bench_preemption's invariants: every preemptor bound, each node lost
    either none or both of its victims, and exactly one node per preemptor
    lost them, the one it is bound to.  Returns the nodes that lost both."""
    lost = {}
    for v in rec["evictions"]:
        _, i, _ = v.split("-")
        lost[int(i)] = lost.get(int(i), 0) + 1
    if len(rec["evictions"]) != len(set(rec["evictions"])):
        raise AssertionError("a victim was evicted twice")
    bound = [rec["bindings"].get(f"hi-{i}") for i in range(n_preemptors)]
    if None in bound:
        raise AssertionError(f"{bound.count(None)} preemptors left unbound after {rec['rounds']} rounds")
    emptied = {f"node-{i}" for i, c in lost.items() if c == 2}
    if any(c != 2 for c in lost.values()) or len(emptied) != n_preemptors or set(bound) != emptied:
        raise AssertionError(f"evictions do not match bench_preemption's: {len(emptied)} nodes emptied for "
                             f"{n_preemptors} preemptors")
    return len(emptied)


def phase_preempt_drains(torch, device, n_small=500, n_large=5000, large_preemptors=250):
    """bench_preemption's drain (preemption_world) at its own size on cuda
    and with device="cpu": bindings, evictions and nominations identical,
    every invariant of check_evictions, no node over its allocatable; then
    at n_large nodes with large_preemptors preemptors on cuda alone.  Every
    preemptor fails in a fast harvest, which reaches PostFilter unnarrowed
    as in the reference: K10 must not launch.  Returns the rows by name."""
    out = {}
    for name, n, k, devices in (("bench_preemption", n_small, n_small, (device, torch.device("cpu"))),
                                ("bench_preemption_large", n_large, large_preemptors, (device,))):
        runs = []
        for dev in devices:
            rec, dt, sched, launches = preemption_drain(torch, dev, *preemption_world(n, k))
            check_capacity(sched)
            emptied = check_evictions(rec, n, k)
            runs.append((rec, dt, sched, launches))
        rec, dt, sched, launches = runs[0]
        if len(runs) > 1 and runs[1][0] != rec:
            raise AssertionError(f"{name}: the cuda drain's bindings, evictions or nominations differ from cpu's")
        if launches["narrow_candidates"] != 0:
            raise AssertionError(f"{name}: K10 narrowed a fast harvest: {launches}")
        m = sched.metrics
        row = dict(name=name, nodes=n, preemptors=k, rounds=rec["rounds"], drain_s=dt,
                   cpu_drain_s=runs[1][1] if len(runs) > 1 else None, identical_to_cpu=len(runs) > 1 or None,
                   evictions=len(rec["evictions"]), nodes_emptied=emptied, nominations=len(rec["nominations"]),
                   launches=launches, **{key: m[key] for key in ("preemption_attempts", "preemption_victims",
                                                                "narrow_batches", "nominated_binds",
                                                                "fast_batches", "chain_batches", "scan_batches",
                                                                "wave_batches", "host_cycles")})
        log(phase="preempt_drain", **row)
        out[name] = row
    return out


def priority_world(n_nodes, n_placed, n_pods, n_big=16, seed=23):
    """The gang-path drain with priorities: nodes of 4 cpu in 3 zones, each
    holding n_placed / n_nodes priority-0 pods of 1 cpu, and n_pods pending
    pods at seeded priorities 0, 50 and 100: config4's spread pods and
    config3's anti-affinity pods of 250m, interleaved, and among them n_big
    pods of 2 cpu that fit no node until lower-priority pods go (they
    preempt, and their nominations stay open while the rest schedule)."""
    from kubernetes_tpu_torch.api import Container, Node, Pod, Resource

    rng = random.Random(seed)
    nodes = [Node(name=f"node-{i}", labels={ZONE: f"zone-{i % 3}", HOSTNAME: f"node-{i}"},
                  capacity=Resource.from_map({"cpu": "4", "memory": "32Gi", "pods": 110})) for i in range(n_nodes)]
    placed = [Pod(name=f"low-{j}", node_name=f"node-{j % n_nodes}", priority=0, labels={"tier": "batch"},
                  containers=[Container(requests={"cpu": "1", "memory": "1Gi"})]) for j in range(n_placed)]
    pending = []
    for a, b in zip(spread_pods(n_pods // 2, prefix="sp"), interpod_pods(n_pods // 2, prefix="aa")):
        pending += [a, b]
    step = max(len(pending) // max(n_big, 1), 1)
    for i, p in enumerate(pending):
        p.priority = rng.choice([0, 50, 100])
        p.containers[0].requests["cpu"] = "2" if n_big and i % step == 0 and i // step < n_big else "250m"
    return nodes, placed, pending


def phase_preempt_parity(torch, device, n_nodes=500, n_placed=1500, n_pods=2000, wave=True):
    """The gang-path drain with priorities (priority_world) in two rounds
    (the second 30 s later, for the preemptors' backoff) on cuda and with
    device="cpu": bindings, evictions and nominations identical, no node
    over its allocatable; K10 and the route's kernels (K8 and K9 under the
    default configuration, K5 under waveDispatch: false) launched, with
    nominations open in the second round."""
    runs = []
    for dev in (device, torch.device("cpu")):
        rec, dt, sched, launches = preemption_drain(torch, dev, *priority_world(n_nodes, n_placed, n_pods),
                                                    rounds=2, wave_dispatch=wave)
        check_capacity(sched)
        runs.append((rec, dt, sched, launches))
    (rec, dt, sched, launches), (rec_cpu, dt_cpu, _, _) = runs
    if rec != rec_cpu:
        raise AssertionError("preempt parity: cuda and cpu differ in bindings, evictions or nominations")
    route = ("wave_speculate", "wave_admit") if wave else ("gang_scan",)
    missing = [k for k in ("narrow_candidates",) + route if launches[k] <= 0]
    if missing or not rec["nominations"]:
        raise AssertionError(f"preempt parity: no nomination, or {missing} never launched: {launches}")
    m = sched.metrics
    log(phase="preempt_parity", wave_dispatch=wave, nodes=n_nodes, placed_before=n_placed, pods=n_pods,
        bound=len(rec["bindings"]), evictions=len(rec["evictions"]), nominations=len(rec["nominations"]),
        identical=True, cuda_drain_s=dt, cpu_drain_s=dt_cpu, launches=launches,
        **{k: m[k] for k in ("preemption_attempts", "narrow_batches", "nominated_binds", "host_cycles",
                             "wave_batches", "chain_batches", "scan_batches", "fast_batches")})
    return launches


# ---------------------------------------------------------------------------
# Phase 8: gang coscheduling (the workloads dispatch: K8 + K11)
# ---------------------------------------------------------------------------


def gang_pods(n_pods, size=8, prefix="gang"):
    """bench.py bench_gang's workload (config10): n_pods // size PodGroups
    of `size` with minMember `size`, every member 100m cpu / 64Mi with label
    app=gang-{g % 32}.  Returns (pods, groups)."""
    from kubernetes_tpu_torch.api import Container, Pod
    from kubernetes_tpu_torch.workloads.gang import PodGroup

    pods, groups = [], []
    for g in range(n_pods // size):
        groups.append(PodGroup(name=f"{prefix}-{g}", min_member=size))
        pods += [Pod(name=f"g{g}-m{m}", pod_group=f"{prefix}-{g}", labels={"app": f"gang-{g % 32}"},
                     containers=[Container(name="c", requests={"cpu": "100m", "memory": "64Mi"})])
                 for m in range(size)]
    return pods, groups


def gang_rows(torch, device, n_live, p_cap, need, size=8):
    """Gang rows laid over the first n_live pods of a batch of p_cap slots:
    consecutive gangs of `size`, gang g needing need(g) members (more than
    `size`: it rolls back whatever it places).  Returns the workloads
    dispatch's gang keyword arguments (workloads/gang.py gang_arrays)."""
    from kubernetes_tpu_torch.workloads.gang import gang_arrays

    positions = {f"g{g}": list(range(g * size, min((g + 1) * size, n_live))) for g in range(-(-n_live // size))}
    needs = {k: need(i) for i, k in enumerate(positions)}
    gid, first, last, gneed, g_cap, _ = gang_arrays(p_cap, positions, needs)
    rows = dict(gang_id=gid, gang_first=first, gang_last=last, gang_need=gneed)
    return dict({k: torch.from_numpy(v).to(device) for k, v in rows.items()}, g_cap=g_cap)


def workloads_shapes(n_config10=1000, n_config4=5000, n_mixed=5000, P=512):
    """K11's three check shapes: (name, nodes, placed pods, pending pods,
    gang need per gang of 8, with nominations).  config10's batch (N =
    1,000 in 8 zones, 64 whole gangs of bench_gang's pods, C = AT = 0);
    config4's (N = 5,000, 45,000 placed spread pods, 512 spread pods) with
    every fourth gang needing 9 of its 8 members, so it rolls back after
    placing them; and the mixed batch without ports (AT = 4) with every
    third gang rolling back and 64 open nominations."""
    c4 = basic_nodes(n_config4, zones=8)
    return [
        ("config10", basic_nodes(n_config10, zones=8), [], gang_pods(P)[0], lambda g: 8, False),
        ("config4", c4, place_round_robin(spread_pods(9 * n_config4, prefix="placed"), c4),
         spread_pods(P, prefix="new"), lambda g: 9 if g % 4 == 0 else 8, False),
        ("mixed", *gen_cluster(5, n_mixed, n_mixed // 10, P, ports_from=P), lambda g: 9 if g % 3 == 0 else 4, True),
    ]


def k11_bound(torch, dc, db, g, wt, rows, chosen, n_feas, weights, dra=None):
    """K11's bound_ms from this run's inputs: K9's bytes for the same
    statics and placements (k5_bytes, the wave tables, one pass over the
    live carry rows) without the demotion stats, plus the gang rows and the
    outputs (the choices before and after rollback, the gang verdicts).
    Operations: K9's.  With ``dra`` (the DRA mode's inputs) also the match
    tensor read once, the request rows, and the two carries read and
    written once; and a verdict step per (pod, node, slot, device).  A
    rollback undoes the members' commits, work of the size of the commits
    themselves, counted in neither."""
    P, N = g.static_mask.shape
    C, AT = g.sp_dv.shape[1], g.ip_dv.shape[1]
    valid = db.valid
    n_live = int(dc.node_valid.sum().item())
    p_live = int(valid.sum().item())
    slots = int(((db.tsc_topo[:, :C] >= 0) & valid[:, None]).sum().item())
    terms = int(((db.aff_kind[:, :AT] >= 0) & valid[:, None]).sum().item())
    t_live = _live(wt["rep_sp_p"]) + 2 * _live(wt["rep_ip_p"])
    b = k5_bytes(torch, dc, db, g, chosen, n_feas, weights) + nbytes(*(wt[k] for k in WAVE_TABLES[:6]))
    b += t_live * n_live * 4 + nbytes(*(rows[k] for k in ("gang_id", "gang_first", "gang_last", "gang_need")))
    b += 2 * P * 4 + 2 * rows["g_cap"] * 4
    ops = n_live * (p_live * (db.requests.shape[1] * 3 + 80) + (slots + terms) * 12) + t_live * n_live * 2
    if dra is not None:
        _, DQ, _, DD = dra["match"].shape
        b += nbytes(dra["match"], *(dra[k] for k in ("req_count", "req_all", "req_cl", "q_valid", "req_bad", "ref_cl")))
        b += 2 * nbytes(dra["free0"], dra["claim_node0"])
        ops += p_live * n_live * DQ * DD * 2
    return bound_ms(b, ops)


def k11_variant(torch, fn, cap):
    """fn() with K11's (and K9's) cluster capped at `cap` CTAs; (its result,
    the CTAs K11's last launch took)."""
    from kubernetes_tpu_torch.ops import coscheduling as cos
    from kubernetes_tpu_torch.ops import wave

    old = wave.ADMIT_CLUSTER_CAP
    wave.ADMIT_CLUSTER_CAP = cap
    try:
        out = fn()
        torch.cuda.synchronize()
        return out, cos.admit_stats["cluster"]
    finally:
        wave.ADMIT_CLUSTER_CAP = old


def workloads_row(torch, name, dc, db, kw, d_cap, flags, wt, rows, reps, nom=None, composite=False):
    """K11 against workloads_admit_plain on one packed batch and its gang
    rows, exact on every output (the choices after and before rollback,
    n_feas, the reason counts, the tallies, gang_admit, gang_landed), on its
    cluster of 16 CTAs and capped at 8, and K11 with the gang rows cleared
    against K9 on the same statics (the same recurrence without the gangs);
    then K11's time, the plain version's (one run), K9's with the gang rows
    cleared (K11 / K9: the gangs' cost, the rollbacks' undo included), the
    cluster, the placements the rollbacks undid, and the bound; with
    `composite`, also workloads_run's bound,
    the sum of the bounds of the kernels it launches here (K1, K6 with
    spread, K7, K8, K11).  Statics: precompute on the card without the
    port axis, as workloads_run runs it (K1, K6 and K7 are held against
    their plain versions by the gang phase).  Returns the row."""
    from kubernetes_tpu_torch.ops import coscheduling as cos
    from kubernetes_tpu_torch.ops import gang, wave

    hk = kw["hostname_key"]
    g = gang.precompute(dc, db, **kw, **dict(flags, has_ports=False))
    targs = [wt[k] for k in WAVE_TABLES]
    gk = [rows[k] for k in ("gang_id", "gang_first", "gang_last", "gang_need", "g_cap")]
    tkw = dict(d_cap=d_cap, d2_cap=wt["d2_cap"], **(nom or {}))
    got = cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw)
    torch.cuda.synchronize()
    cluster, undone = cos.admit_stats["cluster"], int(cos.admit_stats["undone"].item())
    got8, ctas8 = k11_variant(torch, lambda: cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw), 8)
    want, plain_ms = timed_once(torch, lambda: cos.workloads_admit_plain(dc, db, g, hk, *targs, *gk, **tkw))
    P = db.valid.shape[0]
    cleared = [torch.full((P,), -1, dtype=torch.int32, device=dc.node_valid.device),
               torch.zeros((P,), dtype=torch.bool, device=dc.node_valid.device),
               torch.zeros((P,), dtype=torch.bool, device=dc.node_valid.device),
               torch.zeros((P,), dtype=torch.int32, device=dc.node_valid.device), rows["g_cap"]]
    free = cos.workloads_admit(dc, db, g, hk, *targs, *cleared, **tkw)
    c0 = wave.wave_speculate(dc, db, g, d_cap=d_cap, **(nom or {}))
    k9 = wave.wave_admit(dc, db, g, hk, c0, *targs, **tkw)
    torch.cuda.synchronize()

    def outs(o):  # the claim_node output is None without claims
        return list(o[:4]) + [o[4][k] for k in ("requested", "nonzero", "num_pods")] + [
            x for x in o[5:] if x is not None]

    errs = dict(k11_err=max(max_abs_err(torch, a, b) for a, b in zip(outs(got), outs(want))),
                k11_cluster8_err=max(max_abs_err(torch, a, b) for a, b in zip(outs(got8), outs(want))),
                k11_vs_k9=max(max_abs_err(torch, free[0], k9[0]), max_abs_err(torch, free[1], k9[0]),
                              max_abs_err(torch, free[2], k9[1]), max_abs_err(torch, free[3], k9[2])))
    if any(errs.values()) or ctas8 != 8:
        raise AssertionError(f"{name}: workloads_admit differs ({ctas8} CTAs capped at 8): {errs}")
    chosen, raw, n_feas, _, _, gang_admit, gang_landed, _ = want
    if undone != int(((chosen < 0) & (raw >= 0)).sum().item()):
        raise AssertionError(f"{name}: K11 undid {undone} placements, the rolled-back members placed differ")
    b11, by11 = k11_bound(torch, dc, db, g, wt, rows, raw, n_feas, gang.DEFAULT_WEIGHTS)
    row = dict(shape=name, cluster=cluster, undone=undone, N=int(dc.node_valid.sum().item()),
               P=int(db.valid.sum().item()),
               placed=int(dc.epod_valid.sum().item()), C=g.sp_dv.shape[1], AT=g.ip_dv.shape[1],
               Tsp=_live(wt["rep_sp_p"]), Tip=_live(wt["rep_ip_p"]), nominations=len(nom["nom_node"]) if nom else 0,
               gangs=int((gang_admit >= 0).sum().item()), admitted=int((gang_admit == 1).sum().item()),
               rolled_back=int((gang_admit == 0).sum().item()),
               rolled_back_members=int(((chosen < 0) & (raw >= 0)).sum().item()),
               scheduled=int((chosen >= 0).sum().item()), **errs)
    if name != "config10" and not row["rolled_back_members"]:
        raise AssertionError(f"{name}: no gang rolled back after placing members")
    row["workloads_admit"] = dict(
        ms=time_ms(torch, lambda: cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw), reps),
        plain_ms=plain_ms, bound_ms=b11, bound_by=by11, library_ms=None)
    row["wave_admit_ms_same_statics_no_gangs"] = time_ms(torch, lambda: wave.wave_admit(dc, db, g, hk, c0, *targs,
                                                                                        **tkw), reps)
    row["k11_over_k9"] = row["workloads_admit"]["ms"] / row["wave_admit_ms_same_statics_no_gangs"]
    ms8, _ = k11_variant(torch, lambda: time_ms(torch, lambda: cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw),
                                                reps), 8)
    row["workloads_admit"]["cluster8"] = dict(ms=ms8, max_abs_err=errs["k11_cluster8_err"])
    if composite:  # workloads_run's bound: its kernels' bounds at this shape
        spec_feas = torch.zeros((P,), dtype=torch.int64, device=dc.node_valid.device)
        c0p = wave.wave_speculate_plain(dc, db, g, d_cap=d_cap, n_feas=spec_feas, **(nom or {}))
        b8 = wave_bounds(torch, dc, db, g, wt, c0p, spec_feas, raw, n_feas, gang.DEFAULT_WEIGHTS)[0][0]
        b6, b7, _ = gang_bounds(torch, dc, db, g, raw, n_feas, gang.DEFAULT_WEIGHTS)
        parts = dict(static_eval=precompute_static_bound(dc, db, flags["has_images"])[0],
                     gang_interpod_statics=b7[0], wave_speculate=b8, workloads_admit=b11)
        if flags["has_spread"]:
            parts["gang_spread_statics"] = b6[0]
        row["workloads_run_bound_ms"] = sum(parts.values())
        row["workloads_run_bound_parts"] = parts
    log(phase="workloads_kernel_check", **row)
    return row


def phase_workloads_kernels(torch, device, reps=5, shapes=None):
    """workloads_row on workloads_shapes().  Returns the rows by name."""
    rows = {}
    for name, nodes, placed, pending, need, nominated in (shapes or workloads_shapes()):
        dc, db, kw, d_cap, flags, wt = wave_inputs(torch, device, nodes, placed, pending)
        P = db.valid.shape[0]
        gr = gang_rows(torch, device, int(db.valid.sum().item()), P, need)
        nom = nominations(torch, dc, db, 64) if nominated else None
        rows[name] = workloads_row(torch, name, dc, db, kw, d_cap, flags, wt, gr, reps, nom,
                                   composite=name == "config10")
    return rows


def gang_drain(device, nodes, groups, pods, warm=0, storage=((), ()), dra=None, **cfg):
    """A drain of PodGroup gangs through Scheduler(): the groups registered
    through on_pod_group_add, the (PVs, PVCs) of `storage` through
    on_pv_add / on_pvc_add and, with `dra` (slices, classes, claims), the
    DynamicResourceAllocation gate on and the DRA objects through their
    handlers; then the first `warm` pods drained, then the rest (bench_gang's
    and bench_dra's warm-up).  Returns (placements, outcomes by pod name,
    seconds of the second drain, scheduler)."""
    from kubernetes_tpu_torch.framework.config import SchedulerConfiguration
    from kubernetes_tpu_torch.scheduler import Scheduler

    config = SchedulerConfiguration(**cfg)
    config.feature_gates["DynamicResourceAllocation"] = dra is not None
    sched = Scheduler(config, device=device)
    bound = {}

    def sink_many(pairs):
        for pod, node in pairs:
            bound[pod.uid] = node
        return [None] * len(pairs)

    sched.binding_sink_many = sink_many
    for n in nodes:
        sched.on_node_add(n)
    for pg in groups:
        sched.on_pod_group_add(pg)
    for pv in storage[0]:
        sched.on_pv_add(pv)
    for pvc in storage[1]:
        sched.on_pvc_add(pvc)
    if dra is not None:
        slices, classes, claims = dra
        for cls in classes.values():
            sched.on_device_class_add(cls)
        for sl in slices:
            sched.on_resource_slice_add(sl)
        for c in claims.values():
            sched.on_resource_claim_add(c)
    out = []
    for part in (pods[:warm], pods[warm:]):
        for p in part:
            sched.on_pod_add(p)
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out += sched.schedule_pending()
        dt = time.perf_counter() - t0
    got = {o.pod.name: o for o in out}
    if len(got) != len(pods):
        raise AssertionError(f"{len(got)} outcomes for {len(pods)} pods")
    for o in out:
        if o.node is not None and bound.get(o.pod.uid) != o.node:
            raise AssertionError(f"pod {o.pod.name} placed on {o.node} but not bound there")
    return {k: o.node for k, o in got.items()}, got, dt, sched


WORKLOAD_METRICS = ("workload_batches", "workload_spec_admitted", "gang_admitted", "gang_rolled_back")


def phase_config10(torch, device, n_nodes=1000, n_pods=20000):
    """bench.py bench_gang (config10) at full size on the card: 1,000 nodes
    in 8 zones, 20,000 pods in 2,500 PodGroups of 8 (minMember 8), the
    default batch of 512, a warm-up of 576 pods (whole gangs) drained
    first.  Every pod placed, gang_admitted 20,000 and no rollback, every
    gang whole, K11 launched once per workloads batch (>= 39 of them), K8
    launched, no node over its allocatable.  Returns the launches."""
    from kubernetes_tpu_torch.ops import _build

    pods, groups = gang_pods(n_pods)
    warm = min(512 + 64, len(pods) - 64)
    warm -= warm % 8
    _build.reset_launches()
    got, _, dt, sched = gang_drain(device, basic_nodes(n_nodes, zones=8), groups, pods, warm=warm)
    launches = dict(_build.launches)
    check_capacity(sched)
    m = sched.metrics
    gangs = {}
    for p in pods:
        gangs.setdefault(p.pod_group, set()).add(got[p.name] is not None)
    bad = [m["gang_admitted"] != n_pods, m["gang_rolled_back"] != 0, any(v is None for v in got.values()),
           any(s != {True} for s in gangs.values()), launches["workloads_admit"] != m["workload_batches"],
           m["workload_batches"] < 39, launches["wave_speculate"] <= 0]
    if any(bad):
        raise AssertionError(f"config10: {bad}: {launches} {({k: m[k] for k in WORKLOAD_METRICS})}")
    timed = len(pods) - warm
    log(phase="config10_drain", nodes=n_nodes, pods=n_pods, gangs=len(groups), warm_pods=warm, drain_s=dt,
        pods_per_s=timed / dt, placed=n_pods, launches=launches, **{k: m[k] for k in WORKLOAD_METRICS},
        fast_batches=m["fast_batches"], scan_batches=m["scan_batches"], wave_batches=m["wave_batches"],
        whole_gangs=len(gangs), capacity_ok=True)
    return launches


def contended_gang_world(n_nodes=250, n_gangs=100, n_plain=200, seed=29):
    """The contended gang parity workload: n_nodes nodes of 4 cpu / 16Gi in
    4 zones; n_gangs seeded gangs of 4-12 members with minMember between
    half and all of them and member requests of 300m-1500m cpu (weighted
    to the top); a third of the gangs spread over the zones among their own
    members (maxSkew 1, DoNotSchedule), a third with hostname anti-affinity
    among their members; n_plain plain pods of 1-2.5 cpu, two after each
    gang.  Total cpu demand about 125 % of the cluster's.  Returns (nodes,
    groups, pending)."""
    from kubernetes_tpu_torch.api import (
        Affinity, Container, LabelSelector, Node, Pod, PodAffinityTerm, PodAntiAffinity, Resource,
        TopologySpreadConstraint,
    )
    from kubernetes_tpu_torch.workloads.gang import PodGroup

    rng = random.Random(seed)
    nodes = [Node(name=f"node-{i}", labels={ZONE: f"zone-{i % 4}", HOSTNAME: f"node-{i}"},
                  capacity=Resource.from_map({"cpu": "4", "memory": "16Gi", "pods": 110})) for i in range(n_nodes)]
    groups, pending = [], []
    plain = iter(Pod(name=f"plain-{i}", labels={"app": "plain"},
                     containers=[Container(name="c", requests={"cpu": f"{rng.choice([1000, 1500, 2000, 2500])}m",
                                                               "memory": "256Mi"})]) for i in range(n_plain))
    for g in range(n_gangs):
        size = rng.randint(4, 12)
        name = f"cg-{g}"
        groups.append(PodGroup(name=name, min_member=rng.randint((size + 1) // 2, size)))
        sel = LabelSelector(match_labels={"gang": name})
        kw = {}
        if g % 3 == 0:
            kw["topology_spread_constraints"] = (TopologySpreadConstraint(
                max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule", label_selector=sel),)
        elif g % 3 == 1:
            kw["affinity"] = Affinity(pod_anti_affinity=PodAntiAffinity(
                required_during_scheduling_ignored_during_execution=(
                    PodAffinityTerm(topology_key=HOSTNAME, label_selector=sel),)))
        for m in range(size):
            cpu = rng.choice([300, 600, 900, 1200, 1500, 1500, 1500, 1500])
            pending.append(Pod(name=f"{name}-{m}", labels={"gang": name}, pod_group=name,
                               containers=[Container(name="c", requests={"cpu": f"{cpu}m", "memory": "256Mi"})],
                               **kw))
        pending += [next(plain, None), next(plain, None)]
    return nodes, groups, [p for p in pending if p is not None]


def phase_gang_parity_contended(torch, device, **world):
    """contended_gang_world drained once on the card and once with
    device="cpu" (the plain versions): placements, FitErrors and gang
    messages, diagnoses, gang_admitted, gang_rolled_back and
    workload_spec_admitted identical; some gangs rolled back; K8 and K11
    launched on the card; no node over its allocatable.  The card's machine
    has no JAX, so this is the workloads route's end-to-end check there."""
    from kubernetes_tpu_torch.ops import _build

    runs = []
    for dev in (device, torch.device("cpu")):
        nodes, groups, pending = contended_gang_world(**world)
        _build.reset_launches()
        got, outs, dt, sched = gang_drain(dev, nodes, groups, pending)
        check_capacity(sched)
        runs.append(({k: (o.node, o.reason, o.diagnosis) for k, o in outs.items()},
                     {k: sched.metrics[k] for k in WORKLOAD_METRICS}, dt, dict(_build.launches), sched))
    (want, wm, dt, launches, sched), (cpu, cm, dt_cpu, _, _) = runs
    diff = [k for k in want if want[k] != cpu.get(k)]
    if diff or wm != cm:
        raise AssertionError(f"contended gang parity: {len(diff)} outcomes differ (first {diff[:1]}), "
                             f"metrics {wm} vs {cm}")
    if not wm["gang_rolled_back"] or launches["workloads_admit"] <= 0 or launches["wave_speculate"] <= 0:
        raise AssertionError(f"contended gang parity: no rollback, or K8/K11 never launched: {wm} {launches}")
    placed = sum(v[0] is not None for v in want.values())
    log(phase="gang_parity_contended", nodes=len(nodes), pods=len(want), placed=placed, unschedulable=len(want) - placed,
        identical=True, cuda_drain_s=dt, cpu_drain_s=dt_cpu, launches=launches, **wm,
        wave_batches=sched.metrics["wave_batches"], scan_batches=sched.metrics["scan_batches"])
    return launches


# ---------------------------------------------------------------------------
# Phase 10: bound volumes (K12)
# ---------------------------------------------------------------------------

ABSENT_ZONE = "zone-absent"


def zone_selector(*zones):
    from kubernetes_tpu_torch.api import NodeSelector, NodeSelectorRequirement, NodeSelectorTerm

    return NodeSelector(tuple(NodeSelectorTerm(match_expressions=(NodeSelectorRequirement(ZONE, "In", (z,)),))
                              for z in zones))


def bound_pv(name, affinity=None, labels=None):
    """A PV and a PVC bound to it (the StatefulSet replica's data claim)."""
    from kubernetes_tpu_torch.api import storage as st

    pv = st.PersistentVolume(name=f"pv-{name}", capacity=10 << 30, storage_class_name="zonal", node_affinity=affinity,
                             labels=dict(labels or {}), phase=st.PV_BOUND, claim_ref=st.ObjectRef("default", name))
    pvc = st.PersistentVolumeClaim(name=name, request=10 << 30, storage_class_name="zonal", volume_name=pv.name,
                                   phase=st.PVC_BOUND)
    return pv, pvc


def statefulset_world(n_pods=10000, zones=8, seed=31, prefix="ss"):
    """StatefulSet replicas (50 sets, 500m cpu / 1Gi each) with one bound
    PVC apiece, whose PV is, by seeded draw: 60 % node affinity
    `topology.kubernetes.io/zone In [z]`, 20 % the zone label only
    (VolumeZone's form), 15 % nil affinity, 5 % pinned to a zone no node
    carries.  Returns (pvs, pvcs, pods, {pod name: the PV's zone or None})."""
    from kubernetes_tpu_torch.api import Container, Pod, Volume

    rng = random.Random(seed)
    pvs, pvcs, pods, zone_of = [], [], [], {}
    for i in range(n_pods):
        name = f"{prefix}-{i}"
        r, z = rng.random(), f"zone-{rng.randrange(zones)}"
        if r < 0.60:
            pv, pvc = bound_pv(f"data-{name}", affinity=zone_selector(z))
        elif r < 0.80:
            pv, pvc = bound_pv(f"data-{name}", labels={ZONE: z})
        elif r < 0.95:
            pv, pvc = bound_pv(f"data-{name}")
            z = None
        else:
            z = ABSENT_ZONE
            pv, pvc = bound_pv(f"data-{name}", affinity=zone_selector(z))
        pvs.append(pv)
        pvcs.append(pvc)
        zone_of[name] = z
        pods.append(Pod(name=name, labels={"app": f"db-{i % 50}"}, volumes=(Volume(name="data", pvc_name=pvc.name),),
                        containers=[Container(name="c", requests={"cpu": "500m", "memory": "1Gi"})]))
    return pvs, pvcs, pods, zone_of


def k12_world(n_pods=512, zones=8, seed=37):
    """The K12 check's batch, at most two PV2 slots per pod: one claim whose
    PV carries a one- or two-term zone affinity, the zone label (a two-zone
    set among them), both (two slots) or nil affinity; or two claims of one
    slot each; now and then a claim whose PV is missing (a vol_bad pod).
    Returns (pvs, pvcs, pods)."""
    from kubernetes_tpu_torch.api import Container, Pod, Volume

    rng = random.Random(seed)
    pvs, pvcs, pods = [], [], []
    for i in range(n_pods):
        claims = []
        two = rng.random() < 0.3  # two claims of one slot each, else one of up to two
        for c in range(2 if two else 1):
            name, r = f"k12-{i}-{c}", rng.random()
            zs = [f"zone-{rng.randrange(zones)}" for _ in range(2)]
            if r < 0.35:
                pv, pvc = bound_pv(name, affinity=zone_selector(*zs[: rng.randint(1, 2)]))
            elif r < 0.6:
                pv, pvc = bound_pv(name, labels={ZONE: "__".join(zs) if rng.random() < 0.3 else zs[0]})
            elif r < 0.8 and not two:
                pv, pvc = bound_pv(name, affinity=zone_selector(zs[0]), labels={ZONE: zs[1]})
            else:
                pv, pvc = bound_pv(name)
            if rng.random() < 0.04:
                pv = None  # the claim's PV is missing
            if pv is not None:
                pvs.append(pv)
            pvcs.append(pvc)
            claims.append(pvc.name)
        pods.append(Pod(name=f"k12-{i}", volumes=tuple(Volume(name=f"v{k}", pvc_name=c) for k, c in enumerate(claims)),
                        containers=[Container(name="c", requests={"cpu": "100m"})]))
    return pvs, pvcs, pods


def k12_inputs(device, n_nodes=5000, P=512, world=None):
    """k12_world's batch (or ``world``'s (pvs, pvcs, pods)) as the workloads
    dispatch packs it, on config4's node set: (scheduler, PodBatch,
    DeviceCluster, DeviceBatch, the _vol_tables keyword arguments)."""
    from types import SimpleNamespace

    from kubernetes_tpu_torch.framework.config import SchedulerConfiguration
    from kubernetes_tpu_torch.ops.common import DeviceBatch
    from kubernetes_tpu_torch.scheduler import Scheduler

    sched = Scheduler(SchedulerConfiguration(), device=device)
    for n in basic_nodes(n_nodes, zones=8):
        sched.on_node_add(n)
    pvs, pvcs, pods = world if world is not None else k12_world(P)
    for pv in pvs:
        sched.on_pv_add(pv)
    for pvc in pvcs:
        sched.on_pvc_add(pvc)
    sched._repack_mirror()
    _, pb = sched._gang_prep([SimpleNamespace(pod=p) for p in pods])
    dc = sched._dc_cache.sync(sched.mirror, sched.vocab)
    volt = sched._vol_tables(pods, pb.valid.shape[0])
    return sched, pb, dc, DeviceBatch.from_host(pb, device), volt


def k12_check(torch, dc, volt):
    """One K12 launch against volume_topology_mask_plain on the same
    inputs, exactly; returns (K12's mask, differing pairs: 0)."""
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import coscheduling as cos

    n0 = _build.launches["volume_topology_mask"]
    got = cos.volume_topology_mask(dc, **volt)
    torch.cuda.synchronize()
    if _build.launches["volume_topology_mask"] != n0 + 1:
        raise AssertionError("volume_topology_mask did not count its launch")
    want = cos.volume_topology_mask_plain(dc, **volt)
    err = int((got != want).sum().item())
    if err:
        raise AssertionError(f"K12 differs from its plain version at {err} (pod, node) pairs")
    return got, err


def phase_volume_kernels(torch, device, reps=20, n_nodes=5000, P=512):
    """K12 volume_topology_mask against its plain version on the card,
    exactly, at config4's node set (N=5,000 in 8 zones) and P=512 pods of
    k12_world packed by the scheduler's own _vol_tables (PV2 = 2, one to
    two terms per PV, nil-affinity, zone-labelled and vol_bad rows); then K1
    with K12's mask as its extra lane against K1's plain version.  Times
    with CUDA events; bounds from this run's inputs: bytes read and written
    once at 3.35 TB/s, and the requirement compares the table's valid slots
    need at every node at the integer issue rate.  Returns the K12 row."""
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import coscheduling as cos
    from kubernetes_tpu_torch.ops import fastpath as ops_fp
    from kubernetes_tpu_torch.snapshot.interner import PAD

    sched, pb, dc, db, volt = k12_inputs(device, n_nodes, P)
    t = volt["vol_table"]
    got, err = k12_check(torch, dc, volt)
    k12_ms = time_ms(torch, lambda: cos.volume_topology_mask(dc, **volt), reps)
    plain_ms = time_ms(torch, lambda: cos.volume_topology_mask_plain(dc, **volt), 3)
    Pc, PV2, T, R = t.req_key.shape
    V = t.req_vals.shape[-1]
    N = dc.node_labels.shape[0]
    moved = nbytes(t.req_key, t.req_op, t.req_vals, t.req_rhs, t.term_valid, volt["vol_valid"], volt["vol_bad"],
                   dc.node_labels, dc.val_ints, got)
    live = (t.req_op != PAD) & t.term_valid[..., None] & volt["vol_valid"][:, :, None, None]
    ops = int(live.sum().item()) * (V + 1) * N
    bound, by = bound_ms(moved, ops)
    # K1 with the volume mask as its extra lane (the precompute's call)
    every = frozenset({"NodeName", "NodeUnschedulable", "TaintToleration", "NodeAffinity"})
    enabled = sched.profiles["default-scheduler"].enabled
    kw = dict(extra_mask=got, mask_enabled=enabled)
    k1 = ops_fp.static_eval(dc, db, every, False, **kw)
    k1_plain = ops_fp.static_eval_plain(dc, db, every, False, **kw)
    k1_err = sum(int((k1[k] != k1_plain[k]).sum().item()) for k in ops_fp.STATIC_KEYS)
    if k1_err:
        raise AssertionError(f"K1 with the extra mask differs from its plain version at {k1_err} entries")
    k1_ms = time_ms(torch, lambda: ops_fp.static_eval(dc, db, every, False, **kw), reps)
    k1_bound, k1_by = static_bound(dc, db, k1, extra_bytes=nbytes(got))
    live_pn = torch.as_tensor(pb.valid, device=device)[:, None] & dc.node_valid[None, :]
    masked = int(((~got) & live_pn).sum().item())
    log(phase="volume_kernel_check", kernel="volume_topology_mask", replaces="kubernetes_tpu/ops/coscheduling.py:66",
        P=Pc, N=N, PV2=PV2, T=T, R=R, V=V, bad_pods=int(volt["vol_bad"].sum().item()), pairs_masked=masked,
        k12_err=err, ms=k12_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, bytes=moved, ops=ops,
        library_ms=None, k1_extra_err=k1_err, k1_extra_ms=k1_ms, k1_extra_bound_ms=k1_bound, k1_extra_bound_by=k1_by)
    return dict(max_abs_err=err, ms=k12_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)


def phase_statefulset(torch, device, n_nodes=5000, n_pods=10000):
    """The StatefulSet drain on the card: statefulset_world's 10,000
    replicas on config4's 5,000 nodes (8 zones) through Scheduler(), every
    batch a workloads dispatch.  Every placed pod is in its PV's zone, every
    pod whose PV is pinned to the absent zone is unplaced with "volume node
    affinity conflict", every other pod is placed, no node is over its
    allocatable, and K12 launched once per workloads batch (K1, K8 and K11
    launched too).  Before the drain, K12 is held against its plain version
    on the drain's first batch packed as the drain packs it (one PV2 slot).
    Returns (the launches, that check's differing pairs)."""
    from kubernetes_tpu_torch.ops import _build

    nodes = basic_nodes(n_nodes, zones=8)
    zone = {n.name: n.labels[ZONE] for n in nodes}
    pvs, pvcs, pods, zone_of = statefulset_world(n_pods)
    _, _, dc, _, volt = k12_inputs(device, n_nodes, 512, world=(pvs[:512], pvcs[:512], pods[:512]))
    _, k12_err = k12_check(torch, dc, volt)
    k12_shape = tuple(volt["vol_table"].req_key.shape)
    del dc, volt
    _build.reset_launches()
    timer = SyncTimer(torch)
    try:
        got, outs, dt, sched = gang_drain(device, nodes, (), pods, storage=(pvs, pvcs))
    finally:
        syncs = timer.close()
    launches = dict(_build.launches)
    check_capacity(sched)
    m = sched.metrics
    wrong_zone = [k for k, node in got.items() if node is not None and zone_of[k] not in (None, zone[node])]
    absent = [k for k, z in zone_of.items() if z == ABSENT_ZONE]
    absent_ok = all(got[k] is None and "volume node affinity conflict" in outs[k].reason for k in absent)
    others_placed = all(got[k] is not None for k, z in zone_of.items() if z != ABSENT_ZONE)
    bad = [bool(wrong_zone), not absent_ok, not others_placed,
           launches["volume_topology_mask"] != m["workload_batches"], m["workload_batches"] < n_pods // 512,
           any(launches[k] <= 0 for k in ("static_eval", "wave_speculate", "workloads_admit"))]
    if any(bad):
        raise AssertionError(f"statefulset: {bad} wrong zone {wrong_zone[:3]}: {launches} "
                             f"{({k: m[k] for k in WORKLOAD_METRICS})}")
    placed = sum(v is not None for v in got.values())
    log(phase="statefulset_drain", nodes=n_nodes, pods=n_pods, placed=placed, absent_zone_pods=len(absent),
        drain_s=dt, pods_per_s=n_pods / dt, launches=launches, **{k: m[k] for k in WORKLOAD_METRICS},
        fast_batches=m["fast_batches"], wave_batches=m["wave_batches"], scan_batches=m["scan_batches"],
        preemption_attempts=m["preemption_attempts"], zones_ok=True, capacity_ok=True, device_mirror_syncs=syncs,
        k12_err=k12_err, k12_P_PV2_T_R=k12_shape)
    return launches, k12_err


def volume_parity_world(n_nodes=1000, n_vol=600, n_gangs=20, n_spread=320, seed=41):
    """The volume parity workload, one queue: statefulset_world's volume
    pods, 20 PodGroups of 8 (minMember 8) whose members each hold a PV
    pinned to their gang's zone (one gang pinned to a zone it cannot fit),
    and zone-spread pods (config4's), interleaved.  Returns (nodes, groups,
    pvs, pvcs, pods)."""
    from kubernetes_tpu_torch.api import Container, Pod, Volume
    from kubernetes_tpu_torch.workloads.gang import PodGroup

    rng = random.Random(seed)
    nodes = basic_nodes(n_nodes, zones=8)
    pvs, pvcs, vol, _ = statefulset_world(n_vol, seed=seed, prefix="pv")
    spread = spread_pods(n_spread, prefix="sp")
    groups, gang = [], []
    for g in range(n_gangs):
        name = f"vg-{g}"
        groups.append(PodGroup(name=name, min_member=8))
        z = ABSENT_ZONE if g == 7 else f"zone-{g % 8}"
        for m in range(8):
            pv, pvc = bound_pv(f"data-{name}-{m}", affinity=zone_selector(z))
            pvs.append(pv)
            pvcs.append(pvc)
            gang.append(Pod(name=f"{name}-{m}", pod_group=name, volumes=(Volume(name="data", pvc_name=pvc.name),),
                            containers=[Container(name="c", requests={"cpu": f"{rng.choice([1, 2, 4])}",
                                                                      "memory": "2Gi"})]))
    pods, streams = [], [vol, spread, gang]
    while any(streams):
        s = rng.choice([x for x in streams if x])
        pods.append(s.pop(0))
    return nodes, groups, pvs, pvcs, pods


def phase_volume_parity(torch, device, **world):
    """volume_parity_world drained in one batch on the card and with
    device="cpu" (the plain versions): outcomes (node, FitError, diagnosis)
    and the workloads metrics identical; and the placements equal the
    port's serial WorkloadOracle with volumes replaying the same queue.  K12
    launched on the card.  Returns the launches."""
    import copy

    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.oracle.state import OracleState
    from kubernetes_tpu_torch.oracle.workloads import WorkloadOracle

    runs = []
    for dev in (device, torch.device("cpu")):
        nodes, groups, pvs, pvcs, pods = volume_parity_world(**world)
        _build.reset_launches()
        got, outs, dt, sched = gang_drain(dev, nodes, groups, pods, storage=(pvs, pvcs), batch_size=2048)
        check_capacity(sched)
        runs.append(({k: (o.node, o.reason, o.diagnosis) for k, o in outs.items()},
                     {k: sched.metrics[k] for k in WORKLOAD_METRICS}, dt, dict(_build.launches)))
    (want, wm, dt, launches), (cpu, cm, dt_cpu, _) = runs
    diff = [k for k in want if want[k] != cpu.get(k)]
    if diff or wm != cm:
        raise AssertionError(f"volume parity: {len(diff)} outcomes differ (first {diff[:1]}), metrics {wm} vs {cm}")
    nodes, groups, pvs, pvcs, pods = volume_parity_world(**world)
    t0 = time.perf_counter()
    oracle = WorkloadOracle(OracleState.build(nodes, []), groups={pg.key: pg for pg in groups},
                            pvs={pv.name: pv for pv in pvs}, pvcs={pvc.key: pvc for pvc in pvcs})
    serial = oracle.schedule([copy.deepcopy(p) for p in pods]).placements
    dt_oracle = time.perf_counter() - t0
    odiff = [k for k in serial if serial[k] != want[k][0]]
    if odiff or wm["workload_batches"] != 1 or not wm["gang_rolled_back"] or launches["volume_topology_mask"] != 1:
        raise AssertionError(f"volume parity: {len(odiff)} placements differ from the oracle (first {odiff[:1]}), "
                             f"{wm} {launches}")
    placed = sum(v[0] is not None for v in want.values())
    log(phase="volume_parity", nodes=len(nodes), pods=len(want), placed=placed, identical=True,
        equal_to_oracle=True, cuda_drain_s=dt, cpu_drain_s=dt_cpu, oracle_s=dt_oracle, launches=launches, **wm)
    return launches



# ---------------------------------------------------------------------------
# Phase 10: DRA claims (K13 dra_selector_match, K14 dra_spec_mask, K11's DRA
# mode)
# ---------------------------------------------------------------------------

DRA_VALUES = {"vendor": ("x", "y"), "mem": ("16", "32", "80"), "model": ("a", "b", "c"), "numa": ("0", "1")}


def dra_check_world(n_nodes=5000, P=512, devices=8, seed=43):
    """The K13 / K14 / K11 check's DRA surface on config4's node set: one
    ResourceSlice of `devices` devices per node, each device with the four
    DRA_VALUES attributes; DeviceClasses with one selector each ("gpu":
    vendor In x, "big": mem In 32 80, "fresh": model NotIn c) and "any";
    P pods (100m cpu) of one or two claims, each claim one request of class
    gpu / big / fresh / any with zero to two selectors of its own (DQ = 2,
    DS = 3 (bucket 4), DV = 2 once packed): ExactCount of 1 to 4, or All (1
    in 10); one pod in 8 shares the claim of the pod before it; one claim in
    20 is pre-allocated on the last device of a random node (its pod pinned
    there), and 2,000 claims no pod references (fewer on a small node set)
    hold one other device each,
    no device held twice.  Returns (slices, classes, claims, pods)."""
    from kubernetes_tpu_torch.api import Container, Pod
    from kubernetes_tpu_torch.api import dra

    rng = random.Random(seed)
    slices = []
    for i in range(n_nodes):
        devs = tuple(dra.Device(name=f"dev-{j}", attributes=tuple((k, rng.choice(v)) for k, v in DRA_VALUES.items()))
                     for j in range(devices))
        slices.append(dra.ResourceSlice(name=f"sl-{i}", node_name=f"node-{i}", driver="gpu.example.com",
                                        pool=f"pool-{i}", devices=devs))
    classes = {"gpu": dra.DeviceClass("gpu", (dra.DeviceSelector("vendor", "In", ("x",)),)),
               "big": dra.DeviceClass("big", (dra.DeviceSelector("mem", "In", ("32", "80")),)),
               "fresh": dra.DeviceClass("fresh", (dra.DeviceSelector("model", "NotIn", ("c",)),)),
               "any": dra.DeviceClass("any")}
    claims, pods = {}, []
    held = set()  # (node, device slot) an allocated claim holds

    def new_claim(name):
        sels = []
        for _ in range(rng.choice([0, 1, 1, 2])):
            key = rng.choice(sorted(DRA_VALUES))
            op = rng.choice(["In", "In", "NotIn", "Exists"])
            vals = tuple(rng.sample(DRA_VALUES[key], 2 if len(DRA_VALUES[key]) > 2 else 1)) if op != "Exists" else ()
            sels.append(dra.DeviceSelector(key, op, vals))
        mode = dra.ALLOCATION_MODE_ALL if rng.random() < 0.1 else dra.ALLOCATION_MODE_EXACT
        req = dra.DeviceRequest("r", rng.choice(sorted(classes)), count=rng.randint(1, 4), allocation_mode=mode,
                                selectors=tuple(sels))
        alloc = None
        n = rng.randrange(n_nodes)
        if rng.random() < 0.05 and (n, devices - 1) not in held:
            held.add((n, devices - 1))
            alloc = dra.AllocationResult((dra.DeviceRequestAllocationResult("r", "gpu.example.com", f"pool-{n}",
                                                                            f"dev-{devices - 1}"),), f"node-{n}")
        claims[f"default/{name}"] = dra.ResourceClaim(name=name, requests=(req,), allocation=alloc)
        return name

    for i in range(P):
        refs = [new_claim(f"c{i}-{k}") for k in range(rng.choice([1, 1, 2]))]
        if i and rng.random() < 0.125:
            refs = [pods[-1].resource_claims[0]]  # shared with the pod before
        pods.append(Pod(name=f"dra-{i}", resource_claims=tuple(refs),
                        containers=[Container(name="c", requests={"cpu": "100m"})]))
    want = min(2000, n_nodes * (devices - 1) // 4) + len(held)
    while len(held) < want:  # claims no pod references
        n, d = rng.randrange(n_nodes), rng.randrange(devices - 1)
        if (n, d) in held:
            continue
        held.add((n, d))
        u = len(held)
        claims[f"default/held-{u}"] = dra.ResourceClaim(
            name=f"held-{u}", requests=(dra.DeviceRequest("r", "any"),),
            allocation=dra.AllocationResult((dra.DeviceRequestAllocationResult(
                "r", "gpu.example.com", f"pool-{n}", f"dev-{d}"),), f"node-{n}"))
    return slices, classes, claims, pods


def dra_inputs(torch, device, n_nodes=5000, P=512, world=None, seed=43):
    """dra_check_world's batch packed as the workloads dispatch packs it, on
    config4's node set (8 zones): (dc, db, precompute kwargs, d_cap, flags,
    wave tables, dra_tables' tensors, the world)."""
    from kubernetes_tpu_torch.ops import dra as ops_dra
    from kubernetes_tpu_torch.ops import wave

    world = world or dra_check_world(n_nodes, P, seed=seed)
    slices, classes, claims, pods = world
    nodes = basic_nodes(n_nodes, zones=8)
    dc, db, kw, d_cap, flags, pb, nt = _gang_pack(torch, device, nodes, [], pods, P)
    wt = wave.wave_tables(pb, nt.label_vals, kw["hostname_key"], device=device)
    dt = ops_dra.dra_tables(pods, nt.name_to_idx, nt.n_cap, P, slices, classes, claims, device=device)
    return dc, db, kw, d_cap, flags, wt, dt, world


def dra_kernel_row(torch, name, dc, db, kw, d_cap, flags, wt, dt, rows, reps):
    """K13, K14, K8 with K14's lane and K11 in DRA mode against their plain
    versions on one packed batch, exactly (the match tensor, the lane, the
    speculation's c0, and every admission output with claim_node); then
    each kernel's time, its plain version's (one run) and its bound from
    this run's inputs, and K11 on the same statics and gang rows with the
    claims cleared (no DRA rows: the DRA mode's cost is the difference).
    Returns the row."""
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import coscheduling as cos
    from kubernetes_tpu_torch.ops import dra as ops_dra
    from kubernetes_tpu_torch.ops import gang, wave

    sel = [dt[k] for k in ("dev_key", "dev_val", "dev_valid", "sel_key", "sel_op", "sel_vals")]
    req = [dt[k] for k in ("req_count", "req_all", "req_cl", "q_valid", "req_bad", "ref_cl")]
    n13, n14 = _build.launches["dra_selector_match"], _build.launches["dra_spec_mask"]
    match = ops_dra.selector_match(*sel)
    lane = ops_dra.dra_spec_mask(match, dt["free0"], dt["claim_node0"], *req)
    torch.cuda.synchronize()
    if (_build.launches["dra_selector_match"], _build.launches["dra_spec_mask"]) != (n13 + 1, n14 + 1):
        raise AssertionError("the DRA kernels did not count their launches")
    match_p, k13_plain_ms = timed_once(torch, lambda: ops_dra.selector_match_plain(*sel))
    lane_p, k14_plain_ms = timed_once(torch, lambda: ops_dra.dra_spec_mask_plain(match, dt["free0"],
                                                                                  dt["claim_node0"], *req))
    k13_err, k14_err = max_abs_err(torch, match, match_p), max_abs_err(torch, lane, lane_p)
    g = gang.precompute(dc, db, **kw, **dict(flags, has_ports=False))
    # K8 with K14's lane as its port lane: the workloads dispatch's
    # speculation on a batch with claims; without the lane, for the count
    # of pods whose speculative node the lane moved
    c0_k = wave.wave_speculate(dc, db, g, d_cap=d_cap, lane=lane)
    c0_p, k8_lane_plain_ms = timed_once(torch, lambda: wave.wave_speculate_plain(dc, db, g, d_cap=d_cap, lane=lane_p))
    c0_nolane = wave.wave_speculate(dc, db, g, d_cap=d_cap)
    k8_lane_err = max_abs_err(torch, c0_k, c0_p)
    hk = kw["hostname_key"]
    targs = [wt[k] for k in WAVE_TABLES]
    gk = [rows[k] for k in ("gang_id", "gang_first", "gang_last", "gang_need", "g_cap")]
    tkw = dict(d_cap=d_cap, d2_cap=wt["d2_cap"])
    dra = dict(match=match, free0=dt["free0"], claim_node0=dt["claim_node0"],
               **{k: dt[k] for k in ("req_count", "req_all", "req_cl", "q_valid", "req_bad", "ref_cl")})
    got = cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw, dra=dra)
    torch.cuda.synchronize()
    k11_stats = dict(k11_cluster=cos.admit_stats["cluster"], k11_claims_smem=cos.admit_stats["claims_smem"],
                     k11_undone=int(cos.admit_stats["undone"].item()))
    got8, ctas8 = k11_variant(torch, lambda: cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw, dra=dra), 8)
    want, k11_plain_ms = timed_once(torch, lambda: cos.workloads_admit_plain(dc, db, g, hk, *targs, *gk, **tkw,
                                                                              dra=dra))
    torch.cuda.synchronize()

    def outs(o):
        return list(o[:4]) + [o[4][k] for k in ("requested", "nonzero", "num_pods")] + list(o[5:])

    k11_err = max(max_abs_err(torch, a, b) for a, b in zip(outs(got) + outs(got8), outs(want) + outs(want)))
    if ctas8 != 8:
        raise AssertionError(f"{name}: K11 capped at 8 CTAs took {ctas8}")
    if k13_err or k14_err or k8_lane_err or k11_err:
        raise AssertionError(f"{name}: DRA kernels differ: K13 {k13_err}, K14 {k14_err}, K8 with the lane "
                             f"{k8_lane_err}, K11 {k11_err}")
    chosen, raw, n_feas, rc, _, gang_admit, _, claim_node = want
    P, DQ, N, DD = match.shape
    live = db.valid
    cover = dict(all_mode=int((dt["req_all"] & dt["q_valid"]).sum().item()),
                 shared=int((torch.bincount(dt["ref_cl"][dt["ref_cl"] >= 0].long()) > 1).sum().item()),
                 preallocated=int((dt["claim_node0"] >= 0).sum().item()),
                 held_devices=int((dt["dev_valid"] & ~dt["free0"]).sum().item()),
                 dra_rejected_pods=int(((rc[:, 4] > 0) & live).sum().item()),
                 spec_lane_false=int(((~lane) & live[:, None] & dc.node_valid[None, :]).sum().item()),
                 spec_moved_by_lane=int(((c0_p != c0_nolane) & live).sum().item()),
                 claims_allocated=int(((claim_node >= 0) & (dt["claim_node0"] < 0)).sum().item()),
                 rolled_back_members=int(((chosen < 0) & (raw >= 0)).sum().item()),
                 rolled_back=int((gang_admit == 0).sum().item()), scheduled=int((chosen >= 0).sum().item()))
    if not all(cover[k] for k in ("all_mode", "shared", "preallocated", "held_devices", "dra_rejected_pods",
                                  "spec_moved_by_lane", "claims_allocated", "rolled_back_members")):
        raise AssertionError(f"{name}: the DRA check batch misses a case: {cover}")
    k13_ms = time_ms(torch, lambda: ops_dra.selector_match(*sel), reps)
    k14_ms = time_ms(torch, lambda: ops_dra.dra_spec_mask(match, dt["free0"], dt["claim_node0"], *req), reps)
    k8_lane_ms = time_ms(torch, lambda: wave.wave_speculate(dc, db, g, d_cap=d_cap, lane=lane), reps)
    k11_ms = time_ms(torch, lambda: cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw, dra=dra), reps)
    k11_nodra_ms = time_ms(torch, lambda: cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw), reps)
    b11, by11 = k11_bound(torch, dc, db, g, wt, rows, raw, n_feas, gang.DEFAULT_WEIGHTS, dra=dra)
    # bounds: bytes each input read once and each output written once; the
    # operations (a few integer compares per selector slot and device
    # attribute; a popcount walk per request slot) are far below them
    DS, DV, DA = dt["sel_key"].shape[2], dt["sel_vals"].shape[3], dt["dev_key"].shape[2]
    b13 = nbytes(*sel, match)
    ops13 = P * DQ * N * DD * DS * (DA + DV)
    b14 = nbytes(match, dt["free0"], dt["claim_node0"], *req, lane)
    ops14 = P * N * DQ * DD * 4
    k13_bound, k13_by = bound_ms(b13, ops13)
    k14_bound, k14_by = bound_ms(b14, ops14)
    row = dict(shape=name, P=P, DQ=DQ, N=N, DD=DD, DS=DS, DV=DV, DA=DA, CL=dt["claim_node0"].shape[0],
               CQ=dt["ref_cl"].shape[1], k13_err=k13_err, k14_err=k14_err, k8_lane_err=k8_lane_err,
               k11_err=k11_err, **cover, **k11_stats, k8_lane_ms=k8_lane_ms, k8_lane_plain_ms=k8_lane_plain_ms,
               k11_dra_ms=k11_ms, k11_dra_plain_ms=k11_plain_ms, k11_claims_cleared_ms=k11_nodra_ms,
               k11_dra_bound_ms=b11, k11_dra_bound_by=by11, k11_dra_over_cleared=k11_ms / k11_nodra_ms,
               k13_bytes=b13, k14_bytes=b14)
    row["dra_selector_match"] = dict(max_abs_err=k13_err, ms=k13_ms, plain_ms=k13_plain_ms, bound_ms=k13_bound,
                                     bound_by=k13_by, library_ms=None)
    row["dra_spec_mask"] = dict(max_abs_err=k14_err, ms=k14_ms, plain_ms=k14_plain_ms, bound_ms=k14_bound,
                                bound_by=k14_by, library_ms=None)
    log(phase="dra_kernel_check", **row)
    return row


def phase_dra_kernels(torch, device, reps=10, n_nodes=5000, P=512):
    """dra_kernel_row at config4's node set (N = 5,000 in 8 zones, bucket
    5,120) with dra_check_world's surface (8 devices per node, 4 attributes
    each, P = 512 pods, DQ = 2, DS = 3, DV = 2) and gangs of 8 laid over the
    batch, every fourth needing 9 of its 8 members (it rolls back whatever
    it places).  Returns the row."""
    dc, db, kw, d_cap, flags, wt, dt, _ = dra_inputs(torch, device, n_nodes, P)
    rows = gang_rows(torch, device, int(db.valid.sum().item()), db.valid.shape[0], lambda g: 9 if g % 4 == 0 else 8)
    return dra_kernel_row(torch, "config4_dra", dc, db, kw, d_cap, flags, wt, dt, rows, reps)


def dra_bench_world(n_nodes=500, n_pods=2000, devices_per_node=4, count=1):
    """bench.py bench_dra's workload (config11): the DeviceClass "gpu"
    (vendor In bench), one slice of `devices_per_node` devices per node
    (vendor bench, slot j), and n_pods pods of 50m cpu / 32Mi, each with
    its own ExactCount=`count` claim of class gpu.  Returns (nodes,
    slices, classes, claims, pods)."""
    from kubernetes_tpu_torch.api import Container, Pod
    from kubernetes_tpu_torch.api import dra

    classes = {"gpu": dra.DeviceClass("gpu", (dra.DeviceSelector("vendor", "In", ("bench",)),))}
    slices = [dra.ResourceSlice(name=f"sl-{i}", node_name=f"node-{i}", driver="drv", pool=f"pool-{i}",
                                devices=tuple(dra.Device(f"dev-{i}-{j}", (("vendor", "bench"), ("slot", str(j))))
                                              for j in range(devices_per_node)))
              for i in range(n_nodes)]
    claims = {f"default/claim-{i}": dra.ResourceClaim(name=f"claim-{i}",
                                                      requests=(dra.DeviceRequest("g", "gpu", count=count),))
              for i in range(n_pods)}
    pods = [Pod(name=f"dra-{i}", resource_claims=(f"claim-{i}",),
                containers=[Container(name="c", requests={"cpu": "50m", "memory": "32Mi"})])
            for i in range(n_pods)]
    return basic_nodes(n_nodes, zones=8), slices, classes, claims, pods


class HostTimer:
    """Host seconds spent in the named methods while installed (each call
    wrapped, the original restored by close): where a drain's host time
    goes."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.seconds, self.calls = torch, targets, {}, {}
        self._orig = []
        for label, (obj, attr, sync) in targets.items():
            fn = getattr(obj, attr)
            self._orig.append((obj, attr, fn))
            setattr(obj, attr, self._wrap(label, fn, sync))

    def _wrap(self, label, fn, sync):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **k)
                if sync:
                    self.torch.cuda.synchronize()
                return out
            finally:
                self.seconds[label] = self.seconds.get(label, 0.0) + time.perf_counter() - t0
                self.calls[label] = self.calls.get(label, 0) + 1
        return timed

    def close(self) -> dict:
        for obj, attr, fn in self._orig:
            setattr(obj, attr, fn)
        return {k: dict(s=self.seconds[k], calls=self.calls[k]) for k in self.seconds}


def dra_drain_checks(sched, got, claims, pods):
    """Every claim allocated by the drain sits on its pod's node; no device
    is granted twice.  Returns (claims allocated, devices granted)."""
    granted = set()
    allocated = 0
    for c in sched.claim_cache.list():
        if c.allocation is None:
            continue
        for r in c.allocation.results:
            dev = (r.driver, r.pool, r.device)
            if dev in granted:
                raise AssertionError(f"device {dev} granted twice")
            granted.add(dev)
        if claims[c.key].allocation is None:
            allocated += 1
    for p in pods:
        node = got[p.name]
        for name in p.resource_claims:
            c = sched.claim_cache.get(f"{p.namespace}/{name}")
            if node is not None and (c.allocation is None or c.allocation.node_name != node):
                raise AssertionError(f"pod {p.name} on {node}, its claim {name} on "
                                     f"{None if c.allocation is None else c.allocation.node_name}")
    return allocated, len(granted)


def phase_dra_drain(torch, device, n_nodes=500, n_pods=2000, devices_per_node=4):
    """bench.py bench_dra (config11) on the card: 500 nodes of 4 devices,
    2,000 pods with one ExactCount claim each, which fills every device;
    a warm drain of batch_size + 64 pods, then the rest, through Scheduler()
    with the DynamicResourceAllocation gate on.  Every pod placed, no device
    granted twice, every claim on its pod's node, and K13, K14 and K11
    launched (each > 0); the host time of the dispatch's parts (the DRA
    pack, workloads_run with its synchronize, the replay's PreFilter and
    Filter, Reserve, and the binds with PreBind) beside the drain's.
    Returns the launches."""
    from kubernetes_tpu_torch import scheduler as sched_mod
    from kubernetes_tpu_torch.framework.runtime import Framework
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import coscheduling as cos

    nodes, slices, classes, claims, pods = dra_bench_world(n_nodes, n_pods, devices_per_node)
    _build.reset_launches()
    timer = HostTimer(torch, {
        "dra_tables": (sched_mod.Scheduler, "_dra_tables", False),
        "workloads_run": (cos, "workloads_run", True),
        "replay": (sched_mod.Scheduler, "_wl_host_replay", False),
        "reserve": (Framework, "run_reserve", False),
        "binds": (sched_mod.Scheduler, "_flush_binds", False),
    })
    try:
        warm = max(0, min(512 + 64, n_pods - 64))  # bench_dra's warm drain
        got, outs, dt, sched = gang_drain(device, nodes, (), pods, warm=warm, dra=(slices, classes, claims))
    finally:
        host = timer.close()
    launches = dict(_build.launches)
    check_capacity(sched)
    allocated, granted = dra_drain_checks(sched, got, claims, pods)
    m = sched.metrics
    unplaced = [k for k, v in got.items() if v is None]
    bad = [bool(unplaced), allocated != n_pods, granted != n_pods, m["dra_pods"] != n_pods,
           m["dra_claims_allocated"] != n_pods,
           any(launches[k] <= 0 for k in ("dra_selector_match", "dra_spec_mask", "workloads_admit"))]
    if any(bad):
        raise AssertionError(f"dra drain: {bad} unplaced {unplaced[:3]} {launches} {m}")
    log(phase="dra_drain", nodes=n_nodes, pods=n_pods, devices=n_nodes * devices_per_node, placed=n_pods - len(
        unplaced), claims_allocated=allocated, devices_granted=granted, drain_s=dt, pods_per_s=(n_pods - warm) / dt,
        launches=launches, host_both_drains=host, dra_pods=m["dra_pods"],
        dra_claims_allocated=m["dra_claims_allocated"],
        **{k: m[k] for k in WORKLOAD_METRICS}, capacity_ok=True, no_double_grant=True, claims_on_pod_node=True)
    return launches


def dra_parity_world(n_nodes=200, n_pods=600, seed=9):
    """tools/paritycheck.py _dra_workload in the port's types: basic nodes,
    a slice of one to four devices (vendor x / y, mem 16 / 32) on every
    other node, classes gpu (vendor In x) and any, and n_pods pods of one
    claim each (class gpu or any, count 1-2, All 1 in 5, a mem In 32
    selector 3 in 10).  Returns (nodes, slices, classes, claims, pods)."""
    from kubernetes_tpu_torch.api import Container, Pod
    from kubernetes_tpu_torch.api import dra

    rng = random.Random(seed)
    nodes = basic_nodes(n_nodes)
    slices = []
    for i in range(0, n_nodes, 2):
        slices.append(dra.ResourceSlice(name=f"sl-{i}", node_name=f"node-{i}", driver="drv", pool=f"pool-{i}",
                                        devices=tuple(dra.Device(name=f"dev-{i}-{j}", attributes=(
                                            ("vendor", "x" if j % 2 else "y"), ("mem", rng.choice(["16", "32"]))))
                                            for j in range(rng.randrange(1, 5)))))
    classes = {"gpu": dra.DeviceClass("gpu", (dra.DeviceSelector("vendor", "In", ("x",)),)),
               "any": dra.DeviceClass("any")}
    claims, pods = {}, []
    for i in range(n_pods):
        mode_all = rng.random() < 0.2
        c = dra.ResourceClaim(name=f"claim-{i}", requests=(dra.DeviceRequest(
            "r", rng.choice(["gpu", "any"]), count=rng.randrange(1, 3),
            allocation_mode=dra.ALLOCATION_MODE_ALL if mode_all else dra.ALLOCATION_MODE_EXACT,
            selectors=(dra.DeviceSelector("mem", "In", ("32",)),) if rng.random() < 0.3 else ()),))
        claims[c.key] = c
        pods.append(Pod(name=f"dp-{i}", resource_claims=(c.name,),
                        containers=[Container(name="c", requests={"cpu": "100m"})]))
    return nodes, slices, classes, claims, pods


def phase_dra_parity(torch, device, **world):
    """dra_parity_world drained in one batch on the card and with
    device="cpu" (the plain versions): outcomes and the DRA metrics
    identical, and the placements and claim pins equal to the port's serial
    WorkloadOracle replaying the same queue.  Returns the launches."""
    import copy

    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.oracle.state import OracleState
    from kubernetes_tpu_torch.oracle.workloads import WorkloadOracle

    metrics = WORKLOAD_METRICS + ("dra_pods", "dra_claims_allocated")
    runs = []
    for dev in (device, torch.device("cpu")):
        nodes, slices, classes, claims, pods = dra_parity_world(**world)
        _build.reset_launches()
        got, outs, dt, sched = gang_drain(dev, nodes, (), pods, dra=(slices, classes, claims), batch_size=4096)
        check_capacity(sched)
        dra_drain_checks(sched, got, claims, pods)
        pins = {c.key: c.allocation.node_name for c in sched.claim_cache.list() if c.allocation is not None}
        runs.append(({k: (o.node, o.reason, o.diagnosis) for k, o in outs.items()},
                     {k: sched.metrics[k] for k in metrics}, pins, dt, dict(_build.launches)))
    (want, wm, wpins, dt, launches), (cpu, cm, cpins, dt_cpu, _) = runs
    diff = [k for k in want if want[k] != cpu.get(k)]
    if diff or wm != cm or wpins != cpins:
        raise AssertionError(f"dra parity: {len(diff)} outcomes differ (first {diff[:1]}), metrics {wm} vs {cm}")
    nodes, slices, classes, claims, pods = dra_parity_world(**world)
    t0 = time.perf_counter()
    oracle = WorkloadOracle(OracleState.build(nodes, []), slices=slices, device_classes=classes, claims=claims)
    res = oracle.schedule([copy.deepcopy(p) for p in pods])
    dt_oracle = time.perf_counter() - t0
    odiff = [k for k in res.placements if res.placements[k] != want[k][0]]
    if odiff or res.claim_nodes != wpins or wm["workload_batches"] != 1 or any(
            launches[k] != 1 for k in ("dra_selector_match", "dra_spec_mask", "workloads_admit")):
        raise AssertionError(f"dra parity: {len(odiff)} placements differ from the oracle (first {odiff[:1]}), "
                             f"pins equal {res.claim_nodes == wpins}, {wm} {launches}")
    placed = sum(v[0] is not None for v in want.values())
    log(phase="dra_parity", nodes=len(nodes), pods=len(want), placed=placed, claims_allocated=len(wpins),
        identical=True, equal_to_oracle=True, pins_equal=True, cuda_drain_s=dt, cpu_drain_s=dt_cpu,
        oracle_s=dt_oracle, launches=launches, **wm)
    return launches


# ---------------------------------------------------------------------------
# Phase 11: the counterfactual planner (K15, K16; K8 and K11 with a score)
# ---------------------------------------------------------------------------


def k15_k16_inputs(torch, device, n_nodes=5000, KF=64, P=256, seed=47):
    """K15's and K16's inputs at config4's node set (5,000 nodes in 8 zones,
    bucket 5,120) with P=256: fork alive rows with about 5 % of the nodes
    removed per fork and some bucket padding slots alive (clones), a visit
    rank; and, for K16, seeded placements (a tenth unplaced), reason counts,
    post-admission usage at up to the capacity, capacities with a few zeroed
    memory lanes, live masks, and eight padding forks with no live pods.
    Returns (dc, fk_alive, visit_rank, K16's argument tuple)."""
    dc = _gang_pack(torch, device, basic_nodes(n_nodes, zones=8), [], spread_pods(P, prefix="cf"), P)[0]
    g = torch.Generator().manual_seed(seed)
    N, Rn = dc.allocatable.shape
    alive = dc.node_valid.cpu()[None].repeat(KF, 1) & (torch.rand((KF, N), generator=g) > 0.05)
    alive[:, n_nodes:] = torch.rand((KF, N - n_nodes), generator=g) < 0.3
    vr = torch.randperm(N, generator=g).to(torch.int32)
    chosen = torch.randint(0, n_nodes, (KF, P), generator=g, dtype=torch.int32)
    chosen[torch.rand((KF, P), generator=g) < 0.1] = -1
    rc = torch.randint(0, 50, (KF, P, 9), generator=g, dtype=torch.int64)
    alloc = dc.allocatable.cpu()[None].repeat(KF, 1, 1)
    alloc[:, :, 1][torch.rand((KF, N), generator=g) < 0.02] = 0
    req = (alloc.double() * torch.rand((KF, N, Rn), generator=g, dtype=torch.float64)).to(torch.int32)
    live = torch.rand((KF, P), generator=g) < 0.8
    live[KF - 8:] = False
    k16 = tuple(t.to(device) for t in (chosen, rc, req, alloc, alive, torch.ones(P, dtype=torch.bool), live))
    return dc, alive.to(device), vr.to(device), k16


def phase_planner_kernels(torch, device, reps=10, n_nodes=5000, KF=64, P=256):
    """K15 fork_view and K16 fork_summary against their plain versions,
    exact, at KF=64 over config4's node set with P=256, with each kernel's
    time, its plain version's, the bound in bytes and, for K15, one
    torch.where over the node planes stacked side by side (the same values,
    dom_ids transposed); then K8 and K11 with a target extra_score against
    their plain versions with it, exact, and K11's time with and without
    it on the same statics (config4's node set, 256 spread pods in gangs of
    8).  Returns (K15 row, K16 row, extra_score row)."""
    from kubernetes_tpu_torch.ops import coscheduling as cos
    from kubernetes_tpu_torch.ops import counterfactual as cf
    from kubernetes_tpu_torch.ops import gang, wave

    dc, alive, vr, k16 = k15_k16_inputs(torch, device, n_nodes, KF, P)
    N, L = dc.node_labels.shape
    T = dc.taint_key.shape[1]
    got = cf.fork_cluster_view(dc, alive, vr)
    want = cf.fork_cluster_view_plain(dc, alive, vr)
    err15 = max(max_abs_err(torch, got[k], want[k]) for k in want)
    sums = cf.fork_summary(*k16)
    sums_plain = cf.fork_summary_plain(*k16)
    err16 = max(max_abs_err(torch, a, b) for a, b in zip(sums, sums_plain))
    if err15 or err16:
        raise AssertionError(f"fork_view err {err15}, fork_summary err {err16}")
    stacked = torch.cat([dc.node_labels, dc.taint_key, dc.taint_val, dc.taint_effect, dc.dom_ids.T, vr[:, None]], 1)
    fill = torch.tensor([-1] * L + [-2] * (3 * T) + [-1] * (L + 1), dtype=torch.int32, device=device)
    gone = ~alive
    b15 = nbytes(dc.node_labels, dc.taint_key, dc.taint_val, dc.taint_effect, dc.dom_ids, vr, alive, *got.values())
    chosen, rc, req, alloc, f_alive, valid, live = k16
    b16 = nbytes(chosen, rc, f_alive, valid, live, *sums) + 2 * 2 * 4 * KF * N  # cpu and mem lanes of two planes
    ops16 = KF * (P * 9 + N * 8)
    row15 = dict(ms=time_ms(torch, lambda: cf.fork_cluster_view(dc, alive, vr), reps),
                 plain_ms=time_ms(torch, lambda: cf.fork_cluster_view_plain(dc, alive, vr), reps),
                 library_ms=time_ms(torch, lambda: torch.where(gone[:, :, None], fill, stacked[None]), reps),
                 library_call="torch.where over the stacked node planes", max_abs_err=err15,
                 **dict(zip(("bound_ms", "bound_by"), bound_ms(b15, 0))))
    row16 = dict(ms=time_ms(torch, lambda: cf.fork_summary(*k16), reps),
                 plain_ms=time_ms(torch, lambda: cf.fork_summary_plain(*k16), 3), library_ms=None,
                 max_abs_err=err16, **dict(zip(("bound_ms", "bound_by"), bound_ms(b16, ops16))))
    log(phase="planner_kernel_check", KF=KF, N=N, P=P, L=L, T=T, fork_view=row15, fork_summary=row16,
        alive_cells=int(alive.sum().item()))

    # K8 and K11 with a target score: seeded scores and a dominating bonus at
    # one node for every other pod
    nodes = basic_nodes(n_nodes, zones=8)
    dc, db, kw, d_cap, flags, wt = wave_inputs(torch, device, nodes, [], spread_pods(P, prefix="es"), P)
    hk = kw["hostname_key"]
    g = gang.precompute(dc, db, **kw, **dict(flags, has_ports=False))
    rows = gang_rows(torch, device, int(db.valid.sum().item()), P, lambda i: 9 if i % 4 == 0 else 8)
    gen = torch.Generator().manual_seed(5)
    es = torch.randint(0, 300, (P, dc.node_valid.shape[0]), generator=gen, dtype=torch.int64)
    target = n_nodes // 2
    es[::2, target] += 1 << 40
    es = es.to(device)
    targs = [wt[k] for k in WAVE_TABLES]
    gk = [rows[k] for k in ("gang_id", "gang_first", "gang_last", "gang_need", "g_cap")]
    tkw = dict(d_cap=d_cap, d2_cap=wt["d2_cap"])
    c0 = wave.wave_speculate(dc, db, g, d_cap=d_cap, extra_score=es)
    c0_plain = wave.wave_speculate_plain(dc, db, g, d_cap=d_cap, extra_score=es)
    got = cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw, extra_score=es)
    want, plain_ms = timed_once(torch, lambda: cos.workloads_admit_plain(dc, db, g, hk, *targs, *gk, **tkw,
                                                                         extra_score=es))

    def outs(o):
        return list(o[:4]) + [o[4][k] for k in ("requested", "nonzero", "num_pods")] + list(o[5:7])

    err8 = max_abs_err(torch, c0, c0_plain)
    err11 = max(max_abs_err(torch, a, b) for a, b in zip(outs(got), outs(want)))
    at_target = int((want[0] == target).sum().item())
    if err8 or err11 or not at_target:
        raise AssertionError(f"extra_score: K8 err {err8}, K11 err {err11}, {at_target} pods at the target")
    row_es = dict(k8_err=err8, k11_err=err11, pods_at_target=at_target,
                  k11_ms=time_ms(torch, lambda: cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw,
                                                                    extra_score=es), reps),
                  k11_no_score_ms=time_ms(torch, lambda: cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw), reps),
                  k11_plain_ms=plain_ms,
                  k8_ms=time_ms(torch, lambda: wave.wave_speculate(dc, db, g, d_cap=d_cap, extra_score=es), reps),
                  k8_no_score_ms=time_ms(torch, lambda: wave.wave_speculate(dc, db, g, d_cap=d_cap), reps))
    log(phase="extra_score_kernel_check", N=int(dc.node_valid.sum().item()), P=P, **row_es)
    return row15, row16, row_es


def config14_world(n_nodes=300, n_fill=1500, n_backlog=96):
    """bench.py bench_plan (config14): 300 basic nodes in 4 zones, 1,500
    placed pods of 900m / 512Mi at priority 2 (drained first), and a
    backlog of 96 pods of 1200m / 1Gi.  Returns (nodes, fill, backlog)."""
    from kubernetes_tpu_torch.api import Container, Pod

    fill = [Pod(name=f"fill-{i}", priority=2, labels={"app": f"a{i % 16}"},
                containers=[Container(name="c", requests={"cpu": "900m", "memory": "512Mi"})])
            for i in range(n_fill)]
    backlog = [Pod(name=f"want-{i}", labels={"app": "want"},
                   containers=[Container(name="c", requests={"cpu": "1200m", "memory": "1Gi"})])
               for i in range(n_backlog)]
    return basic_nodes(n_nodes, zones=4), fill, backlog


def mixed_forks(sched, k=64, seed=14):
    """bench_plan's K mixed forks over a scheduler's nodes and placed pods:
    clone adds (1-3 clones), cordons, 4-pod evictions and 3/2 scales, in
    turn after a baseline.  The evictions sample the placed pods by name,
    so two schedulers with the same placements get the same forks."""
    from kubernetes_tpu_torch.planner import Fork

    names = sorted((cn.node.name for cn in sched.cache.real_nodes()), key=lambda n: int(n.rsplit("-", 1)[1]))
    by_name = {p.name: p.uid for p in sched.cache.placed_pods()}
    placed = sorted(by_name)
    forks = [Fork(label="baseline")]
    rng = random.Random(seed)
    while len(forks) < k:
        i = len(forks)
        t = names[i % len(names)]
        kind = i % 4
        if kind == 0:
            forks.append(Fork(label=f"add{i}", add=tuple((t, f"{t}~cf{i}-{j}") for j in range(1 + i % 3))))
        elif kind == 1:
            forks.append(Fork(label=f"cordon{i}", cordon=(t,)))
        elif kind == 2:
            forks.append(Fork(label=f"evict{i}", evict=tuple(by_name[n] for n in rng.sample(placed, 4))))
        else:
            forks.append(Fork(label=f"scale{i}", scale=((t, 3, 2),)))
    return forks


def planner_sched(device, nodes, placed, groups=(), **cfg):
    """A Scheduler on `device` with `nodes`, its PodGroups and `placed`:
    pods with node_name set are bound as they are, the rest are drained."""
    from kubernetes_tpu_torch.framework.config import SchedulerConfiguration
    from kubernetes_tpu_torch.scheduler import Scheduler

    sched = Scheduler(SchedulerConfiguration(**cfg), device=device)
    sched.binding_sink_many = lambda pairs: [None] * len(pairs)
    for n in nodes:
        sched.on_node_add(n)
    for pg in groups:
        sched.on_pod_group_add(pg)
    for p in placed:
        sched.on_pod_add(p)
    sched.schedule_pending()
    return sched


FORK_KEYS = ("label", "placements", "admitted", "unschedulable", "density_ppm", "gang_admitted")
# the kernels every kernel-engine planner run launches (K15, K1, K8, K11,
# K16; K6 with spread pods, K7 for the port masks)
PLANNER_KERNELS = ("fork_view", "static_eval", "wave_speculate", "workloads_admit", "fork_summary")


def fork_key(f):
    return tuple(sorted(f[k].items()) if isinstance(f[k], dict) else f[k] for k in FORK_KEYS)


def same_forks(a, b, what):
    if [fork_key(f) for f in a] != [fork_key(f) for f in b]:
        bad = next(i for i, (x, y) in enumerate(zip(a, b)) if fork_key(x) != fork_key(y)) if len(a) == len(b) else -1
        raise AssertionError(f"{what}: fork {bad} differs: {a[bad] if bad >= 0 else len(a)} != "
                             f"{b[bad] if bad >= 0 else len(b)}")


def timed_sim(torch, device, fn):
    """(fn's SimResult, wall seconds, the kernels' launches during it)."""
    from kubernetes_tpu_torch.ops import _build

    if device.type == "cuda":
        torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    sim = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return sim, time.perf_counter() - t0, {k: v for k, v in _build.launches.items() if v}


def config14_bound(torch, sched, forks, backlog):
    """counterfactual_run's bound for one simulate_forks run, from the run's
    own inputs: K15's and K16's bounds (bytes, as phase_planner_kernels
    computes them), plus the fork count times the first fork's K1, K7, K8
    and K11 bounds (precompute_static_bound, gang_bounds, wave_bounds and
    k11_bound on that fork's inputs and outputs; every fork has the same
    shapes).
    The inputs are captured by wrapping the wrappers (and, for a device="cpu"
    scheduler, K15's and K16's plain versions, which the CPU run calls
    directly) for one extra run.  Returns (bound_ms, parts)."""
    import inspect

    from kubernetes_tpu_torch.ops import coscheduling as cos
    from kubernetes_tpu_torch.ops import counterfactual as cf
    from kubernetes_tpu_torch.ops import gang, wave
    from kubernetes_tpu_torch.planner import simulate_forks

    seen, orig = {}, []
    for mod, attr, key in ((cf, "fork_cluster_view", "k15"), (cf, "fork_summary", "k16"),
                           (cf, "fork_cluster_view_plain", "k15"), (cf, "fork_summary_plain", "k16"),
                           (wave, "wave_speculate", "k8"),
                           (cos, "workloads_admit", "k11")):
        fn = getattr(mod, attr)
        orig.append((mod, attr, fn))

        def grab(*a, _fn=fn, _key=key, **k):
            out = _fn(*a, **k)
            if _key not in seen:
                sig = inspect.signature(_fn)
                args = dict(sig.bind(*a, **k).arguments)
                for name, prm in sig.parameters.items():  # a **kwargs parameter's entries, by name
                    if prm.kind is prm.VAR_KEYWORD:
                        args.update(args.pop(name, {}))
                seen[_key] = (args, out)
            return out
        setattr(mod, attr, grab)
    try:
        simulate_forks(sched, forks, backlog)
    finally:
        for mod, attr, fn in orig:
            setattr(mod, attr, fn)
    kf = len(forks)
    a15, v15 = seen["k15"]
    dc15 = a15["dc"]
    b15 = bound_ms(nbytes(dc15.node_labels, dc15.taint_key, dc15.taint_val, dc15.taint_effect, dc15.dom_ids,
                          a15["fk_alive"], *(t for t in (a15.get("visit_rank"),) if t is not None), *v15.values()), 0)
    a16, v16 = seen["k16"]
    KF, P = a16["chosen"].shape
    N = a16["fk_alive"].shape[1]
    b16 = bound_ms(nbytes(a16["chosen"], a16["reason_counts"], a16["fk_alive"], a16["valid"], a16["fk_pod_live"],
                          *v16) + 2 * 2 * 4 * KF * N, KF * (P * 9 + N * 8))
    a11, v11 = seen["k11"]
    dc, db, g = a11["dc"], a11["db"], a11["g"]
    b1 = precompute_static_bound(dc, db, bool((db.img_ids >= 0).any()))
    _, raw, n_feas = v11[:3]
    weights = a11.get("weights", gang.DEFAULT_WEIGHTS)
    wt = {k: a11[k] for k in WAVE_TABLES}
    wt.update(has_ports=False, tid_pt=torch.zeros((0,), dtype=torch.int32), port_conf=torch.zeros((0,), dtype=torch.bool))
    rows = {k: a11[k] for k in ("gang_id", "gang_first", "gang_last", "gang_need", "g_cap")}
    b7 = gang_bounds(torch, dc, db, g, raw, n_feas, weights)[1]
    a8, c0 = seen["k8"]
    spec_feas = torch.zeros((db.valid.shape[0],), dtype=torch.int64, device=dc.node_valid.device)
    wave.wave_speculate_plain(**dict(a8, n_feas=spec_feas))
    b8 = wave_bounds(torch, dc, db, g, wt, c0, spec_feas, raw, n_feas, weights)[0]
    b11 = k11_bound(torch, dc, db, g, wt, rows, raw, n_feas, weights)
    parts = dict(fork_view=b15[0], fork_summary=b16[0], static_eval=b1[0], gang_interpod_statics=b7[0],
                 wave_speculate=b8[0], workloads_admit=b11[0], forks=kf, per_fork=b1[0] + b7[0] + b8[0] + b11[0])
    return b15[0] + b16[0] + kf * parts["per_fork"], parts


def phase_config14(torch, device, k=64, ref_forks=16, **world):
    """bench_plan (config14) on the card: one K=64 simulate_forks on the
    kernel engine (after a warm-up run), its first ``ref_forks`` forks
    equal to the serial engine's (plannerKernel off) and to the kernel
    engine of a device="cpu" scheduler (counterfactual_run_plain), each run
    on those forks alone; then the 64 forks one at a time (K=1), each equal
    to its batched row.  ``world``: config14_world's sizes.  Returns
    the batched run's launches."""
    from kubernetes_tpu_torch.planner import simulate_forks

    nodes, fill, backlog = config14_world(**world)
    sched = planner_sched(device, nodes, fill)
    forks = mixed_forks(sched, k)
    simulate_forks(sched, forks, backlog, planner="warm")
    batched, batched_s, launches = timed_sim(torch, device, lambda: simulate_forks(sched, forks, backlog))
    if batched.engine != "kernel":
        raise AssertionError(f"config14 took the {batched.engine} engine")
    if device.type == "cuda":
        missing = [k for k in PLANNER_KERNELS + ("gang_interpod_statics",) if not launches.get(k)]
        if missing:
            raise AssertionError(f"config14: {missing} not launched ({launches})")
    serial, serial_s, _ = timed_sim(torch, device, lambda: simulate_forks(sched, forks[:ref_forks], backlog,
                                                                          use_kernel=False))
    same_forks(batched.forks[:ref_forks], serial.forks, "config14 kernel vs serial engine")
    cpu = torch.device("cpu")
    nodes_c, fill_c, backlog_c = config14_world(**world)
    sched_c = planner_sched(cpu, nodes_c, fill_c)
    forks_c = mixed_forks(sched_c, k)[:ref_forks]
    plain, plain_s, _ = timed_sim(torch, cpu, lambda: simulate_forks(sched_c, forks_c, backlog_c))
    same_forks(batched.forks[:len(forks_c)], plain.forks, "config14 cuda vs counterfactual_run_plain on the CPU")
    seq_launches = {}
    t0 = time.perf_counter()
    for i, f in enumerate(forks):
        one, _, ln = timed_sim(torch, device, lambda: simulate_forks(sched, [f], backlog))
        same_forks(batched.forks[i:i + 1], one.forks, f"config14 fork {f.label} alone")
        for k, v in ln.items():
            seq_launches[k] = seq_launches.get(k, 0) + v
    seq_s = time.perf_counter() - t0
    cf_bound, cf_parts = config14_bound(torch, sched, forks, backlog)
    log(phase="config14_plan", k=batched.k, pods=len(backlog), nodes=len(nodes), batched_s=batched_s,
        counterfactual_run_bound_ms=cf_bound, counterfactual_run_bound_parts=cf_parts,
        launches=launches, launches_total=sum(launches.values()), serial_s=serial_s, cpu_plain_s=plain_s,
        ref_forks_compared=len(forks_c), seq_k1_s=seq_s, seq_k1_launches=seq_launches,
        seq_k1_launches_total=sum(seq_launches.values()),
        admitted=[f["admitted"] for f in batched.forks], density_ppm=batched.forks[0]["density_ppm"],
        compared=f"kernel == serial == cpu plain on the first {len(forks_c)} forks; kernel == {len(forks)} x K=1")
    return launches


def planner_world(n_nodes=5000, zones=8, n_empty=32, seed=53):
    """The full-width planner cell: config4's 5,000 nodes in 8 zones, in
    four shapes (4 / 8 / 16 / 32 cpu, 4 GiB per cpu) so that autoscale has
    four candidates, every node but the last `n_empty` (4-cpu nodes, left
    empty) holding two placed pods of 35 % of its cpu and memory each
    (70 % full; priorities 0 and 50); and a backlog of 256 pods of 10 cpu /
    16 GiB, larger than any node's free room: 128 plain (priority 0), 96
    zone-spread (maxSkew 1, priority 100) and one PodGroup gang of 32
    (minMember 32).  Returns (nodes, placed, backlog, groups)."""
    from kubernetes_tpu_torch.api import Container, LabelSelector, Node, Pod, Resource, TopologySpreadConstraint
    from kubernetes_tpu_torch.workloads.gang import PodGroup

    shapes = (4, 8, 16, 32)
    nodes, placed = [], []
    for i in range(n_nodes):
        cpu = 4 if i >= n_nodes - n_empty else shapes[i % 4]
        name = f"node-{i}"
        nodes.append(Node(name=name, labels={ZONE: f"zone-{i % zones}", HOSTNAME: name},
                          capacity=Resource.from_map({"cpu": str(cpu), "memory": f"{4 * cpu}Gi", "pods": 110})))
        if i >= n_nodes - n_empty:
            continue
        for j in range(2):
            placed.append(Pod(name=f"placed-{i}-{j}", node_name=name, priority=50 * j, labels={"app": f"p{i % 20}"},
                              containers=[Container(name="c", requests={"cpu": f"{350 * cpu}m",
                                                                        "memory": f"{1434 * cpu}Mi"})]))
    big = {"cpu": "10", "memory": "16Gi"}
    backlog = [Pod(name=f"plain-{i}", labels={"app": "big"}, containers=[Container(name="c", requests=big)])
               for i in range(128)]
    backlog += [Pod(name=f"spread-{i}", priority=100, labels={"app": "big-spread"},
                    topology_spread_constraints=(TopologySpreadConstraint(
                        max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
                        label_selector=LabelSelector(match_labels={"app": "big-spread"})),),
                    containers=[Container(name="c", requests=big)]) for i in range(96)]
    backlog += [Pod(name=f"gang-{m}", pod_group="big-gang", labels={"app": "big-gang"},
                    containers=[Container(name="c", requests=big)]) for m in range(32)]
    return nodes, placed, backlog, [PodGroup(name="big-gang", min_member=32)]


def phase_planner_full(torch, device, n_nodes=5000, sampled=8, k=64):
    """The three planners at full width on the card (planner_world, the
    backlog left unschedulable by one drain with preemption off), each on
    the kernel engine with its K, wall time and launches; then one K=64
    simulate_forks of bench_plan's mixed forks over the backlog, whose
    `sampled` seeded forks each equal the same fork run alone."""
    from kubernetes_tpu_torch.framework.config import Profile
    from kubernetes_tpu_torch.planner import (backlog_pods, plan_autoscale, plan_deschedule, plan_preempt_cost,
                                              simulate_forks)

    nodes, placed, backlog, groups = planner_world(n_nodes)
    t0 = time.perf_counter()
    sched = planner_sched(device, nodes, placed + backlog, groups, profiles=[Profile(post_filter=False)])
    pending = sched.queue.pending_pods()
    stuck = sum(len(v) for v in pending.values())
    if stuck != len(backlog) or len(sched.cache.placed_pods()) != len(placed):
        raise AssertionError(f"{stuck} of {len(backlog)} backlog pods pending")
    setup_s = time.perf_counter() - t0
    rows = {}
    for name, fn in (("autoscale", plan_autoscale), ("deschedule", plan_deschedule),
                     ("preempt_cost", plan_preempt_cost)):
        out, wall, ln = timed_sim(torch, device, lambda: fn(sched))
        res = out.get("result", {})
        if res.get("engine") != "kernel":
            raise AssertionError(f"{name}: engine {res.get('engine')} ({out.get('error')})")
        if device.type == "cuda" and not all(ln.get(k) for k in PLANNER_KERNELS):
            raise AssertionError(f"{name}: a planner kernel was not launched ({ln})")
        rows[name] = dict(k=res["k"], wall_s=wall, launches=ln, launches_total=sum(ln.values()),
                          pods=len(res["batch"]), recommendation=out.get("recommendation"))
        if name == "preempt_cost":
            rows[name]["classes"] = out["classes"]
        if name == "autoscale":
            rows[name]["scale_down"] = len(out["scale_down"])
    if rows["autoscale"]["recommendation"]["action"] != "scale_up":
        raise AssertionError(f"autoscale: {rows['autoscale']['recommendation']}")
    backlog_now, _ = backlog_pods(sched)
    forks = mixed_forks(sched, k)
    batched, batched_s, ln = timed_sim(torch, device, lambda: simulate_forks(sched, forks, backlog_now))
    if batched.engine != "kernel":
        raise AssertionError(f"full width K={k} took the {batched.engine} engine")
    rng = random.Random(61)
    picks = sorted(rng.sample(range(len(forks)), sampled))
    for i in picks:
        one = simulate_forks(sched, [forks[i]], backlog_now)
        same_forks(batched.forks[i:i + 1], one.forks, f"full width fork {forks[i].label} alone")
    log(phase="planner_full_width", nodes=n_nodes, placed=len(placed), backlog=len(backlog_now), setup_s=setup_s,
        planners=rows, k64=dict(k=batched.k, wall_s=batched_s, launches=ln, launches_total=sum(ln.values()),
                                sampled_equal_alone=picks, admitted=[f["admitted"] for f in batched.forks[:8]]))
    return rows


# ---------------------------------------------------------------------------
# Phase 12: explain and the independent pipeline (K17, K18); the DRA kernels
# past 256 device slots
# ---------------------------------------------------------------------------


def packed_snapshot(nodes, placed, pending, P):
    """The snapshot (an object with the packed ``nodes``, ``existing`` and
    their ``vocab``, as a Scheduler's mirror has them) and one packed batch
    of the first P pending pods, through the port's packers."""
    from types import SimpleNamespace

    from kubernetes_tpu_torch.cache.mirror import accumulate_node_usage
    from kubernetes_tpu_torch.snapshot.interner import Vocab
    from kubernetes_tpu_torch.snapshot.schema import pack_existing_pods, pack_nodes, pack_pod_batch

    vocab = Vocab()
    for p in list(placed) + list(pending):
        for k, v in p.labels.items():
            vocab.intern_label(k, v)
    nt = pack_nodes(nodes, vocab)
    accumulate_node_usage(nt, placed, vocab)
    ep = pack_existing_pods(placed, nt.name_to_idx, vocab, k_cap=nt.k_cap)
    pb = pack_pod_batch(pending[:P], vocab, k_cap=nt.k_cap, p_cap=P)
    return SimpleNamespace(nodes=nt, existing=ep, vocab=vocab), pb


def explain_shapes(n_config4=5000, n_mixed=5000, P=512):
    """K17's shapes: config4's (5,000 nodes in 8 zones, 45,000 placed spread
    pods, 512 spread pods) and the mixed one (tests/gen.py-style: 5,000
    nodes, 500 placed pods, 512 pods, one in 16 naming a node and one in 16
    asking 64 cpu), as (name, nodes, placed, pending)."""
    import dataclasses

    from kubernetes_tpu_torch.api import Container

    c4 = basic_nodes(n_config4, zones=8)
    nodes, placed, pending = gen_cluster(5, n_mixed, n_mixed // 10, P)
    for i, p in enumerate(pending):  # nodeName targets and pods too big to fit, for rows 1 and 6
        if i % 16 == 3:
            pending[i] = dataclasses.replace(p, node_name=f"node-{(7 * i) % n_mixed}")
        elif i % 16 == 7:
            pending[i] = dataclasses.replace(p, containers=[Container(name="c0", requests={"cpu": "64",
                                                                                            "memory": "1Gi"})])
    return [("config4", c4, place_round_robin(spread_pods(9 * n_config4, prefix="placed"), c4),
             spread_pods(P, prefix="new")),
            ("mixed", nodes, placed, pending)]


def k17_row(torch, name, dc, db, kw, flags, reps, extra=None):
    """K17 (explain_stack) against its plain version on the statics of the
    precompute (K1, K6, K7) of one packed batch, exact on the [10, P, N]
    buffer, with `extra` as the host-filter lane; the rows' failing pairs,
    the kernel's time, the plain version's and the bound.  Returns the
    row."""
    from kubernetes_tpu_torch.ops import explain as ops_explain
    from kubernetes_tpu_torch.ops import gang

    g = gang.precompute(dc, db, **kw, **dict(flags, has_images=False), extra_mask=extra)
    got = ops_explain.explain_stack(dc, db, g)
    want = ops_explain.explain_stack_plain(dc, db, g)
    err = max_abs_err(torch, got, want)
    if err:
        rows = [r for r in range(got.shape[0]) if not torch.equal(got[r], want[r])]
        raise AssertionError(f"{name}: explain_stack kernel != plain on rows {rows}")
    live = db.valid[:, None] & dc.node_valid[None, :]
    failing = {p: int((~got[r] & live).sum().item()) for r, p in enumerate(gang.DIAG_KERNELS)}
    P, N = live.shape
    C, AT = g.sp_dv.shape[1], g.ip_dv.shape[1]
    read = nbytes(dc.node_valid, dc.num_pods, dc.allowed_pods, dc.allocatable, dc.requested, db.valid, db.requests,
                  g.d_unsched, g.d_nodename, g.d_taints, g.d_nodeaff, g.d_ports, g.d_extra, g.sp_hard, g.sp_dv,
                  g.sp_te, g.sp_dom_cnt, g.sp_dom_pres, g.sp_ndom, g.sp_self, db.tsc_min_domains[:, :C],
                  db.tsc_max_skew[:, :C], g.ip_viol_existing, g.ip_dv, g.ip_dom_cnt, g.ip_is_aff, g.ip_is_anti,
                  g.ip_any_static, g.ip_self_all)
    ops = P * N * (db.requests.shape[1] + 4 * C + 4 * AT + 2 * (gang.N_DIAG + 1))
    b, by = bound_ms(read + nbytes(got), ops)
    ms = time_ms(torch, lambda: ops_explain.explain_stack(dc, db, g), reps)
    plain_ms = time_ms(torch, lambda: ops_explain.explain_stack_plain(dc, db, g), 3)
    row = dict(shape=name, P=int(db.valid.sum().item()), N=int(dc.node_valid.sum().item()), C=C, AT=AT, k17_err=err,
               failing_pairs=failing, feasible_pairs=int(got[gang.N_DIAG].sum().item()), out_bytes=nbytes(got),
               explain_stack=dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                  library_ms=None))
    log(phase="explain_kernel_check", **row)
    return row


def k18_row(torch, device, pc, pb, reps):
    """K18 (pipeline_score) against its plain version on the statics and
    K17's feasible mask of one packed batch, exact on chosen, feasible,
    totals and n_feasible, with the kernel's time, the plain version's and
    the bound; then the whole CUDA route (``pipeline``: K1, K6, K7, K17,
    K18) against ``pipeline_plain`` (the reference's all_masks and
    all_scores) on the card.  Returns the row."""
    from kubernetes_tpu_torch.ops import explain as ops_explain
    from kubernetes_tpu_torch.ops import gang
    from kubernetes_tpu_torch.ops import pipeline as ops_pipe
    from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster
    from kubernetes_tpu_torch.snapshot.schema import bucket_cap

    vocab = pc.vocab
    dc = DeviceCluster.from_host(pc.nodes, vocab, device, ep=pc.existing)
    db = DeviceBatch.from_host(pb, device)
    v_cap = bucket_cap(len(vocab.label_vals))
    hk = vocab.label_keys.lookup(HOSTNAME)
    has_interpod, has_spread, has_images, _ = ops_pipe.batch_feature_flags(pc, pb)
    tables = gang.batch_tables(pb.tsc_topo_key, pb.aff_topo_key, pc.nodes.label_vals, hk)
    d_cap = tables["d_cap"]
    tab = {k: torch.as_tensor(tables[k], device=device) for k in ("sp_keys", "sp_cdv_tab", "ip_keys")}
    g = gang.precompute(dc, db, hk, v_cap, has_interpod=has_interpod, has_spread=has_spread, has_ports=False,
                        has_images=has_images, **tab)
    feasible = ops_explain.explain_stack(dc, db, g)[gang.N_DIAG]
    got = ops_pipe.pipeline_score(dc, db, g, feasible, gang.DEFAULT_WEIGHTS, d_cap)
    want = ops_pipe.pipeline_score_plain(dc, db, g, feasible, gang.DEFAULT_WEIGHTS, d_cap)
    err = max(max_abs_err(torch, a, b) for a, b in zip(got, want))
    route = ops_pipe.pipeline(dc, db, hk, v_cap, has_interpod, has_spread, has_images, **tables)
    ref = ops_pipe.pipeline_plain(dc, db, hk, v_cap, has_interpod, has_spread, has_images)
    ref_ms = time_ms(torch, lambda: ops_pipe.pipeline_plain(dc, db, hk, v_cap, has_interpod, has_spread,
                                                            has_images), 3)
    route_err = max(max_abs_err(torch, a, b) for a, b in zip(route, ref))
    if err or route_err:
        raise AssertionError(f"pipeline: K18 != plain by {err}, the CUDA route != pipeline_plain by {route_err}")
    P, N = feasible.shape
    C, AT = g.sp_dv.shape[1], g.ip_dv.shape[1]
    # bytes this run's data needs: the feasible mask everywhere; at each
    # feasible pair the three static score planes, the symmetric score, the
    # inter-pod rows, sp_all_keys and one count row per soft slot; at each
    # counted pair one compact-domain row per non-hostname slot; the usage
    # rows once; the totals, counts and choices written once
    f_p = feasible.sum(1)
    k_p = (feasible & g.sp_all_keys).sum(1)
    soft_p = g.sp_soft.sum(1)
    nonhost_p = (g.sp_soft & ~g.sp_is_host).sum(1)
    per_feas = 8 * 4 + 8 * AT + (1 if C else 0)
    need = int((f_p * (per_feas + 4 * soft_p) + k_p * 4 * nonhost_p).sum().item())
    need += nbytes(feasible, dc.nonzero_req, db.requests, db.nonzero_req, db.tsc_max_skew[:, :C], g.sp_soft,
                   g.sp_is_host, g.ip_pref_w) + N * 4 * 4 + C * 8  # allocatable / requested cpu and memory
    ops = int((f_p * (40 + 8 * C + 4 * AT)).sum().item()) + P * N * 2
    b, by = bound_ms(need + nbytes(got.chosen, got.totals, got.n_feasible), ops)
    plain_ms = time_ms(torch, lambda: ops_pipe.pipeline_score_plain(dc, db, g, feasible, gang.DEFAULT_WEIGHTS,
                                                                     d_cap), 3)
    ms = time_ms(torch, lambda: ops_pipe.pipeline_score(dc, db, g, feasible, gang.DEFAULT_WEIGHTS, d_cap), reps)
    row = dict(shape="k18_mixed_images", P=int(db.valid.sum().item()), N=int(dc.node_valid.sum().item()), C=C, AT=AT,
               placed=int(dc.epod_valid.sum().item()), has_images=has_images, has_interpod=has_interpod,
               has_spread=has_spread, k18_err=err, route_err=route_err,
               scheduled=int((route.chosen >= 0).sum().item()),
               one_feasible=int((route.n_feasible == 1).sum().item()), totals_bytes=nbytes(got.totals),
               pipeline_plain_ms=ref_ms,
               pipeline_score=dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                                   library_ms=None))
    log(phase="pipeline_kernel_check", **row)
    return row, ref


def phase_explain_kernels(torch, device, reps=10, n_config4=5000, n_mixed=5000, n_k18=10240, P=512):
    """K17 at config4's shape and at the mixed shape (with a seeded
    host-filter lane, so that all nine rows fail somewhere), K18 at the
    K18 shape (10,240 tests/gen.py-style nodes with images, 102 placed
    pods, 512 mixed pods), each exact against its plain version, and the
    CUDA pipeline route against pipeline_plain.  Returns (K17 rows by
    shape, the K18 row, the K18 shape's snapshot, batch and the plain
    pipeline's result)."""
    rows = {}
    for name, nodes, placed, pending in explain_shapes(n_config4, n_mixed, P):
        dc, db, kw, d_cap, flags, pb, nt = _gang_pack(torch, device, nodes, placed, pending, P)
        extra = None
        if name == "mixed":
            gen = torch.Generator().manual_seed(59)
            extra = (torch.rand(db.valid.shape[0], dc.node_valid.shape[0], generator=gen) < 0.9).to(device)
        rows[name] = k17_row(torch, name, dc, db, kw, flags, reps, extra=extra)
    if n_mixed >= 1000 and not all(rows["mixed"]["failing_pairs"].values()):
        raise AssertionError(f"the mixed shape leaves a row unexercised: {rows['mixed']['failing_pairs']}")
    pc, pb = packed_snapshot(*gen_cluster(61, n_k18, n_k18 // 100, P)[:3], P)
    k18, ref = k18_row(torch, device, pc, pb, reps)
    return rows, k18, (pc, pb, ref)


def phase_dra_slots(torch, device, reps=10, n_nodes=1000, P=128):
    """K14 and K11's DRA mode past the register words: dra_kernel_row (every
    output exact against the plain versions) at N=1,000, P=128, DQ=2 with
    320 device slots per node (five 64-bit words, the scratch-row path)
    and with today's 8 (the register path), each with its times.  Returns
    {devices: row}."""
    rows = {}
    for devices in (8, 320):
        world = dra_check_world(n_nodes, P, devices=devices, seed=43)
        dc, db, kw, d_cap, flags, wt, dt, _ = dra_inputs(torch, device, n_nodes, P, world=world)
        grows = gang_rows(torch, device, int(db.valid.sum().item()), db.valid.shape[0],
                          lambda g: 9 if g % 4 == 0 else 8)
        rows[devices] = dra_kernel_row(torch, f"dd{devices}_n{n_nodes}", dc, db, kw, d_cap, flags, wt, dt, grows,
                                       reps)
    log(phase="dra_slots", dd8_k14_ms=rows[8]["dra_spec_mask"]["ms"], dd320_k14_ms=rows[320]["dra_spec_mask"]["ms"],
        dd8_k11_ms=rows[8]["k11_dra_ms"], dd320_k11_ms=rows[320]["k11_dra_ms"])
    return rows


def _uid_names(sched, pods=()):
    out = {p.uid: p.name for p in pods}
    for q in sched.queue.pending_pods().values():
        out.update({p.uid: p.name for p in q})
    out.update({uid: p.name for uid, p in sched.cache.pod_states.items()})
    return out


def _by_name(d, names):
    """The dict with every pod uid replaced by its pod's name (two
    schedulers built apart give the same pods different uids)."""
    if isinstance(d, dict):
        return {k: (names.get(v, v) if k == "uid" else _by_name(v, names)) for k, v in d.items()}
    if isinstance(d, list):
        return [_by_name(v, names) for v in d]
    return d


def explain_probes():
    """explain_pod's four pods on config4's cluster: a spread pod, a
    hostname anti-affinity pod, a pod larger than every node and a pod
    with nodeName."""
    from kubernetes_tpu_torch.api import Container, Pod

    spread = spread_pods(1, prefix="probe-spread")[0]
    anti = interpod_pods(1, prefix="probe-anti")[0]
    big = Pod(name="probe-big", containers=[Container(name="c", requests={"cpu": "64", "memory": "1Ti"})])
    named = Pod(name="probe-named", node_name="node-17", containers=[Container(name="c", requests={"cpu": "1"})])
    return [spread, anti, big, named]


def phase_explain(torch, device, n_nodes=5000, n_placed=45000, n_preempt=500, k18=None):
    """The slice's main path through the entry points a user calls, the
    launch counts reset just before and read just after: explain_pod for
    explain_probes' four pods on config4's cluster (5,000 nodes in 8 zones,
    45,000 placed spread pods) on a Scheduler on cuda; explain_whatif for
    one preemptor of bench_preemption's world (500 nodes) at node-0; and
    schedule_independent at the K18 shape.  Each is held against the same
    call on a device="cpu" Scheduler built the same way (the explain and
    what-if dicts equal, pod uids by name; the what-if's parity True) or,
    for schedule_independent, against the plain pipeline's result from
    phase_explain_kernels.  Returns the launches."""
    from kubernetes_tpu_torch import observability as obs
    from kubernetes_tpu_torch.ops import _build
    from kubernetes_tpu_torch.ops import pipeline as ops_pipe

    def config4_sched(dev):
        nodes = basic_nodes(n_nodes, zones=8)
        sched = planner_sched(dev, nodes, place_round_robin(spread_pods(n_placed, prefix="placed"), nodes))
        sched._repack_mirror()  # set-up: the host snapshot's first full pack, as a drain would have made it
        return sched

    def preempt_sched(dev):
        nodes, victims, preemptors = preemption_world(n_preempt, 1)
        return planner_sched(dev, nodes, victims), preemptors[0]

    devices = (device, torch.device("cpu"))
    scheds = [(config4_sched(dev), *preempt_sched(dev)) for dev in devices]
    if device.type == "cuda":
        torch.cuda.synchronize()
    _build.reset_launches()
    t_path = time.perf_counter()
    runs = []
    for i, dev in enumerate(devices):
        s4, sp, preemptor = scheds[i]
        out = {"explain": {}, "wall_ms": {}}
        for pod in explain_probes():
            t0 = time.perf_counter()
            ex = obs.explain_pod(s4, pod)
            out["wall_ms"][pod.name] = (time.perf_counter() - t0) * 1e3
            out["explain"][pod.name] = _by_name(ex, _uid_names(s4, [pod]))
        t0 = time.perf_counter()
        wi = obs.explain_whatif(sp, preemptor, "node-0")
        out["wall_ms"]["whatif"] = (time.perf_counter() - t0) * 1e3
        out["whatif"] = _by_name(wi, _uid_names(sp, [preemptor]))
        if i == 0:  # the path on the card ends with the pipeline
            pc, pb, ref = k18
            t0 = time.perf_counter()
            res = ops_pipe.schedule_independent(pc, pb, device=dev)
            out["wall_ms"]["schedule_independent"] = (time.perf_counter() - t0) * 1e3
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches = dict(_build.launches)
            path_s = time.perf_counter() - t_path
            si_err = max(max_abs_err(torch, a, b.cpu()) for a, b in zip(res, ref))
        runs.append(out)
    cuda, cpu = runs
    diff = [k for k in cuda["explain"] if cuda["explain"][k] != cpu["explain"][k]]
    wi = cuda["whatif"]
    bad = [bool(diff), wi != cpu["whatif"], wi.get("parity") is not True, si_err != 0,
           launches.get("explain_stack", 0) < len(cuda["explain"]) + 1, launches.get("pipeline_score", 0) < 1]
    if any(bad):
        raise AssertionError(f"explain path: {bad}: explain differs on {diff}, whatif {wi} vs {cpu['whatif']}, "
                             f"schedule_independent err {si_err}, launches {launches}")
    ex = cuda["explain"]
    log(phase="explain_path", nodes=n_nodes, placed=n_placed, equal_to_cpu=True,
        n_feasible={k: v.get("n_feasible") for k, v in ex.items()},
        summary={k: v.get("summary") for k, v in ex.items()},
        whatif=dict(victims=[v["name"] for v in wi.get("victims", [])], parity=wi["parity"],
                    engine=wi["kernel"]["engine"], feasible=wi["feasible_after_preemption"]),
        schedule_independent_equal_plain=True, cuda_wall_ms=cuda["wall_ms"], cpu_wall_ms=cpu["wall_ms"],
        path_s=path_s, launches={k: v for k, v in launches.items() if v})
    return launches


def phase_dra_large(torch, device, n_nodes=50, devices=300, n_pods=1500, count=10):
    """A DRA drain past the register words: 50 nodes of 300 devices each
    and 1,500 pods with one ExactCount=10 claim each (every device taken),
    on cuda and with device="cpu": bindings and claim pins identical, no
    device granted twice, every claim on its pod's node.  Returns the cuda
    drain's launches."""
    from kubernetes_tpu_torch.ops import _build

    runs = []
    for dev in (device, torch.device("cpu")):
        nodes, slices, classes, claims, pods = dra_bench_world(n_nodes, n_pods, devices, count=count)
        _build.reset_launches()
        got, outs, dt, sched = gang_drain(dev, nodes, (), pods, dra=(slices, classes, claims))
        check_capacity(sched)
        allocated, granted = dra_drain_checks(sched, got, claims, pods)
        pins = {c.key: (c.allocation.node_name, tuple(r.device for r in c.allocation.results))
                for c in sched.claim_cache.list() if c.allocation is not None}
        runs.append((got, pins, allocated, granted, dt, dict(_build.launches)))
    (got, pins, allocated, granted, dt, launches), (cgot, cpins, _, _, cdt, _) = runs
    unplaced = [k for k, v in got.items() if v is None]
    bad = [got != cgot, pins != cpins, bool(unplaced), allocated != n_pods, granted != n_pods * count,
           any(launches[k] <= 0 for k in ("dra_spec_mask", "workloads_admit"))]
    if any(bad):
        raise AssertionError(f"dra large drain: {bad} unplaced {unplaced[:3]} {launches}")
    log(phase="dra_large_drain", nodes=n_nodes, devices_per_node=devices, pods=n_pods, count=count,
        claims_allocated=allocated, devices_granted=granted, equal_to_cpu=True, no_double_grant=True,
        cuda_drain_s=dt, cpu_drain_s=cdt, launches={k: v for k, v in launches.items() if v})
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the sampling window, the seeded tie-break and the fit strategies
# ---------------------------------------------------------------------------

SHAPE_RTCR = ((0, 0), (50, 70), (100, 20))  # a three-point RequestedToCapacityRatio shape
TIE_SEED = 7


def step_modes(n_nodes):
    """The step modes of phase 13's kernel rows, as gang_schedule's keyword
    arguments: the default branch; compat sampling with the adaptive window
    (k = numFeasibleNodesToFind(0, n)) and a tie seed; the same window with
    no seed (ties to the first node in visit order from the cursor, what
    percentage_of_nodes_to_score or reference_sampling_compat alone give);
    the window over every node (k = n, the compat first-max with nothing
    cut); MostAllocated; RequestedToCapacityRatio with a three-point
    shape."""
    from kubernetes_tpu_torch.ops import rng
    from kubernetes_tpu_torch.oracle.pipeline import num_feasible_nodes_to_find

    return {
        "default": {},
        "compat_tie": dict(sample_k=num_feasible_nodes_to_find(0, n_nodes), sample_start=1234,
                           tie_key=rng.prng_key(TIE_SEED), attempt_base=100000),
        "compat": dict(sample_k=num_feasible_nodes_to_find(0, n_nodes), sample_start=1234),
        # the cursor among the last tenth of the nodes, which sampling_rows
        # leaves empty: the tied best nodes, where a first-max from the
        # cursor parts from the first-max by slot
        "compat_all": dict(sample_k=n_nodes, sample_start=n_nodes * 19 // 20),
        "most_allocated": dict(fit_strategy=(1, (), (1, 1))),
        "rtcr": dict(fit_strategy=(2, SHAPE_RTCR, (1, 1))),
    }


def sampling_rows(torch, device, reps=3, n_nodes=5000, P=512, modes=None):
    """K5, K8 and K9 in each step mode against their plain versions on the
    card, exact on every output (the scan's chosen, n_feas, reason counts
    and tallies with the advanced cursor; c0; the admission's outputs and
    tallies), and K9's placements equal K5's, at config4's node set
    (basic_nodes(5000, zones=3), N bucket 5,120) with P=512 spread pods over
    4,500 placed ones; each kernel's time in the mode beside the default
    branch's, its plain version's (one run) and its bound.  Returns the rows
    by mode (``modes``: a subset of step_modes' names besides the default
    branch, whose row has the times only)."""
    from kubernetes_tpu_torch.ops import gang, wave

    nodes = basic_nodes(n_nodes, zones=3)
    placed = place_round_robin(spread_pods(n_nodes * 9 // 10, prefix="placed"), nodes)
    dc, db, kw, d_cap, flags, wt = wave_inputs(torch, device, nodes, placed, spread_pods(P, prefix="new"), P)
    hk, v_cap = kw["hostname_key"], kw["v_cap"]
    g = gang.precompute(dc, db, **kw, **dict(flags, has_ports=False))
    targs = [wt[k] for k in WAVE_TABLES]
    tkw = dict(d_cap=d_cap, d2_cap=wt["d2_cap"], has_ports=False, tid_pt=wt["tid_pt"], port_conf=wt["port_conf"])
    # the default branch: its kernels' times only (phases 5 and 6 hold it
    # against the plain versions)
    base = gang.gang_schedule(dc, db, g, v_cap, d_cap=d_cap)[0]
    c0_base = wave.wave_speculate(dc, db, g, d_cap=d_cap)
    rows = {"default": dict(shape="config4_nodes", mode="default", **{
        k: dict(ms=time_ms(torch, fn, reps)) for k, fn in (
            ("gang_scan", lambda: gang.gang_schedule(dc, db, g, v_cap, d_cap=d_cap)),
            ("wave_speculate", lambda: wave.wave_speculate(dc, db, g, d_cap=d_cap)),
            ("wave_admit", lambda: wave.wave_admit(dc, db, g, hk, c0_base, *targs, **tkw)))})}
    rows["default"]["wave_admit"].update(k9_cluster(torch, db, rows["default"]["wave_admit"]["ms"],
                                                    rows["default"]["gang_scan"]["ms"]))
    log(phase="sampling_kernel_check", **rows["default"])
    for mode, m in step_modes(n_nodes).items():
        if mode == "default" or (modes is not None and mode not in modes):
            continue
        ck, nk, rk, tk = gang.gang_schedule(dc, db, g, v_cap, d_cap=d_cap, **m)
        (cp, np_, rp, tp), k5_plain = timed_once(torch, lambda: gang.gang_schedule_plain(dc, db, g, v_cap,
                                                                                        d_cap=d_cap, **m))
        spec_feas = torch.zeros((P,), dtype=torch.int64, device=device)
        c0, k8_plain = timed_once(torch, lambda: wave.wave_speculate_plain(dc, db, g, d_cap=d_cap, n_feas=spec_feas,
                                                                           **m))
        c0_k = wave.wave_speculate(dc, db, g, d_cap=d_cap, **m)
        adm, k9_plain = timed_once(torch, lambda: wave.wave_admit_plain(dc, db, g, hk, c0, *targs, **tkw, **m))
        adm_k = wave.wave_admit(dc, db, g, hk, c0, *targs, **tkw, **m)
        torch.cuda.synchronize()
        errs = dict(
            k5_err=max([max_abs_err(torch, a, b) for a, b in ((ck, cp), (nk, np_), (rk, rp))]
                       + [max_abs_err(torch, tk[k], tp[k]) for k in tp]),
            k8_err=max_abs_err(torch, c0_k, c0),
            k9_err=max([max_abs_err(torch, a, b) for a, b in zip(adm_k[:3] + adm_k[4:], adm[:3] + adm[4:])]
                       + [max_abs_err(torch, adm_k[3][k], adm[3][k]) for k in adm[3]]),
            k9_vs_k5=max(max_abs_err(torch, adm[0], cp), max_abs_err(torch, adm[1], np_)))
        if set(tk) != set(tp) or set(adm_k[3]) != set(adm[3]):
            raise AssertionError(f"sampling {mode}: the tallies' keys differ")
        if any(errs.values()):
            raise AssertionError(f"sampling {mode}: kernels differ from their plain versions: {errs}")
        (_, _, (b5, by5)) = gang_bounds(torch, dc, db, g, cp, np_, gang.DEFAULT_WEIGHTS)
        (b8, by8), (b9, by9), _ = wave_bounds(torch, dc, db, g, wt, c0, spec_feas, adm[0], adm[1],
                                              gang.DEFAULT_WEIGHTS)
        row = dict(shape="config4_nodes", mode=mode, N=int(dc.node_valid.sum().item()), P=int(db.valid.sum().item()),
                   placed=int(dc.epod_valid.sum().item()), scheduled=int((cp >= 0).sum().item()),
                   sample_k=m.get("sample_k"), cursor_in=m.get("sample_start"),
                   cursor_out=int(tp["sample_start"]) if "sample_start" in tp else None,
                   mean_feasible=float(np_.double().mean().item()),
                   moved_from_default=int((cp != base).sum().item()), **errs)
        if not row["moved_from_default"]:
            raise AssertionError(f"sampling {mode}: no placement moved off the default branch's")
        row["gang_scan"] = dict(ms=time_ms(torch, lambda: gang.gang_schedule(dc, db, g, v_cap, d_cap=d_cap, **m),
                                           reps), plain_ms=k5_plain, bound_ms=b5, bound_by=by5, library_ms=None)
        row["wave_speculate"] = dict(ms=time_ms(torch, lambda: wave.wave_speculate(dc, db, g, d_cap=d_cap, **m),
                                                reps), plain_ms=k8_plain, bound_ms=b8, bound_by=by8, library_ms=None)
        row["wave_admit"] = dict(ms=time_ms(torch, lambda: wave.wave_admit(dc, db, g, hk, c0, *targs, **tkw, **m),
                                            reps), plain_ms=k9_plain, bound_ms=b9, bound_by=by9, library_ms=None)
        row["wave_admit"].update(k9_cluster(torch, db, row["wave_admit"]["ms"], row["gang_scan"]["ms"]))
        for k in ("gang_scan", "wave_speculate", "wave_admit"):
            row[k]["default_ms"] = rows["default"][k]["ms"]
        log(phase="sampling_kernel_check", **row)
        rows[mode] = row
    return rows


def k11_strategy_row(torch, device, reps=3, n_nodes=1000, P=512):
    """K11 under MostAllocated against its plain version at config10's
    shape (N=1,000 in 8 zones, 64 gangs of 8), exact on every output,
    with its time beside the default branch's and its bound."""
    from kubernetes_tpu_torch.ops import coscheduling as cos
    from kubernetes_tpu_torch.ops import gang

    name, nodes, placed, pending, need, _ = workloads_shapes(n_config10=n_nodes, P=P)[0]
    dc, db, kw, d_cap, flags, wt = wave_inputs(torch, device, nodes, placed, pending)
    P = db.valid.shape[0]
    rows = gang_rows(torch, device, int(db.valid.sum().item()), P, need)
    g = gang.precompute(dc, db, **kw, **dict(flags, has_ports=False))
    hk = kw["hostname_key"]
    targs = [wt[k] for k in WAVE_TABLES]
    gk = [rows[k] for k in ("gang_id", "gang_first", "gang_last", "gang_need", "g_cap")]
    tkw = dict(d_cap=d_cap, d2_cap=wt["d2_cap"])
    most = dict(fit_strategy=(1, (), (1, 1)))
    got = cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw, **most)
    want, plain_ms = timed_once(torch, lambda: cos.workloads_admit_plain(dc, db, g, hk, *targs, *gk, **tkw, **most))
    default = cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw)
    torch.cuda.synchronize()

    def outs(o):
        return list(o[:4]) + [o[4][k] for k in ("requested", "nonzero", "num_pods")] + list(o[5:7])

    err = max(max_abs_err(torch, a, b) for a, b in zip(outs(got), outs(want)))
    if err:
        raise AssertionError(f"K11 MostAllocated differs from its plain version ({err})")
    moved = int((default[1] != got[1]).sum().item())
    if not moved:
        raise AssertionError("K11: MostAllocated moved no placement off the default branch's")
    b11, by11 = k11_bound(torch, dc, db, g, wt, rows, want[1], want[2], gang.DEFAULT_WEIGHTS)
    row = dict(shape=name, mode="most_allocated", N=int(dc.node_valid.sum().item()), P=int(db.valid.sum().item()),
               k11_err=err, moved_from_default=moved, gangs_admitted=int((want[5] == 1).sum().item()),
               workloads_admit=dict(
                   ms=time_ms(torch, lambda: cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw, **most), reps),
                   default_ms=time_ms(torch, lambda: cos.workloads_admit(dc, db, g, hk, *targs, *gk, **tkw), reps),
                   plain_ms=plain_ms, bound_ms=b11, bound_by=by11, library_ms=None))
    log(phase="sampling_kernel_check", **row)
    return row


# H100 SXM (the same 132 SMs at 1.98 GHz as the float32 peak above): every
# SM issues at most 128 lane operations a clock (four warp instructions);
# integer adds issue on the 64 INT32 lanes or, as IMAD, on the FMA pipe, but
# shifts and logic only on the 64 INT32 lanes
PEAK_INT32_LOGIC_S = PEAK_ISSUE_OPS_S / 2
# threefry2x32 of ktpu::rng, from its round structure: 20 rounds of an add,
# a rotate (one funnel shift) and an xor, and six key injections of two adds
# (the second add's round constant folds into a three-input add); so 40
# shifts and logic operations and 32 adds a call
THREEFRY_LOGIC, THREEFRY_ADDS = 40, 32


def tie_bits_bound(A, N):
    """K19's least time on the H100: the larger of its int64 writes over the
    memory rate and the integer work the function needs, one threefry and
    an xor per (attempt, node) and one fold_in and the key's two xors per
    attempt, with the shifts and logic on the INT32 lanes and the whole
    issued at the SMs' issue rate.  (The kernel folds the attempt in per
    thread, A N fold_ins where A are needed: a cost of its design, not of
    the function.)"""
    logic = A * N * (THREEFRY_LOGIC + 1) + A * (THREEFRY_LOGIC + 2)
    ops = logic + (A * N + A) * THREEFRY_ADDS
    t_bytes = A * N * 8 / PEAK_BYTES_S * 1e3
    t_ops = max(logic / PEAK_INT32_LOGIC_S, ops / PEAK_ISSUE_OPS_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k19_row(torch, device, reps=10, A=512, N=10240, host_N=500):
    """K19 tie_bits against its plain version, exact, for A attempts over
    an N-node bucket, and at the one-pod host cycle's shape (one attempt
    over host_N nodes, what the cycle launches per pod), each with its
    time, the plain version's and its bound (tie_bits_bound)."""
    from kubernetes_tpu_torch.ops import rng

    key, base = rng.prng_key(TIE_SEED), 100000
    row = {}
    for name, a, n in (("tie_bits", A, N), ("host_cycle", 1, host_N)):
        got = rng.tie_bits(key, base, a, n, device)
        want, plain_ms = timed_once(torch, lambda: rng.tie_bits_plain(key, base, a, n, device))
        err = max_abs_err(torch, got, want)
        if err:
            raise AssertionError(f"K19 tie_bits differs from its plain version at A={a} N={n} ({err})")
        b, by = tie_bits_bound(a, n)
        row[name] = dict(shape=f"A={a} N={n}", max_abs_err=err,
                         ms=time_ms(torch, lambda: rng.tie_bits(key, base, a, n, device), reps),
                         plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None)
    row["k19_err"] = max(r["max_abs_err"] for r in row.values())
    log(phase="sampling_kernel_check", **row)
    return row


def phase_sampling_drains(torch, device, n_nodes=5000, n_pods=10240, n_host_nodes=500, n_host_pods=128,
                          n_seedless_nodes=1000, n_seedless_pods=256, n_small_nodes=90):
    """Full-width drains through Scheduler() on the card, on config4's node
    set (basic_nodes(5000, zones=3)): 10,240 spread pods under
    reference_sampling_compat with tie_break_seed 7, every batch on the
    direct wave (no fast, chained or scan batch), the zone skew within
    maxSkew, the attempt counter at the pod count and the cursor read back
    from K9; and 10,240 plain pods (bench.py's north-star mix) under
    MostAllocated, off the fast path on the chained scan as the reference
    routes them, its first batch's 512 placements equal to a device="cpu"
    drain of those pods; then the one-pod host cycle: 128 pods asking for an
    extended GPU resource on 500 nodes under a MostAllocated strategy that
    weighs it (scored on the host), compat sampling and the tie seed, one
    K19 launch per pod, equal to the same drain on the CPU in placements
    and cursor; then reference_sampling_compat with no seed, where ties go
    to the first node in visit order from the cursor, on 1,000 nodes (the
    adaptive window, 420 of 1,000) and on 90 (under 100 nodes the window is
    every node, k = n), added zone by zone (the visit order, zone
    round-robin, is not the slots'), in batches of 256: 256 spread pods (a batch on the
    wave) then 256 plain pods (a batch on the direct scan), each drain equal
    to the same drain on the CPU in placements, cursor and attempts.
    Returns the drains' launches."""
    from kubernetes_tpu_torch.framework.config import Profile
    from kubernetes_tpu_torch.ops import _build

    out = {}
    nodes = basic_nodes(n_nodes, zones=3)
    _build.reset_launches()
    got, dt, sched = drain(device, nodes, spread_pods(n_pods), reference_sampling_compat=True,
                           tie_break_seed=TIE_SEED)
    launches = out["compat"] = dict(_build.launches)
    check_capacity(sched)
    m = sched.metrics
    batches = -(-n_pods // sched.config.batch_size)
    if (m["wave_batches"], m["scan_batches"], m["chain_batches"], m["fast_batches"]) != (batches, 0, 0, 0):
        raise AssertionError(f"compat drain: routes {m}")
    if sched._attempt_counter != n_pods or not 0 <= sched._next_start_node_index < n_nodes:
        raise AssertionError("compat drain: the counters did not advance as the reference's")
    missing = [k for k in ("static_eval", "gang_spread_statics", "wave_speculate", "wave_admit") if not launches[k]]
    if missing:
        raise AssertionError(f"compat drain never launched {missing}")
    log(phase="sampling_drain", name="compat_spread", nodes=n_nodes, pods=len(got),
        placed=sum(v is not None for v in got.values()), drain_s=dt, pods_per_s=len(got) / dt,
        zone_skew=zone_skew_ok(sched, got), cursor=sched._next_start_node_index,
        attempts=sched._attempt_counter, launches=launches, wave_batches=m["wave_batches"],
        scan_batches=m["scan_batches"], chain_batches=m["chain_batches"], fast_batches=m["fast_batches"])

    most = [Profile(plugin_config={"NodeResourcesFit": {"scoringStrategy": {"type": "MostAllocated"}}})]
    _build.reset_launches()
    got, dt, sched = drain(device, nodes, north_star_pods(n_pods), profiles=most)
    launches = out["most_allocated"] = dict(_build.launches)
    check_capacity(sched)
    m = sched.metrics
    if m["fast_batches"] or m["resident_batches"] or m["scan_batches"] + m["chain_batches"] != batches:
        raise AssertionError(f"MostAllocated drain: routes {m}")
    if not launches["gang_scan"] or not launches["static_eval"]:
        raise AssertionError(f"MostAllocated drain never launched K1 and K5: {launches}")
    first = north_star_pods(512)
    want, cpu_s, _ = drain(torch.device("cpu"), basic_nodes(n_nodes, zones=3), first,
                           profiles=[Profile(plugin_config=most[0].plugin_config)])
    diff = [k for k in want if want[k] != got.get(k)]
    if diff:
        raise AssertionError(f"MostAllocated drain: {len(diff)} of the first 512 placements differ from the CPU's")
    used = len({v for v in got.values() if v is not None})
    log(phase="sampling_drain", name="most_allocated", nodes=n_nodes, pods=len(got),
        placed=sum(v is not None for v in got.values()), drain_s=dt, pods_per_s=len(got) / dt, nodes_used=used,
        compared_with_cpu=len(want), cpu_drain_s=cpu_s, launches=launches, scan_batches=m["scan_batches"],
        chain_batches=m["chain_batches"], fast_batches=m["fast_batches"])

    # the one-pod host cycle: a strategy weighing an extended resource scores
    # on the host, every pod alone, with the window and K19's bits
    host_nodes, host_pods = gpu_world(n_host_nodes, n_host_pods)
    host_cfg = dict(profiles=[Profile(plugin_config={"NodeResourcesFit": {"scoringStrategy": {
        "type": "MostAllocated", "resources": [{"name": "cpu", "weight": 1}, {"name": "memory", "weight": 1},
                                               {"name": GPU, "weight": 5}]}}})],
        reference_sampling_compat=True, tie_break_seed=TIE_SEED)
    _build.reset_launches()
    got, dt, sched = drain(device, host_nodes, host_pods, **host_cfg)
    launches = out["host_fit_tie"] = dict(_build.launches)
    check_capacity(sched)
    if sched.metrics["host_cycles"] != n_host_pods or launches["tie_bits"] != n_host_pods:
        raise AssertionError(f"host-scored drain: {sched.metrics['host_cycles']} host cycles, "
                             f"{launches['tie_bits']} K19 launches for {n_host_pods} pods")
    want, cpu_s, cpu_sched = drain(torch.device("cpu"), *gpu_world(n_host_nodes, n_host_pods), **host_cfg)
    if want != got or cpu_sched._next_start_node_index != sched._next_start_node_index:
        raise AssertionError("host-scored drain: the placements or the cursor differ from the CPU's")
    log(phase="sampling_drain", name="host_fit_tie", nodes=n_host_nodes, pods=len(got),
        placed=sum(v is not None for v in got.values()), drain_s=dt, pods_per_s=len(got) / dt, cpu_drain_s=cpu_s,
        cursor=sched._next_start_node_index, attempts=sched._attempt_counter, launches=launches,
        host_cycles=sched.metrics["host_cycles"], equal_to_cpu=True)

    # no seed: the compat first-max in visit order, cut and uncut, the
    # nodes added zone by zone so that the visit order is not the slots'
    for name, n in (("compat_seedless", n_seedless_nodes), ("compat_seedless_all", n_small_nodes)):
        def world():
            nodes = sorted(basic_nodes(n, zones=3), key=lambda nd: nd.labels[ZONE])
            return nodes, spread_pods(n_seedless_pods) + north_star_pods(n_seedless_pods)

        _build.reset_launches()
        seedless = dict(reference_sampling_compat=True, batch_size=n_seedless_pods)
        got, dt, sched = drain(device, *world(), **seedless)
        launches = out[name] = dict(_build.launches)
        check_capacity(sched)
        m = sched.metrics
        if (m["wave_batches"], m["scan_batches"], m["chain_batches"], m["fast_batches"]) != (1, 1, 0, 0):
            raise AssertionError(f"{name}: routes {m}")
        missing = [k for k in ("gang_scan", "wave_speculate", "wave_admit") if not launches[k]]
        if missing:
            raise AssertionError(f"{name} never launched {missing}")
        want, cpu_s, cpu_sched = drain(torch.device("cpu"), *world(), **seedless)
        if (want != got or cpu_sched._next_start_node_index != sched._next_start_node_index
                or cpu_sched._attempt_counter != sched._attempt_counter):
            raise AssertionError(f"{name}: the placements, the cursor or the attempts differ from the CPU's")
        sample_k = sched._sampling_args(next(iter(sched.profiles.values())))["sample_k"]
        log(phase="sampling_drain", name=name, nodes=n, pods=len(got), placed=sum(v is not None for v in got.values()),
            sample_k=sample_k, drain_s=dt, pods_per_s=len(got) / dt, cpu_drain_s=cpu_s,
            cursor=sched._next_start_node_index, attempts=sched._attempt_counter,
            launches=launches, wave_batches=m["wave_batches"], scan_batches=m["scan_batches"], equal_to_cpu=True)
    return out


GPU = "example.com/gpu"


def gpu_world(n_nodes, n_pods, seed=61):
    """Nodes with 8 cpu, 32Gi and 8 of an extended GPU resource in three
    zones, and pods asking for 1-2 GPUs with 100-500m cpu."""
    from kubernetes_tpu_torch.api import Container, Node, Pod, Resource

    rng = random.Random(seed)
    nodes = [Node(name=f"node-{i}", labels={ZONE: f"zone-{i % 3}", HOSTNAME: f"node-{i}"},
                  capacity=Resource.from_map({"cpu": "8", "memory": "32Gi", "pods": 110, GPU: 8}))
             for i in range(n_nodes)]
    pods = [Pod(name=f"gpu-{i}", containers=[Container(name="c", requests={
        "cpu": f"{rng.choice([100, 250, 500])}m", "memory": "256Mi", GPU: rng.choice([1, 2])})])
        for i in range(n_pods)]
    return nodes, pods


def phase_sampling_parity(torch, device, compat=(600, 900, 77), wave=(200, 400, 47)):
    """Port copies of the reference's tools/paritycheck.py
    check_compat_vs_oracle and check_compat_wave_vs_oracle: a compat drain
    with tie_break_seed = seed on the card (plain pods; then mixed spread /
    anti-affinity / plain pods, which must ride the wave) against the port
    oracle's serial loop in nodeTree order (feasible_nodes with the adaptive
    window from the cursor, prioritize, the (score, bits) maximum), the bits
    of every attempt drawn by K19 in one launch.  Sizes cut from the
    reference's (2,000 / 3,000 and 800 / 1,600: the serial oracle walks
    every placed anti-affinity pod per candidate node, minutes at that
    size) to 600 / 900 and 200 / 400.  Returns the launches."""
    from kubernetes_tpu_torch.ops import _build, rng
    from kubernetes_tpu_torch.oracle.pipeline import feasible_nodes, prioritize
    from kubernetes_tpu_torch.oracle.state import OracleState

    def serial(nodes, pods, seed, count_all):
        state = OracleState.build(nodes)
        n = len(nodes)
        bits = rng.tie_bits(rng.prng_key(seed), 0, len(pods), n, device).cpu().tolist()
        idx_of = {name: i for i, name in enumerate(state.nodes)}
        start = attempt = 0
        want = {}
        for pod in pods:
            fit = feasible_nodes(pod, state, sample_pct=0, start_index=start)
            start = (start + fit.processed) % n
            totals = prioritize(pod, state, fit.feasible)
            if count_all:
                attempt += 1
            if not totals:
                want[pod.name] = None
                continue
            if not count_all:
                attempt += 1
            h = bits[attempt - 1]
            node = max(totals, key=lambda m: (totals[m], h[idx_of[m]]))
            want[pod.name] = node
            pod.node_name = node
            state.place(pod)
        return want

    launches = {}
    for name, (n_nodes, n_pods, seed), make, count_all in (
            ("compat_vs_oracle", compat, lambda n, s: north_star_pods(n, prefix="pp", seed=s), False),
            ("compat_wave_vs_oracle", wave, cross_pod_pods, True)):
        t0 = time.perf_counter()
        _build.reset_launches()
        got, dt, sched = drain(device, basic_nodes(n_nodes, zones=3), make(n_pods, seed),
                               reference_sampling_compat=True, tie_break_seed=seed)
        t1 = time.perf_counter()
        want = serial(basic_nodes(n_nodes, zones=3), make(n_pods, seed), seed, count_all)
        launches[name] = dict(_build.launches)
        diffs = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        wave_batches = sched.metrics["wave_batches"]
        log(phase="sampling_parity", name=name, nodes=n_nodes, pods=n_pods, seed=seed,
            bound_device=sum(v is not None for v in got.values()),
            bound_oracle=sum(v is not None for v in want.values()),
            diffs=len(diffs), first_diffs=[(k, got.get(k), want.get(k)) for k in diffs[:5]], wave_batches=wave_batches,
            drain_s=dt, oracle_s=time.perf_counter() - t1, wall_s=time.perf_counter() - t0, launches=launches[name])
        if diffs:
            raise AssertionError(f"{name}: {len(diffs)} placements differ from the serial oracle")
        if name == "compat_wave_vs_oracle" and not wave_batches:
            raise AssertionError("compat_wave_vs_oracle: the wave never engaged")
    return launches


def cross_pod_pods(n, seed=99):
    """The reference's tools/paritycheck.py _cross_pod_pods: mixed
    zone-spread (maxSkew 3), hostname anti-affinity and plain pods, the
    wave's diet."""
    from kubernetes_tpu_torch.api import (Affinity, Container, LabelSelector, Pod, PodAffinityTerm, PodAntiAffinity,
                                          TopologySpreadConstraint)

    rng = random.Random(seed)
    pods = []
    for i in range(n):
        kw = {}
        if i % 2 == 0:
            app = f"sp-{i % 12}"
            kw["labels"] = {"app": app}
            kw["topology_spread_constraints"] = (TopologySpreadConstraint(
                max_skew=3, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
                label_selector=LabelSelector(match_labels={"app": app})),)
        elif i % 4 == 1:
            grp = f"g{i % 20}"
            kw["labels"] = {"group": grp}
            kw["affinity"] = Affinity(pod_anti_affinity=PodAntiAffinity(
                required_during_scheduling_ignored_during_execution=(PodAffinityTerm(
                    topology_key=HOSTNAME, label_selector=LabelSelector(match_labels={"group": grp})),)))
        else:
            kw["labels"] = {"app": f"plain-{i % 8}"}
        pods.append(Pod(name=f"wp-{i}", containers=[Container(name="c", requests={
            "cpu": f"{rng.choice([100, 250])}m", "memory": "128Mi"})], **kw))
    return pods


def phase_sampling(torch, device):
    """Phase 13: the kernel rows (sampling_rows, k11_strategy_row,
    k19_row), the full-width drains and the two parity copies.  Returns
    (rows by mode, K11's row, K19's row, the drains' launches, the parity
    runs' launches)."""
    rows = sampling_rows(torch, device)
    k11 = k11_strategy_row(torch, device)
    k19 = k19_row(torch, device)
    drains = phase_sampling_drains(torch, device)
    parity = phase_sampling_parity(torch, device)
    return rows, k11, k19, drains, parity


# The kernels redesigned after their port, as the kernels line names them.
DESIGNS = {
    "sig_scan": "an incremental argmax: sig_mark flags the batch's signatures, sig_build (a grid of (signature, "
                "1,024 nodes) blocks) keys every (present signature, node) and builds each signature's 32-ary "
                "tournament tree of (key, lowest node) maxima; one block then reads a root per pod, commits, "
                "re-keys only the chosen node in every tree and repairs each tree along that node's path (an "
                "entry keeps its place unless the new key beats it or its node lay in the changed child); "
                "inner levels in shared memory while they fit",
    "gang_scan": "one thread-block cluster of 16 CTAs (8 where the card admits no cluster of 16) on neighbouring "
                 "SMs running the shared step under ClusterPolicyT<false>, laid out and staged as K9; every CTA "
                 "walks the committed peers itself into its own per-domain counters (no exchange carries them), "
                 "reading their nodes from its own copy of the choices; 4 exchanges a pod with spread slots "
                 "(min-match, counts, spread normalizers, argmax), 2 without",
    "wave_admit": "one thread-block cluster of 16 CTAs (8 where the card admits no cluster of 16) on neighbouring "
                  "SMs, each over a slice of the nodes with its usage rows, carries, node statics and each pod's "
                  "planes (bulk copies one pod ahead) in shared memory; four exchanges a pod (sums with the "
                  "min-match, the counts, the spread normalizers, the argmax) push each CTA's part into every "
                  "CTA's shared memory with st.async on an mbarrier",
    "gang_spread_statics": "classes (a warp a constraint finds its first equal selector, where the placed pods "
                           "outnumber the constraints 2:1), a match kernel (a tile of 4-8 representative "
                           "selectors in shared memory against 256 placed pods a block, each pod's row read once "
                           "for the tile, 32-pod match words by ballot), then a block per (pod, constraint): node "
                           "counts from the bits in shared memory, the domain sums in shared memory (warp-"
                           "aggregated for keys of up to 64 domains), domain tiles past the budget, node-major "
                           "16- and 4-byte loads and stores; no host sync in the wrapper",
    "gang_interpod_statics": "a terms kernel (each placed term's key, domain, weight and anti flag, the used keys "
                             "marked), ext (a block of 512 threads a pod, the cells of the used keys only in shared "
                             "memory, domain tiles past the budget), the classes and match kernels over the pods' "
                             "own terms and a block per (pod, term) with its domain cells in shared memory; the "
                             "port kernel as before; no host sync in the wrapper",
    "fork_view": "source-stationary: one 16-byte source vector per thread in registers, one int4 store per fork "
                 "masked by the fork's alive byte (node-major planes) or uchar4 (node-minor planes), a plane per "
                 "blockIdx.y, a chunk of forks per blockIdx.z",
}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's kernels need a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from kubernetes_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the kubernetes_tpu_torch package is missing beside this script ({e})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.load()
    log(phase="build", card=card, build_s=time.perf_counter() - t0, cached=_build.build_log == "")

    checks = phase_kernels(torch, device)
    checks["resident_run"] = phase_resident(torch, device)
    phase_transport(torch, device)

    # config0 under residentDrain: false (K1, K2, K3) and under the default
    # configuration (K1, K4, K3; its host tail on the committer), taken in
    # turns DRAIN_REPEATS times each so that their spread is seen; then once
    # with residentSerialTail (K1, K4, its tail on K2, K3)
    config0 = (lambda: basic_nodes(10000), lambda: north_star_pods(100000))
    want, spread = None, {"config0": [], "config0_default": []}
    for _ in range(DRAIN_REPEATS):
        off, want, dt = phase_drain(torch, "config0", device, *config0,
                                    ("static_eval", "sig_scan", "usage_checksum"), want=want,
                                    resident_drain=False)
        spread["config0"].append(dt)
        default, _, dt = phase_drain(torch, "config0_default", device, *config0,
                                     ("static_eval", "resident_run", "usage_checksum"), want=want)
        spread["config0_default"].append(dt)
    for name, dts in spread.items():
        log(phase="drain_spread", name=name, drain_s=dts, min_s=min(dts), median_s=statistics.median(dts),
            max_s=max(dts))
    phase_drain(torch, "config0_serial_tail", device, *config0,
                ("static_eval", "resident_run", "sig_scan", "usage_checksum"), want=want,
                resident_serial_tail=True)
    mixed = (lambda: mixed_nodes(1000), lambda: mixed_pods(10000))
    _, want, _ = phase_drain(torch, "mixed", device, *mixed,
                             ("static_eval", "sig_scan", "usage_checksum"), resident_drain=False)
    phase_drain(torch, "mixed_default", device, *mixed, ("static_eval", "resident_run", "usage_checksum"),
                want=want)
    phase_drain(torch, "mixed_serial_tail", device, *mixed,
                ("static_eval", "resident_run", "usage_checksum"), want=want, resident_serial_tail=True)

    # the gang path: K5-K7 against their plain versions at full width, then
    # config4 and config3 under waveDispatch: false (the gang scan), the
    # preferred-affinity drain under the default configuration, and the
    # cuda-vs-cpu parity drain
    gang, wave = phase_gang_kernels(torch, device)
    c4 = (lambda: basic_nodes(5000, zones=8), lambda: spread_pods(50000))
    c3 = (lambda: basic_nodes(1000), lambda: interpod_pods(5000))
    check4 = lambda sched, got: zone_skew_ok(sched, got)  # noqa: E731
    check3 = lambda sched, got: anti_affinity_ok(got)  # noqa: E731
    spread_l, want4 = phase_gang_drain(torch, "config4", device, c4[0](), c4[1](),
                                       ("static_eval", "gang_spread_statics", "gang_scan"), check=check4,
                                       wave_dispatch=False)
    interpod_l, want3 = phase_gang_drain(torch, "config3", device, c3[0](), c3[1](),
                                         ("static_eval", "gang_interpod_statics", "gang_scan"), check=check3,
                                         wave_dispatch=False)
    phase_gang_drain(torch, "preferred", device, tier_nodes(10000), preferred_pods(20000),
                     ("static_eval", "gang_interpod_statics", "gang_scan"),
                     check=first_pods_match_cpu(torch, tier_nodes(10000), preferred_pods(512)))
    phase_gang_parity(torch, device)

    # the wave: K8 and K9 against their plain versions (and K9 against K5)
    # at full width (config4's and config3's shapes ran with the gang
    # kernels above); config4 and config3 under the default configuration,
    # every batch on the wave, placed as the gang-scan drains above placed
    # them; a port-contended drain (every batch a direct wave with the port
    # carry) against the same drain under waveDispatch: false; and the parity
    # drain under the default configuration
    wave.update(phase_wave_kernels(torch, device))
    wave_k = ("wave_speculate", "wave_admit")
    wave4_l, _ = phase_gang_drain(torch, "config4_wave", device, c4[0](), c4[1](),
                                  ("static_eval", "gang_spread_statics") + wave_k, check=check4, want=want4,
                                  wave_batches=98)
    phase_gang_drain(torch, "config3_wave", device, c3[0](), c3[1](), ("static_eval", "gang_interpod_statics")
                     + wave_k, check=check3, want=want3, wave_batches=10)
    ports = (lambda: basic_nodes(1000, zones=4), lambda: port_heavy_pods(4096))
    _, want_p = phase_gang_drain(torch, "ports", device, ports[0](), ports[1](), ("static_eval", "gang_scan"),
                                 wave_dispatch=False)
    phase_gang_drain(torch, "ports_wave", device, ports[0](), ports[1](), ("static_eval",) + wave_k, want=want_p,
                     wave_batches=8)
    phase_gang_parity(torch, device, wave=True)

    # preemption: K10 against its plain version at config0's node count (K5,
    # K8 and K9 with 64 open nominations ran with the kernel checks above);
    # bench_preemption's drain on cuda and on the CPU, and at 5k nodes; the
    # gang-path drain with priorities on cuda and on the CPU
    checks["narrow_candidates"] = phase_preempt_kernels(torch, device)
    phase_preempt_drains(torch, device)
    preempt_l = phase_preempt_parity(torch, device, n_nodes=200, n_placed=600, n_pods=800)

    # gang coscheduling: K11 against its plain version (and, gangs cleared,
    # against K9) at config10's, config4's and the mixed shape; bench_gang's
    # drain (config10) at full size; the contended gang drain on cuda and on
    # the CPU
    wl_rows = phase_workloads_kernels(torch, device)
    # the composite roots' bounds: the sums of their kernels' bounds at
    # config4's shape (the appends of chain_dispatch are copies, not counted)
    # and, for workloads_run, config10's
    g4, w4 = gang["config4"], wave["config4"]
    pre4 = g4["static_eval_bound_ms"] + g4["k6_bound_ms"] + g4["k7_bound_ms"]
    scan4 = pre4 + g4["gang_scan"]["bound_ms"]
    wave4 = pre4 + w4["wave_speculate"]["bound_ms"] + w4["wave_admit"]["bound_ms"]
    log(phase="composite_bounds", gang_run=scan4, wave_run=wave4, chain_dispatch_scan=scan4,
        chain_dispatch_wave=wave4, workloads_run=wl_rows["config10"]["workloads_run_bound_ms"],
        workloads_run_parts=wl_rows["config10"]["workloads_run_bound_parts"])
    config10_l = phase_config10(torch, device)
    phase_gang_parity_contended(torch, device)

    # bound volumes: K12 (and K1 with its mask as the extra lane) against
    # the plain versions at config4's node set; the StatefulSet drain of
    # 10,000 bound-volume pods on 5,000 nodes; the volume parity drain on
    # cuda, on the CPU and against the serial WorkloadOracle
    checks["volume_topology_mask"] = phase_volume_kernels(torch, device)
    statefulset_l, k12_err = phase_statefulset(torch, device)
    checks["volume_topology_mask"]["max_abs_err"] = max(checks["volume_topology_mask"]["max_abs_err"], k12_err)
    phase_volume_parity(torch, device, n_nodes=600, n_vol=360, n_gangs=12, n_spread=192)

    # DRA claims: K13, K14 and K11's DRA mode against their plain versions
    # at config4's node set; bench_dra's drain (config11) at full size; the
    # DRA parity drain on cuda, on the CPU and against the serial oracle
    dra_row = phase_dra_kernels(torch, device)
    checks["dra_selector_match"] = dra_row["dra_selector_match"]
    checks["dra_spec_mask"] = dra_row["dra_spec_mask"]
    dra_l = phase_dra_drain(torch, device)
    dra_parity_l = phase_dra_parity(torch, device)
    k11_dra = dict(max_abs_err=dra_row["k11_err"], ms=dra_row["k11_dra_ms"], plain_ms=dra_row["k11_dra_plain_ms"],
                   bound_ms=dra_row["k11_dra_bound_ms"], bound_by=dra_row["k11_dra_bound_by"], library_ms=None,
                   claims_cleared_ms=dra_row["k11_claims_cleared_ms"], launches_dra_drain=dra_l["workloads_admit"],
                   launches_dra_parity=dra_parity_l["workloads_admit"])
    # the counterfactual planner: K15 and K16 against their plain versions
    # at 64 forks over config4's node set, K8 and K11 with a target score;
    # config14 (bench_plan) on the kernel engine against the serial engine
    # and the CPU's plain run on its first 8 forks, and the 64 forks one
    # at a time; the three planners
    # at full width
    k15, k16, es_row = phase_planner_kernels(torch, device)
    checks["fork_view"], checks["fork_summary"] = k15, k16
    config14_l = phase_config14(torch, device, ref_forks=8)
    phase_planner_full(torch, device)
    # explain and the independent pipeline: K17 at config4's and the mixed
    # shape, K18 at the K18 shape, each against its plain version, and the
    # CUDA pipeline route against pipeline_plain; K14 and K11's DRA mode
    # at 320 device slots beside 8; the main path (explain_pod,
    # explain_whatif, schedule_independent) on cuda against the CPU; the
    # DRA drain with 300 devices per node on cuda and on the CPU
    k17_rows, k18_row_, k18_shape = phase_explain_kernels(torch, device)
    dd_rows = phase_dra_slots(torch, device)
    explain_l = phase_explain(torch, device, k18=k18_shape)
    dra_large_l = phase_dra_large(torch, device, n_nodes=30, n_pods=900)
    checks["explain_stack"] = dict(k17_rows["config4"]["explain_stack"], mixed=k17_rows["mixed"]["explain_stack"],
                                   max_abs_err=max(r["k17_err"] for r in k17_rows.values()))
    checks["pipeline_score"] = dict(route_err=k18_row_["route_err"], **k18_row_["pipeline_score"])
    # the sampling window, the seeded tie-break (K19) and the fit strategies:
    # K5, K8 and K9 in each mode, K11 under MostAllocated, K19, against their
    # plain versions; the compat and MostAllocated drains at full width and
    # the one-pod host cycle's drain; the two compat parity copies
    modes, k11_most, k19, sampling_l, sampling_parity_l = phase_sampling(torch, device)
    checks["tie_bits"] = dict(k19["tie_bits"], max_abs_err=k19["k19_err"], host_cycle=k19["host_cycle"])
    checks["dra_spec_mask"]["max_abs_err"] = max(checks["dra_spec_mask"]["max_abs_err"],
                                                 *(r["k14_err"] for r in dd_rows.values()))
    checks["dra_spec_mask"]["dd320"] = dict(dd_rows[320]["dra_spec_mask"], dd8_ms=dd_rows[8]["dra_spec_mask"]["ms"],
                                            launches_dra_large_drain=dra_large_l["dra_spec_mask"])
    # each kernel's error: the largest over the shapes of this run
    for kernel, err in (("gang_scan", "k5_err"), ("gang_spread_statics", "k6_err"),
                        ("gang_interpod_statics", "k7_err")):
        checks[kernel] = dict(max_abs_err=max(row[err] for row in gang.values()),
                              **gang["config3" if kernel == "gang_interpod_statics" else "config4"][kernel])
    # K7 as every config4 batch launches it: the port kernel alone
    checks["gang_interpod_statics"]["ports_only_config4"] = gang["config4"]["k7_ports_only"]
    for kernel, err in (("wave_speculate", "k8_err"), ("wave_admit", "k9_err")):
        checks[kernel] = dict(max_abs_err=max(row[err] for row in wave.values()), **wave["config4"][kernel])
    # each of K5, K8 and K9 in the step modes of phase 13, and the launches of
    # the sampling and strategy drains
    for kernel, err in (("gang_scan", "k5_err"), ("wave_speculate", "k8_err"), ("wave_admit", "k9_err")):
        checks[kernel]["max_abs_err"] = max(checks[kernel]["max_abs_err"],
                                            *(r[err] for r in modes.values() if err in r))
        checks[kernel]["modes"] = {mode: dict(r[kernel], max_abs_err=r.get(err)) for mode, r in modes.items()}
        checks[kernel]["launches_sampling_drains"] = {k: v[kernel] for k, v in sampling_l.items()}
    # K8 with K14's lane, the DRA batch's speculation
    checks["wave_speculate"]["max_abs_err"] = max(checks["wave_speculate"]["max_abs_err"], dra_row["k8_lane_err"])
    checks["wave_speculate"]["dra_lane"] = dict(shape="config4_dra", max_abs_err=dra_row["k8_lane_err"],
                                                ms=dra_row["k8_lane_ms"], plain_ms=dra_row["k8_lane_plain_ms"])
    checks["workloads_admit"] = dict(max_abs_err=max([r["k11_err"] for r in wl_rows.values()] + [dra_row["k11_err"]]
                                                     + [r["k11_err"] for r in dd_rows.values()]),
                                     dra=k11_dra, **wl_rows["config10"]["workloads_admit"])
    checks["workloads_admit"]["dra"]["dd320"] = dict(
        max_abs_err=dd_rows[320]["k11_err"], ms=dd_rows[320]["k11_dra_ms"], plain_ms=dd_rows[320]["k11_dra_plain_ms"],
        dd8_ms=dd_rows[8]["k11_dra_ms"], launches_dra_large_drain=dra_large_l["workloads_admit"])
    # K8 and K11 with the planner's extra_score (a target bonus)
    checks["wave_speculate"]["max_abs_err"] = max(checks["wave_speculate"]["max_abs_err"], es_row["k8_err"])
    checks["wave_speculate"]["extra_score"] = dict(shape="config4_extra_score", max_abs_err=es_row["k8_err"],
                                                   ms=es_row["k8_ms"], no_score_ms=es_row["k8_no_score_ms"])
    checks["workloads_admit"]["max_abs_err"] = max(checks["workloads_admit"]["max_abs_err"], es_row["k11_err"])
    checks["workloads_admit"]["max_abs_err"] = max(checks["workloads_admit"]["max_abs_err"], k11_most["k11_err"])
    checks["workloads_admit"]["most_allocated"] = dict(shape=k11_most["shape"], max_abs_err=k11_most["k11_err"],
                                                       **k11_most["workloads_admit"])
    checks["workloads_admit"]["extra_score"] = dict(
        shape="config4_extra_score", max_abs_err=es_row["k11_err"], ms=es_row["k11_ms"],
        no_score_ms=es_row["k11_no_score_ms"], plain_ms=es_row["k11_plain_ms"],
        launches_config14=config14_l["workloads_admit"])
    sources = {
        "static_eval": ("kubernetes_tpu_torch/csrc/static_eval.cu", "kubernetes_tpu/ops/fastpath.py:50",
                        "config0_default", default),
        "sig_scan": ("kubernetes_tpu_torch/csrc/sig_scan.cu", "kubernetes_tpu/ops/fastpath.py:220",
                     "config0", off),
        "usage_checksum": ("kubernetes_tpu_torch/csrc/usage_checksum.cu", "kubernetes_tpu/ops/resident.py:451",
                           "config0_default", default),
        "resident_run": ("kubernetes_tpu_torch/csrc/resident_run.cu", "kubernetes_tpu/ops/resident.py:265",
                         "config0_default", default),
        "gang_spread_statics": ("kubernetes_tpu_torch/csrc/gang_statics.cu", "kubernetes_tpu/ops/gang.py:268",
                                "config4", spread_l),
        "gang_interpod_statics": ("kubernetes_tpu_torch/csrc/gang_statics.cu", "kubernetes_tpu/ops/gang.py:268",
                                  "config3", interpod_l),
        "gang_scan": ("kubernetes_tpu_torch/csrc/gang_scan.cu", "kubernetes_tpu/ops/gang.py:975", "config4",
                      spread_l),
        "wave_speculate": ("kubernetes_tpu_torch/csrc/wave.cu", "kubernetes_tpu/ops/wave.py:666", "config4_wave",
                           wave4_l),
        "workloads_admit": ("kubernetes_tpu_torch/csrc/workloads.cu", "kubernetes_tpu/ops/coscheduling.py:140",
                            "config10", config10_l),
        "wave_admit": ("kubernetes_tpu_torch/csrc/wave.cu", "kubernetes_tpu/ops/wave.py:666", "config4_wave",
                       wave4_l),
        "narrow_candidates": ("kubernetes_tpu_torch/csrc/preemption.cu", "kubernetes_tpu/ops/preemption.py:63",
                              "preempt_parity", preempt_l),
        "volume_topology_mask": ("kubernetes_tpu_torch/csrc/volume.cu", "kubernetes_tpu/ops/coscheduling.py:66",
                                 "statefulset", statefulset_l),
        "dra_selector_match": ("kubernetes_tpu_torch/csrc/dra.cu", "kubernetes_tpu/ops/dra.py:275", "dra_drain",
                               dra_l),
        "dra_spec_mask": ("kubernetes_tpu_torch/csrc/dra.cu", "kubernetes_tpu/ops/dra.py:319", "dra_drain", dra_l),
        "fork_view": ("kubernetes_tpu_torch/csrc/counterfactual.cu", "kubernetes_tpu/ops/counterfactual.py:148",
                      "config14", config14_l),
        "fork_summary": ("kubernetes_tpu_torch/csrc/counterfactual.cu",
                         "kubernetes_tpu/ops/counterfactual.py:148", "config14", config14_l),
        "explain_stack": ("kubernetes_tpu_torch/csrc/explain.cu", "kubernetes_tpu/ops/explain.py:67",
                          "explain_path", explain_l),
        "pipeline_score": ("kubernetes_tpu_torch/csrc/pipeline.cu", "kubernetes_tpu/ops/pipeline.py:52",
                           "explain_path", explain_l),
        "tie_bits": ("kubernetes_tpu_torch/csrc/rng.cu", "kubernetes_tpu/ops/gang.py:910", "host_fit_tie",
                     sampling_l["host_fit_tie"]),
    }
    kernels = []
    for name, (src, replaces, path, launches) in sources.items():
        keep = {k: v for k, v in checks[name].items() if k != "library_call"}
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces, path=path,
                            launches=launches[name], check="equal", **keep))
        if name == "wave_speculate":  # K8 is also the workloads dispatch's speculation
            kernels[-1]["also"] = dict(replaces="kubernetes_tpu/ops/coscheduling.py:287", path="config10",
                                       launches=config10_l[name])
        if name in DESIGNS:
            kernels[-1]["design"] = DESIGNS[name]
        if name == "tie_bits":  # K19 also draws the parity copies' bits
            kernels[-1]["also"] = dict(replaces="kubernetes_tpu/scheduler.py:4990", path="sampling_parity",
                                       launches=sum(v[name] for v in sampling_parity_l.values()))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
