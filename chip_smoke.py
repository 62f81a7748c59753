#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubernetes_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one output line each:
  1. card and build: the card's name and power limit (nvidia-smi), and the
     time to build the CUDA kernels from csrc/;
  2. each kernel against its plain PyTorch version on the card, exact
     equality of every output (all outputs are integer or bool, so the
     tolerance is zero), at the slice's shapes: K1 static_eval at S=16 over
     the 10k-node bucket, K2 sig_scan at P=4096, K3 usage_checksum on K2's
     final state; with the kernel's, the plain version's and (K3) a
     torch.sum's time;
  3. the config0 drain — 10k nodes, 100k pending pods, residentDrain false —
     through Scheduler() on cuda, held pod for pod against the same drain on
     the port's host FastCommitter alone (device="cpu", every batch on the
     committer), with no node over its allocatable, and the launches of
     each kernel in that drain;
  4. a mixed drain (1k nodes, 10k pods: NoSchedule taints, tolerations,
     nodeSelector, required node affinity, images), held the same way;
  5. the kernels line.

The second-to-last line is the kernels JSON; the last line is
{"ok": true, "device": {...}}.  Any failed phase exits non-zero.  Without
CUDA, or without the package beside this script, it exits 2 and prints no
result.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the scalar (non
# tensor-core) 32-bit rate, used as the rate of the kernels' integer work
PEAK_BYTES_S = 3.35e12
PEAK_SCALAR_OPS_S = 67e12


def log(**kw) -> None:
    print(json.dumps(kw, sort_keys=True), flush=True)


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
    t_ops = ops / PEAK_SCALAR_OPS_S * 1e3
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


def north_star_pods(n_pods, prefix="ns"):
    """bench.py _north_star_pods: app-sharded labels, 3 × 3 cpu/mem requests."""
    from kubernetes_tpu_torch.api import Container, Pod

    rng = random.Random(4242)
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


def k2_inputs(torch, device, nt, mask, P=4096, seed=5):
    """Sixteen signatures (one all-zero, one asking for an extended lane)
    over K1's statics-feasible mask, a pod feed with -1 pads, and a usage
    state with overcommitted nodes."""
    g = torch.Generator().manual_seed(seed)
    N, R = nt.allocatable.shape
    S = mask.shape[0]
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


def max_abs_err(torch, a, b) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


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
    in_bytes = nbytes(dc.node_labels, dc.val_ints, dc.taint_key, dc.taint_val, dc.taint_effect,
                      dc.unschedulable, dc.node_valid, dc.img_sizes, db.valid, db.pref_weight,
                      db.tol_key, db.tol_op, db.tol_val, db.tol_effect, db.target_name_val,
                      db.img_ids, db.n_containers,
                      *(getattr(t, f) for t in (db.node_sel, db.pref_node)
                        for f in ("req_key", "req_op", "req_vals", "req_rhs", "term_valid")))
    out_bytes = nbytes(*got.values())
    T, TL = dc.taint_key.shape[1], db.tol_key.shape[1]
    NT, NR, NV = db.node_sel.req_vals.shape[1:]
    PT, PR, PV = db.pref_node.req_vals.shape[1:]
    # a full walk per pair: taint × toleration compares for the filter and
    # the score, each DNF requirement's value scan, the image terms
    per_pair = 2 * T * TL * 8 + NT * NR * (NV + 8) + PT * PR * (PV + 8) + db.img_ids.shape[1] * 8 + 32
    k1_bound, k1_by = bound_ms(in_bytes + out_bytes, S * N * per_pair)
    log(phase="kernel_check", kernel="static_eval", shape=[S, N], max_abs_err=k1_err,
        ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound, bound_by=k1_by)

    # K2 ------------------------------------------------------------------
    fixed, state0 = k2_inputs(torch, device, nt, got["mask"])
    w = dict(w_fit=1, w_bal=1, w_img=1, check_fit=True)

    def fresh():
        return {k: v.clone() for k, v in state0.items()}

    def run(fn, st):
        return fn(fixed["sig_ids"], fixed["sig_req"], fixed["sig_nz"], fixed["sig_allzero"],
                  fixed["sig_ok"], fixed["sig_img"], fixed["alloc"], fixed["allowed"],
                  st["used"], st["nz0"], st["nz1"], st["num_pods"], **w)[0]

    st_k, st_p = fresh(), fresh()
    ch_k = run(ops_fp.sig_scan, st_k)
    ch_p = run(ops_fp.sig_scan_plain, st_p)
    torch.cuda.synchronize() if device.type == "cuda" else None
    k2_err = max([max_abs_err(torch, ch_k, ch_p)] + [max_abs_err(torch, st_k[k], st_p[k]) for k in st_k])
    if k2_err:
        raise AssertionError("sig_scan kernel != plain version")
    placed = int((ch_k >= 0).sum().item())
    scratch = {}

    def reset():
        for k, v in state0.items():
            scratch.setdefault(k, torch.empty_like(v)).copy_(v)

    k2_ms = time_ms(torch, lambda: run(ops_fp.sig_scan, scratch), reps, setup=reset)
    k2_plain_ms = time_ms(torch, lambda: run(ops_fp.sig_scan_plain, scratch), 1, setup=reset)
    P = fixed["sig_ids"].shape[0]
    live = int((fixed["sig_ids"] >= 0).sum().item())
    Nn, R = fixed["alloc"].shape
    k2_bytes = nbytes(*fixed.values()) + 2 * nbytes(*state0.values()) + P * 4
    k2_bound, k2_by = bound_ms(k2_bytes, live * Nn * (R * 4 + 40))
    # the recurrence's floor in this design: the same launch over one node,
    # so each of the P steps is only its reduction and barriers
    one = {k: (v[:, :1].contiguous() if k in ("sig_ok", "sig_img") else
               v[:1].contiguous() if k in ("alloc", "allowed") else v) for k, v in fixed.items()}
    st1 = {k: v[:1].clone() for k, v in state0.items()}

    def run_one():
        ops_fp.sig_scan(one["sig_ids"], one["sig_req"], one["sig_nz"], one["sig_allzero"],
                        one["sig_ok"], one["sig_img"], one["alloc"], one["allowed"],
                        st1["used"], st1["nz0"], st1["nz1"], st1["num_pods"], **w)

    step_floor_ms = time_ms(torch, run_one, reps)
    log(phase="kernel_check", kernel="sig_scan", P=P, live_pods=live, N=Nn, placed=placed,
        max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound, bound_by=k2_by,
        bytes_bound_ms=k2_bytes / PEAK_BYTES_S * 1e3, step_floor_ms=step_floor_ms)

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
        "sig_scan": dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound,
                         bound_by=k2_by, library_ms=None, step_floor_ms=step_floor_ms),
        "usage_checksum": dict(max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_bound,
                               bound_by=k3_by, library_ms=k3_lib_ms),
    }


def drain(device, nodes, pods, host_only=False):
    """One drain through the port's entry points; returns (placements,
    seconds, scheduler)."""
    from kubernetes_tpu_torch.framework.config import SchedulerConfiguration
    from kubernetes_tpu_torch.scheduler import Scheduler

    cfg = SchedulerConfiguration(resident_drain=False)
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


def phase_drain(torch, name, device, make_nodes, make_pods):
    from kubernetes_tpu_torch.ops import _build

    _build.reset_launches()
    got, dt, sched = drain(device, make_nodes(), make_pods())
    launches = dict(_build.launches)
    want, dt_host, _ = drain(torch.device("cpu"), make_nodes(), make_pods(), host_only=True)
    diff = [k for k in want if want[k] != got.get(k)]
    if diff:
        raise AssertionError(f"{name}: {len(diff)} placements differ from the host committer, "
                             f"first {diff[0]}: {got.get(diff[0])} vs {want[diff[0]]}")
    check_capacity(sched)
    placed = sum(v is not None for v in got.values())
    log(phase="drain", name=name, nodes=len(sched.cache.real_nodes()), pods=len(got), placed=placed,
        drain_s=dt, pods_per_s=len(got) / dt, host_committer_drain_s=dt_host, launches=launches,
        metrics=sched.metrics, identical_to_host_committer=True)
    return launches


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
    launches = phase_drain(torch, "config0", device, lambda: basic_nodes(10000),
                           lambda: north_star_pods(100000))
    mixed = phase_drain(torch, "mixed", device, lambda: mixed_nodes(1000), lambda: mixed_pods(10000))
    if min(mixed.values()) <= 0:
        raise AssertionError(f"mixed drain skipped a kernel: {mixed}")

    sources = {
        "static_eval": ("kubernetes_tpu_torch/csrc/static_eval.cu", "kubernetes_tpu/ops/fastpath.py:50"),
        "sig_scan": ("kubernetes_tpu_torch/csrc/sig_scan.cu", "kubernetes_tpu/ops/fastpath.py:220"),
        "usage_checksum": ("kubernetes_tpu_torch/csrc/usage_checksum.cu", "kubernetes_tpu/ops/resident.py:451"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        if launches[name] <= 0:
            raise AssertionError(f"config0 drain never launched {name}")
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches[name], check="equal", **checks[name]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
