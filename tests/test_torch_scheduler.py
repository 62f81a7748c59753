"""The slice as a whole: the port's Scheduler against the JAX Scheduler.

Both drain the same seeded fast workloads (the tests/test_fastpath.py
generators, plus numpy-seeded specs with images and overcommit) with
``fastDeviceMin: 64``, so small batches take the host committer and large
ones the device route: sig_scan under ``residentDrain: false``, and
resident_run under the default ``residentDrain: true`` (with the window and
run width of tests/test_resident.py), in both tail modes, with equal
resident rounds and resolved pods.  On the CPU the kernels run their plain
versions.
Placements must be identical pod for pod — they are node names, so the
tolerance is zero — and so must the diagnosis of every unschedulable pod.
The JAX scheduler runs with its dispatch ledger off.

Also checked: refusals of pods outside the slice, no automatic CPU
fallback for a missing card, and the checksum guard on both routes.
"""

import random

import pytest
import torch

import kubernetes_tpu_torch.api.resource as p_res
import kubernetes_tpu_torch.api.types as p_types
from kubernetes_tpu.framework.config import SchedulerConfiguration as JConfig
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch.framework.config import SchedulerConfiguration as PConfig
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from tests.test_torch_pack import JAX_API, PORT_API, build_nodes, build_pods, node_specs, pod_specs


# ---- the tests/test_fastpath.py generators, for either package's types ----


def fastpath_cluster(T, R, rng, n_nodes):
    nodes = []
    for i in range(n_nodes):
        taints = ()
        if rng.random() < 0.2:
            taints = (T.Taint(key="dedicated", value=rng.choice(["a", "b"])),)
        nodes.append(
            T.Node(
                name=f"n{i:03d}",
                labels={
                    "kubernetes.io/hostname": f"n{i:03d}",
                    "zone": f"z{i % 3}",
                    "disk": rng.choice(["ssd", "hdd"]),
                },
                capacity=R.Resource.from_map(
                    {
                        "cpu": rng.choice(["2", "4", "8"]),
                        "memory": rng.choice(["8Gi", "16Gi"]),
                        "pods": rng.choice([5, 20]),
                    }
                ),
                taints=taints,
            )
        )
    return nodes


def fastpath_pod(T, rng, i):
    kwargs = {}
    if rng.random() < 0.3:
        kwargs["tolerations"] = (T.Toleration(key="dedicated", operator="Equal", value="a"),)
    if rng.random() < 0.3:
        kwargs["node_selector"] = {"disk": rng.choice(["ssd", "hdd"])}
    if rng.random() < 0.2:
        kwargs["affinity"] = T.Affinity(
            node_affinity=T.NodeAffinity(
                required_during_scheduling_ignored_during_execution=T.NodeSelector(
                    (
                        T.NodeSelectorTerm(
                            match_expressions=(
                                T.NodeSelectorRequirement("zone", "In", (rng.choice(["z0", "z1"]),)),
                            )
                        ),
                    )
                )
            )
        )
    return T.Pod(
        name=f"p{i:04d}",
        containers=[
            T.Container(
                name="c",
                requests={
                    "cpu": rng.choice(["100m", "250m", "500m", "1"]),
                    "memory": rng.choice(["64Mi", "256Mi", "1Gi"]),
                },
            )
        ],
        **kwargs,
    )


def fastpath_workload(api, seed, n_nodes, n_pods):
    T, R = api
    nodes = fastpath_cluster(T, R, random.Random(seed), n_nodes)
    pods = [fastpath_pod(T, random.Random(seed * 1000 + i), i) for i in range(n_pods)]
    return nodes, pods


def spec_workload(api, seed, n_nodes, n_pods):
    """NoSchedule taints only and no preferred terms: every signature stays
    argmax-neutral, so the whole drain is fast-path."""
    ns = node_specs(seed, n_nodes, prefer=False)
    ps = pod_specs(seed + 50, n_pods, n_nodes, prefer=False)
    return build_nodes(api, ns), build_pods(api, ps)


def drain(sched, nodes, pods):
    for n in nodes:
        sched.on_node_add(n)
    for p in pods:
        sched.on_pod_add(p)
    out = sched.schedule_pending()
    placed = {o.pod.name: o.node for o in out}
    diag = {o.pod.name: o.diagnosis for o in out if o.node is None}
    return placed, diag


def jax_drain(workload, seed, n_nodes, n_pods, **cfg):
    from kubernetes_tpu.observability import kernels

    cfg = {"resident_drain": False, **cfg}
    sched = JScheduler(JConfig(fast_device_min=64, kernel_ledger=False, **cfg))
    kernels.deactivate()
    sched.binding_sink = lambda pod, node: None
    return drain(sched, *workload(JAX_API, seed, n_nodes, n_pods)), sched


def port_drain(workload, seed, n_nodes, n_pods, **cfg):
    bound = {}
    cfg = {"resident_drain": False, **cfg}
    sched = PScheduler(
        PConfig(fast_device_min=64, **cfg),
        binding_sink=lambda pod, node: bound.__setitem__(pod.name, node),
        device="cpu",
    )
    placed, diag = drain(sched, *workload(PORT_API, seed, n_nodes, n_pods))
    assert bound == {k: v for k, v in placed.items() if v is not None}
    return (placed, diag), sched


@pytest.mark.parametrize(
    "workload,seed,n_nodes,n_pods",
    [
        (fastpath_workload, 0, 40, 600),
        (fastpath_workload, 1, 40, 900),
        (fastpath_workload, 2, 30, 1200),
        (spec_workload, 3, 120, 1500),
        (spec_workload, 4, 200, 700),
    ],
)
def test_scheduler_matches_reference(workload, seed, n_nodes, n_pods):
    (want, want_diag), js = jax_drain(workload, seed, n_nodes, n_pods)
    (got, got_diag), ps = port_drain(workload, seed, n_nodes, n_pods)
    assert js.metrics["fast_batches"] > 0
    assert got == want, {k: (want[k], got.get(k)) for k in want if want[k] != got.get(k)}
    assert got_diag == want_diag
    # the sig_scan path ran (its plain version, on CPU tensors)
    assert ps.metrics["device_batches"] > 0
    assert ps.metrics["static_evals"] >= 1 and ps.metrics["state_uploads"] >= 1
    assert 0 < sum(v is not None for v in got.values())


def test_small_batches_take_the_host_committer():
    (want, _), _ = jax_drain(fastpath_workload, 5, 20, 60)
    (got, _), ps = port_drain(fastpath_workload, 5, 20, 60)
    assert got == want
    assert ps.metrics["host_batches"] > 0 and ps.metrics["device_batches"] == 0


def test_no_nodes_leaves_every_pod_unschedulable():
    sched = PScheduler(PConfig(resident_drain=False), device="cpu")
    _, pods = fastpath_workload(PORT_API, 3, 0, 20)
    for p in pods:
        sched.on_pod_add(p)
    out = sched.schedule_pending()
    assert [o.node for o in out] == [None] * 20
    assert all(o.reason == "0/0 nodes are available" for o in out)
    # no plugin rejected them (there is no node), so they back off instead
    # of parking, as the reference's queue does (scheduling_queue.go:642)
    assert len(sched.queue) == 20 and not sched.queue.unschedulable


def _spread_pod(T, name="spread"):
    return T.Pod(
        name=name,
        containers=[T.Container(name="c", requests={"cpu": "100m"})],
        topology_spread_constraints=(
            T.TopologySpreadConstraint(max_skew=1, topology_key="zone", when_unsatisfiable="DoNotSchedule"),
        ),
    )


def test_spread_pod_raises_not_implemented_and_stays_queued():
    """A spread pod in a batch of resource-only pods: under the default
    waveDispatch: true the batch takes the speculative wave (it raised
    before the wave was ported), which places every pod, as the JAX
    scheduler does."""
    def run(sched, api):
        T, _ = api
        nodes, pods = fastpath_workload(api, 0, 10, 5)
        for n in nodes:
            sched.on_node_add(n)
        for p in pods + [_spread_pod(T)]:
            sched.on_pod_add(p)
        return {o.pod.name: o.node for o in sched.schedule_pending()}

    from kubernetes_tpu.observability import kernels

    js = JScheduler(JConfig(kernel_ledger=False, resident_drain=False))
    kernels.deactivate()
    js.binding_sink = lambda pod, node: None
    sched = PScheduler(PConfig(resident_drain=False), device="cpu")
    got = run(sched, PORT_API)
    assert got == run(js, JAX_API)
    assert len(got) == 6 and None not in got.values()
    assert not len(sched.queue)
    assert sched.metrics["wave_batches"] == 1 and sched.metrics["wave_pods"] == 6
    assert sched.metrics["scan_batches"] == 0 and sched.metrics["chain_batches"] == 0


def test_nonconstant_static_score_raises_not_implemented():
    """PreferNoSchedule on a subset of nodes makes an untolerating pod's
    taint score vary over its feasible nodes: the fast path declines and,
    as in JAX, the gang scan places the pod (it raised before the scan was
    ported) on the best untainted node."""
    sched = PScheduler(PConfig(resident_drain=False), device="cpu")
    for i in range(6):
        taints = (p_types.Taint(key="soft", effect="PreferNoSchedule"),) if i % 3 == 0 else ()
        sched.on_node_add(
            p_types.Node(name=f"n{i}", capacity=p_res.Resource.from_map({"cpu": "4", "memory": "8Gi"}), taints=taints)
        )
    sched.on_pod_add(p_types.Pod(name="p", containers=[p_types.Container(name="c", requests={"cpu": "1"})]))
    out = sched.schedule_pending()
    assert [o.node for o in out] == ["n1"]
    assert sched.metrics["scan_batches"] == 1 and sched.metrics["fast_batches"] == 0


RESIDENT = dict(resident_drain=True, resident_window=64, resident_run_max=512)
RESIDENT_METRICS = ("resident_batches", "resident_pods", "resident_rounds")


@pytest.mark.parametrize("serial_tail", [False, True])
@pytest.mark.parametrize(
    "workload,seed,n_nodes,n_pods",
    [
        (fastpath_workload, 0, 40, 600),
        (fastpath_workload, 1, 40, 900),
        (fastpath_workload, 2, 30, 1200),
        (spec_workload, 3, 120, 1500),
        (spec_workload, 4, 200, 700),
    ],
)
def test_default_resident_drain_matches_reference(workload, seed, n_nodes, n_pods, serial_tail):
    """residentDrain: true, the default: device-sized batches are resident
    runs (resident_run's plain version on the CPU), with the reference's
    rounds and resolved pods."""
    cfg = dict(RESIDENT, resident_serial_tail=serial_tail)
    (want, want_diag), js = jax_drain(workload, seed, n_nodes, n_pods, **cfg)
    (got, got_diag), ps = port_drain(workload, seed, n_nodes, n_pods, **cfg)
    assert got == want, {k: (want[k], got.get(k)) for k in want if want[k] != got.get(k)}
    assert got_diag == want_diag
    assert ps.metrics["resident_batches"] > 0
    assert {k: ps.metrics[k] for k in RESIDENT_METRICS} == {k: js.metrics[k] for k in RESIDENT_METRICS}


def interleaved_workload(api, seed, n_nodes, n_pods):
    """Half the nodes labelled disk=ssd, half disk=hdd, and pods that
    alternate between the two selectors: every resident round admits one
    pod, so the adaptive stop hands the run's tail over."""
    T, R = api
    nodes = [
        T.Node(
            name=f"n{i:03d}",
            labels={"kubernetes.io/hostname": f"n{i:03d}", "disk": ("ssd", "hdd")[i % 2]},
            capacity=R.Resource.from_map({"cpu": "16", "memory": "64Gi", "pods": 110}),
        )
        for i in range(n_nodes)
    ]
    rng = random.Random(seed)
    pods = [
        T.Pod(
            name=f"p{i:04d}",
            containers=[T.Container(name="c", requests={"cpu": rng.choice(["100m", "250m"]), "memory": "128Mi"})],
            node_selector={"disk": ("ssd", "hdd")[i % 2]},
        )
        for i in range(n_pods)
    ]
    return nodes, pods


@pytest.mark.parametrize("serial_tail", [False, True])
def test_resident_tail_matches_reference(serial_tail):
    """The adaptive stop fires: the unresolved tail is finished on the host
    committer (the lineage is dropped and the next run re-uploads) or, with
    residentSerialTail, by the serial replay inside the run."""
    cfg = dict(RESIDENT, resident_serial_tail=serial_tail)
    (want, want_diag), js = jax_drain(interleaved_workload, 6, 40, 1100, **cfg)
    (got, got_diag), ps = port_drain(interleaved_workload, 6, 40, 1100, **cfg)
    assert got == want and got_diag == want_diag
    assert {k: ps.metrics[k] for k in RESIDENT_METRICS} == {k: js.metrics[k] for k in RESIDENT_METRICS}
    m = ps.metrics
    # 512 + 512 + 76 pods: every batch of this drain is a resident run
    assert m["resident_batches"] == m["device_batches"] == 3
    assert m["resident_pods"] < 1100
    # host tail: each run drops the lineage, so each run uploads anew
    assert m["state_uploads"] == (1 if serial_tail else 3)


def north_star_workload(api, seed, n_nodes, n_pods):
    """bench.py's config0 templates: 8-cpu / 32Gi nodes in three zones, and
    pods of nine cpu x memory request shapes drawn from a seeded stream."""
    T, R = api
    nodes = [
        T.Node(
            name=f"node-{i}",
            labels={"topology.kubernetes.io/zone": f"zone-{i % 3}", "kubernetes.io/hostname": f"node-{i}"},
            capacity=R.Resource.from_map({"cpu": "8", "memory": "32Gi", "pods": 110}),
        )
        for i in range(n_nodes)
    ]
    rng = random.Random(seed)
    pods = [
        T.Pod(
            name=f"ns-{i}",
            labels={"app": f"app-{i % 16}"},
            containers=[
                T.Container(
                    name="c",
                    requests={"cpu": f"{rng.choice([100, 250, 500])}m", "memory": f"{rng.choice([128, 256, 512])}Mi"},
                )
            ],
        )
        for i in range(n_pods)
    ]
    return nodes, pods


@pytest.mark.parametrize("serial_tail", [False, True])
def test_north_star_default_configuration_matches_reference(serial_tail):
    """config0's templates at 1k nodes and 10k pods under the default
    window and run size: one resident run, whose adaptive stop hands most
    of it to the tail, with the reference's rounds and resolved pods."""
    cfg = dict(resident_drain=True, resident_serial_tail=serial_tail)
    (want, want_diag), js = jax_drain(north_star_workload, 4242, 1000, 10000, **cfg)
    (got, got_diag), ps = port_drain(north_star_workload, 4242, 1000, 10000, **cfg)
    assert got == want and got_diag == want_diag
    assert {k: ps.metrics[k] for k in RESIDENT_METRICS} == {k: js.metrics[k] for k in RESIDENT_METRICS}
    assert ps.metrics["resident_batches"] == 1
    assert sum(v is not None for v in got.values()) == 10000


def test_default_resident_checksum_mismatch_raises_and_requeues():
    """The epoch guard on the resident route: a usage row changed behind
    the scheduler's back fails the checksum after the next run; the batch
    goes back to the queue and nothing reaches the cache or the committer."""
    sched = PScheduler(
        PConfig(fast_device_min=64, batch_size=64, fast_batch_max=64, resident_run_max=64,
                resident_window=64),
        device="cpu",
    )
    nodes, _ = interleaved_workload(PORT_API, 2, 100, 0)
    pods = [
        p_types.Pod(name=f"u{i}", containers=[p_types.Container(name="c", requests={"cpu": "100m"})])
        for i in range(128)
    ]
    for n in nodes:
        sched.on_node_add(n)
    for p in pods[:64]:
        sched.on_pod_add(p)
    sched.schedule_pending()
    # the whole run resolved on the device, so the lineage stays resident
    assert sched.metrics["resident_batches"] == 1 and sched.metrics["resident_pods"] == 64
    holder = sched._holder
    holder["dev"].nz1[3] += 7
    committed = [list(r) for r in holder["fc"].used_rows]
    placed = len(sched.cache.pod_states)
    for p in pods[64:128]:
        sched.on_pod_add(p)
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        sched.schedule_pending()
    assert len(sched.queue) == 64
    assert len(sched.cache.pod_states) == placed
    assert holder["fc"].used_rows == committed and holder["dev"] is None


@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_without_a_card_raises(monkeypatch, device):
    """Asking for CUDA where there is none raises; the scheduler never moves
    to the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PScheduler(PConfig(resident_drain=False), device=device)


def test_checksum_mismatch_raises_and_requeues():
    """A torn device usage state (here: one row changed behind the
    scheduler's back between batches) fails the epoch guard; the batch goes
    back to the queue and nothing reaches the cache or the committer."""
    sched = PScheduler(PConfig(resident_drain=False, fast_device_min=64, batch_size=64, fast_batch_max=64), device="cpu")
    nodes, pods = fastpath_workload(PORT_API, 2, 30, 256)
    for n in nodes:
        sched.on_node_add(n)
    for p in pods[:64]:
        sched.on_pod_add(p)
    sched.schedule_pending()
    assert sched.metrics["device_batches"] == 1
    holder = sched._holder
    holder["dev"].used[0, 0] += 1
    committed = [list(r) for r in holder["fc"].used_rows]
    placed = len(sched.cache.pod_states)
    for p in pods[64:128]:
        sched.on_pod_add(p)
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        sched.schedule_pending()
    assert len(sched.queue) == 64
    assert len(sched.cache.pod_states) == placed
    assert holder["fc"].used_rows == committed and holder["dev"] is None
