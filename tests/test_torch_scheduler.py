"""The slice as a whole: the port's Scheduler against the JAX Scheduler.

Both drain the same seeded fast workloads (the tests/test_fastpath.py
generators, plus numpy-seeded specs with images and overcommit) with
``residentDrain: false`` and ``fastDeviceMin: 64``, so large batches take
sig_scan (the plain version on the CPU) and small ones the host committer.
Placements must be identical pod for pod — they are node names, so the
tolerance is zero — and so must the diagnosis of every unschedulable pod.
The JAX scheduler runs with its dispatch ledger off.

Also checked: refusals of pods and configurations outside the slice, no
automatic CPU fallback for a missing card, and the checksum guard.
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


def jax_drain(workload, seed, n_nodes, n_pods):
    from kubernetes_tpu.observability import kernels

    sched = JScheduler(JConfig(resident_drain=False, fast_device_min=64, kernel_ledger=False))
    kernels.deactivate()
    sched.binding_sink = lambda pod, node: None
    return drain(sched, *workload(JAX_API, seed, n_nodes, n_pods)), sched


def port_drain(workload, seed, n_nodes, n_pods, **cfg):
    bound = {}
    sched = PScheduler(
        PConfig(resident_drain=False, fast_device_min=64, **cfg),
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
    assert len(sched.queue.unschedulable) == 20


def _spread_pod(T, name="spread"):
    return T.Pod(
        name=name,
        containers=[T.Container(name="c", requests={"cpu": "100m"})],
        topology_spread_constraints=(
            T.TopologySpreadConstraint(max_skew=1, topology_key="zone", when_unsatisfiable="DoNotSchedule"),
        ),
    )


def test_spread_pod_raises_not_implemented_and_stays_queued():
    sched = PScheduler(PConfig(resident_drain=False), device="cpu")
    nodes, pods = fastpath_workload(PORT_API, 0, 10, 5)
    for n in nodes:
        sched.on_node_add(n)
    for p in pods + [_spread_pod(p_types)]:
        sched.on_pod_add(p)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        sched.schedule_pending()
    assert len(sched.queue) == 6
    assert not sched.cache.pod_states


def test_nonconstant_static_score_raises_not_implemented():
    """PreferNoSchedule on a subset of nodes makes an untolerating pod's
    taint score vary over its feasible nodes: JAX takes the gang scan, the
    port refuses."""
    sched = PScheduler(PConfig(resident_drain=False), device="cpu")
    for i in range(6):
        taints = (p_types.Taint(key="soft", effect="PreferNoSchedule"),) if i % 3 == 0 else ()
        sched.on_node_add(
            p_types.Node(name=f"n{i}", capacity=p_res.Resource.from_map({"cpu": "4", "memory": "8Gi"}), taints=taints)
        )
    sched.on_pod_add(p_types.Pod(name="p", containers=[p_types.Container(name="c", requests={"cpu": "1"})]))
    with pytest.raises(NotImplementedError, match="gang scan"):
        sched.schedule_pending()


def test_default_resident_drain_refuses_device_batches():
    sched = PScheduler(PConfig(fast_device_min=64), device="cpu")
    nodes, pods = fastpath_workload(PORT_API, 1, 20, 200)
    for n in nodes:
        sched.on_node_add(n)
    for p in pods:
        sched.on_pod_add(p)
    with pytest.raises(NotImplementedError, match="ROADMAP B3"):
        sched.schedule_pending()
    assert len(sched.queue) == 200


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
