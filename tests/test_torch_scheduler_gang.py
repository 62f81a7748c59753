"""The gang path end to end: the port's Scheduler against the JAX Scheduler.

Both drain the same seeded workloads to the end, with the same
configuration; on the CPU the port runs its kernels' plain versions.  The
placements (node names), the FitError message and diagnosis of every
unschedulable pod, and the route counts (scan_batches, chain_batches,
fast_batches, resident_batches) must be identical: the tolerance is zero.
The JAX scheduler runs with its dispatch ledger off.  (The default
configuration's wave drains of these workloads are held against the JAX
scheduler in tests/test_torch_scheduler_wave.py.)

Workloads, at a few dozen nodes:
  (a) bench.py's config4 spread pods under wave_dispatch=False;
  (b) its config3 hostname anti-affinity pods under wave_dispatch=False;
  (c) pods with one preferred node-affinity term under the default
      configuration (the fast path declines them: the direct gang_run);
  (d) placed anti-affinity pods, then resource-only pods in blocks that
      those placed terms do or do not admit, under the default
      configuration: fast batches and chained scan batches interleave;
  (e) host-port pods under wave_dispatch=False (direct gang_run with
      has_ports);
  (f) an overfull cluster, for the unschedulable diagnoses.
"""

import pytest

from kubernetes_tpu.framework.config import SchedulerConfiguration as JConfig
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch.framework.config import SchedulerConfiguration as PConfig
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from tests.test_torch_pack import JAX_API, PORT_API

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
ROUTES = ("scan_batches", "chain_batches", "fast_batches", "resident_batches")
BATCH = 256


def basic_nodes(api, n, zones=3, cpu="8", pods=110, tiers=False):
    T, R = api
    out = []
    for i in range(n):
        labels = {ZONE: f"zone-{i % zones}", HOST: f"node-{i}"}
        if tiers:
            labels["tier"] = ("gold", "silver", "bronze")[i % 3]
        out.append(
            T.Node(
                name=f"node-{i}",
                labels=labels,
                capacity=R.Resource.from_map({"cpu": cpu, "memory": "32Gi", "pods": pods}),
            )
        )
    return out


def _pod(T, name, labels, **kw):
    return T.Pod(
        name=name,
        labels=labels,
        containers=[
            T.Container(
                name="c",
                requests={"cpu": kw.pop("cpu", "100m"), "memory": "64Mi"},
                ports=kw.pop("ports", ()),
            )
        ],
        **kw,
    )


def spread_pods(api, n, prefix="pod"):
    """bench.py bench_spread: maxSkew 5 over zones, 20 apps."""
    T, _ = api
    out = []
    for i in range(n):
        app = f"a{i % 20}"
        tsc = T.TopologySpreadConstraint(
            max_skew=5,
            topology_key=ZONE,
            when_unsatisfiable="DoNotSchedule",
            label_selector=T.LabelSelector(match_labels={"app": app}),
        )
        out.append(_pod(T, f"{prefix}-{i}", {"app": app}, topology_spread_constraints=(tsc,)))
    return out


def anti_pods(api, n, groups=50, prefix="pod", **kw):
    """bench.py bench_interpod: required anti-affinity on the hostname."""
    T, _ = api
    out = []
    for i in range(n):
        group = f"g{i % groups}"
        anti = T.PodAntiAffinity(
            required_during_scheduling_ignored_during_execution=(
                T.PodAffinityTerm(topology_key=HOST, label_selector=T.LabelSelector(match_labels={"group": group})),
            )
        )
        out.append(_pod(T, f"{prefix}-{i}", {"group": group}, affinity=T.Affinity(pod_anti_affinity=anti), **kw))
    return out


def preferred_pods(api, n):
    T, _ = api
    out = []
    for i in range(n):
        tier = ("gold", "silver", "bronze")[i % 3]
        na = T.NodeAffinity(
            preferred_during_scheduling_ignored_during_execution=(
                T.PreferredSchedulingTerm(
                    weight=10 + i % 7,
                    preference=T.NodeSelectorTerm(match_expressions=(T.NodeSelectorRequirement("tier", "In", (tier,)),)),
                ),
            )
        )
        out.append(_pod(T, f"pref-{i}", {"app": f"p{i % 5}"}, affinity=T.Affinity(node_affinity=na)))
    return out


def port_pods(api, n):
    T, _ = api
    out = []
    for i in range(n):
        ports = (T.ContainerPort(container_port=80, host_port=(8080, 9090)[i % 2], host_ip=("", "10.0.0.1")[i % 3 == 0]),)
        out.append(_pod(T, f"port-{i}", {"app": "ports"}, ports=ports))
    return out


def workload_a(api):
    return basic_nodes(api, 48, zones=8), [], spread_pods(api, 700)


def workload_b(api):
    return basic_nodes(api, 48), [], anti_pods(api, 700, groups=25)


def workload_c(api):
    return basic_nodes(api, 60, tiers=True), [], preferred_pods(api, 600)


def workload_d(api):
    """40 placed anti-affinity pods (groups g0..g9, bound round-robin), then
    blocks of pending resource-only pods: plain ones, and ones labelled
    into a placed group, whose required anti-affinity admits them."""
    T, _ = api
    nodes = basic_nodes(api, 48)
    placed = anti_pods(api, 40, groups=10, prefix="placed")
    for i, p in enumerate(placed):
        p.node_name = f"node-{i % 48}"
    pending = []
    for b in range(4):
        for i in range(300):
            labels = {"app": "web"} if b % 2 == 0 else {"group": f"g{i % 10}"}
            pending.append(_pod(T, f"d{b}-{i}", labels, cpu=("100m", "250m")[i % 2]))
    return nodes, placed, pending


def workload_e(api):
    return basic_nodes(api, 40), [], port_pods(api, 260)


def workload_f(api):
    """10 small nodes and a mixed overfull feed: spread, anti-affinity and
    plain pods that cannot all fit."""
    nodes = basic_nodes(api, 10, zones=2, cpu="2", pods=20)
    pods = spread_pods(api, 160, prefix="sp") + anti_pods(api, 160, groups=6, prefix="aa", cpu="250m")
    return nodes, [], pods


def drain(sched, workload, api):
    nodes, placed, pending = workload(api)
    for n in nodes:
        sched.on_node_add(n)
    for p in placed:
        sched.on_pod_add(p)
    for p in pending:
        sched.on_pod_add(p)
    out = sched.schedule_pending()
    placements = {o.pod.name: o.node for o in out}
    fails = {}
    for o in out:
        if o.node is None:
            msg = "; ".join(o.status.reasons) if hasattr(o, "status") else o.reason
            fails[o.pod.name] = (msg, o.diagnosis)
    return placements, fails


def run_both(workload, **cfg):
    from kubernetes_tpu.observability import kernels

    js = JScheduler(JConfig(kernel_ledger=False, batch_size=BATCH, **cfg))
    kernels.deactivate()
    js.binding_sink = lambda pod, node: None
    want = drain(js, workload, JAX_API)
    bound = {}
    ps = PScheduler(PConfig(batch_size=BATCH, **cfg), device="cpu",
                    binding_sink=lambda pod, node: bound.__setitem__(pod.name, node))
    got = drain(ps, workload, PORT_API)
    assert bound == {k: v for k, v in got[0].items() if v is not None}
    return want, got, js, ps


def assert_same_drain(want, got, js, ps):
    (wp, wf), (gp, gf) = want, got
    assert gp == wp, {k: (wp[k], gp.get(k)) for k in wp if wp[k] != gp.get(k)}
    assert gf == wf
    assert {k: ps.metrics[k] for k in ROUTES} == {k: js.metrics.get(k, 0) for k in ROUTES}


@pytest.mark.parametrize(
    "workload,cfg,routes",
    [
        (workload_a, dict(wave_dispatch=False), ("scan_batches", "chain_batches")),
        (workload_b, dict(wave_dispatch=False), ("scan_batches", "chain_batches")),
        (workload_c, {}, ("scan_batches",)),
        (workload_d, {}, ("chain_batches", "fast_batches")),
        (workload_e, dict(wave_dispatch=False), ("scan_batches",)),
        (workload_f, dict(wave_dispatch=False), ("scan_batches", "chain_batches")),
    ],
    ids=["a-spread", "b-anti", "c-preferred", "d-mixed", "e-ports", "f-overfull"],
)
def test_gang_drain_matches_reference(workload, cfg, routes):
    want, got, js, ps = run_both(workload, **cfg)
    assert_same_drain(want, got, js, ps)
    for r in routes:
        assert ps.metrics[r] > 0, (r, ps.metrics)
    if workload is workload_f:
        assert len(got[1]) > 100  # most of the overfull feed fails, diagnosed


def test_spread_batch_under_default_raises_b7_and_requeues():
    """The config4 spread drain under the default configuration (it raised
    before the wave was ported): every batch takes the wave, direct then
    chained, and the drain equals the JAX scheduler's."""
    want, got, js, ps = run_both(workload_a)
    assert_same_drain(want, got, js, ps)
    assert ps.metrics["wave_batches"] == js.metrics["wave_batches"] == 3
    assert ps.metrics["scan_batches"] == 0 and ps.metrics["chain_batches"] == 0
    assert not len(ps.queue) and len(ps.cache.pod_states) == 700
