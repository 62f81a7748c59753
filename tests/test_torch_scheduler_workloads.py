"""Gang coscheduling end to end: the port's Scheduler against the JAX
Scheduler, and against the port's serial WorkloadOracle.

Both schedulers run the same scenario round by round on a manual clock (the
queue's backoff and the gangs' timeouts read it), PodGroups arriving through
their informer handlers (the JAX side's ``storage_handlers(POD_GROUP)``, the
port's ``on_pod_group_*``), pods through ``on_pod_add``.  On the CPU the
port runs its kernels' plain versions (K11's ``workloads_admit_plain``
among them); the JAX scheduler runs with its dispatch ledger off.  After
every round the outcomes in order (pod, node, FitError or gang message),
the bindings and the four workloads metrics (workload_batches,
workload_spec_admitted, gang_admitted, gang_rolled_back) must be identical:
all are names or integers, so the tolerance is zero.

Scenarios: the gang scenarios of tests/test_coscheduling.py (the
test_gang_property_vs_oracle seeds 3, 17 and 41, also held against the
oracle; gangDispatch off; a gang incomplete, then admitted; the timeout; a
mixed batch with a host-port pod; the sibling pull, alone and in a mixed
batch; the metrics), a pod naming an unregistered group, duplicate
hostnames, and a gang beside spread and anti-affinity pods.  Also: pods with
a missing ResourceClaim, uncovered volumes or scheduling gates beside a
gang are still refused.
"""

import copy
import random

import pytest

from kubernetes_tpu.framework.config import SchedulerConfiguration as JConfig
from kubernetes_tpu.framework.interface import EventResource as JEvent
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.workloads import gang as j_wlg
from kubernetes_tpu_torch.framework.config import SchedulerConfiguration as PConfig
from kubernetes_tpu_torch.oracle.state import OracleState
from kubernetes_tpu_torch.oracle.workloads import WorkloadOracle
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from kubernetes_tpu_torch.workloads import gang as p_wlg
from tests.test_torch_pack import JAX_API, PORT_API

METRICS = ("workload_batches", "workload_spec_admitted", "gang_admitted", "gang_rolled_back")


class Side:
    """One scheduler, its manual clock, its PodGroup handlers and bindings."""

    def __init__(self, api, **cfg):
        self.api = api
        self.now = [1000.0]
        clock = lambda: self.now[0]  # noqa: E731
        if api is JAX_API:
            from kubernetes_tpu.observability import kernels

            self.s = JScheduler(JConfig(kernel_ledger=False, **cfg), clock=clock)
            kernels.deactivate()
            self.wlg = j_wlg
            self.pg_add, self.pg_update, self.pg_delete = self.s.storage_handlers(JEvent.POD_GROUP)
        else:
            self.s = PScheduler(PConfig(**cfg), device="cpu", clock=clock)
            self.wlg = p_wlg
            self.pg_add, self.pg_update, self.pg_delete = (self.s.on_pod_group_add, self.s.on_pod_group_update,
                                                           self.s.on_pod_group_delete)
        self.bindings = {}
        self.s.binding_sink = lambda pod, node: self.bindings.__setitem__(pod.name, node)

    def group(self, name, min_member, timeout=None):
        kw = {} if timeout is None else dict(schedule_timeout_s=timeout)
        return self.wlg.PodGroup(name=name, min_member=min_member, **kw)

    def round(self, advance: float = 0.0) -> dict:
        self.now[0] += advance
        out = self.s.schedule_pending()
        outcomes = []
        for o in out:
            reason = "; ".join(o.status.reasons) if hasattr(o, "status") else o.reason
            outcomes.append((o.pod.name, o.node, "" if o.node else reason))
        return {"outcomes": outcomes, "bindings": dict(self.bindings),
                "metrics": {k: self.s.metrics[k] for k in METRICS}}


def run_twins(scenario, rounds, **cfg):
    """Drive both sides through ``scenario(api, side)`` (which adds objects
    and may return a hook run before each round) and compare every round."""
    sides = [Side(JAX_API, **cfg), Side(PORT_API, **cfg)]
    hooks = [scenario(side.api, side) for side in sides]
    history = []
    for r, advance in enumerate(rounds):
        got = []
        for side, hook in zip(sides, hooks):
            if hook is not None:
                hook(r, side)
            got.append(side.round(advance))
        want, port = got
        assert port == want, f"round {r}: " + str({k: (want[k], port[k]) for k in want if want[k] != port[k]})
        history.append(port)
    return history, sides


def make_node(api, name, cpu="4", zone="zone-a", hostname=None):
    T, R = api
    return T.Node(name=name, labels={"kubernetes.io/hostname": hostname or name, "topology.kubernetes.io/zone": zone},
                  capacity=R.Resource.from_map({"cpu": cpu, "memory": "16Gi", "pods": 110}))


def mkpod(api, name, group="", cpu="100m", labels=None, **kw):
    T, _ = api
    return T.Pod(name=name, labels=dict(labels or {}), containers=[T.Container(name="c", requests={"cpu": cpu})],
                 pod_group=group, **kw)


# ---- tests/test_coscheduling.py's randomized gang workload -----------------


def random_gang_workload(api, rng, n_groups=3):
    """_random_gang_workload of tests/test_coscheduling.py for either
    package: plain pods and gangs on tight capacity, so some gangs roll
    back.  Returns (nodes, pods, {key: (name, min_member)})."""
    nodes = [make_node(api, f"node-{i}", cpu=rng.choice(["1", "2"]), zone=f"zone-{i % 3}")
             for i in range(rng.randrange(4, 9))]
    pods, groups = [], {}
    for i in range(rng.randrange(2, 6)):
        pods.append(mkpod(api, f"plain-{i}", cpu=f"{rng.choice([100, 300])}m"))
    for gi in range(n_groups):
        size = rng.randrange(2, 5)
        min_member = rng.randrange(2, size + 1)
        name = f"gang-{gi}"
        groups[f"default/{name}"] = (name, min_member)
        for m in range(size):
            pods.append(mkpod(api, f"{name}-{m}", group=name, cpu=rng.choice(["300m", "700m", "1500m"])))
    rng.shuffle(pods)
    return nodes, pods, groups


@pytest.mark.parametrize("seed", [3, 17, 41])
def test_gang_property_matches_reference_and_oracle(seed):
    rngs = {id(api): random.Random(seed) for api in (JAX_API, PORT_API)}
    for trial in range(3):
        work = {}

        def scenario(api, side):
            nodes, pods, groups = random_gang_workload(api, rngs[id(api)])
            work[id(api)] = (nodes, pods, groups)
            for n in nodes:
                side.s.on_node_add(n)
            for name, mm in groups.values():
                side.pg_add(side.group(name, mm))
            for p in pods:
                side.s.on_pod_add(copy.deepcopy(p))

        history, (_, port) = run_twins(scenario, (0.0,), batch_size=128)
        got = {name: node for name, node, _ in history[0]["outcomes"]}
        nodes, pods, groups = work[id(PORT_API)]
        oracle = WorkloadOracle(state=OracleState.build(nodes),
                                groups={k: p_wlg.PodGroup(name=n, min_member=mm) for k, (n, mm) in groups.items()})
        want = oracle.schedule(copy.deepcopy(pods)).placements
        assert got == want, (seed, trial, got, want)
        assert port.s.metrics["workload_batches"] >= 1


# ---- the barrier scenarios --------------------------------------------------


def scenario_switch_off(api, side):
    side.s.on_node_add(make_node(api, "node-0", cpu="1"))
    side.pg_add(side.group("g", 2))
    side.s.on_pod_add(mkpod(api, "m-0", group="g", cpu="500m"))
    side.s.on_pod_add(mkpod(api, "m-1", group="g", cpu="100"))


def scenario_incomplete_then_admits(api, side):
    for i in range(3):
        side.s.on_node_add(make_node(api, f"node-{i}"))
    pg = side.group("trio", 3)
    side.pg_add(pg)
    side.s.on_pod_add(mkpod(api, "t-0", group="trio"))
    side.s.on_pod_add(mkpod(api, "t-1", group="trio"))

    def hook(r, side):
        if r == 1:
            side.s.on_pod_add(mkpod(api, "t-2", group="trio"))  # fires the synthetic group UPDATE
            side.pg_update(pg, pg)

    return hook


def scenario_timeout(api, side):
    side.s.on_node_add(make_node(api, "node-0", cpu="1"))
    pg = side.group("stuck", 2, timeout=5.0)
    side.pg_add(pg)
    side.s.on_pod_add(mkpod(api, "s-0", group="stuck", cpu="800m"))
    side.s.on_pod_add(mkpod(api, "s-1", group="stuck", cpu="800m"))

    def hook(r, side):
        if r >= 1:
            side.pg_update(pg, pg)  # the group's event requeues the members

    return hook


def scenario_mixed_batch(api, side):
    T, _ = api
    side.s.on_node_add(make_node(api, "node-0", cpu="1"))
    side.pg_add(side.group("duo", 2))
    port_pod = mkpod(api, "porty")
    port_pod.containers[0].ports = [T.ContainerPort(container_port=80, host_port=8080)]
    side.s.on_pod_add(port_pod)
    side.s.on_pod_add(mkpod(api, "m-0", group="duo", cpu="500m"))
    side.s.on_pod_add(mkpod(api, "m-1", group="duo", cpu="100"))


def scenario_sibling_pull(api, side):
    for i in range(4):
        side.s.on_node_add(make_node(api, f"node-{i}"))
    side.pg_add(side.group("big", 6))
    for m in range(6):
        side.s.on_pod_add(mkpod(api, f"big-{m}", group="big"))


def scenario_sibling_pull_mixed(api, side):
    for i in range(4):
        side.s.on_node_add(make_node(api, f"node-{i}"))
    side.pg_add(side.group("duo", 5))
    for i in range(2):
        side.s.on_pod_add(mkpod(api, f"plain-{i}", cpu="200m"))
    for m in range(5):
        side.s.on_pod_add(mkpod(api, f"duo-{m}", group="duo"))


def scenario_metrics(api, side):
    for i in range(2):
        side.s.on_node_add(make_node(api, f"node-{i}"))
    side.pg_add(side.group("duo", 2))
    side.s.on_pod_add(mkpod(api, "d-0", group="duo"))
    side.s.on_pod_add(mkpod(api, "d-1", group="duo"))


def scenario_unregistered(api, side):
    """A pod naming a group nobody registered schedules as an ordinary pod,
    but stays off the fast path; its label-named sibling likewise."""
    T, _ = api
    for i in range(2):
        side.s.on_node_add(make_node(api, f"node-{i}", cpu="1"))
    side.s.on_pod_add(mkpod(api, "lone-0", group="ghost", cpu="600m"))
    side.s.on_pod_add(mkpod(api, "lone-1", cpu="600m", labels={p_wlg.GROUP_LABEL: "ghost"}))
    side.s.on_pod_add(mkpod(api, "lone-2", group="ghost", cpu="600m"))


def scenario_duplicate_hostnames(api, side):
    """Two nodes share a hostname label value: the workloads dispatch steps
    aside and the members schedule one by one, without the quorum."""
    side.s.on_node_add(make_node(api, "node-0", cpu="1", hostname="shared"))
    side.s.on_node_add(make_node(api, "node-1", cpu="1", hostname="shared"))
    side.pg_add(side.group("duo", 2))
    side.s.on_pod_add(mkpod(api, "m-0", group="duo", cpu="500m"))
    side.s.on_pod_add(mkpod(api, "m-1", group="duo", cpu="100"))


def scenario_with_constraints(api, side):
    """Gangs beside spread and anti-affinity pods (the carries of the
    factored admission), on three zones, one gang rolling back."""
    T, _ = api
    for i in range(9):
        side.s.on_node_add(make_node(api, f"node-{i}", cpu="2", zone=f"zone-{i % 3}"))
    side.pg_add(side.group("ok", 3))
    side.pg_add(side.group("big", 3))
    spread = T.TopologySpreadConstraint(max_skew=1, topology_key="topology.kubernetes.io/zone",
                                        when_unsatisfiable="DoNotSchedule",
                                        label_selector=T.LabelSelector(match_labels={"app": "web"}))
    anti = T.Affinity(pod_anti_affinity=T.PodAntiAffinity(
        required_during_scheduling_ignored_during_execution=(T.PodAffinityTerm(
            topology_key="kubernetes.io/hostname", label_selector=T.LabelSelector(match_labels={"app": "db"})),)))
    for i in range(4):
        side.s.on_pod_add(mkpod(api, f"web-{i}", cpu="300m", labels={"app": "web"},
                                topology_spread_constraints=(spread,)))
        side.s.on_pod_add(mkpod(api, f"ok-{i}", group="ok", cpu="500m", labels={"app": "web"},
                                topology_spread_constraints=(spread,)))
        side.s.on_pod_add(mkpod(api, f"db-{i}", cpu="300m", labels={"app": "db"}, affinity=anti))
    for i in range(3):
        side.s.on_pod_add(mkpod(api, f"big-{i}", group="big", cpu="1900m" if i else "300m", labels={"app": "db"},
                                affinity=anti))


SCENARIOS = {
    "switch-off": (scenario_switch_off, (0.0,), dict(gang_dispatch=False)),
    "incomplete-then-admits": (scenario_incomplete_then_admits, (0.0, 1.5), {}),
    "timeout": (scenario_timeout, (0.0, 3.0, 3.0), {}),
    "mixed-batch": (scenario_mixed_batch, (0.0,), {}),
    "sibling-pull": (scenario_sibling_pull, (0.0,), dict(batch_size=3)),
    "sibling-pull-mixed": (scenario_sibling_pull_mixed, (0.0,), dict(batch_size=4)),
    "metrics": (scenario_metrics, (0.0,), {}),
    "unregistered-group": (scenario_unregistered, (0.0,), {}),
    "duplicate-hostnames": (scenario_duplicate_hostnames, (0.0,), {}),
    "with-constraints": (scenario_with_constraints, (0.0,), {}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_gang_scenario_matches_reference(name):
    scenario, rounds, cfg = SCENARIOS[name]
    history, (_, port) = run_twins(scenario, rounds, **cfg)
    final = history[-1]
    placed = {n: node for n, node, _ in final["outcomes"]}
    m = port.s.metrics
    if name == "switch-off":
        assert placed == {"m-0": "node-0", "m-1": None} and m["workload_batches"] == 0
    if name == "incomplete-then-admits":
        assert {n for n, node, _ in history[0]["outcomes"] if node is None} == {"t-0", "t-1"}
        assert any("waiting for the rest" in r for _, _, r in history[0]["outcomes"])
        assert sorted(final["bindings"]) == ["t-0", "t-1", "t-2"]
    if name == "timeout":
        reasons = [r for rnd in history for _, _, r in rnd["outcomes"]]
        assert any("timed out" in r for r in reasons), reasons
    if name == "mixed-batch":
        assert placed == {"porty": "node-0", "m-0": None, "m-1": None} and m["gang_rolled_back"] == 1
    if name in ("sibling-pull", "sibling-pull-mixed"):
        assert all(placed.values()) and m["workload_batches"] == 1
    if name == "metrics":
        assert all(placed.values()) and m["gang_admitted"] == 2 and m["gang_rolled_back"] == 0
    if name == "unregistered-group":
        assert m["workload_batches"] == 0 and m["fast_batches"] == 0 and sum(v is not None for v in placed.values()) == 2
    if name == "duplicate-hostnames":
        assert m["workload_batches"] == 0 and placed["m-0"] is not None and placed["m-1"] is None
    if name == "with-constraints":
        assert m["workload_batches"] == 1 and m["gang_rolled_back"] == 1 and m["gang_admitted"] == 4


@pytest.mark.parametrize("field,item", [
    pytest.param("resource_claims", "A5", id="resource_claims-A8 (DRA half)"),  # its id from before A8 was ported
    ("volumes", "A6"), ("scheduling_gates", "A5")])
def test_unported_pods_are_refused_and_requeued(field, item):
    """Gang members schedule now; a pod beside them with a ResourceClaim that
    does not exist (under the DynamicResourceAllocation gate: the reference
    holds it in PreEnqueue, ROADMAP A5), a volume the workloads route does
    not cover (a PVC that does not exist, ROADMAP A6b) or scheduling gates
    still raises NotImplementedError naming the ROADMAP item, and the
    popped batch goes back to the queue unscheduled."""
    from kubernetes_tpu_torch.framework.config import DEFAULT_FEATURE_GATES

    T, _ = PORT_API
    side = Side(PORT_API, feature_gates=dict(DEFAULT_FEATURE_GATES,
                                             DynamicResourceAllocation=field == "resource_claims"))
    side.s.on_node_add(make_node(PORT_API, "node-0"))
    side.pg_add(side.group("duo", 2))
    for m in range(2):
        side.s.on_pod_add(mkpod(PORT_API, f"m-{m}", group="duo"))
    value = {"resource_claims": ("claim",), "volumes": (T.Volume(name="v", pvc_name="missing"),), "scheduling_gates": ("gate",)}[field]
    side.s.on_pod_add(mkpod(PORT_API, "odd", **{field: value}))
    with pytest.raises(NotImplementedError, match=item.replace("(", r"\(").replace(")", r"\)")):
        side.s.schedule_pending()
    assert len(side.s.queue) == 3 and not side.bindings
