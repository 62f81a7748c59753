"""DRA claims end to end: the port's Scheduler against the JAX Scheduler,
and against the port's serial WorkloadOracle.

Both schedulers run the same scenario round by round on a manual clock,
nodes and pods arriving through ``on_node_add`` / ``on_pod_add``,
DeviceClasses, ResourceSlices and ResourceClaims through their informer
handlers (the JAX side's ``storage_handlers``, the port's
``on_device_class_add`` / ``on_resource_slice_add`` /
``on_resource_claim_add``), PodGroups likewise, evictions through
``pod_deleter`` wired to each side's ``on_pod_delete``, and each side's
claim writes (DynamicResources' PreBind) recorded.  Both run with the
DynamicResourceAllocation gate on unless a test says otherwise.  On the CPU
the port runs its kernels' plain versions (K13's, K14's, K8's and K11's);
the JAX scheduler runs with its dispatch ledger off.  After every round the
outcomes in order (pod, node, FitError or status), the bindings, the claim
cache (each claim's allocation, node and reservedFor), the claim writes, the
open nominations, the evictions and the workloads and DRA metrics
(workload_batches, workload_spec_admitted, gang_admitted, gang_rolled_back,
dra_pods, dra_claims_allocated) must be identical: all are names or
integers, so the tolerance is zero.

Scenarios: the nine of tests/test_dra.py (the claim whose pod the reference
gates in PreEnqueue is a refusal here, naming ROADMAP A5), and
tests/test_coscheduling.py's test_dra_property_vs_oracle (seeds 5, 23, 67,
also held against the oracle), test_gang_rollback_releases_devices,
test_all_mode_claim_vs_contention, test_shared_claim_pins_batch_peers,
test_kill_switch_identity_dra (gangDispatch off is a refusal naming A6b),
test_dra_flight_event_and_counter and
test_devices_taken_by_unreferenced_claims_stay_taken; a nominated claims
pod; and the gate off, where claims are ignored.
"""

import copy
import random

import pytest

from kubernetes_tpu.api import dra as j_dra
from kubernetes_tpu.framework.config import SchedulerConfiguration as JConfig
from kubernetes_tpu.framework.interface import EventResource as JEvent
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.workloads import gang as j_wlg
from kubernetes_tpu_torch.api import dra as p_dra
from kubernetes_tpu_torch.framework.config import SchedulerConfiguration as PConfig
from kubernetes_tpu_torch.oracle.state import OracleState
from kubernetes_tpu_torch.oracle.workloads import WorkloadOracle
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from kubernetes_tpu_torch.workloads import gang as p_wlg
from tests.test_torch_pack import JAX_API, PORT_API

METRICS = ("workload_batches", "workload_spec_admitted", "gang_admitted", "gang_rolled_back", "dra_pods",
           "dra_claims_allocated")


def claim_view(c):
    alloc = None if c.allocation is None else (
        c.allocation.node_name, tuple((r.request, r.driver, r.pool, r.device) for r in c.allocation.results))
    return (c.key, alloc, len(c.reserved_for))


class Side:
    """One scheduler, its manual clock, its informer handlers and its
    recorded side effects."""

    def __init__(self, api, gate=True, **cfg):
        self.api = api
        self.now = [1000.0]
        clock = lambda: self.now[0]  # noqa: E731
        if api is JAX_API:
            from kubernetes_tpu.observability import kernels

            config = JConfig(kernel_ledger=False, **cfg)
            config.feature_gates["DynamicResourceAllocation"] = gate
            self.s = JScheduler(config, clock=clock)
            kernels.deactivate()
            self.D, self.wlg = j_dra, j_wlg
            self.class_add = self.s.storage_handlers(JEvent.DEVICE_CLASS)[0]
            self.slice_add = self.s.storage_handlers(JEvent.RESOURCE_SLICE)[0]
            self.claim_add = self.s.storage_handlers(JEvent.RESOURCE_CLAIM)[0]
            self.pg_add = self.s.storage_handlers(JEvent.POD_GROUP)[0]
        else:
            config = PConfig(**cfg)
            config.feature_gates["DynamicResourceAllocation"] = gate
            self.s = PScheduler(config, device="cpu", clock=clock)
            self.D, self.wlg = p_dra, p_wlg
            self.class_add, self.slice_add = self.s.on_device_class_add, self.s.on_resource_slice_add
            self.claim_add, self.pg_add = self.s.on_resource_claim_add, self.s.on_pod_group_add
        self.bindings = {}
        self.evictions = []
        self.writes = []
        self.s.binding_sink = lambda pod, node: self.bindings.__setitem__(pod.name, node)
        self.s.pod_deleter = self.evict
        self.s.claim_writer = lambda claim: self.writes.append(claim_view(claim))

    def evict(self, pod):
        self.evictions.append(pod.name)
        self.s.on_pod_delete(pod)

    def round(self, advance: float = 0.0) -> dict:
        self.now[0] += advance
        out = self.s.schedule_pending()
        outcomes = []
        for o in out:
            reason = "; ".join(o.status.reasons) if hasattr(o, "status") else o.reason
            outcomes.append((o.pod.name, o.node, "" if o.node else reason))
        return {"outcomes": outcomes, "bindings": dict(self.bindings),
                "claims": sorted(claim_view(c) for c in self.s.claim_cache.list()), "writes": list(self.writes),
                "nominated": sorted((p.name, node) for node, p in self.s.nominator.entries()),
                "evictions": list(self.evictions), "metrics": {k: self.s.metrics[k] for k in METRICS}}

    # ---- DRA objects -----------------------------------------------------

    def gpu_class(self, name="gpu", vendor="example.com"):
        D = self.D
        self.class_add(D.DeviceClass(name=name, selectors=(D.DeviceSelector("vendor", "In", (vendor,)),)))

    def gpu_slice(self, name, node, n_devices, vendor="example.com", driver="gpu.example.com"):
        D = self.D
        self.slice_add(D.ResourceSlice(name=name, node_name=node, driver=driver, pool=f"{node}-pool", devices=tuple(
            D.Device(name=f"gpu-{i}", attributes=(("vendor", vendor),)) for i in range(n_devices))))

    def claim(self, name, count=1, mode="ExactCount", cls="gpu", selectors=(), allocation=None):
        D = self.D
        self.claim_add(D.ResourceClaim(name=name, requests=(D.DeviceRequest(
            name="gpu", device_class_name=cls, count=count, allocation_mode=mode, selectors=selectors),),
            allocation=allocation))


def run_twins(scenario, rounds, gate=True, **cfg):
    """Drive both sides through ``scenario(api, side)`` (which adds objects
    and may return a hook run before each round) and compare every round."""
    sides = [Side(JAX_API, gate, **cfg), Side(PORT_API, gate, **cfg)]
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


def make_node(api, name, cpu="8", zone="zone-a"):
    T, R = api
    return T.Node(name=name, labels={"kubernetes.io/hostname": name, "topology.kubernetes.io/zone": zone},
                  capacity=R.Resource.from_map({"cpu": cpu, "memory": "16Gi", "pods": 110}))


def mkpod(api, name, claims=(), cpu="100m", group="", **kw):
    T, _ = api
    return T.Pod(name=name, containers=[T.Container(name="c", requests={"cpu": cpu})], resource_claims=tuple(claims),
                 pod_group=group, **kw)


def placed(history, r=-1):
    return {n: node for n, node, _ in history[r]["outcomes"]}


# ---- tests/test_dra.py ----------------------------------------------------------


def test_claim_allocated_on_node_with_devices():
    def scenario(api, side):
        for n in ("node-1", "node-2"):
            side.s.on_node_add(make_node(api, n))
        side.gpu_class()
        side.gpu_slice("sl-2", "node-2", 2)
        side.claim("claim-g")
        side.s.on_pod_add(mkpod(api, "pod-g", ("claim-g",)))

    history, _ = run_twins(scenario, (0.0,), batch_size=8)
    assert placed(history) == {"pod-g": "node-2"}
    (claim,) = history[0]["claims"]
    assert claim[1][0] == "node-2" and len(claim[1][1]) == 1 and claim[2] == 1
    assert history[0]["metrics"]["dra_pods"] == 1 and history[0]["metrics"]["workload_batches"] == 1


def test_device_exclusivity_across_claims():
    def scenario(api, side):
        side.s.on_node_add(make_node(api, "node-1"))
        side.gpu_class()
        side.gpu_slice("sl-1", "node-1", 1)
        for i in range(2):
            side.claim(f"claim-{i}")
            side.s.on_pod_add(mkpod(api, f"pod-{i}", (f"claim-{i}",)))

    history, _ = run_twins(scenario, (0.0,), batch_size=8)
    got = placed(history)
    assert sorted(v for v in got.values() if v) == ["node-1"]
    failed = [r for _, node, r in history[0]["outcomes"] if node is None]
    assert len(failed) == 1 and "cannot allocate all devices" in failed[0]


def test_count_and_selector_matching():
    def scenario(api, side):
        for n in ("node-1", "node-2"):
            side.s.on_node_add(make_node(api, n))
        side.gpu_class()
        side.gpu_slice("sl-1", "node-1", 1)
        side.gpu_slice("sl-2", "node-2", 3)
        side.claim("claim-2", count=2, selectors=(side.D.DeviceSelector("vendor", "In", ("example.com",)),))
        side.s.on_pod_add(mkpod(api, "pod-2", ("claim-2",)))

    history, _ = run_twins(scenario, (0.0,), batch_size=8)
    assert placed(history) == {"pod-2": "node-2"} and len(history[0]["claims"][0][1][1]) == 2


def test_preallocated_claim_pins_node():
    def scenario(api, side):
        D = side.D
        for n in ("node-1", "node-2"):
            side.s.on_node_add(make_node(api, n))
        side.gpu_class()
        side.claim("claim-p", allocation=D.AllocationResult(
            results=(D.DeviceRequestAllocationResult("gpu", "gpu.example.com", "node-1-pool", "gpu-0"),),
            node_name="node-1"))
        side.s.on_pod_add(mkpod(api, "pod-p", ("claim-p",)))

    history, _ = run_twins(scenario, (0.0,), batch_size=8)
    assert placed(history) == {"pod-p": "node-1"}
    assert history[0]["metrics"]["dra_claims_allocated"] == 0


def test_missing_claim_is_refused_naming_the_preenqueue_tier():
    """The reference keeps such a pod out of the queue in PreEnqueue until
    its claim exists; the port refuses it (ROADMAP A5) before any side
    effect, and the popped batch goes back to the queue."""
    side = Side(PORT_API)
    side.s.on_node_add(make_node(PORT_API, "node-1"))
    side.gpu_class()
    side.gpu_slice("sl-1", "node-1", 1)
    side.claim("here")
    side.s.on_pod_add(mkpod(PORT_API, "fine", ("here",)))
    side.s.on_pod_add(mkpod(PORT_API, "pod-w", ("claim-w",)))
    with pytest.raises(NotImplementedError, match="A5"):
        side.s.schedule_pending()
    assert len(side.s.queue) == 2 and not side.bindings and not side.writes
    jside = Side(JAX_API)
    jside.s.on_node_add(make_node(JAX_API, "node-1"))
    jside.s.on_pod_add(mkpod(JAX_API, "pod-w", ("claim-w",)))
    assert jside.s.schedule_pending() == []  # gated: never reached the active queue


def test_unreserve_rolls_back_assumed_claim():
    """A failed bind unreserves: the claim cache is back to the unallocated
    claim on both sides."""

    def failing_bind(pod, node):
        raise RuntimeError("api down")

    def scenario(api, side):
        side.s.on_node_add(make_node(api, "node-1"))
        side.gpu_class()
        side.gpu_slice("sl-1", "node-1", 1)
        side.claim("claim-r")
        side.s.on_pod_add(mkpod(api, "pod-r", ("claim-r",)))
        side.s.binding_sink = failing_bind

    history, _ = run_twins(scenario, (0.0,), batch_size=8)
    assert placed(history) == {"pod-r": None}
    assert history[0]["outcomes"] == [("pod-r", None, "api down")]  # the sink's error, bare on both sides
    assert history[0]["claims"] == [("default/claim-r", None, 0)]


def test_in_batch_contention_via_workloads_kernel():
    def scenario(api, side):
        side.s.on_node_add(make_node(api, "node-1"))
        side.gpu_class()
        side.gpu_slice("sl-1", "node-1", 1)
        for i in range(2):
            side.claim(f"wl-claim-{i}")
            side.s.on_pod_add(mkpod(api, f"wl-pod-{i}", (f"wl-claim-{i}",)))

    history, _ = run_twins(scenario, (0.0,), batch_size=8)
    assert placed(history) == {"wl-pod-0": "node-1", "wl-pod-1": None}
    m = history[0]["metrics"]
    assert m["workload_batches"] >= 1 and m["dra_pods"] == 1 and m["dra_claims_allocated"] == 1


def test_all_mode_requires_every_match_free():
    def scenario(api, side):
        side.s.on_node_add(make_node(api, "node-1"))
        side.gpu_class()
        side.gpu_slice("sl-1", "node-1", 2)
        side.claim("one")
        side.claim("all", mode="All")
        side.s.on_pod_add(mkpod(api, "p-one", ("one",)))
        side.s.on_pod_add(mkpod(api, "p-all", ("all",)))

    history, _ = run_twins(scenario, (0.0,), batch_size=8)
    assert placed(history) == {"p-one": "node-1", "p-all": None}


def test_kernel_path_decisions():
    """tests/test_dra.py::test_kernel_path_matches_serial_path_decisions'
    workload under gangDispatch (its serial twin is refused, below)."""

    def scenario(api, side):
        for i in range(3):
            side.s.on_node_add(make_node(api, f"node-{i}"))
        side.gpu_class()
        side.gpu_slice("sl-0", "node-0", 2)
        side.gpu_slice("sl-2", "node-2", 1)
        for i in range(4):
            side.claim(f"c{i}", count=1 + i % 2)
            side.s.on_pod_add(mkpod(api, f"p{i}", (f"c{i}",)))

    history, _ = run_twins(scenario, (0.0,), batch_size=8)
    assert sum(v is not None for v in placed(history).values()) >= 2


# ---- tests/test_coscheduling.py --------------------------------------------------


def random_dra_workload(api, D, rng):
    """_random_dra_workload of tests/test_coscheduling.py for either
    package: (nodes, slices, classes, claims, pods)."""
    nodes = [make_node(api, f"node-{i}") for i in range(rng.randrange(3, 7))]
    slices = []
    for i, n in enumerate(nodes):
        if rng.random() < 0.7:
            devs = tuple(D.Device(name=f"dev-{i}-{j}", attributes=(("vendor", rng.choice(["x", "y"])),
                                                                   ("mem", rng.choice(["16", "32"]))))
                         for j in range(rng.randrange(1, 4)))
            slices.append(D.ResourceSlice(name=f"sl-{i}", node_name=n.name, driver="drv", pool=f"pool-{i}",
                                          devices=devs))
    classes = {"gpu": D.DeviceClass(name="gpu", selectors=(D.DeviceSelector("vendor", "In", ("x",)),)),
               "any": D.DeviceClass(name="any")}
    claims, pods = {}, []
    for ci in range(rng.randrange(3, 8)):
        mode_all = rng.random() < 0.25
        sels = ()
        if rng.random() < 0.4:
            sels = (D.DeviceSelector("mem", rng.choice(["In", "NotIn"]), ("32",)),)
        if rng.random() < 0.15:
            sels = sels + (D.DeviceSelector("vendor", "Exists"),)
        req = D.DeviceRequest(name="r0", device_class_name=rng.choice(["gpu", "any"]), count=rng.randrange(1, 3),
                              allocation_mode="All" if mode_all else "ExactCount", selectors=sels)
        c = D.ResourceClaim(name=f"claim-{ci}", requests=(req,))
        claims[c.key] = c
    names = [c.split("/", 1)[1] for c in claims]
    for pi in range(rng.randrange(4, 9)):
        pods.append(mkpod(api, f"pod-{pi}", rng.sample(names, rng.randrange(0, 3))))
    return nodes, slices, classes, claims, pods


@pytest.mark.parametrize("seed", [5, 23, 67])
def test_dra_property_vs_reference_and_oracle(seed):
    """test_dra_property_vs_oracle: three seeded workloads per seed, each
    drained in one round on both sides, and the placements and claim pins
    equal to the port's serial WorkloadOracle."""
    rngs = {JAX_API: random.Random(seed), PORT_API: random.Random(seed)}
    for it in range(3):
        worlds = {}

        def scenario(api, side):
            nodes, slices, classes, claims, pods = random_dra_workload(api, side.D, rngs[api])
            worlds[api] = (nodes, slices, classes, claims, pods)
            for n in nodes:
                side.s.on_node_add(n)
            for cls in classes.values():
                side.class_add(cls)
            for sl in slices:
                side.slice_add(sl)
            for c in claims.values():
                side.claim_add(copy.deepcopy(c))
            for p in pods:
                side.s.on_pod_add(copy.deepcopy(p))

        history, (_, port) = run_twins(scenario, (0.0,), batch_size=128)
        nodes, slices, classes, claims, pods = worlds[PORT_API]
        oracle = WorkloadOracle(state=OracleState.build(nodes), slices=copy.deepcopy(slices),
                                device_classes=copy.deepcopy(classes), claims=copy.deepcopy(claims))
        res = oracle.schedule(copy.deepcopy(pods))
        assert placed(history) == res.placements, (seed, it)
        pins = {k: alloc[0] for k, alloc, _ in history[0]["claims"] if alloc is not None}
        assert pins == res.claim_nodes, (seed, it)


def _gpu_env(side, api, n_nodes=3, devices_per_node=2, gpu_nodes=None):
    for i in range(n_nodes):
        side.s.on_node_add(make_node(api, f"node-{i}", cpu="4"))
    side.gpu_class(vendor="x")
    for i in gpu_nodes if gpu_nodes is not None else range(n_nodes):
        side.gpu_slice(f"sl-{i}", f"node-{i}", devices_per_node, vendor="x", driver="drv")


def test_gang_rollback_releases_devices():
    def scenario(api, side):
        _gpu_env(side, api, n_nodes=2, devices_per_node=1, gpu_nodes=[0])
        side.pg_add(side.wlg.PodGroup(name="g", min_member=2))
        side.claim("c-member")
        side.claim("c-late")
        side.s.on_pod_add(mkpod(api, "g-0", ("c-member",), group="g"))
        side.s.on_pod_add(mkpod(api, "g-1", group="g", cpu="100"))
        side.s.on_pod_add(mkpod(api, "late", ("c-late",)))

    history, _ = run_twins(scenario, (0.0,), batch_size=128)
    assert placed(history) == {"g-0": None, "g-1": None, "late": "node-0"}
    claims = dict((k, a) for k, a, _ in history[0]["claims"])
    assert claims["default/c-member"] is None and claims["default/c-late"][0] == "node-0"
    assert history[0]["metrics"]["gang_rolled_back"] == 1


def test_all_mode_claim_vs_contention():
    def scenario(api, side):
        _gpu_env(side, api, n_nodes=2, devices_per_node=2, gpu_nodes=[0, 1])
        side.claim("c-one")
        side.claim("c-all", mode="All")
        side.s.on_pod_add(mkpod(api, "p-one", ("c-one",)))
        side.s.on_pod_add(mkpod(api, "p-all", ("c-all",)))

    history, _ = run_twins(scenario, (0.0,), batch_size=128)
    assert placed(history) == {"p-one": "node-0", "p-all": "node-1"}


def test_shared_claim_pins_batch_peers():
    def scenario(api, side):
        _gpu_env(side, api, n_nodes=3, devices_per_node=1, gpu_nodes=[1])
        side.claim("c-shared")
        side.s.on_pod_add(mkpod(api, "a", ("c-shared",)))
        side.s.on_pod_add(mkpod(api, "b", ("c-shared",)))

    history, _ = run_twins(scenario, (0.0,), batch_size=128)
    assert placed(history) == {"a": "node-1", "b": "node-1"}
    (claim,) = history[0]["claims"]
    assert len(claim[1][1]) == 1 and claim[2] == 2
    assert history[0]["metrics"]["dra_claims_allocated"] == 1 and history[0]["metrics"]["dra_pods"] == 2


def test_dra_counter():
    """test_dra_flight_event_and_counter's counter: one claim allocated."""

    def scenario(api, side):
        _gpu_env(side, api, n_nodes=2, devices_per_node=1, gpu_nodes=[0])
        side.claim("c-f")
        side.s.on_pod_add(mkpod(api, "p-f", ("c-f",)))

    history, _ = run_twins(scenario, (0.0,), batch_size=128)
    assert placed(history) == {"p-f": "node-0"} and history[0]["metrics"]["dra_claims_allocated"] == 1


def test_devices_taken_by_unreferenced_claims_stay_taken():
    """The second drain's claim does not reference the first's, whose device
    on node-0 stays taken: the pod lands on node-1 though node-0 scores
    better."""

    def scenario(api, side):
        _gpu_env(side, api, n_nodes=2, devices_per_node=1, gpu_nodes=[0, 1])
        side.claim("c0")
        side.s.on_pod_add(mkpod(api, "p0", ("c0",), node_selector={"kubernetes.io/hostname": "node-0"}))
        side.s.on_pod_add(mkpod(api, "heavy", cpu="2000m"))

        def hook(r, side):
            if r == 1:
                side.claim("c1")
                side.s.on_pod_add(mkpod(api, "p1", ("c1",)))
        return hook

    history, _ = run_twins(scenario, (0.0, 0.0), batch_size=128)
    assert placed(history, 0)["p0"] == "node-0" and placed(history, 1) == {"p1": "node-1"}


def test_nominated_claims_pod():
    """A claims pod that outranks a placed pod: its preemption's dry run
    runs DynamicResources' Filter (only node-0 has a device), evicts node-0's
    victim and nominates it; back from backoff it takes the nominated-node
    path with the host Filters and binds there, its claim allocated."""

    def scenario(api, side):
        T, _ = api
        for n in ("node-0", "node-1"):
            side.s.on_node_add(make_node(api, n, cpu="1"))
            side.s.on_pod_add(T.Pod(name=f"victim-{n}", priority=0, node_name=n,
                                    containers=[T.Container(name="c", requests={"cpu": "900m"})]))
        side.gpu_class()
        side.gpu_slice("sl-0", "node-0", 1)
        side.claim("c-p")
        side.s.on_pod_add(mkpod(api, "pod-p", ("c-p",), cpu="500m", priority=100))

    history, (_, port) = run_twins(scenario, (0.0, 30.0), batch_size=8)
    assert history[0]["evictions"] == ["victim-node-0"] and history[0]["nominated"] == [("pod-p", "node-0")]
    assert placed(history, 1) == {"pod-p": "node-0"}
    assert history[1]["claims"][0][1][0] == "node-0"


def test_gate_off_ignores_claims():
    """With DynamicResourceAllocation off the claims are ignored: the pods
    schedule on the ordinary routes, identically, and nothing allocates."""

    def scenario(api, side):
        for i in range(3):
            side.s.on_node_add(make_node(api, f"node-{i}"))
        side.gpu_class()
        side.gpu_slice("sl-0", "node-0", 1)
        for i in range(6):
            side.claim(f"c{i}")
            side.s.on_pod_add(mkpod(api, f"p{i}", (f"c{i}",) if i % 2 else ("missing",)))

    history, (_, port) = run_twins(scenario, (0.0,), gate=False, batch_size=8)
    assert all(placed(history).values())
    assert all(a is None for _, a, _ in history[0]["claims"]) and not history[0]["writes"]
    assert port.s.metrics["workload_batches"] == 0


# ---- what the slice does not cover ---------------------------------------------


@pytest.mark.parametrize("reason", ["gang-dispatch-off", "host-ports"])
def test_uncovered_claims_pods_are_refused(reason):
    """A claims pod with host ports, or any claims pod while gangDispatch is
    off (the reference's serial host-veto split path, as
    test_kill_switch_identity_dra runs it), raises NotImplementedError
    naming ROADMAP A6b; the popped batch goes back to the queue."""
    T, _ = PORT_API
    side = Side(PORT_API, **({"gang_dispatch": False} if reason == "gang-dispatch-off" else {}))
    _gpu_env(side, PORT_API, n_nodes=2)
    side.claim("c0")
    side.claim("c1")
    side.s.on_pod_add(mkpod(PORT_API, "fine", ("c0",)))
    if reason == "host-ports":
        pod = T.Pod(name="odd", resource_claims=("c1",), containers=[T.Container(
            name="c", ports=(T.ContainerPort(container_port=80, host_port=8080),))])
    else:
        pod = mkpod(PORT_API, "odd", ("c1",))
    side.s.on_pod_add(pod)
    with pytest.raises(NotImplementedError, match="A6b"):
        side.s.schedule_pending()
    assert len(side.s.queue) == 2 and not side.bindings


def test_node_beyond_the_kernels_device_slots():
    """A node with more devices than the DRA kernels keep in registers (256
    slots; past them each thread's words go to a scratch row): the port
    places its claims pod as the JAX Scheduler does, with no refusal, and
    the claim's allocation names the same 257 devices.  On the CPU the
    port runs the plain versions; the kernels' scratch path is held to
    them on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py)."""
    n_dev = 257

    def scenario(api, side):
        side.s.on_node_add(make_node(api, "node-1"))
        side.gpu_class()
        side.gpu_slice("sl-1", "node-1", n_dev)
        side.claim("many", count=n_dev)
        side.s.on_pod_add(mkpod(api, "pod-m", ("many",)))

    history, (ref, port) = run_twins(scenario, (0.0,), batch_size=8)
    assert placed(history) == {"pod-m": "node-1"}
    got = claim_view(port.s.claim_cache.get("default/many"))
    assert got == claim_view(ref.s.claim_cache.get("default/many"))
    assert got[1][0] == "node-1" and len(got[1][1]) == n_dev
    assert port.s.metrics["workload_batches"] == 1


@pytest.mark.parametrize("gate", ["SchedulerQueueingHints", "VolumeCapacityPriority"])
def test_unread_feature_gates_are_rejected(gate):
    """The port's gate table holds only the gate it reads, with the
    reference's default; a gate it does not read fails validation instead
    of being ignored."""
    from kubernetes_tpu.framework.config import DEFAULT_FEATURE_GATES as J_GATES
    from kubernetes_tpu_torch.framework.config import DEFAULT_FEATURE_GATES as P_GATES

    assert dict(P_GATES) == {"DynamicResourceAllocation": dict(J_GATES)["DynamicResourceAllocation"]}
    config = PConfig()
    config.feature_gates[gate] = dict(J_GATES)[gate]
    with pytest.raises(ValueError, match=gate):
        PScheduler(config, device="cpu")
