"""Bound-volume pods end to end: the port's Scheduler against the JAX
Scheduler.

Both sides run the same scenario round by round on a manual clock, nodes
and pods arriving through ``on_node_add`` / ``on_pod_add``, PVs, PVCs and
StorageClasses through their informer handlers (the JAX side's
``storage_handlers``, the port's ``on_pv_add`` / ``on_pvc_add`` /
``on_storage_class_add``), PodGroups likewise, and evictions through
``pod_deleter`` wired to each side's ``on_pod_delete``.  On the CPU the port
runs its kernels' plain versions (K12's ``volume_topology_mask_plain``
among them); the JAX scheduler runs with its dispatch ledger off.  After
every round the outcomes in order (pod, node, FitError or status), the
bindings, the open nominations, the evictions and the workloads metrics
(workload_batches, workload_spec_admitted, gang_admitted, gang_rolled_back)
must be identical: all are names or integers, so the tolerance is zero.

Scenarios: tests/test_coscheduling.py's test_volume_topology_kernel_mask,
zone-labelled PVs (VolumeZone's form, a zone set among them), volume pods
inside a PodGroup, volume pods beside spread and anti-affinity pods, a
volume pod batched with a host-port pod (the split), a PV pinned to a zone
no node carries until a node in that zone arrives (the requeue), preemption
with a PV pinned to one node (tests/test_volume_plugins.py's
test_preemption_respects_volume_node_affinity), a claim being deleted (a
PreFilter rejection), and emptyDir-only pods on the fast path.  Also: every
pod shape the slice does not cover raises NotImplementedError naming
ROADMAP A6b, before any side effect.
"""

import copy

import numpy as np
import pytest

from kubernetes_tpu.api import storage as j_st
from kubernetes_tpu.framework.config import SchedulerConfiguration as JConfig
from kubernetes_tpu.framework.interface import EventResource as JEvent
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.workloads import gang as j_wlg
from kubernetes_tpu_torch.api import storage as p_st
from kubernetes_tpu_torch.framework.config import SchedulerConfiguration as PConfig
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from kubernetes_tpu_torch.workloads import gang as p_wlg
from tests.test_torch_pack import JAX_API, PORT_API

METRICS = ("workload_batches", "workload_spec_admitted", "gang_admitted", "gang_rolled_back")
ZONE = "topology.kubernetes.io/zone"


class Side:
    """One scheduler, its manual clock, its informer handlers and its
    recorded side effects."""

    def __init__(self, api, **cfg):
        self.api = api
        self.now = [1000.0]
        clock = lambda: self.now[0]  # noqa: E731
        if api is JAX_API:
            from kubernetes_tpu.observability import kernels

            self.s = JScheduler(JConfig(kernel_ledger=False, **cfg), clock=clock)
            kernels.deactivate()
            self.st, self.wlg = j_st, j_wlg
            self.pv_add = self.s.storage_handlers(JEvent.PV)[0]
            self.pvc_add, self.pvc_update, _ = self.s.storage_handlers(JEvent.PVC)
            self.sc_add = self.s.storage_handlers(JEvent.STORAGE_CLASS)[0]
            self.csinode_add = self.s.storage_handlers(JEvent.CSI_NODE)[0]
            self.pg_add = self.s.storage_handlers(JEvent.POD_GROUP)[0]
        else:
            self.s = PScheduler(PConfig(**cfg), device="cpu", clock=clock)
            self.st, self.wlg = p_st, p_wlg
            self.pv_add, self.pvc_add, self.pvc_update = self.s.on_pv_add, self.s.on_pvc_add, self.s.on_pvc_update
            self.sc_add, self.csinode_add, self.pg_add = (self.s.on_storage_class_add, self.s.on_csinode_add,
                                                          self.s.on_pod_group_add)
        self.bindings = {}
        self.evictions = []
        self.s.binding_sink = lambda pod, node: self.bindings.__setitem__(pod.name, node)
        self.s.pod_deleter = self.evict

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
                "nominated": sorted((p.name, node) for node, p in self.s.nominator.entries()),
                "evictions": list(self.evictions), "metrics": {k: self.s.metrics[k] for k in METRICS}}

    # ---- storage objects --------------------------------------------------

    def bound_claim(self, name, affinity=None, labels=None, namespace="default", access=("ReadWriteOnce",)):
        """A PV (``affinity``: a NodeSelector of this side's types, None for
        nil) and a PVC bound to it, through the informer handlers."""
        st = self.st
        pv = st.PersistentVolume(name=f"pv-{name}", capacity=10, access_modes=access, storage_class_name="std",
                                 node_affinity=affinity, labels=dict(labels or {}), phase=st.PV_BOUND,
                                 claim_ref=st.ObjectRef(namespace, name))
        pvc = st.PersistentVolumeClaim(name=name, namespace=namespace, request=10, access_modes=access,
                                       storage_class_name="std", volume_name=pv.name, phase=st.PVC_BOUND)
        self.pv_add(pv)
        self.pvc_add(pvc)
        return pvc


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


def make_node(api, name, cpu="4", zone="zone-a", labels=None):
    T, R = api
    return T.Node(name=name, labels={"kubernetes.io/hostname": name, ZONE: zone, **(labels or {})},
                  capacity=R.Resource.from_map({"cpu": cpu, "memory": "16Gi", "pods": 110}))


def vol_pod(api, name, *claims, cpu="100m", **kw):
    T, _ = api
    return T.Pod(name=name, containers=[T.Container(name="c", requests={"cpu": cpu})],
                 volumes=tuple(T.Volume(name=f"v{i}", pvc_name=c) for i, c in enumerate(claims)), **kw)


def zone_affinity(api, *zones, key=ZONE, op="In"):
    T, _ = api
    return T.NodeSelector((T.NodeSelectorTerm(match_expressions=(T.NodeSelectorRequirement(key, op, zones),)),))


def names_affinity(api, *names):
    T, _ = api
    return T.NodeSelector((T.NodeSelectorTerm(match_fields=(T.NodeSelectorRequirement("metadata.name", "In",
                                                                                      names),)),))


def outcome_of(history, r, name):
    return next(o for o in history[r]["outcomes"] if o[0] == name)


# ---- scenarios ----------------------------------------------------------------


def test_volume_topology_kernel_mask():
    """tests/test_coscheduling.py::test_volume_topology_kernel_mask: the pod
    lands in its PV's zone through the workloads dispatch; a PV pinned to a
    zone no node carries fails with the volume node affinity conflict."""

    def scenario(api, side):
        for i in range(4):
            side.s.on_node_add(make_node(api, f"node-{i}", zone="zone-b" if i >= 2 else "zone-a"))
        side.bound_claim("data-b", zone_affinity(api, "zone-b"))
        side.bound_claim("data-none", zone_affinity(api, "zone-c"))
        side.s.on_pod_add(vol_pod(api, "pinned", "data-b"))
        side.s.on_pod_add(vol_pod(api, "impossible", "data-none"))

    history, (_, port) = run_twins(scenario, (0.0,), batch_size=128)
    assert outcome_of(history, 0, "pinned")[1] in ("node-2", "node-3")
    bad = outcome_of(history, 0, "impossible")
    assert bad[1] is None and "volume node affinity" in bad[2]
    assert history[0]["metrics"]["workload_batches"] >= 1


def test_zone_labelled_pvs():
    """VolumeZone's form: PVs carrying zone labels (one a __-joined zone
    set, one with a region label too) fold into K12's table as In
    conjunctions; several affinity operators ride beside them."""

    def scenario(api, side):
        for i in range(6):
            side.s.on_node_add(make_node(api, f"node-{i}", zone=f"z{i % 3}",
                                         labels={"topology.kubernetes.io/region": "r1" if i < 4 else "r2",
                                                 "tier": str(i)}))
        side.bound_claim("zl", labels={ZONE: "z2"})
        side.bound_claim("zset", labels={ZONE: "z0__z1"})
        side.bound_claim("zreg", labels={ZONE: "z1", "topology.kubernetes.io/region": "r2"})
        side.bound_claim("notin", zone_affinity(api, "z0", op="NotIn"))
        side.bound_claim("gt", zone_affinity(api, "3", key="tier", op="Gt"))
        side.bound_claim("exists", zone_affinity(api, key="tier", op="Exists"))
        for name in ("zl", "zset", "zreg", "notin", "gt", "exists"):
            side.s.on_pod_add(vol_pod(api, f"p-{name}", name))
        side.s.on_pod_add(vol_pod(api, "p-two", "zset", "gt"))

    history, _ = run_twins(scenario, (0.0,), batch_size=128)
    got = {o[0]: o[1] for o in history[0]["outcomes"]}
    assert got["p-zl"] in ("node-2", "node-5") and got["p-zreg"] == "node-4"
    assert got["p-two"] == "node-4"


def test_volume_pods_inside_a_pod_group():
    """Volume pods as gang members: a gang whose members' PVs pin it to a
    full zone rolls back; the other gang lands whole in its zone."""

    def scenario(api, side):
        for i in range(4):
            side.s.on_node_add(make_node(api, f"node-{i}", cpu="1", zone="zone-b" if i >= 2 else "zone-a"))
        side.pg_add(side.wlg.PodGroup(name="ok", min_member=2))
        side.pg_add(side.wlg.PodGroup(name="tight", min_member=3))
        for m in range(2):
            side.bound_claim(f"ok-{m}", zone_affinity(api, "zone-a"))
            side.s.on_pod_add(vol_pod(api, f"ok-{m}", f"ok-{m}", cpu="600m", pod_group="ok"))
        for m in range(3):
            side.bound_claim(f"t-{m}", zone_affinity(api, "zone-b"))
            side.s.on_pod_add(vol_pod(api, f"t-{m}", f"t-{m}", cpu="600m", pod_group="tight"))
        side.s.on_pod_add(vol_pod(api, "plain", cpu="300m"))

    history, _ = run_twins(scenario, (0.0,), batch_size=128)
    m = history[0]["metrics"]
    assert m["gang_admitted"] == 2 and m["gang_rolled_back"] == 1
    got = {o[0]: o[1] for o in history[0]["outcomes"]}
    assert got["ok-0"] in ("node-0", "node-1") and got["t-0"] is None


def test_volume_pods_beside_spread_and_anti_affinity():
    """A batch of volume pods, zone-spread pods and hostname anti-affinity
    pods takes one workloads dispatch (K12 beside K6 and K7)."""

    def scenario(api, side):
        T, _ = api
        for i in range(6):
            side.s.on_node_add(make_node(api, f"node-{i}", zone=f"zone-{i % 3}"))
        for i in range(4):
            side.bound_claim(f"d{i}", zone_affinity(api, f"zone-{i % 2}"))
            side.s.on_pod_add(vol_pod(api, f"v{i}", f"d{i}", labels={"app": "db"}))
        for i in range(4):
            side.s.on_pod_add(T.Pod(name=f"s{i}", labels={"app": "web"},
                                    containers=[T.Container(name="c", requests={"cpu": "100m"})],
                                    topology_spread_constraints=(T.TopologySpreadConstraint(
                                        max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
                                        label_selector=T.LabelSelector(match_labels={"app": "web"})),)))
        for i in range(3):
            term = T.PodAffinityTerm(label_selector=T.LabelSelector(match_labels={"app": "db"}),
                                     topology_key="kubernetes.io/hostname")
            side.s.on_pod_add(T.Pod(name=f"a{i}", labels={"app": "x"},
                                    containers=[T.Container(name="c", requests={"cpu": "100m"})],
                                    affinity=T.Affinity(pod_anti_affinity=T.PodAntiAffinity(
                                        required_during_scheduling_ignored_during_execution=(term,)))))

    history, _ = run_twins(scenario, (0.0,), batch_size=128)
    assert history[0]["metrics"]["workload_batches"] == 1
    assert all(o[1] is not None for o in history[0]["outcomes"])


def test_volume_pod_batched_with_a_host_port_pod():
    """A host-port pod disqualifies the workloads dispatch for the batch; the
    split sends each volume pod to the workloads dispatch alone and the
    other pods to the direct path."""

    def scenario(api, side):
        T, _ = api
        for i in range(3):
            side.s.on_node_add(make_node(api, f"node-{i}", zone="zone-b" if i else "zone-a"))
        side.bound_claim("d0", zone_affinity(api, "zone-b"))
        side.bound_claim("d1", zone_affinity(api, "zone-a"))
        side.s.on_pod_add(vol_pod(api, "v0", "d0"))
        side.s.on_pod_add(T.Pod(name="port", containers=[T.Container(
            name="c", requests={"cpu": "100m"}, ports=(T.ContainerPort(container_port=80, host_port=8080),))]))
        side.s.on_pod_add(vol_pod(api, "v1", "d1"))
        side.s.on_pod_add(vol_pod(api, "plain"))

    history, _ = run_twins(scenario, (0.0,), batch_size=128)
    assert history[0]["metrics"]["workload_batches"] == 2
    got = {o[0]: o[1] for o in history[0]["outcomes"]}
    assert got["v0"] in ("node-1", "node-2") and got["v1"] == "node-0" and got["port"] is not None


def test_absent_zone_then_node_added_requeues():
    """A PV pinned to a zone no node carries: the pod fails (VolumeBinding
    among its rejecting plugins); a node in that zone arrives, the node
    event requeues it, and it lands there."""

    def scenario(api, side):
        for i in range(2):
            side.s.on_node_add(make_node(api, f"node-{i}"))
        side.bound_claim("far", zone_affinity(api, "zone-z"))
        side.s.on_pod_add(vol_pod(api, "waiter", "far"))

        def hook(r, side):
            if r == 1:
                side.s.on_node_add(make_node(api, "node-z", zone="zone-z"))
        return hook

    history, _ = run_twins(scenario, (0.0, 30.0), batch_size=128)
    assert outcome_of(history, 0, "waiter")[1] is None
    assert outcome_of(history, 1, "waiter")[1] == "node-z"


def test_preemption_respects_volume_node_affinity():
    """tests/test_volume_plugins.py::test_preemption_respects_volume_node_
    affinity: a high-priority pod whose PV is pinned to node-1 evicts only
    node-1's victim (the dry run runs the host volume Filters), then binds
    there on the nominated-node path."""

    def scenario(api, side):
        T, _ = api
        for n in ("node-1", "node-2"):
            side.s.on_node_add(make_node(api, n, cpu="1"))
            side.s.on_pod_add(T.Pod(name=f"victim-{n}", priority=0, node_name=n,
                                    containers=[T.Container(name="c", requests={"cpu": "900m"})]))
        side.bound_claim("claim-p", names_affinity(api, "node-1"))
        side.s.on_pod_add(vol_pod(api, "pod-p", "claim-p", cpu="500m", priority=100))

    history, _ = run_twins(scenario, (0.0, 30.0), batch_size=8)
    assert history[0]["evictions"] == ["victim-node-1"]
    assert history[0]["nominated"] == [("pod-p", "node-1")]
    assert outcome_of(history, 1, "pod-p")[1] == "node-1"


def test_nominated_volume_pod_whose_node_no_longer_fits():
    """A volume pod nominated by its preemption comes back from backoff to
    find its nominated node taken, in one popped batch between plain pods
    of higher and lower priority.  It takes the full one-pod host cycle
    with the host volume Filters (the reference's nominated fall-through)
    and lands on the other node of its PV's zone; the pods after it in the
    batch are scheduled in the same round."""

    def scenario(api, side):
        T, _ = api
        victims = {}
        for n, zone in (("node-1", "zone-a"), ("node-2", "zone-a"), ("node-3", "zone-b")):
            side.s.on_node_add(make_node(api, n, cpu="4" if zone == "zone-b" else "1", zone=zone))
            if zone == "zone-a":
                victims[n] = T.Pod(name=f"victim-{n}", priority=0, node_name=n,
                                   containers=[T.Container(name="c", requests={"cpu": "900m"})])
                side.s.on_pod_add(victims[n])
        side.bound_claim("claim-p", zone_affinity(api, "zone-a"))
        side.s.on_pod_add(vol_pod(api, "pod-p", "claim-p", cpu="500m", priority=100))

        def hook(r, side):
            if r != 1:
                return
            (nom,) = [node for node, p in side.s.nominator.entries() if p.name == "pod-p"]
            other = next(n for n in victims if n != nom)
            side.s.on_pod_add(T.Pod(name="intruder", priority=1000, node_name=nom,
                                    containers=[T.Container(name="c", requests={"cpu": "900m"})]))
            side.s.on_pod_delete(victims[other])
            for i in range(3):
                side.s.on_pod_add(vol_pod(api, f"a{i}", priority=200))
                side.s.on_pod_add(vol_pod(api, f"b{i}", priority=50))

        return hook

    history, sides = run_twins(scenario, (0.0, 30.0), batch_size=16)
    (nom,) = [node for _, node in history[0]["nominated"]]
    other = "node-2" if nom == "node-1" else "node-1"
    assert outcome_of(history, 1, "pod-p")[1] == other
    assert all(outcome_of(history, 1, f"{x}{i}")[1] for x in "ab" for i in range(3))
    assert len(sides[1].s.queue) == 0 and sides[1].s.metrics["host_cycles"] == 1


def test_split_that_raises_returns_the_rest_of_the_batch():
    """A sub-run of the split that raises (here the nominated-node path,
    made to refuse) pushes its own pod back; the split pushes back the pods
    it had not reached, and the placements committed before the raise are
    bound.  The next drain schedules the rest."""
    T, _ = PORT_API
    side = Side(PORT_API, batch_size=16)
    side.s.on_node_add(make_node(PORT_API, "node-0"))
    for i in range(3):
        side.s.on_pod_add(vol_pod(PORT_API, f"a{i}", priority=200))
        side.s.on_pod_add(vol_pod(PORT_API, f"b{i}", priority=50))
    nom = vol_pod(PORT_API, "nom", priority=100)
    nom.nominated_node_name = "node-0"
    side.s.on_pod_add(nom)
    real = side.s._schedule_one_nominated

    def refuse(profile, qp):
        side.s._refuse([qp], "refused for the test")

    side.s._schedule_one_nominated = refuse
    with pytest.raises(NotImplementedError, match="refused for the test"):
        side.s.schedule_pending()
    assert sorted(side.bindings) == ["a0", "a1", "a2"]
    assert len(side.s.queue) == 4
    side.s._schedule_one_nominated = real
    out = side.s.schedule_pending()
    assert sorted(o.pod.name for o in out if o.node) == ["b0", "b1", "b2", "nom"]
    assert sorted(side.bindings) == ["a0", "a1", "a2", "b0", "b1", "b2", "nom"]


def test_claim_being_deleted_fails_at_prefilter():
    """A bound claim with a deletion timestamp: VolumeBinding's PreFilter
    rejects the pod unresolvably inside the workloads dispatch (no
    PostFilter), beside a pod that places."""

    def scenario(api, side):
        side.s.on_node_add(make_node(api, "node-0"))
        side.bound_claim("ok", zone_affinity(api, "zone-a"))
        pvc = side.bound_claim("gone")
        dying = copy.deepcopy(pvc)
        dying.deletion_timestamp = 5.0
        dying.resource_version = 1
        side.pvc_update(pvc, dying)
        side.s.on_pod_add(vol_pod(api, "keeps", "ok"))
        side.s.on_pod_add(vol_pod(api, "doomed", "gone", priority=10))

    history, _ = run_twins(scenario, (0.0,), batch_size=128)
    assert "being deleted" in outcome_of(history, 0, "doomed")[2]
    assert outcome_of(history, 0, "keeps")[1] == "node-0"


def test_empty_dir_pods_take_the_fast_path():
    """Volumes no host Filter acts on (emptyDir, configMap) leave a pod on
    the signature fast path, as tests/test_volume_plugins.py's
    test_volumeless_batch_keeps_fast_path has it for volume-less pods."""

    def scenario(api, side):
        T, _ = api
        for i in range(4):
            side.s.on_node_add(make_node(api, f"node-{i}"))
        for i in range(8):
            side.s.on_pod_add(T.Pod(name=f"e{i}", containers=[T.Container(name="c", requests={"cpu": "100m"})],
                                    volumes=(T.Volume(name="scratch"),)))

    history, (jside, pside) = run_twins(scenario, (0.0,), batch_size=16)
    assert all(o[1] is not None for o in history[0]["outcomes"])
    assert pside.s.metrics["fast_batches"] >= 1 and jside.s.metrics["fast_batches"] >= 1
    assert pside.s.metrics["workload_batches"] == 0


# ---- what the slice does not cover ----------------------------------------------


def _refusal_world(side, reason):
    api, T, st = side.api, side.api[0], side.st
    side.s.on_node_add(make_node(api, "node-0"))
    side.bound_claim("good", zone_affinity(api, "zone-a"))
    side.s.on_pod_add(vol_pod(api, "fine", "good"))
    if reason == "missing-pvc":
        pod = vol_pod(api, "odd", "nope")
    elif reason == "unbound":
        side.pvc_add(st.PersistentVolumeClaim(name="loose", request=10, storage_class_name="std"))
        pod = vol_pod(api, "odd", "loose")
    elif reason == "wait-for-first-consumer":
        side.sc_add(st.StorageClass(name="wffc", volume_binding_mode=st.BINDING_WAIT_FOR_FIRST_CONSUMER))
        side.pvc_add(st.PersistentVolumeClaim(name="late", request=10, storage_class_name="wffc"))
        pod = vol_pod(api, "odd", "late")
    elif reason == "missing-pv":
        side.pvc_add(st.PersistentVolumeClaim(name="orphan", request=10, storage_class_name="std",
                                              volume_name="pv-gone", phase=st.PVC_BOUND))
        pod = vol_pod(api, "odd", "orphan")
    elif reason == "read-write-once-pod":
        side.bound_claim("rwop", access=("ReadWriteOncePod",))
        pod = vol_pod(api, "odd", "rwop")
    elif reason == "inline-disk":
        pod = T.Pod(name="odd", containers=[T.Container(name="c")],
                    volumes=(T.Volume(name="d", source_kind="gce-pd", source_id="disk-1"),))
    elif reason == "csi-with-csinode":
        side.csinode_add(st.CSINode(name="node-0", drivers=(st.CSINodeDriver(name="csi.example", allocatable_count=4),)))
        pod = vol_pod(api, "odd", "good")
    elif reason == "host-ports":
        pod = T.Pod(name="odd", volumes=(T.Volume(name="v", pvc_name="good"),), containers=[T.Container(
            name="c", ports=(T.ContainerPort(container_port=80, host_port=8080),))])
    else:  # gang-dispatch-off
        pod = vol_pod(api, "odd", "good")
    side.s.on_pod_add(pod)


@pytest.mark.parametrize("reason", ["missing-pvc", "unbound", "wait-for-first-consumer", "missing-pv",
                                    "read-write-once-pod", "inline-disk", "csi-with-csinode", "host-ports",
                                    "gang-dispatch-off"])
def test_uncovered_volume_pods_are_refused(reason):
    """Each pod shape the reference sends down its host-veto split path
    raises NotImplementedError naming ROADMAP A6b; the popped batch goes back
    to the queue unscheduled, with nothing bound."""
    cfg = {"gang_dispatch": False} if reason == "gang-dispatch-off" else {}
    side = Side(PORT_API, **cfg)
    _refusal_world(side, reason)
    with pytest.raises(NotImplementedError, match="A6b"):
        side.s.schedule_pending()
    assert len(side.s.queue) == 2 and not side.bindings


def test_volume_drain_delta_sync_matches_full_upload():
    """Every workloads batch syncs the resident snapshot; a delta sync copies
    its changed row ranges (usage rows, appended placed pods and their terms)
    into the resident tensors.  After
    a drain of volume pods and spread pods in four batches, the synced
    DeviceCluster equals a fresh full upload, field for field."""
    from kubernetes_tpu_torch.ops.common import DeviceCluster
    from tests.test_torch_chain import _leaves, _np

    T, _ = PORT_API
    side = Side(PORT_API, batch_size=16)
    side.s.mirror.e_cap_hint = 256
    side.s.mirror._m_cap_max = 256
    for i in range(12):
        side.s.on_node_add(make_node(PORT_API, f"node-{i}", zone=f"zone-{i % 3}"))
    for i in range(40):
        side.bound_claim(f"d{i}", zone_affinity(PORT_API, f"zone-{i % 3}"))
        term = T.PodAffinityTerm(label_selector=T.LabelSelector(match_labels={"app": f"a{i % 4}"}),
                                 topology_key="kubernetes.io/hostname")
        side.s.on_pod_add(vol_pod(PORT_API, f"v{i}", f"d{i}", labels={"app": f"a{i % 4}"}, affinity=T.Affinity(
            pod_anti_affinity=T.PodAntiAffinity(required_during_scheduling_ignored_during_execution=(term,)))))
    for i in range(24):
        side.s.on_pod_add(vol_pod(PORT_API, f"p{i}"))
    out = side.s.schedule_pending()
    cache = side.s._dc_cache
    assert side.s.metrics["workload_batches"] >= 3 and cache.delta_syncs >= 2
    assert sum(o.node is not None for o in out) > 40
    m = side.s.mirror
    synced = cache.sync(m, m.vocab)
    fresh = DeviceCluster.from_host(m.nodes, m.vocab, "cpu", m.existing)
    got = _leaves(synced)
    for name, v in _leaves(fresh).items():
        assert np.array_equal(_np(v), _np(got[name])), name
