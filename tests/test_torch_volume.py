"""Bound volumes, module level: the port's volume_topology_mask, precompute
with an extra mask, workloads_run with volume arguments, the assume cache,
the four volume plugins and the WorkloadOracle's volume half against the JAX
package's.

Clusters are tests/gen.py's (make_cluster on seeds 41, 42, 43 and 111: zone,
region, hostname, disk and numeric tier labels), packed by the reference and
carried across by kubernetes_tpu_torch.convert.  The volume tables are the
reference scheduler's ``_vol_tables`` packing of seeded bound PVs: node
affinities with In, NotIn, Exists, DoesNotExist, Gt and Lt requirements and
metadata.name terms, zone- and region-labelled PVs (zone sets among them),
nil affinities, several claims per pod, and claims whose PV is missing (the
``vol_bad`` rows).  On the CPU the port runs its plain versions.  Every
output is an integer or a bool, so the tolerance is zero.
"""

import random
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import storage as j_st
from kubernetes_tpu.api import types as j_types
from kubernetes_tpu.framework import volume_plugins as j_vp
from kubernetes_tpu.framework import volumebinding as j_vb
from kubernetes_tpu.framework.interface import CycleState as JCycleState
from kubernetes_tpu.observability import kernels as j_kernels
from kubernetes_tpu.oracle.scores import HOSTNAME_LABEL
from kubernetes_tpu.oracle.state import NodeState as JNodeState
from kubernetes_tpu.oracle.state import OracleState as JOracleState
from kubernetes_tpu.oracle.workloads import WorkloadOracle as JWorkloadOracle
from kubernetes_tpu.ops import coscheduling as j_cos
from kubernetes_tpu.ops import gang as j_gang
from kubernetes_tpu.ops import wave as j_wave
from kubernetes_tpu.ops.common import DeviceBatch as JBatch
from kubernetes_tpu.ops.common import DeviceCluster as JCluster
from kubernetes_tpu.ops.common import I32 as J_I32
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.snapshot.cluster import pack_cluster
from kubernetes_tpu.snapshot.interner import Vocab
from kubernetes_tpu.snapshot.schema import bucket_cap, pack_pod_batch
from kubernetes_tpu.snapshot.selectors import METADATA_NAME_KEY
from kubernetes_tpu.util.assumecache import AssumeCache as JAssumeCache
from kubernetes_tpu.util.assumecache import AssumeCacheError as JAssumeCacheError
from kubernetes_tpu.workloads import gang as j_wlg
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.api import storage as p_st
from kubernetes_tpu_torch.framework import volume_plugins as p_vp
from kubernetes_tpu_torch.framework import volumebinding as p_vb
from kubernetes_tpu_torch.framework.interface import CycleState as PCycleState
from kubernetes_tpu_torch.oracle.state import NodeState as PNodeState
from kubernetes_tpu_torch.oracle.state import OracleState as POracleState
from kubernetes_tpu_torch.oracle.workloads import WorkloadOracle as PWorkloadOracle
from kubernetes_tpu_torch.ops import coscheduling as p_cos
from kubernetes_tpu_torch.ops import gang as p_gang
from kubernetes_tpu_torch.util.assumecache import AssumeCache as PAssumeCache
from kubernetes_tpu_torch.util.assumecache import AssumeCacheError as PAssumeCacheError
from tests.gen import make_cluster, make_pod
from tests.test_torch_pack import JAX_API, PORT_API
from tests.test_torch_wave import assert_same
from tests.test_torch_workloads import OUT_NAMES, WT, _gang_kw, _outputs, lay_gangs
from tests.test_wave import NS_LABELS

SEEDS = [(41, 10, 20, 20), (42, 10, 20, 20), (43, 12, 24, 24), (111, 40, 80, 60)]
ZONE = "topology.kubernetes.io/zone"
REGION = "topology.kubernetes.io/region"
STORAGE = {id(JAX_API): j_st, id(PORT_API): p_st}


def _requirement(api, rng, nodes):
    """One seeded node-selector requirement over the generator's labels."""
    T, _ = api
    op = rng.choice(["In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"])
    if op in ("Gt", "Lt"):
        return T.NodeSelectorRequirement("tier", op, (str(rng.randrange(0, 5)),))
    key = rng.choice([ZONE, REGION, "disk", "tier", HOSTNAME_LABEL])
    if op in ("Exists", "DoesNotExist"):
        return T.NodeSelectorRequirement(key, op, ())
    pool = sorted({n.labels[key] for n in nodes if key in n.labels} | {"absent-value"})
    return T.NodeSelectorRequirement(key, op, tuple(rng.sample(pool, min(len(pool), rng.randint(1, 3)))))


def seeded_volumes(api, seed, nodes, pods):
    """(pvs, pvcs) for ``pods`` (given their claim names here): per pod one
    to three bound claims whose PVs carry a nil affinity, one to two DNF
    terms of one to three requirements, a metadata.name term, zone / region
    labels (zone sets among them), or no PV at all (a vol_bad pod)."""
    T, _ = api
    st = STORAGE[id(api)]
    rng = random.Random(seed)
    pvs, pvcs, claims = {}, {}, []
    for i, pod in enumerate(pods):
        names = []
        for c in range(rng.randint(1, 3)):
            name = f"c{i}-{c}"
            names.append(name)
            kind = rng.random()
            affinity, labels = None, {}
            if kind < 0.15:
                pass  # nil affinity
            elif kind < 0.55:
                terms = tuple(
                    T.NodeSelectorTerm(match_expressions=tuple(_requirement(api, rng, nodes)
                                                               for _ in range(rng.randint(1, 3))))
                    for _ in range(rng.randint(1, 2)))
                affinity = T.NodeSelector(terms)
            elif kind < 0.65:
                picks = tuple(rng.sample([n.name for n in nodes], 3))
                affinity = T.NodeSelector((T.NodeSelectorTerm(
                    match_fields=(T.NodeSelectorRequirement(METADATA_NAME_KEY, "In", picks),)),))
            elif kind < 0.9:
                labels[ZONE] = "__".join(rng.sample(["zone-a", "zone-b", "zone-c", "zone-x"], rng.randint(1, 2)))
                if rng.random() < 0.4:
                    labels[REGION] = rng.choice(["region-1", "region-2"])
                if rng.random() < 0.3:
                    affinity = T.NodeSelector((T.NodeSelectorTerm(match_expressions=(_requirement(api, rng, nodes),)),))
            pvc = st.PersistentVolumeClaim(name=name, request=10, storage_class_name="std", volume_name=f"pv-{name}",
                                           phase=st.PVC_BOUND)
            pvcs[pvc.key] = pvc
            if kind < 0.95:  # else the PV is missing: a vol_bad pod
                pvs[f"pv-{name}"] = st.PersistentVolume(name=f"pv-{name}", capacity=10, storage_class_name="std",
                                                        node_affinity=affinity, labels=labels, phase=st.PV_BOUND)
        claims.append(names)
    return pvs, pvcs, claims


class VolPacked:
    """A tests/gen.py cluster and batch packed by the reference, with seeded
    bound claims on every pending pod and the reference's volume tables."""

    def __init__(self, seed, n_nodes, n_placed, n_pending):
        j_kernels.deactivate()
        rng = random.Random(seed)
        self.nodes, placed = make_cluster(rng, n_nodes, n_placed)
        self.pending = [make_pod(rng, f"pend-{i}") for i in range(n_pending)]
        for p in self.pending:
            for c in p.containers:
                c.ports = ()  # the workloads dispatch admits no host ports
        self.pvs, self.pvcs, claims = seeded_volumes(JAX_API, seed, self.nodes, self.pending)
        for p, names in zip(self.pending, claims):
            p.volumes = tuple(j_types.Volume(name=f"v{k}", pvc_name=n) for k, n in enumerate(names))
        self.state = JOracleState.build(self.nodes, placed, namespace_labels=NS_LABELS)
        vocab = Vocab()
        pc = pack_cluster(self.state, vocab, pending_pods=self.pending)
        self.pb = pack_pod_batch(self.pending, vocab, k_cap=pc.nodes.k_cap, namespace_labels=NS_LABELS)
        self.nt = pc.nodes
        self.v_cap = bucket_cap(len(vocab.label_vals))
        self.hk = vocab.label_keys.lookup(HOSTNAME_LABEL)
        self.jhk = jnp.asarray(self.hk, J_I32)
        tables = j_gang.batch_tables(self.pb.tsc_topo_key, self.pb.aff_topo_key, self.nt.label_vals, self.hk)
        self.d_cap = tables.pop("d_cap")
        self.tables = tables
        self.jdc = JCluster.from_host(self.nt, pc.existing, vocab)
        self.jdb = JBatch.from_host(self.pb)
        self.pdc = convert.cluster_from_numpy(
            self.nt, name_key=vocab.label_keys.lookup(METADATA_NAME_KEY),
            unsched_key=vocab.label_keys.lookup("node.kubernetes.io/unschedulable"),
            empty_val=vocab.label_vals.lookup(""), device="cpu", ep=pc.existing)
        self.pdb = convert.batch_from_numpy(self.pb, "cpu")
        self.wt = j_wave.wave_tables(self.pb, self.nt.label_vals, self.hk)
        self.pwt = convert.wave_tables_from_numpy(self.wt, "cpu")
        # the reference scheduler's packing, on its own caches
        caches = SimpleNamespace(pvc_cache=self.pvcs, pv_cache=self.pvs)
        self.volt = JScheduler._vol_tables(caches, self.pending, self.pb.valid.shape[0], vocab)
        self.pvolt = convert.vol_tables_from_numpy(self.volt, "cpu")


_PACKED = {}


def vol_packed(case) -> VolPacked:
    if case not in _PACKED:
        _PACKED[case] = VolPacked(*case)
    return _PACKED[case]


@pytest.mark.parametrize("case", SEEDS, ids=[f"gen-{c[0]}" for c in SEEDS])
def test_volume_topology_mask_matches_reference(case):
    """K12's plain version and its wrapper against the reference's
    volume_topology_mask; the tables exercised what they are for."""
    pk = vol_packed(case)
    t = pk.volt["vol_table"]
    want = j_cos.volume_topology_mask(pk.jdc, t, pk.volt["vol_valid"], pk.volt["vol_bad"])
    for fn in (p_cos.volume_topology_mask_plain, p_cos.volume_topology_mask):
        got = fn(pk.pdc, pk.pvolt["vol_table"], pk.pvolt["vol_valid"], pk.pvolt["vol_bad"])
        assert_same(want, got, fn.__name__)
    w = np.asarray(want)
    assert np.asarray(pk.volt["vol_bad"]).any() and w.any() and not w[: len(pk.pending)].all()
    assert np.asarray(t.term_valid).any() and (np.asarray(pk.volt["vol_valid"]).sum(axis=1) >= 2).any()


@pytest.mark.parametrize("case", SEEDS[:3], ids=[f"gen-{c[0]}" for c in SEEDS[:3]])
def test_precompute_with_extra_mask_matches_reference(case):
    """precompute with an extra mask: static_mask and d_extra carry it; every
    GangStatics field equals the reference's."""
    pk = vol_packed(case)
    rng = np.random.default_rng(case[0])
    extra = rng.random(pk.jdb.valid.shape + pk.jdc.node_valid.shape) < 0.7
    want = j_gang.precompute(pk.jdc, pk.jdb, pk.jhk, pk.v_cap, extra_mask=jnp.asarray(extra), **pk.tables)
    got = p_gang.precompute(pk.pdc, pk.pdb, pk.hk, pk.v_cap, extra_mask=torch.from_numpy(extra), **pk.tables)
    for f in p_gang.GangStatics._fields:
        assert_same(getattr(want, f), getattr(got, f), f)
    assert not np.asarray(want.d_extra).all()


@pytest.mark.parametrize("case", SEEDS[:3], ids=[f"gen-{c[0]}" for c in SEEDS[:3]])
def test_workloads_run_with_volumes_matches_reference(case):
    """workloads_run with the volume tables, with and without gangs laid
    over the batch, against the reference's, output for output; the volume
    rows reach the host-filter lane of the reason counts."""
    pk = vol_packed(case)
    P = pk.pb.valid.shape[0]
    jw, pw = [pk.wt[k] for k in WT], [pk.pwt[k] for k in WT]
    dk = dict(d_cap=pk.d_cap, d2_cap=pk.wt["d2_cap"])
    for gangs in (False, True):
        arrays = lay_gangs(case[0], len(pk.pending), P) if gangs else j_wlg.gang_arrays(P, {}, {})
        jg, pg = _gang_kw(arrays, True), _gang_kw(arrays, False)
        want = _outputs(j_cos.workloads_run(pk.jdc, pk.jdb, pk.jhk, pk.v_cap, jg.pop("g_cap"), *jw, **jg,
                                            **pk.volt, **pk.tables, **dk))
        got = _outputs(p_cos.workloads_run(pk.pdc, pk.pdb, pk.hk, pk.v_cap, pg.pop("g_cap"), *pw, **pg,
                                           **pk.pvolt, **pk.tables, **dk))
        for w, o, name in zip(want, got, OUT_NAMES):
            assert_same(w, o, f"workloads_run gangs={gangs} {name}")
        lane = p_gang.DIAG_KERNELS.index("HostFilters")
        assert np.asarray(want[2])[:, lane].any()


def test_workload_oracle_volume_half_matches_reference():
    """The serial oracle's volume narrowing (each PV's affinity and zone
    labels) places every pod where the reference's does."""
    for seed in (41, 43):
        rng = random.Random(seed)
        j_nodes, _ = make_cluster(rng, 12, 0)
        pods = [make_pod(rng, f"pend-{i}") for i in range(20)]
        jpvs, jpvcs, claims = seeded_volumes(JAX_API, seed, j_nodes, pods)
        ppvs = {k: convert.pv_from_reference(v) for k, v in jpvs.items()}
        ppvcs = {k: convert.pvc_from_reference(v) for k, v in jpvcs.items()}
        placements = []
        for api, Oracle, State, pvs, pvcs in ((JAX_API, JWorkloadOracle, JOracleState, jpvs, jpvcs),
                                              (PORT_API, PWorkloadOracle, POracleState, ppvs, ppvcs)):
            T, R = api
            nodes = [T.Node(name=n.name, labels=dict(n.labels),
                            capacity=R.Resource.from_map({"cpu": "4", "memory": "8Gi", "pods": 110}))
                     for n in j_nodes]
            batch = [T.Pod(name=p.name, containers=[T.Container(name="c", requests={"cpu": "300m"})],
                           volumes=tuple(T.Volume(name=f"v{k}", pvc_name=c) for k, c in enumerate(names)))
                     for p, names in zip(pods, claims)]
            placements.append(Oracle(State.build(nodes, []), pvs=pvs, pvcs=pvcs).schedule(batch).placements)
        assert placements[0] == placements[1]
        assert any(v is None for v in placements[0].values()) and any(placements[0].values())


# ---- the assume cache -----------------------------------------------------------


@pytest.mark.parametrize("side", ["jax", "port"])
def test_assume_cache_event_vs_assume_ordering(side):
    """tests/test_volume_plugins.py's case on either package: a stale event
    keeps the assumed object, a newer one replaces it, and assume must carry
    the stored resource_version."""
    st, Cache, Err = (j_st, JAssumeCache, JAssumeCacheError) if side == "jax" else (p_st, PAssumeCache,
                                                                                     PAssumeCacheError)
    c = Cache("pv")
    pv = st.PersistentVolume.make("pv-1", "1Gi")
    pv.resource_version = 5
    c.on_add(pv)
    assumed = pv.clone()
    assumed.claim_ref = st.ObjectRef("default", "claim")
    c.assume(assumed)
    assert c.get("pv-1").claim_ref is not None
    stale = pv.clone()
    stale.resource_version = 4
    c.on_add(stale)
    assert c.get("pv-1").claim_ref is not None
    newer = pv.clone()
    newer.resource_version = 6
    c.on_update(pv, newer)
    assert c.get("pv-1").claim_ref is None and c.get_api_obj("pv-1") is newer
    wrong = newer.clone()
    wrong.resource_version = 3
    with pytest.raises(Err):
        c.assume(wrong)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_assume_cache_restore(side):
    st, Cache = (j_st, JAssumeCache) if side == "jax" else (p_st, PAssumeCache)
    c = Cache("pvc")
    pvc = st.PersistentVolumeClaim.make("c1")
    pvc.resource_version = 1
    c.on_add(pvc)
    assumed = pvc.clone()
    assumed.annotations["volume.kubernetes.io/selected-node"] = "node-1"
    c.assume(assumed)
    c.restore(pvc.key)
    assert "volume.kubernetes.io/selected-node" not in c.get(pvc.key).annotations
    c.on_delete(pvc)
    assert c.get(pvc.key) is None and len(c) == 0


# ---- the four plugins ------------------------------------------------------------


class _Handle:
    def __init__(self, pvs, pvcs, classes=(), csinodes=()):
        self.pv_cache = pvs
        self.pvc_cache = pvcs
        self.classes = {c.name: c for c in classes}
        self.csinodes = {c.name: c for c in csinodes}

    def get_storage_class(self, name):
        return self.classes.get(name)

    def get_csinode(self, name):
        return self.csinodes.get(name)


def _plugin_world(api):
    """tests/test_volume_plugins.py's shapes on one package: nodes in two
    zones, a zone-labelled PV (test_volume_zone_conflict), a PV pinned to
    node-3 (test_bound_claim_pv_node_affinity_steers_pod), a ReadWriteOncePod
    claim held by a placed pod, an inline disk in use, a CSINode limiting a
    driver to one volume, an unbound immediate claim and a missing one.
    The storage objects are the reference's, carried into the port's types
    by kubernetes_tpu_torch.convert on the port's side."""
    T, R = api
    J = j_types
    sc = j_st.StorageClass(name="fast")
    pvs = {
        "pv-z": j_st.PersistentVolume.make("pv-z", "10Gi", storage_class_name="fast", labels={ZONE: "z2"},
                                           claim_ref=j_st.ObjectRef("default", "claim-vz")),
        "pv-b": j_st.PersistentVolume.make("pv-b", "10Gi", storage_class_name="fast", csi_driver="csi.example",
                                           node_affinity=J.NodeSelector((J.NodeSelectorTerm(match_fields=(
                                               J.NodeSelectorRequirement("metadata.name", "In", ("node-3",)),)),))),
        "pv-rwop": j_st.PersistentVolume.make("pv-rwop", "10Gi", storage_class_name="fast",
                                              csi_driver="csi.example"),
    }
    pvcs = {}
    for name, pv, modes in (("claim-vz", "pv-z", ("ReadWriteOnce",)), ("claim-b", "pv-b", ("ReadWriteOnce",)),
                            ("claim-rwop", "pv-rwop", ("ReadWriteOncePod",))):
        pvcs[f"default/{name}"] = j_st.PersistentVolumeClaim.make(name, storage_class_name="fast", volume_name=pv,
                                                                  phase=j_st.PVC_BOUND, access_modes=modes)
    pvcs["default/loose"] = j_st.PersistentVolumeClaim.make("loose", storage_class_name="fast")
    st = STORAGE[id(api)]
    csinode = st.CSINode(name="node-3", drivers=(st.CSINodeDriver(name="csi.example", allocatable_count=1),))
    if api is PORT_API:
        pvs = {k: convert.pv_from_reference(v) for k, v in pvs.items()}
        pvcs = {k: convert.pvc_from_reference(v) for k, v in pvcs.items()}
        sc = convert.storage_class_from_reference(sc)
    handle = _Handle(pvs, pvcs, (sc,), (csinode,))

    def node(name, zone):
        return T.Node(name=name, labels={"kubernetes.io/hostname": name, ZONE: zone},
                      capacity=R.Resource.from_map({"cpu": "8", "memory": "16Gi", "pods": 110}))

    def pod(name, *claims, volumes=()):
        return T.Pod(name=name, containers=[T.Container(name="c", requests={"cpu": "100m"})],
                     volumes=tuple(T.Volume(name=f"v-{c}", pvc_name=c) for c in claims) + tuple(volumes))

    disk = T.Volume(name="d", source_kind="gce-pd", source_id="disk-1")
    holder = pod("holder", "claim-rwop", volumes=(disk,))
    holder.node_name = "node-3"
    nodes = [node("node-1", "z1"), node("node-2", "z2"), node("node-3", "z2")]
    pods = [pod("vz", "claim-vz"), pod("b", "claim-b"), pod("rwop", "claim-rwop"), pod("disk", volumes=(disk,)),
            pod("loose", "loose"), pod("nope", "nope"), pod("empty", volumes=(T.Volume(name="scratch"),)),
            pod("csi", "claim-vz", "claim-b")]
    return handle, nodes, holder, pods


def _verdicts(api, pkg):
    handle, nodes, holder, pods = _plugin_world(api)
    vp, vb = pkg
    Node, Cycle = (JNodeState, JCycleState) if api is JAX_API else (PNodeState, PCycleState)
    states = []
    for n in nodes:
        ns = Node(node=n)
        if n.name == holder.node_name:
            ns.add_pod(holder)
        states.append(ns)
    out = []
    for cls in (vp.VolumeRestrictions, vp.NodeVolumeLimits, vb.VolumeBinding, vp.VolumeZone):
        plugin = cls(None, handle) if api is JAX_API else cls(handle)
        for p in pods:
            state = Cycle()
            s = plugin.pre_filter(state, p)
            row = [cls.name, p.name, plugin.maybe_relevant(p), int(s.code), s.reasons]
            if s.code == 0:
                for ns in states:
                    f = plugin.filter(state, p, ns)
                    row.append((ns.node.name, int(f.code), f.reasons))
            out.append(row)
    return out


def test_volume_plugins_match_reference():
    """PreFilter and Filter of VolumeRestrictions, NodeVolumeLimits,
    VolumeBinding and VolumeZone on every node for every pod of the shapes:
    statuses, reasons and relevance equal the reference's.  The zone-
    labelled PV admits only z2's nodes, the pinned PV only node-3, the
    ReadWriteOncePod claim and the inline disk conflict with the holder on
    node-3, node-3's CSINode admits one csi.example volume, and the unbound
    and the missing claims fail PreFilter."""
    want = _verdicts(JAX_API, (j_vp, j_vb))
    got = _verdicts(PORT_API, (p_vp, p_vb))
    assert got == want
    by = {(r[0], r[1]): r for r in got}
    assert [v[1] for v in by[("VolumeZone", "vz")][5:]] == [3, 0, 0]
    assert [v[1] for v in by[("VolumeBinding", "b")][5:]] == [3, 3, 0]
    assert [v[1] for v in by[("VolumeRestrictions", "rwop")][5:]] == [0, 0, 2]
    assert [v[1] for v in by[("NodeVolumeLimits", "csi")][5:]] == [0, 0, 2]
    assert by[("VolumeBinding", "loose")][3] == 3 and by[("VolumeBinding", "nope")][3] == 3
    assert by[("VolumeBinding", "empty")][3] == 5 and not by[("VolumeRestrictions", "empty")][2]


def test_volume_binding_reserve_and_prebind_on_bound_claims():
    """Reserve after a passing Filter records the node, PreBind has nothing
    to bind; Reserve on a node the Filter never passed is an error, as in
    the reference."""
    handle, nodes, _, pods = _plugin_world(PORT_API)
    plugin = p_vb.VolumeBinding(handle)
    pod = next(p for p in pods if p.name == "b")
    state = PCycleState()
    assert plugin.pre_filter(state, pod).ok
    assert plugin.filter(state, pod, PNodeState(node=nodes[2])).ok
    assert plugin.reserve(state, pod, "node-3").ok and plugin.pre_bind(state, pod, "node-3").ok
    assert plugin.reserve(state, pod, "node-1").code == 1
