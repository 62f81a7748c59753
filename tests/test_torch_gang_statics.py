"""The gang precompute's spread and inter-pod statics (K6's and K7's plain
versions) against the JAX package's precompute, on scenarios the generator
cases of tests/test_torch_gang.py do not reach.

Each scenario is packed once by the reference (pack_cluster,
pack_pod_batch) and carried across by kubernetes_tpu_torch.convert, so both
sides read the same arrays:

  * preferred anti-affinity (negative symmetric weights) beside required
    and preferred affinity, under hard_pod_affinity_weight 0 and 100;
  * placed terms whose pod is invalid or deleting, whose node lacks the
    topology key, or whose key no node carries;
  * terms over the hostname, the zone and the region at once;
  * spread constraints over several keys with the node-affinity and the
    taint inclusion policies both ways, on nodes with taints and without
    some topology labels;
  * several namespaces: term namespace lists, selectors over namespace
    labels and all-namespace terms, and spread counting in the pod's own
    namespace;
  * a planner fork view (ops/counterfactual.py) with gone nodes.

On the CPU the port runs its plain versions; the CUDA kernels are held to
them on the card by tests/test_torch_kernels_cuda.py.  Every field is an
integer or a bool, so the tolerance is zero: all 39 GangStatics fields must
be identical.  The last tests hold DeviceCluster's device leaves dom_size
and dom_off (the per-key domain counts and their prefix sums, which K6's
and K7's wrappers read instead of copying them from the host) to the host
tuple dom_counts, and dom_vals (each domain's label value, which the
kernels read in place of node_labels' node-minor rows) to node_labels,
after the upload and in a fork view.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import kubernetes_tpu.api.types as j_types
from kubernetes_tpu.observability import kernels as j_kernels
from kubernetes_tpu.oracle.scores import HOSTNAME_LABEL
from kubernetes_tpu.oracle.state import OracleState
from kubernetes_tpu.ops import counterfactual as j_cf
from kubernetes_tpu.ops import gang as j_gang
from kubernetes_tpu.ops.common import DeviceBatch as JBatch
from kubernetes_tpu.ops.common import DeviceCluster as JCluster
from kubernetes_tpu.ops.common import I32 as J_I32
from kubernetes_tpu.snapshot.cluster import pack_cluster
from kubernetes_tpu.snapshot.interner import Vocab
from kubernetes_tpu.snapshot.schema import bucket_cap, pack_pod_batch
from kubernetes_tpu.snapshot.selectors import METADATA_NAME_KEY
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import counterfactual as p_cf
from kubernetes_tpu_torch.ops import gang as p_gang
from tests.test_gang import NS_LABELS
from tests.test_torch_gang import assert_same

KEYS = (HOSTNAME_LABEL, chip_smoke.ZONE, chip_smoke.REGION)
SEEDS = [3, 8]


class Scenario:
    """One chip_smoke.statics_world scenario, built with the reference's API
    types and packed by the reference, on both sides (the card's tests
    build the same scenarios with the port's types)."""

    def __init__(self, kind, seed):
        j_kernels.deactivate()
        nodes, placed, pending, mutate = chip_smoke.statics_world(kind, seed, j_types)
        state = OracleState.build(nodes, placed, namespace_labels=NS_LABELS)
        self.vocab = vocab = Vocab()
        pc = pack_cluster(state, vocab, pending_pods=pending)
        self.pb = pack_pod_batch(pending, vocab, k_cap=pc.nodes.k_cap, namespace_labels=NS_LABELS)
        self.nt, self.ep = pc.nodes, pc.existing
        if mutate is not None:
            mutate(self.ep)
        self.v_cap = bucket_cap(len(vocab.label_vals))
        self.hk = vocab.label_keys.lookup(HOSTNAME_LABEL)
        self.jdc = JCluster.from_host(self.nt, self.ep, vocab)
        self.jdb = JBatch.from_host(self.pb)
        self.pdc = convert.cluster_from_numpy(
            self.nt, name_key=vocab.label_keys.lookup(METADATA_NAME_KEY),
            unsched_key=vocab.label_keys.lookup("node.kubernetes.io/unschedulable"),
            empty_val=vocab.label_vals.lookup(""), device="cpu", ep=self.ep)
        self.pdb = convert.batch_from_numpy(self.pb, "cpu")

    def tables(self, label_vals=None):
        lv = self.nt.label_vals if label_vals is None else label_vals
        t = j_gang.batch_tables(self.pb.tsc_topo_key, self.pb.aff_topo_key, lv, self.hk)
        t.pop("d_cap")
        p = p_gang.batch_tables(self.pb.tsc_topo_key, self.pb.aff_topo_key, lv, self.hk)
        p.pop("d_cap")
        return t, p

    def check(self, jdc=None, pdc=None, label_vals=None, hard_pod_affinity_weight=1):
        tj, tp = self.tables(label_vals)
        jdc, pdc = jdc or self.jdc, pdc or self.pdc
        want = j_gang.precompute(jdc, self.jdb, jnp.asarray(self.hk, J_I32), self.v_cap,
                                 hard_pod_affinity_weight=hard_pod_affinity_weight, **tj)
        got = p_gang.precompute(pdc, self.pdb, self.hk, self.v_cap,
                                hard_pod_affinity_weight=hard_pod_affinity_weight, **tp)
        for f in p_gang.GangStatics._fields:
            assert_same(getattr(want, f), getattr(got, f), f)
        return got


_SCENARIOS = {}


def scenario(kind, seed) -> Scenario:
    if (kind, seed) not in _SCENARIOS:
        _SCENARIOS[kind, seed] = Scenario(kind, seed)
    return _SCENARIOS[kind, seed]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("hard_weight", [0, 100])
def test_preferred_anti_affinity_and_hard_weight(hard_weight, seed):
    """Negative symmetric weights of placed preferred anti-affinity terms
    beside required affinity weighted 0 or 100 (ip_sym, ip_sym_w)."""
    sc = scenario("preferred_anti", seed)
    g = sc.check(hard_pod_affinity_weight=hard_weight)
    assert bool((g.ip_sym < 0).any()) and bool(g.ip_viol_existing.any())


@pytest.mark.parametrize("seed", SEEDS)
def test_dead_placed_terms(seed):
    """Placed terms of invalid and deleting pods, of pods on nodes without
    the zone label, and over a key no node carries."""
    sc = scenario("dead_terms", seed)
    assert not sc.ep.valid.all() and sc.ep.deleting.any()
    sc.check()


@pytest.mark.parametrize("seed", SEEDS)
def test_terms_over_three_keys(seed):
    """Placed and own terms over the hostname, the zone and the region."""
    sc = scenario("three_keys", seed)
    used = set(np.asarray(sc.ep.term_topo_key).tolist()) & set(sc.vocab.label_keys.lookup(k) for k in KEYS)
    assert len(used) == 3
    g = sc.check()
    assert bool(g.ip_dom_cnt.any())


@pytest.mark.parametrize("seed", SEEDS)
def test_spread_over_several_keys_and_policies(seed):
    """Two or three spread constraints a pod over the three keys, each with
    its own node-affinity and taint inclusion policy."""
    sc = scenario("spread_keys", seed)
    pol = np.asarray(sc.pb.tsc_honor_taints)[np.asarray(sc.pb.tsc_topo_key) >= 0]
    assert pol.any() and not pol.all()
    g = sc.check()
    assert bool(g.sp_node_cnt.any()) and not bool(g.sp_te.all())


@pytest.mark.parametrize("seed", SEEDS)
def test_namespace_sets(seed):
    """Terms over namespace lists, namespace label selectors and all
    namespaces; spread counts in the pod's own namespace."""
    sc = scenario("namespaces", seed)
    assert bool(np.asarray(sc.ep.term_ns_all).any()) and bool(np.asarray(sc.pb.aff_ns_all).any())
    sc.check()


def _fork(sc, seed):
    """One fork with three gone nodes and the placed pods on them evicted,
    on both sides: the reference's fork_cluster_view and the port's plain
    fork view with its fork DeviceCluster (as counterfactual_run builds
    it)."""
    rng = np.random.default_rng(seed)
    nt = sc.nt
    alive = np.asarray(nt.valid, bool).copy()
    gone = rng.choice(np.nonzero(alive)[0], 3, replace=False)
    alive[gone] = False
    ep_valid = np.asarray(sc.jdc.epod_valid, bool) & ~np.isin(np.asarray(sc.jdc.epod_node), gone)
    planes = dict(fk_alive=alive, fk_unsched=np.asarray(nt.unschedulable, bool),
                  fk_alloc=np.asarray(nt.allocatable, np.int32), fk_req=np.asarray(nt.requested, np.int32),
                  fk_nz=np.asarray(nt.nonzero_req, np.int32), fk_npods=np.asarray(nt.num_pods, np.int32),
                  fk_epod_valid=ep_valid)
    n_valid = int(alive.sum())
    jdc = j_cf.fork_cluster_view(sc.jdc, *(jnp.asarray(planes[k]) for k in (
        "fk_alive", "fk_unsched", "fk_alloc", "fk_req", "fk_nz", "fk_npods", "fk_epod_valid")),
                                 jnp.asarray(n_valid, J_I32))
    stacked = {k: torch.from_numpy(v.copy())[None] for k, v in planes.items()}
    view = p_cf.fork_cluster_view_plain(sc.pdc, stacked["fk_alive"], visit_rank=sc.pdc.visit_rank)
    pdc = p_cf._fork_cluster(sc.pdc, view, stacked, 0, n_valid)
    return jdc, pdc, gone


@pytest.mark.parametrize("seed", SEEDS)
def test_fork_view_with_gone_nodes(seed):
    """A planner fork whose gone nodes lose their labels and domain ids:
    the statics over the fork's cluster (its batch tables from the fork's
    labels) equal the reference's."""
    sc = scenario("three_keys", seed)
    jdc, pdc, gone = _fork(sc, seed)
    assert (pdc.dom_ids[:, torch.from_numpy(gone)] == -1).all()
    sc.check(jdc=jdc, pdc=pdc, label_vals=np.asarray(jdc.node_labels))


def _dom_leaves_match(dc):
    counts = np.asarray(dc.dom_counts, np.int64)
    assert dc.dom_size.dtype == torch.int32 and dc.dom_off.dtype == torch.int32
    assert np.array_equal(dc.dom_size.numpy(), counts)
    assert np.array_equal(dc.dom_off.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    ids, lab = dc.dom_ids.numpy(), dc.node_labels.numpy()
    off, vals = dc.dom_off.numpy(), dc.dom_vals.numpy()
    assert dc.dom_vals.dtype == torch.int32 and vals.shape == (counts.sum(),)
    for k in range(ids.shape[0]):
        # each key's ids number exactly its domains (a fork may leave some
        # unused), and a node's domain carries its label value
        has = ids[k] >= 0
        assert int(ids[k].max(initial=-1)) < counts[k]
        assert np.array_equal(has, lab[:, k] >= 0)
        assert np.array_equal(vals[off[k] + ids[k][has]], lab[has, k])


@pytest.mark.parametrize("seed", SEEDS)
def test_domain_count_leaves_after_upload_and_in_a_fork(seed):
    """DeviceCluster.dom_size / dom_off equal dom_counts and its prefix
    sums, and dom_vals gives each node's label value at its domain, after
    the packed upload (the port's own packers and DeviceCluster.from_host,
    and the reference-packed arrays through convert) and in a fork view,
    which carries the leaves unchanged."""
    import chip_smoke

    from kubernetes_tpu_torch.ops.common import DeviceCluster

    nodes, placed, pending = chip_smoke.gen_cluster(seed, 30, 40, 8)
    pc, _ = chip_smoke.packed_snapshot(nodes, placed, pending, 8)
    dc = DeviceCluster.from_host(pc.nodes, pc.vocab, "cpu", pc.existing)
    assert sum(dc.dom_counts) > 0
    _dom_leaves_match(dc)
    sc = scenario("three_keys", seed)
    _dom_leaves_match(sc.pdc)
    _, pdc, _ = _fork(sc, seed)
    _dom_leaves_match(pdc)
    assert pdc.dom_size is sc.pdc.dom_size and pdc.dom_off is sc.pdc.dom_off and pdc.dom_vals is sc.pdc.dom_vals
