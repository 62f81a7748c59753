"""The independent pipeline, module level: the port's all_masks, all_scores,
pipeline_plain, the statics route (precompute, explain_stack,
pipeline_score) and schedule_independent against the JAX package's
filters, scores and ``_pipeline``.

Inputs are tests/test_kernels.py's (seeded clusters of tests/gen.py with
hard spread, inter-pod terms, ports, taints, images and preferred node
affinity) and the three tests/test_resources_edge.py cases, packed by the
reference and carried across by kubernetes_tpu_torch.convert, or packed by
the port itself from the same objects.  The port runs its plain versions on
the CPU.  Every output is an integer or a bool, so the tolerance is zero.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api.resource import Resource as JResource
from kubernetes_tpu.api.types import Container as JContainer
from kubernetes_tpu.api.types import Node as JNode
from kubernetes_tpu.api.types import Pod as JPod
from kubernetes_tpu.observability import kernels as j_kernels
from kubernetes_tpu.oracle.scores import HOSTNAME_LABEL
from kubernetes_tpu.oracle.state import OracleState
from kubernetes_tpu.ops import filters as JF
from kubernetes_tpu.ops import gang as j_gang
from kubernetes_tpu.ops import scores as JS
from kubernetes_tpu.ops.common import DeviceBatch as JBatch
from kubernetes_tpu.ops.common import DeviceCluster as JCluster
from kubernetes_tpu.ops.common import I32 as J_I32
from kubernetes_tpu.ops.pipeline import _pipeline as j_pipeline
from kubernetes_tpu.ops.pipeline import batch_feature_flags as j_flags
from kubernetes_tpu.ops.pipeline import schedule_independent as j_schedule_independent
from kubernetes_tpu.snapshot.cluster import pack_cluster
from kubernetes_tpu.snapshot.interner import Vocab
from kubernetes_tpu.snapshot.schema import bucket_cap, pack_pod_batch
from kubernetes_tpu.snapshot.selectors import METADATA_NAME_KEY
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import explain as p_explain
from kubernetes_tpu_torch.ops import filters as PF
from kubernetes_tpu_torch.ops import gang as p_gang
from kubernetes_tpu_torch.ops import pipeline as p_pipeline
from kubernetes_tpu_torch.ops import scores as PS
from tests.gen import make_cluster, make_pod
from tests.test_kernels import NS_LABELS

# the reference's functions jitted as _pipeline jits them (eager dispatch of
# their per-slot loops is slow)
j_all_masks = jax.jit(JF.all_masks, static_argnames=("v_cap", "has_interpod", "has_spread", "enabled"))
j_all_scores = jax.jit(JS.all_scores, static_argnames=("v_cap", "weights", "has_images"))

MASK_KEYS = ("NodeName", "NodeUnschedulable", "TaintToleration", "NodeAffinity", "NodePorts", "NodeResourcesFit",
             "InterPodAffinity", "PodTopologySpread", "_combined")
RESULT_KEYS = ("chosen", "feasible", "totals", "n_feasible")


class Packed:
    """One (cluster, batch) pair packed by the reference, on both sides."""

    def __init__(self, state, pending):
        j_kernels.deactivate()
        self.state, self.pending = state, pending
        self.vocab = vocab = Vocab()
        self.pc = pc = pack_cluster(state, vocab, pending_pods=pending)
        self.pb = pack_pod_batch(pending, vocab, k_cap=pc.nodes.k_cap, namespace_labels=state.namespace_labels)
        self.v_cap = bucket_cap(len(vocab.label_vals))
        self.hk = vocab.label_keys.lookup(HOSTNAME_LABEL)
        self.flags = j_flags(pc, self.pb)
        self.jdc = JCluster.from_host(pc.nodes, pc.existing, vocab)
        self.jdb = JBatch.from_host(self.pb)
        self.pdc = convert.cluster_from_numpy(
            pc.nodes, name_key=vocab.label_keys.lookup(METADATA_NAME_KEY),
            unsched_key=vocab.label_keys.lookup("node.kubernetes.io/unschedulable"),
            empty_val=vocab.label_vals.lookup(""), device="cpu", ep=pc.existing)
        self.pdb = convert.batch_from_numpy(self.pb, "cpu")
        self.tables = p_gang.batch_tables(self.pb.tsc_topo_key, self.pb.aff_topo_key, pc.nodes.label_vals, self.hk)

    def reference(self):
        has_interpod, has_spread, has_images, _ = self.flags
        return j_pipeline(self.jdc, self.jdb, jnp.asarray(self.hk, J_I32), self.v_cap, has_interpod=has_interpod,
                          has_spread=has_spread, has_images=has_images)


def kernels_case(seed, n_nodes=12, n_placed=24, n_pending=16):
    """tests/test_kernels.py build()."""
    rng = random.Random(seed)
    nodes, placed = make_cluster(rng, n_nodes, n_placed)
    state = OracleState.build(nodes, placed, namespace_labels=NS_LABELS)
    pending = [make_pod(rng, f"pend-{i}", hard=True) for i in range(n_pending)]
    return Packed(state, pending)


def _edge_unknown_lane():
    nodes = [JNode(name="n0", capacity=JResource.from_map({"cpu": "4", "memory": "8Gi", "example.com/gpu": 2}))]
    pods = [JPod(name="p", containers=[JContainer(requests={"cpu": "1", "vendor.com/fpga": 1})]),
            JPod(name="p2", containers=[JContainer(requests={"cpu": "1", "example.com/gpu": 1})])]
    return nodes, pods, ()


def _edge_zero_request():
    nodes = [JNode(name="n0", capacity=JResource.from_map({"cpu": "1", "memory": "1Gi"}))]
    hog = JPod(name="hog", node_name="n0", containers=[JContainer(requests={"cpu": "1", "memory": "1Gi"})])
    pods = [JPod(name="empty"), JPod(name="nz", containers=[JContainer(requests={"cpu": "100m"})])]
    return nodes, pods, (hog,)


def _edge_multi_tib():
    nodes = [JNode(name="big", capacity=JResource.from_map({"cpu": "64", "memory": "4Ti"}))]
    pods = [JPod(name="p", containers=[JContainer(requests={"cpu": "1", "memory": "1Ti"})])]
    return nodes, pods, ()


EDGE_CASES = {"unknown-lane": _edge_unknown_lane, "zero-request": _edge_zero_request, "multi-tib": _edge_multi_tib}


def edge_case(name):
    nodes, pods, placed = EDGE_CASES[name]()
    return Packed(OracleState.build(nodes, placed), pods)


_CACHE = {}


def case(key):
    if key not in _CACHE:
        _CACHE[key] = edge_case(key) if isinstance(key, str) else kernels_case(*key)
    return _CACHE[key]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(want, got, what):
    w, g = np.asarray(want), _np(got)
    assert w.shape == g.shape, f"{what}: shape {g.shape} != {w.shape}"
    assert w.dtype == g.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    assert np.array_equal(w, g), f"{what}: {np.argwhere(w != g)[:5].tolist()}"


def assert_result(want, got, what):
    for k in RESULT_KEYS:
        assert_same(getattr(want, k), getattr(got, k), f"{what} {k}")


SCORE_SEEDS = [(11,), (12,), (13,)]
DECISION_SEEDS = [(21, 16, 40, 24), (22, 16, 40, 24), (23, 16, 40, 24), (24, 16, 40, 24)]


@pytest.mark.parametrize("key", SCORE_SEEDS, ids=lambda k: f"seed{k[0]}")
def test_all_masks_match_reference(key):
    """Every plugin mask and the AND, key for key, and the inter-pod and
    spread state they share with the scores."""
    pk = case(key)
    want = j_all_masks(pk.jdc, pk.jdb, pk.v_cap)
    got = PF.all_masks(pk.pdc, pk.pdb, pk.v_cap)
    assert set(got) == set(want)
    for k in MASK_KEYS:
        assert_same(want[k], got[k], k)
    for k in ("_interpod_pre", "_spread_pre"):
        for f in type(want[k])._fields:
            assert_same(getattr(want[k], f), getattr(got[k], f), f"{k}.{f}")


@pytest.mark.parametrize("key", SCORE_SEEDS, ids=lambda k: f"seed{k[0]}")
def test_all_scores_match_reference(key):
    """The weighted total and each plugin's normalized score, key for key,
    over the reference's own feasible mask; and with the constraint state
    dropped (the has_* flags off)."""
    pk = case(key)
    jm = j_all_masks(pk.jdc, pk.jdb, pk.v_cap)
    pm = PF.all_masks(pk.pdc, pk.pdb, pk.v_cap)
    for drop in (False, True):
        ji, js = (None, None) if drop else (jm["_interpod_pre"], jm["_spread_pre"])
        pi, ps = (None, None) if drop else (pm["_interpod_pre"], pm["_spread_pre"])
        want_total, want_per = j_all_scores(pk.jdc, pk.jdb, jm["_combined"], ji, js, pk.v_cap,
                                             jnp.asarray(pk.hk, J_I32))
        got_total, got_per = PS.all_scores(pk.pdc, pk.pdb, pm["_combined"], pi, ps, pk.v_cap, pk.hk)
        assert set(got_per) == set(want_per)  # (jit returns the dict with its keys sorted)
        for k in want_per:
            assert_same(want_per[k], got_per[k], f"{k} drop={drop}")
        assert_same(want_total, got_total, f"total drop={drop}")


@pytest.mark.parametrize("key", SCORE_SEEDS + DECISION_SEEDS + list(EDGE_CASES),
                         ids=lambda k: k if isinstance(k, str) else f"seed{k[0]}")
def test_pipeline_matches_reference(key):
    """pipeline_plain (the reference's formulas) and pipeline, the statics
    route (precompute, explain_stack's combined mask, pipeline_score; plain
    versions here) against _pipeline: chosen, feasible, totals and
    n_feasible."""
    pk = case(key)
    want = pk.reference()
    has_interpod, has_spread, has_images, _ = pk.flags
    got = p_pipeline.pipeline_plain(pk.pdc, pk.pdb, pk.hk, pk.v_cap, has_interpod, has_spread, has_images)
    assert_result(want, got, "pipeline_plain")
    statics = p_pipeline.pipeline(pk.pdc, pk.pdb, pk.hk, pk.v_cap, has_interpod, has_spread, has_images,
                                  **pk.tables)
    assert_result(want, statics, "statics route")


@pytest.mark.parametrize("key", [(11,), (21, 16, 40, 24)] + list(EDGE_CASES),
                         ids=lambda k: k if isinstance(k, str) else f"seed{k[0]}")
def test_schedule_independent_matches_reference(key):
    """The host wrappers end to end on the same packed snapshot and batch:
    the flags, then the result on the CPU."""
    pk = case(key)
    assert p_pipeline.batch_feature_flags(pk.pc, pk.pb) == pk.flags
    want = j_schedule_independent(pk.pc, pk.pb)
    got = p_pipeline.schedule_independent(pk.pc, pk.pb, device="cpu")
    assert_result(want, got, "schedule_independent")


def test_schedule_independent_edge_decisions():
    """tests/test_resources_edge.py's three verdicts on the port: an
    unadvertised extended resource fits nowhere, an advertised one does; an
    all-zero request fits an overcommitted node, a cpu request does not; a
    4 TiB node takes a 1 TiB pod."""
    got = {k: p_pipeline.schedule_independent(case(k).pc, case(k).pb, device="cpu").chosen.tolist()
           for k in EDGE_CASES}
    assert got == {"unknown-lane": [-1, 0], "zero-request": [0, -1], "multi-tib": [0]}


@pytest.mark.parametrize("key", SCORE_SEEDS + DECISION_SEEDS[:2], ids=lambda k: f"seed{k[0]}")
def test_explain_combined_is_pipeline_feasible(key):
    """With every filter enabled and no host-filter lane, explain's combined
    mask is the pipeline's feasible mask."""
    pk = case(key)
    has_interpod, has_spread, _, has_ports = pk.flags
    t = dict(pk.tables)
    t.pop("d_cap")
    _, combined = p_explain.explain_masks_plain(pk.pdc, pk.pdb, pk.hk, pk.v_cap, has_interpod, has_spread,
                                                has_ports, **t)
    feasible = p_pipeline.pipeline_plain(pk.pdc, pk.pdb, pk.hk, pk.v_cap, has_interpod, has_spread).feasible
    assert_same(feasible.numpy(), combined, "combined")
    assert_same(np.asarray(pk.reference().feasible), combined, "combined vs _pipeline")


def test_pipeline_score_with_one_feasible_node():
    """Pods with exactly one feasible node (the reference's oracle test
    skips their totals): K18's plain version normalizes over that node
    alone and equals all_scores there."""
    pk = case((13,))
    want = pk.reference()
    has_interpod, has_spread, has_images, _ = pk.flags
    # the same pods, each left with only its chosen node
    g = p_gang.precompute(pk.pdc, pk.pdb, pk.hk, pk.v_cap, has_interpod=has_interpod, has_spread=has_spread,
                          has_ports=False, has_images=has_images,
                          **{k: torch.as_tensor(v) for k, v in pk.tables.items() if k != "d_cap"})
    feasible = torch.as_tensor(np.array(want.feasible))
    chosen = torch.as_tensor(np.array(want.chosen)).long()
    keep = torch.zeros_like(feasible)
    rows = torch.nonzero(chosen >= 0)[:, 0]
    keep[rows, chosen[rows]] = True
    one = feasible & keep
    got = p_pipeline.pipeline_score_plain(pk.pdc, pk.pdb, g, one, p_gang.DEFAULT_WEIGHTS, pk.tables["d_cap"])
    jm = j_all_masks(pk.jdc, pk.jdb, pk.v_cap, has_interpod=has_interpod, has_spread=has_spread)
    want_total, _ = j_all_scores(pk.jdc, pk.jdb, jnp.asarray(one.numpy()), jm["_interpod_pre"], jm["_spread_pre"],
                                  pk.v_cap, jnp.asarray(pk.hk, J_I32), has_images=has_images)
    assert_same(np.where(one.numpy(), np.asarray(want_total), 0), got.totals, "one-node totals")
    placed = np.asarray(want.chosen) >= 0
    assert placed.any()
    assert_same(placed.astype(np.int64), got.n_feasible, "n_feasible")
    assert_same(want.chosen, got.chosen, "chosen")
