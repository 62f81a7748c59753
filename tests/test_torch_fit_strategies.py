"""NodeResourcesFit's scoring strategies: the port against the JAX package.

Module level, on the reference-packed inputs of tests/test_torch_wave.py
(tests/gen.py seed 43: 12 nodes, 24 pending pods with spread, inter-pod
terms, host ports and taints; the statics as in
tests/test_torch_sampling.py): the plain gang_schedule and wave_schedule
under MostAllocated and under RequestedToCapacityRatio with a three-point
shape, and the plain workloads_schedule (gang rows of
tests/test_torch_workloads.py) under MostAllocated, against the JAX roots
output for output; the port oracle's MostAllocated, broken-linear and
RequestedToCapacityRatio scorers against the reference oracle's.

Scheduler level: the port's Scheduler (device="cpu") against the JAX
Scheduler on the cases of tests/test_fit_strategies.py (the placements and
the route counts), including the strategies that weigh an extended
resource, which score on the host's one-pod cycle, and a drain whose
batches take the direct and the chained scan under the strategy.  Every output is an
integer: the tolerance is zero.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from kubernetes_tpu.framework import config as j_cfg
from kubernetes_tpu.observability import kernels as j_kernels
from kubernetes_tpu.ops import coscheduling as j_cos
from kubernetes_tpu.ops import gang as j_gang
from kubernetes_tpu.ops import wave as j_wave
from kubernetes_tpu.oracle import scores as j_scores
from kubernetes_tpu.oracle.state import OracleState as JState
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch.framework import config as p_cfg
from kubernetes_tpu_torch.ops import coscheduling as p_cos
from kubernetes_tpu_torch.ops import gang as p_gang
from kubernetes_tpu_torch.ops import wave as p_wave
from kubernetes_tpu_torch.oracle import scores as p_scores
from kubernetes_tpu_torch.oracle.state import OracleState as PState
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from tests.gen import make_cluster, make_pod
from tests.test_torch_sampling import packed, to_port
from tests.test_torch_wave import OUT_NAMES, _outputs, assert_same
from tests.test_torch_workloads import OUT_NAMES as WL_NAMES
from tests.test_torch_workloads import WT, _gang_kw, lay_gangs
from tests.test_torch_workloads import _outputs as wl_outputs

CASE = ("gen", 43, 12, 24, 24)
SHAPE3 = ((0, 0), (40, 80), (100, 30))
STRATEGIES = {"most": (1, (), (1, 1)), "rtcr": (2, SHAPE3, (2, 1))}


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_gang_and_wave_strategies_match_reference(strategy):
    fs = STRATEGIES[strategy]
    pk = packed(CASE)
    chosen, n_feas, rc, tallies = j_gang.gang_schedule(pk.jdc, pk.jdb, pk.g, pk.v_cap, d_cap=pk.d_cap,
                                                       fit_strategy=fs)
    got = p_gang.gang_schedule(pk.pdc, pk.pdb, pk.pg, pk.v_cap, d_cap=pk.d_cap, fit_strategy=fs)
    for w, o, name in zip((chosen, n_feas, rc, tallies["requested"]), got[:3] + (got[3]["requested"],),
                          OUT_NAMES[:4]):
        assert_same(w, o, "gang " + name)
    want = j_wave.wave_schedule(pk.jdc, pk.jdb, pk.g, pk.jhk, pk.v_cap, *pk.wave_args(pk.wt), **pk.wave_kw(pk.wt),
                                fit_strategy=fs)
    gotw = p_wave.wave_schedule(pk.pdc, pk.pdb, pk.pg, pk.hk, pk.v_cap, *pk.wave_args(pk.pwt),
                                **pk.wave_kw(pk.pwt), fit_strategy=fs)
    for w, o, name in zip(_outputs(want), _outputs(gotw), OUT_NAMES):
        assert_same(w, o, "wave " + name)
    # the strategy moved placements off the default's
    default = p_gang.gang_schedule(pk.pdc, pk.pdb, pk.pg, pk.v_cap, d_cap=pk.d_cap)
    assert not np.array_equal(default[0].numpy(), got[0].numpy())


def test_workloads_most_allocated_matches_reference():
    pk = packed(CASE, has_ports=False)
    g, pg = pk.g, pk.pg
    fs = STRATEGIES["most"]
    arrays = lay_gangs(CASE[1], len(pk.pending), pk.pb.valid.shape[0])
    jg, pgk = _gang_kw(arrays, True), _gang_kw(arrays, False)
    dk = dict(d_cap=pk.d_cap, d2_cap=pk.wt["d2_cap"])
    want = wl_outputs(j_cos.workloads_schedule(pk.jdc, pk.jdb, g, pk.jhk, pk.v_cap, jg.pop("g_cap"),
                                               *[pk.wt[k] for k in WT], **jg, **dk, fit_strategy=fs))
    g_cap = pgk.pop("g_cap")
    got = wl_outputs(p_cos.workloads_schedule(pk.pdc, pk.pdb, pg, pk.hk, pk.v_cap, g_cap, *[pk.pwt[k] for k in WT],
                                              **pgk, **dk, fit_strategy=fs))
    for w, o, name in zip(want, got, WL_NAMES):
        assert_same(w, o, name)


def test_oracle_scorers_match_reference():
    """score_most_allocated, broken_linear and
    score_requested_to_capacity_ratio (two shapes, default and weighted
    resources) on seeded nodes with placed pods, for seeded pods."""
    rng = random.Random(7)
    nodes, placed = make_cluster(rng, 16, 40)
    pods = [make_pod(rng, f"q-{i}") for i in range(12)]
    js = JState.build(nodes, placed)
    ps = PState.build([to_port(n) for n in nodes], [to_port(p) for p in placed])
    shapes = (SHAPE3, ((0, 100), (100, 0)), ((10, 0), (20, 50), (90, 70), (95, 100)))
    for x in range(-10, 120, 3):
        for sh in shapes:
            assert p_scores.broken_linear(sh, x) == j_scores.broken_linear(sh, x)
    for res in ((("cpu", 1), ("memory", 1)), (("cpu", 3), ("memory", 1), ("ephemeral-storage", 2))):
        for pod in pods:
            pp = to_port(pod)
            for name in js.nodes:
                jn, pn = js.nodes[name], ps.nodes[name]
                assert p_scores.score_most_allocated(pp, pn, res) == j_scores.score_most_allocated(pod, jn, res)
                for sh in shapes:
                    assert (p_scores.score_requested_to_capacity_ratio(pp, pn, sh, res)
                            == j_scores.score_requested_to_capacity_ratio(pod, jn, sh, res))


ROUTES = ("scan_batches", "wave_batches", "chain_batches", "fast_batches", "resident_batches")


def _sched_pair(pc):
    js = JScheduler(j_cfg.SchedulerConfiguration(kernel_ledger=False,
                                                 profiles=[j_cfg.Profile(plugin_config={"NodeResourcesFit": pc})]))
    j_kernels.deactivate()
    ps = PScheduler(p_cfg.SchedulerConfiguration(profiles=[p_cfg.Profile(plugin_config={"NodeResourcesFit": pc})]),
                    device="cpu")
    return js, ps


def _run(sched, nodes, placed, pending):
    got = {}
    sched.binding_sink = lambda pod, node: got.__setitem__(pod.name, node)
    for n in nodes:
        sched.on_node_add(n)
    for p in placed + pending:
        sched.on_pod_add(p)
    outs = sched.schedule_pending()
    return {o.pod.name: o.node for o in outs}


def _two_nodes():
    """tests/test_fit_strategies.py _add_nodes: n0 pre-loaded, n1 empty."""
    from kubernetes_tpu.api.resource import Resource
    from kubernetes_tpu.api.types import Container, Node, Pod

    nodes = [Node(name=n, labels={"kubernetes.io/hostname": n},
                  capacity=Resource.from_map({"cpu": "4", "memory": "8Gi"})) for n in ("n0", "n1")]
    placed = [Pod(name="preload", node_name="n0", containers=[Container(requests={"cpu": "2", "memory": "4Gi"})])]
    pending = [Pod(name="p", containers=[Container(requests={"cpu": "500m", "memory": "512Mi"})])]
    return nodes, placed, pending


def _gpu_nodes(want_cpu: bool):
    """tests/test_fit_strategies.py TestExtendedResourceScoring's cluster."""
    from kubernetes_tpu.api.resource import Resource
    from kubernetes_tpu.api.types import Container, Node, Pod

    nodes, placed = [], []
    for name, used in (("g0", 6), ("g1", 1)):
        nodes.append(Node(name=name, labels={"kubernetes.io/hostname": name},
                          capacity=Resource.from_map({"cpu": "16", "memory": "64Gi", "example.com/gpu": 8})))
        placed += [Pod(name=f"f-{name}-{v}", node_name=name, containers=[Container(requests={"example.com/gpu": 1})])
                   for v in range(used)]
    req = {"cpu": "100m", "memory": "64Mi", "example.com/gpu": 1} if want_cpu else {"example.com/gpu": 1}
    return nodes, placed, [Pod(name="want-gpu", containers=[Container(requests=req)])]


SHAPE_UP = [{"utilization": 0, "score": 0}, {"utilization": 100, "score": 10}]
SHAPE_DOWN = [{"utilization": 0, "score": 10}, {"utilization": 100, "score": 0}]
SCHED_CASES = {
    "most_allocated_packs": ({"scoringStrategy": {"type": "MostAllocated"}}, _two_nodes, "n0"),
    "least_allocated_spreads": ({"scoringStrategy": {"type": "LeastAllocated"}}, _two_nodes, "n1"),
    "rtcr_shape_packs": ({"scoringStrategy": {"type": "RequestedToCapacityRatio",
                                              "requestedToCapacityRatio": {"shape": SHAPE_UP}}}, _two_nodes, "n0"),
    "rtcr_shape_spreads": ({"scoringStrategy": {"type": "RequestedToCapacityRatio",
                                                "requestedToCapacityRatio": {"shape": SHAPE_DOWN}}}, _two_nodes, "n1"),
    "gpu_most_allocated": ({"scoringStrategy": {"type": "MostAllocated",
                                                "resources": [{"name": "example.com/gpu", "weight": 5}]}},
                           lambda: _gpu_nodes(True), "g0"),
    "gpu_least_allocated": ({"scoringStrategy": {"type": "LeastAllocated",
                                                 "resources": [{"name": "example.com/gpu", "weight": 5}]}},
                            lambda: _gpu_nodes(False), "g1"),
}


@pytest.mark.parametrize("case", list(SCHED_CASES))
def test_scheduler_fit_strategies_match_reference(case):
    pc, world, node = SCHED_CASES[case]
    js, ps = _sched_pair(pc)
    want = _run(js, *world())
    nodes, placed, pending = world()
    got = _run(ps, [to_port(n) for n in nodes], [to_port(p) for p in placed], [to_port(p) for p in pending])
    assert got == want
    assert got[pending[0].name] == node
    for r in ROUTES:
        assert ps.metrics[r] == js.metrics.get(r, 0), r
    host_scored = "resources" in pc["scoringStrategy"]
    assert ps.profiles["default-scheduler"].fit_plugin().device_score is not host_scored
    assert (ps.metrics["host_cycles"] > 0) == host_scored
    default = pc["scoringStrategy"]["type"] == "LeastAllocated" and not host_scored
    assert (ps.metrics["fast_batches"] > 0) == default


def test_scheduler_strategy_drain_matches_reference():
    """A drain of resource-only pods (three cpu / memory mixes) under a
    weighted MostAllocated on seeded nodes with placed pods: the first batch
    takes the direct gang_run, the next ones the chained scan, both with
    the strategy (the fast path takes none of it, as in the reference)."""
    from kubernetes_tpu.api.types import Container, Pod

    rng = random.Random(17)
    nodes, placed = make_cluster(rng, 16, 20)
    pending = [Pod(name=f"m-{i}", containers=[Container(requests={
        "cpu": f"{rng.choice([100, 500, 1000])}m", "memory": f"{rng.choice([128, 512, 1024])}Mi"})])
        for i in range(24)]
    pc = {"scoringStrategy": {"type": "MostAllocated", "resources": [{"name": "cpu", "weight": 2},
                                                                    {"name": "memory", "weight": 1}]}}
    js, ps = _sched_pair(pc)
    js.config.batch_size = ps.config.batch_size = 8
    want = _run(js, nodes, placed, pending)
    got = _run(ps, [to_port(n) for n in nodes], [to_port(p) for p in placed], [to_port(p) for p in pending])
    assert got == want
    for r in ROUTES:
        assert ps.metrics[r] == js.metrics.get(r, 0), r
    assert ps.metrics["fast_batches"] == 0 and ps.metrics["scan_batches"] == 1 and ps.metrics["chain_batches"] == 2


def test_profile_validation_matches_reference():
    """The args' validation: an unknown strategy, a shape out of range or
    not increasing, and percentages out of [0, 100] raise in both."""
    bad = [
        {"scoringStrategy": {"type": "Nope"}},
        {"scoringStrategy": {"type": "RequestedToCapacityRatio",
                             "requestedToCapacityRatio": {"shape": [{"utilization": 50, "score": 1},
                                                                    {"utilization": 50, "score": 2}]}}},
        {"scoringStrategy": {"type": "RequestedToCapacityRatio",
                             "requestedToCapacityRatio": {"shape": [{"utilization": 0, "score": 11}]}}},
        {"scoringStrategy": {"type": "RequestedToCapacityRatio",
                             "requestedToCapacityRatio": {"shape": [{"utilization": 101, "score": 1}]}}},
    ]
    for pc in bad:
        with pytest.raises(ValueError):
            JScheduler(j_cfg.SchedulerConfiguration(kernel_ledger=False,
                                                    profiles=[j_cfg.Profile(plugin_config={"NodeResourcesFit": pc})]))
        with pytest.raises(ValueError):
            PScheduler(p_cfg.SchedulerConfiguration(profiles=[p_cfg.Profile(plugin_config={"NodeResourcesFit": pc})]),
                       device="cpu")
    for kw in (dict(percentage_of_nodes_to_score=101), dict(percentage_of_nodes_to_score=-1)):
        with pytest.raises(ValueError):
            j_cfg.SchedulerConfiguration(**kw).validate()
        with pytest.raises(ValueError):
            p_cfg.SchedulerConfiguration(**kw).validate()
    with pytest.raises(ValueError):
        p_cfg.SchedulerConfiguration(profiles=[p_cfg.Profile(percentage_of_nodes_to_score=120)]).validate()
    with pytest.raises(ValueError, match="plugin args"):
        p_cfg.SchedulerConfiguration(profiles=[p_cfg.Profile(plugin_config={"InterPodAffinity": {}})]).validate()
    assert jnp.asarray(0) == 0  # jax stays importable beside the port
