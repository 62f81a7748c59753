"""The speculative wave end to end: the port's Scheduler under the default
SchedulerConfiguration() against the JAX Scheduler.

Both drain the same workloads to the end with batch_size 256; on the CPU the
port runs its kernels' plain versions, and the JAX scheduler runs with its
dispatch ledger off.  Wave-shaped batches (spread, inter-pod terms, host
ports) take wave_run (the first batch, and every batch with host ports) or
chain_dispatch(wave=True).  Identical, with zero tolerance: placements,
FitErrors and diagnoses, the route counts, wave_batches, wave_pods,
wave_admitted, wave_groups, the conflicts by kind (the reference's
wave_conflicts counter) and the fallbacks by reason (its wave_fallback
counter).  Workloads a, b, e and f of tests/test_torch_scheduler_gang.py,
a one-node host-port race, a duplicated hostname, one shared hard term and
fully disjoint terms.
"""

import pytest

from kubernetes_tpu.ops import wave as j_wave
from kubernetes_tpu_torch.framework.config import SchedulerConfiguration as PConfig
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from tests.test_torch_pack import PORT_API
from tests.test_torch_scheduler_gang import (
    ZONE,
    _pod,
    assert_same_drain,
    basic_nodes,
    run_both,
    workload_a,
    workload_b,
    workload_e,
    workload_f,
)

WAVE = ("wave_batches", "wave_pods", "wave_admitted", "wave_groups")
FALLBACKS = ("dup_hostname", "kill_switch")


def assert_same_wave(js, ps):
    assert {k: ps.metrics[k] for k in WAVE} == {k: js.metrics.get(k, 0) for k in WAVE}
    want = {k: int(js.prom.wave_conflicts.value(kind=k)) for k in j_wave.DEMOTE_KINDS.values()}
    assert ps.metrics["wave_conflicts"] == {k: v for k, v in want.items() if v}
    assert {r: ps.metrics["wave_fallback_" + r] for r in FALLBACKS} == {
        r: int(js.prom.wave_fallback.value(reason=r)) for r in FALLBACKS
    }


@pytest.mark.parametrize(
    "workload,kinds",
    [(workload_a, {"spread"}), (workload_b, {"affinity"}), (workload_e, {"ports"}),
     (workload_f, {"spread", "affinity", "fit"})],
    ids=["a-spread", "b-anti", "e-ports", "f-overfull"],
)
def test_wave_drain_matches_reference(workload, kinds):
    want, got, js, ps = run_both(workload)
    assert_same_drain(want, got, js, ps)
    assert_same_wave(js, ps)
    m = ps.metrics
    assert m["wave_batches"] > 0 and m["scan_batches"] == 0 and m["chain_batches"] == 0
    assert m["wave_pods"] == len(want[0])
    assert kinds <= set(m["wave_conflicts"]), m["wave_conflicts"]
    if workload is workload_f:
        assert len(got[1]) > 100  # most of the overfull feed fails, diagnosed


def _racers(api, n=2):
    """n pods racing one host port on one node."""
    T, _ = api
    port = (T.ContainerPort(container_port=8080, host_port=7777, protocol="TCP"),)
    return [_pod(T, f"racer-{i}", {"app": "race"}, ports=port) for i in range(n)]


def test_port_conflict_demotes_with_ports_kind():
    """Two pods racing one host port on the only node: both speculate onto
    it, the second is demoted with kind ports and stays unschedulable."""
    want, got, js, ps = run_both(lambda api: (basic_nodes(api, 1), [], _racers(api)))
    assert_same_drain(want, got, js, ps)
    assert_same_wave(js, ps)
    assert got[0] == {"racer-0": "node-0", "racer-1": None}
    assert ps.metrics["wave_conflicts"] == {"ports": 1}
    assert ps.metrics["wave_admitted"] == 1


def _dup_hostname(api):
    """Six zone nodes and one more claiming node-0's hostname label, with
    one shared hard spread term over 16 pods."""
    T, R = api
    nodes = basic_nodes(api, 6, zones=3)
    nodes.append(T.Node(name="impostor", labels={ZONE: "zone-0", "kubernetes.io/hostname": "node-0"},
                        capacity=R.Resource.from_map({"cpu": "8", "memory": "32Gi", "pods": 110})))
    return nodes, [], _one_term(api, 16)


def _one_term(api, n):
    T, _ = api
    tsc = T.TopologySpreadConstraint(max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
                                     label_selector=T.LabelSelector(match_labels={"app": "one"}))
    return [_pod(T, f"p{i}", {"app": "one"}, topology_spread_constraints=(tsc,)) for i in range(n)]


def test_duplicate_hostname_falls_back_counted():
    """Two nodes with one hostname label value: the wave's factored counts
    would be wrong, so the batch takes the gang scan, counted under
    dup_hostname, with the reference's placements."""
    want, got, js, ps = run_both(_dup_hostname)
    assert_same_drain(want, got, js, ps)
    assert_same_wave(js, ps)
    assert ps.metrics["wave_batches"] == 0 and ps.metrics["scan_batches"] == 1
    assert ps.metrics["wave_fallback_dup_hostname"] == 1
    assert not ps.mirror.hostnames_unique


@pytest.mark.parametrize("workload", [workload_b, workload_e], ids=["b-anti", "e-ports"])
def test_wave_off_matches_wave_on(workload):
    """The kill switch sends every wave-shaped batch to the gang scan,
    counted under kill_switch, with the same placements and diagnoses."""
    on, on_got, js, ps_on = run_both(workload)
    off, off_got, js_off, ps_off = run_both(workload, wave_dispatch=False)
    assert off_got == on_got
    assert_same_wave(js_off, ps_off)
    assert ps_off.metrics["wave_batches"] == 0
    assert ps_off.metrics["wave_fallback_kill_switch"] == ps_on.metrics["wave_batches"] > 0
    assert ps_on.metrics["wave_fallback_kill_switch"] == 0


def test_one_shared_term_degenerates_to_the_serial_recurrence():
    """All pods share one hard zone term: almost every speculation is
    demoted, and the placements still equal the reference's."""
    want, got, js, ps = run_both(lambda api: (basic_nodes(api, 12, zones=4), [], _one_term(api, 40)))
    assert_same_drain(want, got, js, ps)
    assert_same_wave(js, ps)
    assert ps.metrics["wave_admitted"] <= ps.metrics["wave_pods"] // 2


def _disjoint(api, n=24):
    """Per-pod spread terms and two dedicated nodes per pod: no interaction."""
    T, R = api
    nodes = basic_nodes(api, 2 * n, zones=4)
    for i, node in enumerate(nodes):
        node.labels["slot"] = f"s{i // 2}"
    pods = []
    for i in range(n):
        tsc = T.TopologySpreadConstraint(max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
                                         label_selector=T.LabelSelector(match_labels={"app": f"solo-{i}"}))
        pods.append(_pod(T, f"p{i}", {"app": f"solo-{i}"}, node_selector={"slot": f"s{i}"},
                         topology_spread_constraints=(tsc,)))
    return nodes, [], pods


def test_disjoint_terms_admit_every_pod():
    want, got, js, ps = run_both(_disjoint)
    assert_same_drain(want, got, js, ps)
    assert_same_wave(js, ps)
    assert ps.metrics["wave_admitted"] == ps.metrics["wave_pods"] == 24
    assert ps.metrics["wave_conflicts"] == {}
    assert ps.metrics["wave_groups"] == 24


def test_mirror_hostnames_unique_memoizes():
    """The uniqueness bit is computed once per snapshot lineage; a node
    duplicating a hostname invalidates it."""
    T, R = PORT_API
    s = PScheduler(PConfig(), device="cpu")
    for n in basic_nodes(PORT_API, 4):
        s.on_node_add(n)
    s._repack_mirror()
    assert s.mirror.hostnames_unique
    memo = s.mirror._hostnames_unique_memo
    assert s.mirror.hostnames_unique
    assert s.mirror._hostnames_unique_memo is memo
    s.on_node_add(T.Node(name="dup", labels={"kubernetes.io/hostname": "node-0"},
                         capacity=R.Resource.from_map({"cpu": "8", "memory": "32Gi", "pods": 110})))
    s._repack_mirror()
    assert not s.mirror.hostnames_unique

