"""Preemption end to end: the port's Scheduler against the JAX Scheduler.

Both sides run the same scenario round by round on a manual clock (the
scheduling queue's backoff reads it), with ``pod_deleter`` wired to their
own ``on_pod_delete``, as bench.py's bench_preemption wires it.  After every
``schedule_pending`` the round's outcomes (pod → node, and the FitError of
each failure), the open nominations, the evictions in order, the bindings
and the count of preemption attempts must be identical: all are names or
integers, so the tolerance is zero.  On the CPU the port runs its kernels'
plain versions (K10's ``narrow_candidates_plain`` among them); the JAX
scheduler runs with its dispatch ledger off.

Scenarios: every one of tests/test_preemption.py (basic, Never, minimal
victims, lowest-priority victims, fewest PDB violations, lowest highest
victim priority, nominated resources blocking lower-priority pods, not
helpful, batch peers), bench_preemption's shape at 50 nodes, gang-path and
wave-path drains of spread and anti-affinity pods while nominations are
open, and fast-path failures on more than 1,000 potential nodes (which
only an unnarrowed dry run sizes as the reference does).  Also: an eviction
between two chained batches ends the chain, and the next batch sees the
freed capacity.
"""

import pytest

from kubernetes_tpu.framework.config import SchedulerConfiguration as JConfig
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch.framework.config import SchedulerConfiguration as PConfig
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from tests.test_torch_pack import JAX_API, PORT_API
from tests.test_torch_scheduler_gang import anti_pods, basic_nodes, spread_pods


class Side:
    """One scheduler, its manual clock and its recorded side effects."""

    def __init__(self, api, **cfg):
        self.api = api
        self.now = [1000.0]
        clock = lambda: self.now[0]  # noqa: E731
        if api is JAX_API:
            from kubernetes_tpu.observability import kernels

            self.s = JScheduler(JConfig(kernel_ledger=False, **cfg), clock=clock)
            kernels.deactivate()
        else:
            self.s = PScheduler(PConfig(**cfg), device="cpu", clock=clock)
        self.bindings = {}
        self.evictions = []
        self.pdbs = []
        self.s.binding_sink = lambda pod, node: self.bindings.__setitem__(pod.name, node)
        self.s.pod_deleter = self.evict
        self.s.pdb_lister = lambda: list(self.pdbs)

    def evict(self, pod):
        self.evictions.append(pod.name)
        self.s.on_pod_delete(pod)

    def attempts(self) -> int:
        if self.api is JAX_API:
            return int(self.s.prom.preemption_attempts.value())
        return self.s.metrics["preemption_attempts"]

    def round(self, advance: float = 0.0) -> dict:
        self.now[0] += advance
        out = self.s.schedule_pending()
        fails = {}
        for o in out:
            if o.node is None:
                fails[o.pod.name] = "; ".join(o.status.reasons) if hasattr(o, "status") else o.reason
        return {
            "placed": sorted((o.pod.name, o.node) for o in out if o.node is not None),
            "failed": fails,
            "nominated": sorted((p.name, node) for node, p in self.s.nominator.entries()),
            "evictions": list(self.evictions),
            "bindings": dict(self.bindings),
            "attempts": self.attempts(),
        }


def run_twins(scenario, rounds, **cfg):
    """Drive both sides through ``scenario(api, side)`` (which adds objects
    and returns the per-round hooks) and compare every round."""
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
        assert port == want, f"round {r}: " + str(
            {k: (want[k], port[k]) for k in want if want[k] != port[k]}
        )
        history.append(port)
    return history, sides


# ---- tests/test_preemption.py's cluster shapes, for either package --------


def _node(api, name, cpu="4", taints=()):
    T, R = api
    return T.Node(
        name=name,
        labels={"kubernetes.io/hostname": name},
        capacity=R.Resource.from_map({"cpu": cpu, "memory": "16Gi", "pods": 50}),
        taints=taints,
    )


def _pod(api, name, cpu="1", priority=0, labels=None, start_time=None, policy="PreemptLowerPriority", node=""):
    T, _ = api
    return T.Pod(
        name=name,
        priority=priority,
        labels=labels or {},
        preemption_policy=policy,
        start_time=start_time,
        node_name=node,
        containers=[T.Container(name="c", requests={"cpu": cpu, "memory": "64Mi"})],
    )


def full_cluster(api, side, n_nodes=3, victims_per_node=4):
    for i in range(n_nodes):
        side.s.on_node_add(_node(api, f"n{i}"))
    for i in range(n_nodes):
        for j in range(victims_per_node):
            side.s.on_pod_add(_pod(api, f"v{i}-{j}", start_time=float(i * 10 + j), node=f"n{i}"))


def scenario_basic(api, side):
    full_cluster(api, side)
    side.s.on_pod_add(_pod(api, "hp", priority=100))


def scenario_never(api, side):
    full_cluster(api, side)
    side.s.on_pod_add(_pod(api, "hp", priority=100, policy="Never"))


def scenario_minimal_victims(api, side):
    full_cluster(api, side, n_nodes=1)
    side.s.on_pod_add(_pod(api, "hp", priority=50))


def scenario_lowest_priority_victims(api, side):
    side.s.on_node_add(_node(api, "n0"))
    for j, pr in enumerate([5, 1, 9, 3]):
        side.s.on_pod_add(_pod(api, f"v{j}", priority=pr, node="n0"))
    side.s.on_pod_add(_pod(api, "hp", priority=100))


def scenario_fewest_pdb_violations(api, side):
    T, _ = api
    side.s.on_node_add(_node(api, "n0", cpu="1"))
    side.s.on_node_add(_node(api, "n1", cpu="1"))
    side.s.on_pod_add(_pod(api, "a", labels={"app": "db"}, node="n0"))
    side.s.on_pod_add(_pod(api, "b", node="n1"))
    side.pdbs.append(
        T.PodDisruptionBudget(name="db-pdb", selector=T.LabelSelector(match_labels={"app": "db"}),
                              disruptions_allowed=0)
    )
    side.s.on_pod_add(_pod(api, "hp", priority=10))


def scenario_lowest_max_victim_priority(api, side):
    side.s.on_node_add(_node(api, "n0", cpu="1"))
    side.s.on_node_add(_node(api, "n1", cpu="1"))
    side.s.on_pod_add(_pod(api, "a", priority=7, node="n0"))
    side.s.on_pod_add(_pod(api, "b", priority=3, node="n1"))
    side.s.on_pod_add(_pod(api, "hp", priority=10))


def scenario_nominated_blocks_lower(api, side):
    side.s.on_node_add(_node(api, "n0", cpu="2"))
    side.s.on_pod_add(_pod(api, "mid", cpu="2", priority=5, node="n0"))
    side.s.on_pod_add(_pod(api, "hp", cpu="2", priority=100))

    def hook(r, side):
        if r == 1:  # a low-priority pod arrives while hp backs off
            side.s.on_pod_add(_pod(api, "lp", cpu="2", priority=0))

    return hook


def scenario_not_helpful(api, side):
    T, _ = api
    side.s.on_node_add(_node(api, "t0", cpu="1", taints=(T.Taint(key="k", value="v"),)))
    side.s.on_pod_add(_pod(api, "v0", node="t0"))
    side.s.on_pod_add(_pod(api, "hp", priority=100))


def scenario_batch_peers(api, side):
    for i in range(2):
        side.s.on_node_add(_node(api, f"n{i}"))
    for i in range(2):
        side.s.on_pod_add(_pod(api, f"v{i}", cpu="3", start_time=float(i), node=f"n{i}"))
    side.s.on_pod_add(_pod(api, "hp0", priority=100))
    side.s.on_pod_add(_pod(api, "hp1", priority=100))
    side.s.on_pod_add(_pod(api, "mid", cpu="3", priority=50))


SCENARIOS = {
    "basic": (scenario_basic, (0.0, 1.05, 1.05)),
    "never": (scenario_never, (0.0, 1.05)),
    "minimal-victims": (scenario_minimal_victims, (0.0, 1.05)),
    "lowest-priority-victims": (scenario_lowest_priority_victims, (0.0, 1.05)),
    "fewest-pdb-violations": (scenario_fewest_pdb_violations, (0.0, 1.05)),
    "lowest-max-victim-priority": (scenario_lowest_max_victim_priority, (0.0, 1.05)),
    "nominated-blocks-lower": (scenario_nominated_blocks_lower, (0.0, 0.0, 1.1, 1.1)),
    "not-helpful": (scenario_not_helpful, (0.0, 1.05)),
    "batch-peers": (scenario_batch_peers, (0.0, 1.05)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_preemption_scenario_matches_reference(name):
    scenario, rounds = SCENARIOS[name]
    history, (_, port) = run_twins(scenario, rounds)
    final = history[-1]
    if name == "basic":
        assert final["bindings"].get("hp") and len(final["evictions"]) == 1
        assert history[0]["nominated"] == [("hp", final["bindings"]["hp"])]
    if name in ("never", "not-helpful"):
        assert not final["evictions"] and not final["nominated"] and final["attempts"] == 0
    if name == "lowest-priority-victims":
        assert final["evictions"] == ["v1"]
    if name == "fewest-pdb-violations":
        assert history[0]["nominated"] == [("hp", "n1")] and final["evictions"] == ["b"]
    if name == "lowest-max-victim-priority":
        assert history[0]["nominated"] == [("hp", "n1")]
    if name == "nominated-blocks-lower":
        assert "lp" in history[1]["failed"] and final["bindings"].get("hp") == "n0"
        assert "lp" not in final["bindings"]
    if name == "batch-peers":
        assert "mid" in history[0]["failed"] and len(final["evictions"]) == 1
        # a fast harvest reaches PostFilter unnarrowed, as in the reference
        assert port.s.metrics["fast_batches"] > 0 and port.s.metrics["narrow_batches"] == 0


# ---- bench.py bench_preemption's shape, at 50 nodes -----------------------


def bench_preemption_scenario(n_nodes, n_preemptors):
    def scenario(api, side):
        T, R = api
        for i in range(n_nodes):
            side.s.on_node_add(
                T.Node(name=f"node-{i}", labels={"kubernetes.io/hostname": f"node-{i}"},
                       capacity=R.Resource.from_map({"cpu": "4", "memory": "16Gi"}))
            )
            for v in range(2):
                side.s.on_pod_add(
                    T.Pod(name=f"victim-{i}-{v}", node_name=f"node-{i}", priority=0,
                          containers=[T.Container(requests={"cpu": "1500m", "memory": "2Gi"})])
                )
        for i in range(n_preemptors):
            side.s.on_pod_add(
                T.Pod(name=f"hi-{i}", priority=100, containers=[T.Container(requests={"cpu": "3", "memory": "4Gi"})])
            )

    return scenario


def test_bench_preemption_shape_matches_reference():
    history, (_, port) = run_twins(bench_preemption_scenario(50, 50), (0.0,) + (30.0,) * 3)
    final = history[-1]
    assert sorted(final["bindings"]) == sorted(f"hi-{i}" for i in range(50))
    assert len(final["evictions"]) == 100 and final["attempts"] == 50
    # every preemptor fails in a fast harvest, which K10 does not narrow
    assert port.s.metrics["nominated_binds"] == 50 and port.s.metrics["narrow_batches"] == 0


# ---- gang-path and wave-path drains while nominations are open -------------


def nominated_mixed_scenario(n_each):
    """24 nodes (3 zones) each holding two priority-0 pods of 1.5 cpu; 8
    preemptors (3 cpu, priority 100) nominate and evict in round 0; in round
    1, while they back off, ``n_each`` spread (priority 50) and as many
    anti-affinity (priority 0) pods of 250m schedule with the nominations
    charged; in round 2 the preemptors return."""
    return lambda api, side: _nominated_mixed(api, side, n_each)


def _nominated_mixed(api, side, n_each):
    T, R = api
    for n in basic_nodes(api, 24, zones=3, cpu="4", pods=110):
        side.s.on_node_add(n)
    for i in range(24):
        for v in range(2):
            side.s.on_pod_add(
                T.Pod(name=f"victim-{i}-{v}", node_name=f"node-{i}", priority=0, start_time=float(v),
                      containers=[T.Container(requests={"cpu": "1500m", "memory": "1Gi"})])
            )
    for i in range(8):
        side.s.on_pod_add(
            T.Pod(name=f"hi-{i}", priority=100, containers=[T.Container(requests={"cpu": "3", "memory": "2Gi"})])
        )

    def hook(r, side):
        if r != 1:
            return
        sp = spread_pods(api, n_each, prefix="sp")
        for p in sp:
            p.priority = 50
            p.containers[0].requests["cpu"] = "250m"
        aa = anti_pods(api, n_each, groups=12, prefix="aa", cpu="250m")
        for i, (a, b) in enumerate(zip(sp, aa)):
            side.s.on_pod_add(a)
            side.s.on_pod_add(b)

    return hook


@pytest.mark.parametrize("wave", [False, True], ids=["gang-scan", "wave"])
@pytest.mark.parametrize(
    "n_each,rounds",
    # 120 + 120 pods: the spread pods preempt too, inside chained batches
    # with committed peers, while the first nominations are open.  The run
    # stops after round 1: in round 2 the preemptors bind on the
    # nominated-node path in the first popped batch, and the reference's
    # bind workers release those nominations asynchronously (in practice
    # after the next popped batch's dispatch read them), the port's at the
    # bind flush (CHANGES.md).  80 + 80 pods: round 2 is one popped batch.
    [(120, (0.0, 0.0)), (80, (0.0, 0.0, 30.0))],
    ids=["preempting-feed", "preemptors-return"],
)
def test_drain_with_open_nominations_matches_reference(wave, n_each, rounds):
    history, (_, port) = run_twins(nominated_mixed_scenario(n_each), rounds, batch_size=64, wave_dispatch=wave)
    assert len(history[0]["nominated"]) == 8
    assert history[1]["placed"]  # the mixed pods scheduled while nominations were open
    m = port.s.metrics
    if wave:
        assert m["wave_batches"] > 0
    else:
        assert m["chain_batches"] > 0 and m["wave_batches"] == 0
    if len(rounds) == 3:
        for i in range(8):
            assert f"hi-{i}" in history[-1]["bindings"]
    elif not wave:
        assert m["preemption_attempts"] > 8  # the feed's own preemptions, inside chained batches
    if m["chain_batches"] + m["wave_batches"] and m["preemption_attempts"] > 8:
        assert m["narrow_batches"] > 0  # K10's plain version narrowed a gang-path harvest


# ---- an eviction between two chained batches -------------------------------


def test_eviction_between_chained_batches_ends_the_chain():
    """Two chained batches fill a node; an eviction of the second one's pod,
    then a third chained batch whose pod fits only in the freed capacity.
    The eviction must end the chain (its epoch moves), so the third batch
    restarts from the host state and places the pod there."""
    T, R = PORT_API
    s = PScheduler(PConfig(), device="cpu")
    s.on_node_add(T.Node(name="n0", labels={"kubernetes.io/hostname": "n0"},
                         capacity=R.Resource.from_map({"cpu": "3", "memory": "8Gi", "pods": 20})))
    # a placed pod whose anti-affinity term admits the newcomers keeps them
    # off the fast path (its zone topology is absent, so it blocks nothing):
    # after the first (direct) batch packs the mirror, every batch chains
    guard = _pod(PORT_API, "guard", cpu="100m", labels={"group": "other"}, node="n0")
    guard.affinity = T.Affinity(pod_anti_affinity=T.PodAntiAffinity(
        required_during_scheduling_ignored_during_execution=(
            T.PodAffinityTerm(topology_key="zone", label_selector=T.LabelSelector(match_labels={"app": "web"})),
        )))
    s.on_pod_add(guard)
    placed = []
    for name in ("w1", "w2"):
        s.on_pod_add(_pod(PORT_API, name, cpu="1", labels={"app": "web"}))
        placed += s.schedule_pending()
    assert [o.node for o in placed] == ["n0", "n0"]
    assert s.metrics["scan_batches"] == 1 and s.metrics["chain_batches"] == 1
    chained = s._chain
    s.on_pod_delete(s.cache.pod_states[placed[1].pod.uid])  # evict w2
    s.on_pod_add(_pod(PORT_API, "next", cpu="1500m", labels={"app": "web"}))
    out = s.schedule_pending()
    assert s.metrics["chain_batches"] == 2
    assert s._chain["epoch"] != chained["epoch"]
    assert [o.node for o in out] == ["n0"], out


def test_eviction_reaches_the_mirrors():
    """An eviction (on_pod_delete) of a placed pod with an anti-affinity
    term: the cache, the host view, the host mirror's usage rows and its
    placed-pod and term tables, and the device mirror all drop it; the
    synced device snapshot equals a fresh upload of the repacked mirror."""
    from tests.test_torch_chain import _assert_synced

    T, _ = PORT_API
    s = PScheduler(PConfig(batch_size=16, wave_dispatch=False), device="cpu")
    for n in basic_nodes(PORT_API, 12):
        s.on_node_add(n)
    for p in anti_pods(PORT_API, 30, groups=6, prefix="aa"):
        s.on_pod_add(p)
    out = s.schedule_pending()
    victim = s.cache.pod_states[next(o.pod.uid for o in out if o.node is not None)]
    view = s.oracle_view()
    s._repack_mirror()
    _assert_synced(s)
    n_terms = s.mirror.m_used
    s.on_pod_delete(victim)
    assert victim.uid not in s.cache.pod_states
    assert s.oracle_view() is view and victim.uid not in {p.uid for p in view.nodes[victim.node_name].pods}
    s._repack_mirror()
    ep, nt = s.mirror.existing, s.mirror.nodes
    assert s.mirror.e_used == len(s.cache.pod_states) and s.mirror.m_used == n_terms - 1
    i = nt.name_to_idx[victim.node_name]
    assert int(nt.num_pods[i]) == len(s.cache.nodes[victim.node_name].pods)
    assert victim.uid not in {p.uid for _, p in s.mirror._epod_slots.values()}
    assert int(ep.valid.sum()) == len(s.cache.pod_states)
    _assert_synced(s)


# ---- fast-path failures on more than 1,000 potential nodes -----------------


def skewed_fast_scenario(n_full=2000, n_small=150, n_blocked=150, n_preemptors=4):
    """``n_full`` nodes of 4 cpu, each full with two 2-cpu victims whose
    priority falls with the node's index (so the best candidate lies past
    the dry run's 10 % window), and, interleaved among the first of them,
    nodes that K10 drops although they hold a lower-priority pod: ``n_small``
    nodes of 2 cpu (too small for the preemptor even when empty) and
    ``n_blocked`` nodes whose other 2 cpu hold a pod of the preemptors' own
    priority.  Preemptors of 3 cpu at priority 100 with resource requests
    only take the fast path."""

    def scenario(api, side):
        T, R = api

        def node(name, cpu):
            return T.Node(name=name, labels={"kubernetes.io/hostname": name},
                          capacity=R.Resource.from_map({"cpu": cpu, "memory": "16Gi", "pods": 50}))

        def pod(name, node_name, cpu, priority, start):
            return T.Pod(name=name, node_name=node_name, priority=priority, start_time=start,
                         containers=[T.Container(name="c", requests={"cpu": cpu, "memory": "64Mi"})])

        drops = ["small"] * n_small + ["blocked"] * n_blocked
        order = []
        for i in range(n_full):
            order.append(("full", i))
            if drops:
                order.append((drops.pop(), i))
        for kind, i in order:
            name = f"{kind}-{i}"
            side.s.on_node_add(node(name, "2" if kind == "small" else "4"))
            if kind == "full":
                for v in range(2):
                    side.s.on_pod_add(pod(f"v-{i}-{v}", name, "2", -i, float(v)))
            elif kind == "small":
                side.s.on_pod_add(pod(f"s-{i}", name, "1", -5000, 0.0))
            else:
                side.s.on_pod_add(pod(f"peer-{i}", name, "2", 100, 0.0))
                side.s.on_pod_add(pod(f"b-{i}", name, "2", -5000, 0.0))
        for k in range(n_preemptors):
            side.s.on_pod_add(pod(f"hp-{k}", "", "3", 100, None))

    return scenario


def test_fast_path_failures_on_many_nodes_match_reference():
    """The dry run sizes itself from the potential-node list (10 % of it,
    at least 100): a K10 shortlist shorter than the unnarrowed list collects
    fewer candidates and can pick another node.  The reference narrows only
    the gang and wave harvests, so a fast harvest's failures must reach
    PostFilter unnarrowed: the same nominations, victims and, a round
    later, placements as the JAX Scheduler."""
    history, (_, port) = run_twins(skewed_fast_scenario(), (0.0, 30.0))
    first, final = history
    assert len(first["nominated"]) == 4 and len(first["evictions"]) == 8
    assert sorted(final["bindings"]) == [f"hp-{k}" for k in range(4)]
    assert port.s.metrics["fast_batches"] > 0 and port.s.metrics["narrow_batches"] == 0
