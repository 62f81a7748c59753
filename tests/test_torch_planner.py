"""The counterfactual planner end to end: the port's Scheduler against the
JAX Scheduler, on both engines.

The scenarios are tests/test_planner.py's: seeded clusters with placed pods
and a backlog of plain, spread and gang pods under seeded forks (evictions,
cordons, clones, scales, removals), fork isolation, the plannerKernel kill
switch, pod-live masking, a gang that rolls back in one fork and admits in
another, the autoscale, deschedule and preempt-cost planners, the one-pod
what-if after evictions (feasible and infeasible, both engines),
run_planner's bad inputs, the one-pod rule of ``target_node`` and the
planner metrics.  Each scenario is built on both schedulers from the same
specs (informer handlers, a manual clock, bindings recorded); the JAX side
runs with its dispatch ledger off, the port on the CPU, where
counterfactual_run takes its plain versions.  Every output compared is a
name or an integer, so the tolerance is zero: the port's kernel engine
equals its serial engine, the JAX kernel engine and the JAX serial engine
fork for fork.  Wall times are left out.  A drain after a planner run
equals the drain without one and the JAX Scheduler's after the same run.
"""

import random

import pytest

from kubernetes_tpu import planner as j_planner
from kubernetes_tpu.framework.config import SchedulerConfiguration as JConfig
from kubernetes_tpu.framework.interface import EventResource as JEvent
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.workloads import gang as j_wlg
from kubernetes_tpu_torch import planner as p_planner
from kubernetes_tpu_torch.framework.config import SchedulerConfiguration as PConfig
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from kubernetes_tpu_torch.workloads import gang as p_wlg
from tests.test_torch_pack import JAX_API, PORT_API

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


class Twin:
    """One scheduler of either package, its planner module and the objects
    made for it, by name."""

    def __init__(self, api, **cfg):
        self.api = api
        self.now = [1000.0]
        clock = lambda: self.now[0]  # noqa: E731
        if api is JAX_API:
            from kubernetes_tpu.observability import kernels

            self.s = JScheduler(JConfig(kernel_ledger=False, batch_size=128, **cfg), clock=clock)
            kernels.deactivate()
            self.pl, self.wlg = j_planner, j_wlg
            self.pg_add = self.s.storage_handlers(JEvent.POD_GROUP)[0]
        else:
            self.s = PScheduler(PConfig(batch_size=128, **cfg), device="cpu", clock=clock)
            self.pl, self.wlg = p_planner, p_wlg
            self.pg_add = self.s.on_pod_group_add
        self.bindings = {}
        self.s.binding_sink = lambda pod, node: self.bindings.__setitem__(pod.name, node)
        self.batch_uid = {}  # batch pod name → uid, for the fork specs' live sets

    def node(self, name, cpu="2", zone="zone-a", mem="8Gi"):
        T, R = self.api
        self.s.on_node_add(T.Node(name=name, labels={HOST: name, ZONE: zone},
                                  capacity=R.Resource.from_map({"cpu": cpu, "memory": mem, "pods": 110})))

    def pod(self, name, cpu="500m", prio=0, group="", spread=False):
        """tests/test_planner.py mkpod for this package (not added)."""
        T, _ = self.api
        tsc = ()
        if spread:
            tsc = (T.TopologySpreadConstraint(max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
                                              label_selector=T.LabelSelector(match_labels={"app": "spread"})),)
        return T.Pod(name=name, priority=prio, labels={"app": "spread" if spread else "x"}, pod_group=group,
                     topology_spread_constraints=tsc,
                     containers=[T.Container(name="c", requests={"cpu": cpu, "memory": "256Mi"})])

    def add(self, *a, **kw):
        pod = self.pod(*a, **kw)
        self.s.on_pod_add(pod)
        return pod

    def group(self, name, min_member):
        self.pg_add(self.wlg.PodGroup(name=name, min_member=min_member))

    def forks(self, specs):
        """Fork specs with pod names → this package's Forks (pod uids)."""
        out = []
        for spec in specs:
            kw = dict(spec)
            for key in ("evict", "live"):
                if key in kw and kw[key] is not None:
                    kw[key] = tuple(self.pod_uid(n) for n in kw[key])
            out.append(self.pl.Fork(**kw))
        return out

    def pod_uid(self, name):
        placed = {p.name: p.uid for p in self.s.cache.placed_pods()}
        return placed.get(name) or self.batch_uid[name]


def twins(**cfg):
    return Twin(JAX_API, **cfg), Twin(PORT_API, **cfg)


FORK_KEYS = ("label", "placements", "admitted", "unschedulable", "density_ppm", "gang_admitted")


def fork_key(f):
    return tuple(sorted(f[k].items()) if isinstance(f[k], dict) else f[k] for k in FORK_KEYS)


def same_forks(a, b, what):
    assert len(a.forks) == len(b.forks), what
    for fa, fb in zip(a.forks, b.forks):
        assert fork_key(fa) == fork_key(fb), f"{what}: fork {fa['label']!r}\n{fa}\n!=\n{fb}"


def sim_json(sim):
    out = sim.to_json()
    out.pop("wall_s")
    return out


def plan_json(out):
    out = dict(out)
    if "result" in out:
        out["result"] = {k: v for k, v in out["result"].items() if k != "wall_s"}
    return out


def simulate_all(pair, forks_spec, pods_of, **kw):
    """simulate_forks on both packages and both engines; every fork equal.
    Returns the port's kernel-engine SimResult."""
    sims = {}
    for tw in pair:
        pods = pods_of(tw)
        tw.batch_uid = {p.name: p.uid for p in pods}
        forks = tw.forks(forks_spec)
        sims[tw.api is JAX_API, "kernel"] = tw.pl.simulate_forks(tw.s, forks, pods, planner="test", **kw)
        sims[tw.api is JAX_API, "serial"] = tw.pl.simulate_forks(tw.s, forks, pods, planner="test",
                                                                  use_kernel=False, **kw)
    port, jax = sims[False, "kernel"], sims[True, "kernel"]
    assert port.engine == "kernel" and jax.engine == "kernel"
    assert sims[False, "serial"].engine == "serial"
    assert sim_json(port) == sim_json(jax), "kernel engines differ"
    assert sim_json(sims[False, "serial"]) == sim_json(sims[True, "serial"]), "serial engines differ"
    same_forks(port, sims[False, "serial"], "port kernel vs port serial")
    return port


def placed_state(tw):
    return sorted((p.name, p.node_name) for p in tw.s.cache.placed_pods())


# ---------------------------------------------------------------------------
# the randomized property (tests/test_planner.py _random_env / _random_forks)
# ---------------------------------------------------------------------------


def random_env(rng):
    """Specs: nodes, fill pods (placed), backlog pods, a gang of two."""
    nodes = [(f"node-{i}", rng.choice(["1", "2", "4"]), f"zone-{i % 3}") for i in range(rng.randrange(4, 8))]
    fill = [(f"fill-{i}", f"{rng.choice([200, 400, 700])}m") for i in range(rng.randrange(5, 12))]
    want = [(f"want-{i}", f"{rng.choice([300, 800, 1200])}m", rng.random() < 0.4) for i in range(rng.randrange(3, 7))]
    order = list(range(len(want) + 2))
    rng.shuffle(order)
    return nodes, fill, want, order


def build_env(pair, env):
    nodes, fill, want, order = env
    for tw in pair:
        for name, cpu, zone in nodes:
            tw.node(name, cpu=cpu, zone=zone)
        for name, cpu in fill:
            tw.add(name, cpu=cpu, prio=2)
        tw.s.schedule_pending()
        tw.group("pg", 2)
    assert placed_state(pair[0]) == placed_state(pair[1])

    def pods_of(tw):
        pods = [tw.pod(n, cpu=c, spread=s) for n, c, s in want] + [tw.pod(f"pg-{m}", cpu="600m", group="pg")
                                                                   for m in range(2)]
        return [pods[i] for i in order]

    return pods_of


def random_forks(rng, tw, max_k=6):
    """tests/test_planner.py _random_forks as specs (placed pods by name)."""
    placed = sorted(p.name for p in tw.s.cache.placed_pods())
    names = sorted(cn.node.name for cn in tw.s.cache.real_nodes())
    specs = [dict(label="baseline")]
    for k in range(rng.randrange(2, max_k)):
        kind = rng.choice(["evict", "cordon", "add", "scale", "remove", "mix"])
        spec = dict(label=f"f{k}:{kind}")
        if kind in ("evict", "mix") and placed:
            spec["evict"] = tuple(rng.sample(placed, min(len(placed), rng.randrange(1, 4))))
        if kind in ("cordon", "mix"):
            spec["cordon"] = (rng.choice(names),)
        if kind == "remove":
            spec["remove"] = (rng.choice(names),)
        if kind in ("add", "mix"):
            t = rng.choice(names)
            spec["add"] = tuple((t, f"{t}~cf{i}") for i in range(rng.randrange(1, 3)))
        if kind == "scale":
            spec["scale"] = ((rng.choice(names), rng.choice([1, 3, 2]), 2),)
        specs.append(spec)
    return specs


@pytest.mark.parametrize("seed", [7, 23, 61])
def test_plan_property_matches_reference(seed):
    rng = random.Random(seed)
    for _ in range(2):
        pair = twins()
        pods_of = build_env(pair, random_env(rng))
        specs = random_forks(rng, pair[1])
        simulate_all(pair, specs, pods_of)


def test_fork_isolation():
    """Each fork of a batched run equals the same fork alone (K=1), on the
    port and as on the JAX side."""
    rng = random.Random(5)
    pair = twins()
    pods_of = build_env(pair, random_env(rng))
    placed = [n for n, _ in placed_state(pair[1])]
    specs = [dict(label="baseline"), dict(label="evict-all", evict=tuple(placed)),
             dict(label="cordon-0", cordon=("node-0",)), dict(label="clone", add=(("node-1", "node-1~cf0"),))]
    batched = simulate_all(pair, specs, pods_of)
    tw = pair[1]
    pods = pods_of(tw)
    tw.batch_uid = {p.name: p.uid for p in pods}
    for i, f in enumerate(tw.forks(specs)):
        alone = tw.pl.simulate_forks(tw.s, [f], pods, planner="test")
        assert alone.engine == "kernel"
        assert fork_key(batched.forks[i]) == fork_key(alone.forks[0]), f.label


def test_kill_switch_identity():
    """plannerKernel: false replays the same forks on the serial engine,
    with no dispatch, on both packages."""
    rng = random.Random(11)
    pair = twins()
    pods_of = build_env(pair, random_env(rng))
    specs = random_forks(rng, pair[1])
    runs = {}
    for tw in pair:
        pods = pods_of(tw)
        tw.batch_uid = {p.name: p.uid for p in pods}
        forks = tw.forks(specs)
        kern = tw.pl.simulate_forks(tw.s, forks, pods, planner="test")
        tw.s.config.planner_kernel = False
        off = tw.pl.simulate_forks(tw.s, forks, pods, planner="test")
        assert (kern.engine, kern.dispatches, off.engine, off.dispatches) == ("kernel", 1, "serial", 0)
        same_forks(kern, off, "kill switch")
        runs[tw.api is JAX_API] = sim_json(off)
    assert runs[False] == runs[True]


def test_pod_live_masking():
    """A fork simulating part of the batch sees only its live pods."""
    pair = twins()
    for tw in pair:
        for i in range(2):
            tw.node(f"node-{i}", cpu="1")
    pods_of = lambda tw: [tw.pod(n, cpu="800m") for n in "abc"]  # noqa: E731
    sim = simulate_all(pair, [dict(label="only-a", live=("a",)), dict(label="all")], pods_of)
    only_a, all_f = sim.forks
    assert set(only_a["placements"]) == {"a"} and only_a["admitted"] == 1
    assert all_f["admitted"] == 2 and all_f["unschedulable"] == 1


def test_gang_rides_forks():
    """A gang admits all or nothing per fork: rolled back in the baseline,
    admitted once two clones add room."""
    pair = twins()
    for tw in pair:
        tw.node("node-0", cpu="1")
        tw.group("g", 3)
    pods_of = lambda tw: [tw.pod(f"g-{m}", cpu="700m", group="g") for m in range(3)]  # noqa: E731
    sim = simulate_all(pair, [dict(label="baseline"),
                              dict(label="grow", add=(("node-0", "node-0~cf0"), ("node-0", "node-0~cf1")))], pods_of)
    base, grow = sim.forks
    assert base["gang_admitted"].get("default/g") == 0 and base["admitted"] == 0
    assert grow["gang_admitted"].get("default/g") == 1 and grow["admitted"] == 3


# ---------------------------------------------------------------------------
# the planners
# ---------------------------------------------------------------------------


def stranded_env(pair):
    """Four full nodes and a backlog that fits only after a scale-up."""
    for tw in pair:
        for i in range(4):
            tw.node(f"node-{i}", zone=f"zone-{i % 2}")
        for i in range(12):
            tw.add(f"fill-{i}", cpu="600m", prio=2)
        tw.s.schedule_pending()
        for i in range(6):
            tw.add(f"want-{i}", cpu="900m")
        tw.s.schedule_pending()


def both(pair, fn, *a, **kw):
    """fn(sched) of each package's planner module; equal minus wall times."""
    got = [plan_json(getattr(tw.pl, fn)(tw.s, *a, **kw)) for tw in pair]
    assert got[1] == got[0], fn
    return got[1]


def test_autoscale_matches_reference():
    pair = twins()
    stranded_env(pair)
    for kernel in (True, False):
        for tw in pair:
            tw.s.config.planner_kernel = kernel
        out = both(pair, "plan_autoscale", max_count=2)
        assert out["result"]["engine"] == ("kernel" if kernel else "serial")
        rec = out["recommendation"]
        assert rec["action"] == "scale_up" and rec["newly_schedulable"] > 0
        by_label = {f["label"]: f for f in out["result"]["forks"]}
        assert by_label[f"add:{rec['shape']}x2"]["admitted"] >= by_label[f"add:{rec['shape']}x1"]["admitted"]
        if kernel:
            kern = out
    assert [fork_key(f) for f in kern["result"]["forks"]] == [fork_key(f) for f in out["result"]["forks"]]


def test_autoscale_scale_down_matches_reference():
    pair = twins()
    for tw in pair:
        for i in range(3):
            tw.node(f"node-{i}")
        for i in range(4):
            tw.add(f"fill-{i}", cpu="900m")
        tw.s.schedule_pending()
        tw.add("want-0", cpu="1900m")
        tw.s.schedule_pending()
    out = both(pair, "plan_autoscale", max_count=1)
    assert out["result"]["engine"] == "kernel"
    empties = {cn.node.name for cn in pair[1].s.cache.real_nodes() if not cn.pods}
    assert set(out.get("scale_down", ())) <= empties


def test_deschedule_matches_reference():
    pair = twins()
    for tw in pair:
        for i in range(3):
            tw.node(f"node-{i}", cpu="4")
        for i in range(6):
            tw.add(f"p-{i}", cpu="300m")
        tw.s.schedule_pending()
    out = both(pair, "plan_deschedule", max_candidates=3)
    assert out["result"]["engine"] == "kernel"
    assert any(d["fully_drainable"] for d in out["drains"]) and out["recommendation"]["action"] == "drain"


def test_preempt_cost_matches_reference():
    """Same-priority pods cannot preempt: no victims, no cascade."""
    pair = twins()
    for tw in pair:
        for i in range(2):
            tw.node(f"node-{i}", cpu="2")
        for i in range(4):
            tw.add(f"low-{i}", cpu="900m", prio=0)
        tw.s.schedule_pending()
        tw.add("same-prio", cpu="1500m", prio=0)
        tw.s.schedule_pending()
    out = both(pair, "plan_preempt_cost")
    assert out["result"]["engine"] == "kernel"
    c0 = {c["priority"]: c for c in out["classes"]}[0]
    assert c0["victims_considered"] == 0 and c0["cascade_upper_bound"] == 0


def lows_env(pair):
    for tw in pair:
        for i in range(2):
            tw.node(f"n{i}", cpu="2")
        for i in range(4):
            tw.add(f"low-{i}", cpu="900m", prio=0)
        tw.s.schedule_pending()


def test_preempt_cost_counts_lower_priority_victims():
    pair = twins()
    lows_env(pair)
    lows = [f"low-{i}" for i in range(4)]
    sim = simulate_all(pair, [dict(label="base", live=("hi",)), dict(label="preempt", evict=tuple(lows), live=("hi",))],
                       lambda tw: [tw.pod("hi", cpu="1500m", prio=10)])
    base, pre = sim.forks
    assert base["admitted"] == 0 and pre["admitted"] == 1


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "kill_switch"])
def test_whatif_after_evictions_matches_reference(kernel):
    """The one-pod what-if on node n0 after evicting n0's pods: feasible for
    a pod that fits there then, infeasible for one larger than the node."""
    pair = twins(planner_kernel=kernel)
    lows_env(pair)
    outs = {}
    for tw in pair:
        victims = [p.uid for p in tw.s.cache.placed_pods() if p.node_name == "n0"]
        outs[tw.api is JAX_API] = [tw.pl.whatif_after_evictions(tw.s, tw.pod(name, cpu=cpu, prio=10), "n0", victims)
                                   for name, cpu in (("hi", "1500m"), ("huge", "2500m"))]
    assert outs[False] == outs[True]
    fits, huge = outs[False]
    engine = "kernel" if kernel else "serial"
    assert fits["engine"] == engine and fits["feasible"] is True and fits["placement"] == "n0"
    assert huge["engine"] == engine and huge["feasible"] is False


def test_run_planner_never_raises_on_bad_input():
    pair = twins()
    stranded_env(pair)
    for params, want in (({"max_count": "abc"}, "bad parameter"), ({"shapes": "no-such-node"}, "no-such-node")):
        got = [plan_json(tw.pl.run_planner(tw.s, "autoscale", params)) for tw in pair]
        assert got[1] == got[0] and want in got[1]["error"]
    got = [tw.pl.run_planner(tw.s, name) for tw in pair for name in ("list", "bogus")]
    assert got[:2] == got[2:]
    assert "unknown planner" in got[3]["error"]


def test_target_node_requires_single_pod():
    tw = Twin(PORT_API)
    tw.node("n0")
    with pytest.raises(ValueError, match="single-pod"):
        tw.pl.simulate_forks(tw.s, [tw.pl.Fork(label="x")], [tw.pod("a"), tw.pod("b")], target_node="n0")


def test_plan_metrics_match_reference():
    pair = twins()
    stranded_env(pair)
    out = both(pair, "plan_autoscale", max_count=1)
    js, ps = pair[0].s, pair[1].s
    assert ps.metrics["plan_forks"] == js.prom.plan_forks.value() == out["result"]["k"]
    assert ps.metrics["plan_runs"] == 1 and ps.metrics["plan_seconds"] > 0


def test_drain_after_planner_run_is_unchanged():
    """The planners are read-only: after a planner run with clones (new
    vocabulary, a repacked mirror) a drain places as the same drain without
    the run, and as the JAX Scheduler's after the same run."""
    runs = []
    for plan in (True, False):
        pair = twins()
        stranded_env(pair)
        if plan:
            both(pair, "plan_autoscale", max_count=2)
            both(pair, "plan_deschedule")
        for tw in pair:
            for i in range(4):
                tw.node(f"late-{i}", cpu="2", zone="zone-2")
            for i in range(8):
                tw.add(f"after-{i}", cpu="700m", spread=i % 2 == 0)
            tw.s.schedule_pending()
        assert pair[1].bindings == pair[0].bindings
        runs.append(pair[1].bindings)
    assert runs[0] == runs[1]
    assert sum(1 for n in runs[0].values() if n.startswith("late-")) > 0
