"""Explain mode: the port's explain masks, explain_pod, find_pod,
oracle_explain and explain_whatif against the JAX package's.

Module level, ``explain_masks_plain`` (the precompute's plain version, then
K17's) against the JAX root ``explain_masks`` on tests/test_gang.py's seeds,
with every filter, with the resource fit off, with a subset of the plugins
and with a host-filter lane.  Scheduler level, the scenarios of
tests/test_observability.py (a mixed batch against the host oracle, the
truncated summary, find_pod), a PreFilter narrowing and rejection, a claims
pod that a host Filter rejects, a pod the wave demoted (its ``wave`` entry),
the what-ifs of tests/test_planner.py and tests/test_coscheduling.py on
both planner engines, and explain between two drains, which must leave the
second drain as the JAX Scheduler's.  Both schedulers are built from the
same specs; the JAX one runs with its dispatch ledger off, the port on the
CPU (the plain versions).  Pod uids differ between the packages, so the
dicts are compared with each uid replaced by its pod's name; every other
field is compared exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from kubernetes_tpu import observability as j_obs
from kubernetes_tpu.framework.config import SchedulerConfiguration as JConfig
from kubernetes_tpu.ops import explain as j_explain
from kubernetes_tpu.ops import gang as j_gang
from kubernetes_tpu.ops.common import I32 as J_I32
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch import observability as p_obs
from kubernetes_tpu_torch.framework.config import SchedulerConfiguration as PConfig
from kubernetes_tpu_torch.ops import explain as p_explain
from kubernetes_tpu_torch.ops import gang as p_gang
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from tests.test_torch_gang import CASES, NO_SPREAD_IP, NO_TAINTS, packed
from tests.test_torch_pack import JAX_API, PORT_API
from tests.test_torch_planner import twins
from tests.test_torch_scheduler_gang import ROUTES, _pod, basic_nodes, spread_pods

HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"


# ---- explain_masks against the JAX root --------------------------------------

MASK_VARIANTS = {
    "all": dict(),
    "no-fit": dict(check_fit=False),
    "no-spread-ip": dict(enabled=NO_SPREAD_IP),
    "no-taints": dict(enabled=NO_TAINTS),
    "extra-lane": dict(extra=True),
}


@pytest.mark.parametrize("variant", list(MASK_VARIANTS))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_explain_masks_match_reference(case, variant):
    """The [N_DIAG, P, N] stack and the combined mask, exactly."""
    pk = packed(case)
    opts = dict(MASK_VARIANTS[variant])
    extra = opts.pop("extra", False)
    flags = dict(has_interpod=True, has_spread=True, has_ports=True)
    j_extra = p_extra = None
    if extra:
        P, N = pk.pdb.valid.shape[0], pk.pdc.node_valid.shape[0]
        lane = np.random.default_rng(case[0]).random((P, N)) < 0.8
        j_extra, p_extra = jnp.asarray(lane), torch.as_tensor(lane)
    _, tj = pk.ref_tables()
    _, tp = pk.port_tables()
    want_stack, want_comb = j_explain.explain_masks(pk.jdc, pk.jdb, jnp.asarray(pk.hk, J_I32), pk.v_cap, **flags,
                                                    extra_mask=j_extra, **opts, **tj)
    got_stack, got_comb = p_explain.explain_masks_plain(pk.pdc, pk.pdb, pk.hk, pk.v_cap, **flags,
                                                        extra_mask=p_extra, **opts, **tp)
    for what, w, g in (("stack", want_stack, got_stack), ("combined", want_comb, got_comb)):
        w = np.asarray(w)
        assert g.dtype == torch.bool and tuple(g.shape) == w.shape, what
        assert np.array_equal(w, g.numpy()), f"{what}: {np.argwhere(w != g.numpy())[:5].tolist()}"
    assert not np.asarray(want_comb).all()  # some pair fails
    # the wrapper on CPU tensors takes the same plain versions
    stack, comb = p_explain.explain_masks(pk.pdc, pk.pdb, pk.hk, pk.v_cap, **flags, extra_mask=p_extra, **opts, **tp)
    assert torch.equal(stack, got_stack) and torch.equal(comb, got_comb)
    assert p_gang.DIAG_KERNELS == j_gang.DIAG_KERNELS == p_obs.DIAG_PLUGINS


# ---- the schedulers ---------------------------------------------------------


class Side:
    """One scheduler of either package and its observability module."""

    def __init__(self, api, **cfg):
        self.api = api
        self.bound = {}
        if api is JAX_API:
            from kubernetes_tpu.observability import kernels

            self.s = JScheduler(JConfig(kernel_ledger=False, **cfg))
            kernels.deactivate()
            self.obs = j_obs
            self.fwk_enabled = lambda pod: self.s.profiles[pod.scheduler_name or "default-scheduler"].device_enabled()
        else:
            self.s = PScheduler(PConfig(**cfg), device="cpu")
            self.obs = p_obs
            self.fwk_enabled = lambda pod: self.s.profiles[pod.scheduler_name or "default-scheduler"].enabled
        self.s.binding_sink = lambda pod, node: self.bound.__setitem__(pod.name, node)

    def nodes(self, n=4, cpu="2", zones=2, taint_every=0):
        """tests/test_observability.py _nodes."""
        T, R = self.api
        for i in range(n):
            taints = (T.Taint(key="dedicated", value="infra"),) if taint_every and i % taint_every == 0 else ()
            self.s.on_node_add(T.Node(name=f"n{i}", labels={HOST: f"n{i}", ZONE: f"zone-{i % zones}"},
                                      capacity=R.Resource.from_map({"cpu": cpu, "memory": "4Gi"}), taints=taints))

    def pod(self, name, cpu="100m", mem="64Mi", **kw):
        """tests/test_observability.py _pod."""
        T, _ = self.api
        return T.Pod(name=name, containers=[T.Container(requests={"cpu": cpu, "memory": mem})], **kw)


def sides(**cfg):
    return Side(JAX_API, **cfg), Side(PORT_API, **cfg)


def _names(sched):
    """uid → pod name over everything the scheduler knows."""
    out = {}
    for pods in sched.queue.pending_pods().values():
        out.update({p.uid: p.name for p in pods})
    states = sched.cache.pod_states
    for uid, st in states.items():
        out[uid] = getattr(st, "pod", st).name
    return out


def norm(d, names):
    """The dict with each pod uid replaced by the pod's name."""
    if isinstance(d, dict):
        return {k: (names.get(v, v) if k == "uid" else norm(v, names)) for k, v in d.items()}
    if isinstance(d, list):
        return [norm(v, names) for v in d]
    return d


def explain_both(pair, make_pod, oracle=True, **kw):
    """explain_pod on both sides for the same spec; the port's dict equals
    the JAX one, and (with ``oracle``: no PreFilter narrowing) its per-node
    verdicts equal the port's host oracle."""
    outs = []
    for side in pair:
        pod = make_pod(side)
        ex = side.obs.explain_pod(side.s, pod, **kw)
        names = dict(_names(side.s), **{pod.uid: pod.name})
        outs.append(norm(ex, names))
        if oracle and side.api is PORT_API and "error" not in ex and "pre_filter" not in ex and ex["nodes"]:
            ora = p_obs.oracle_explain(pod, side.s.oracle_view(), side.fwk_enabled(pod))
            if not ex["truncated"]:
                assert {n: set(v) for n, v in ex["nodes"].items()} == ora
    want, got = outs
    assert got == want
    return got


def _mixed_batch_world(side):
    """tests/test_observability.py test_explain_matches_oracle_mixed_batch:
    4 nodes (n0 / n2 zone-0, n1 / n3 zone-1; n0 tainted; 2 cpu), group=g
    placed on n1, app=x skewed onto zone-0."""
    T, _ = side.api
    side.nodes(4, cpu="2", zones=2, taint_every=4)
    side.s.on_pod_add(side.pod("placed-g", node_name="n1", labels={"group": "g"}))
    for i, node in enumerate(("n0", "n2")):
        side.s.on_pod_add(side.pod(f"placed-x{i}", node_name=node, labels={"app": "x"}))


def _anti(side):
    T, _ = side.api
    return side.pod("anti", labels={"group": "g"}, affinity=T.Affinity(pod_anti_affinity=T.PodAntiAffinity(
        required_during_scheduling_ignored_during_execution=(T.PodAffinityTerm(
            topology_key=HOST, label_selector=T.LabelSelector(match_labels={"group": "g"})),))))


def _spread(side):
    T, _ = side.api
    return side.pod("spread", labels={"app": "x"}, topology_spread_constraints=(T.TopologySpreadConstraint(
        max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
        label_selector=T.LabelSelector(match_labels={"app": "x"})),))


def _named(side):
    pod = side.pod("named")
    pod.node_name = "n2"
    return pod


MIXED_PODS = {
    "feasible": lambda side: side.pod("feasible"),
    "big": lambda side: side.pod("big", cpu="64", mem="100Gi"),
    "named": _named,
    "anti": _anti,
    "spread": _spread,
}


@pytest.mark.parametrize("kind", list(MIXED_PODS))
def test_explain_pod_mixed_batch_matches_reference(kind):
    """Each pod of the mixed batch: the port's dict equals the JAX
    Scheduler's and its per-node verdicts equal the host oracle's."""
    pair = sides()
    for side in pair:
        _mixed_batch_world(side)
    got = explain_both(pair, MIXED_PODS[kind], max_nodes=10_000)
    assert got["n_feasible"] == len(got["feasible"])
    if kind == "big":
        assert got["n_feasible"] == 0 and got["summary"]["NodeResourcesFit"] == 4
        assert "TaintToleration" in got["nodes"]["n0"]
    if kind == "named":
        assert set(got["feasible"]) == {"n2"} and got["nodes"]["n0"].count("NodeName") == 1
    if kind == "anti":
        assert "InterPodAffinity" in got["nodes"]["n1"] and "n1" not in got["feasible"]
    if kind == "spread":
        assert "PodTopologySpread" in got["nodes"]["n0"] and "PodTopologySpread" in got["nodes"]["n2"]


def test_oracle_explain_matches_reference():
    """oracle_explain on both packages' host views, node for node."""
    pair = sides()
    for side in pair:
        _mixed_batch_world(side)
    outs = []
    for side in pair:
        st = side.s.oracle_view()
        outs.append({k: side.obs.oracle_explain(make(side), st, side.fwk_enabled(make(side)))
                     for k, make in MIXED_PODS.items()})
    assert outs[1] == outs[0]
    assert p_obs.reason_to_plugin("Insufficient cpu") == j_obs.reason_to_plugin("Insufficient cpu")


def test_explain_truncation_and_summary_cover_all_nodes():
    pair = sides()
    for side in pair:
        side.nodes(8, cpu="1")
    got = explain_both(pair, lambda side: side.pod("big", cpu="32"), max_nodes=3)
    assert len(got["nodes"]) == 3 and got["truncated"]
    assert got["summary"]["NodeResourcesFit"] == 8


def test_find_pod_resolves_queue_and_cache():
    pair = sides()
    found = []
    for side in pair:
        side.nodes(2)
        big = side.pod("big", cpu="64")
        ok = side.pod("ok")
        side.s.on_pod_add(big)
        side.s.on_pod_add(ok)
        side.s.schedule_pending()  # big parks unschedulable, ok binds
        f = side.obs.find_pod
        assert f(side.s, big.uid) is not None and f(side.s, ok.uid) is not None
        found.append([None if f(side.s, r) is None else f(side.s, r).name for r in ("big", "ok", "nope")])
    assert found[1] == found[0] == ["big", "ok", None]


def _node_names(T, *names):
    return T.Affinity(node_affinity=T.NodeAffinity(required_during_scheduling_ignored_during_execution=T.NodeSelector(
        (T.NodeSelectorTerm(match_fields=tuple(T.NodeSelectorRequirement("metadata.name", "In", (n,))
                                               for n in names)),))))


@pytest.mark.parametrize("names", [("n1",), ("n1", "n2")], ids=["narrowed", "rejected"])
def test_explain_prefilter_narrowing(names):
    """A required metadata.name term narrows the nodes (PreFilterResult on
    every other node); two names in one term intersect to none, a PreFilter
    rejection."""
    pair = sides()
    for side in pair:
        side.nodes(4)
    got = explain_both(pair, lambda side: side.pod("nm", affinity=_node_names(side.api[0], *names)), oracle=False)
    if len(names) == 1:
        assert got["feasible"] == ["n1"] and "PreFilterResult" in got["nodes"]["n0"]
    else:
        assert got["pre_filter"]["plugin"] == "NodeAffinity" and got["n_feasible"] == 0


def test_explain_claims_pod_host_filter_verdicts():
    """A claims pod under the DynamicResourceAllocation gate: its claim can
    only be met on the node with devices; the others carry the host
    plugin's verdict."""
    from tests.test_torch_scheduler_dra import Side as DraSide
    from tests.test_torch_scheduler_dra import make_node, mkpod

    outs = []
    for api in (JAX_API, PORT_API):
        side = DraSide(api)
        for n in ("node-1", "node-2", "node-3"):
            side.s.on_node_add(make_node(api, n))
        side.gpu_class()
        side.gpu_slice("sl-1", "node-1", 2)
        side.claim("c0", count=2)
        pod = mkpod(api, "claimer", ("c0",))
        obs = j_obs if api is JAX_API else p_obs
        outs.append(norm(obs.explain_pod(side.s, pod), {pod.uid: pod.name}))
    assert outs[1] == outs[0]
    assert outs[1]["feasible"] == ["node-1"] and set(outs[1]["nodes"]) == {"node-2", "node-3"}


def test_explain_wave_demoted_pod():
    """Two pods racing one host port on one node: both speculate onto it,
    the wave demotes the second (kind ports), and explain_pod reports the
    demotion from the flight recorder, as the JAX Scheduler does."""
    pair = sides(batch_size=256)
    for side in pair:
        T, _ = side.api
        for n in basic_nodes(side.api, 1):
            side.s.on_node_add(n)
        port = (T.ContainerPort(container_port=8080, host_port=7777, protocol="TCP"),)
        side.racers = [_pod(T, f"racer-{i}", {"app": "race"}, ports=port) for i in range(2)]
        for p in side.racers:
            side.s.on_pod_add(p)
        side.s.schedule_pending()
    assert pair[1].s.metrics["wave_conflicts"] == {"ports": 1}
    got = explain_both(pair, lambda side: side.racers[1])
    assert got["wave"]["conflict_kind"] == "ports" and got["wave"]["events"][0]["spec_node"] == "node-0"
    ev = [e["kind"] for e in pair[1].s.flight.events_for(pair[1].racers[1].uid)]
    assert ev == ["wave_demoted"]
    assert pair[1].s.flight.stats()["recorded_total"] == 1


# ---- explain_whatif ---------------------------------------------------------


def _whatif_both(pair, node, name):
    outs = []
    for tw in pair:
        pod = tw.pl_obs.find_pod(tw.s, name)
        outs.append(norm(tw.pl_obs.explain_whatif(tw.s, pod, node), _names(tw.s)))
    assert outs[1] == outs[0]
    return outs[1]


@pytest.mark.parametrize("planner_kernel", [True, False], ids=["kernel", "serial"])
def test_explain_whatif_matches_reference(planner_kernel):
    """tests/test_planner.py's what-if: two 2-cpu nodes full of priority-0
    pods; a 1.5-cpu preemptor is feasible on n0 after its victims go, a
    2.5-cpu one is not; the one-fork planner agrees with the dry run."""
    pair = twins(planner_kernel=planner_kernel)
    for tw in pair:
        tw.pl_obs = j_obs if tw.api is JAX_API else p_obs
        for i in range(2):
            tw.node(f"n{i}", cpu="2")
        for i in range(4):
            tw.add(f"low-{i}", cpu="900m", prio=0)
        tw.s.schedule_pending()
        tw.add("hi", cpu="1500m", prio=10)
        tw.add("huge", cpu="2500m", prio=10)
    out = _whatif_both(pair, "n0", "hi")
    assert out["kernel"]["engine"] == ("kernel" if planner_kernel else "serial")
    assert out["feasible_after_preemption"] is True and out["parity"] is True
    out2 = _whatif_both(pair, "n0", "huge")
    assert out2["feasible_after_preemption"] is False and out2["parity"] is True


def test_explain_whatif_preemption_victims():
    """tests/test_coscheduling.py's what-if, asked before any scheduling
    attempt: node-0 holds two priority-0 pods, node-1 two priority-1000
    pods; a priority-500 pod of 600m frees node-0 and not node-1, and an
    unknown node is an error."""
    pair = twins()
    for tw in pair:
        T, _ = tw.api
        tw.pl_obs = j_obs if tw.api is JAX_API else p_obs
        tw.node("node-0", cpu="1")
        tw.node("node-1", cpu="1")
        for i in range(2):
            for name, prio, node in ((f"low-{i}", 0, "node-0"), (f"high-{i}", 1000, "node-1")):
                p = tw.pod(name, cpu="500m", prio=prio)
                p.node_name = node
                tw.s.on_pod_add(p)
        tw.add("wanter", cpu="600m", prio=500)
    out0 = _whatif_both(pair, "node-0", "wanter")
    assert out0["eligible"] is True and out0["feasible_after_preemption"] is True
    assert {v["name"] for v in out0["victims"]} <= {"low-0", "low-1"} and out0["num_pdb_violations"] == 0
    out1 = _whatif_both(pair, "node-1", "wanter")
    assert out1["feasible_after_preemption"] is False and out1["lower_priority_pods"] == 0
    out2 = _whatif_both(pair, "node-nope", "wanter")
    assert "unknown node" in out2["error"]


@pytest.mark.parametrize("failure", [RuntimeError("device lost"), KeyError("fork"), ValueError("bad fork")],
                         ids=["RuntimeError", "KeyError", "ValueError"])
def test_explain_whatif_planner_failure_answers_as_reference(monkeypatch, failure):
    """The one-fork planner failing inside explain_whatif, the same failure
    monkeypatched on both sides: the answer carries the failure as
    kernel.error, keeps the host dry run's verdict, and has no parity, as
    the reference's does (its debug surface answers, whatever the error)."""
    import kubernetes_tpu.planner.plan as j_plan
    import kubernetes_tpu_torch.planner.plan as p_plan

    def fail(*args, **kwargs):
        raise failure

    monkeypatch.setattr(j_plan, "whatif_after_evictions", fail)
    monkeypatch.setattr(p_plan, "whatif_after_evictions", fail)
    pair = twins()
    for tw in pair:
        tw.pl_obs = j_obs if tw.api is JAX_API else p_obs
        for i in range(2):
            tw.node(f"n{i}", cpu="2")
        for i in range(4):
            tw.add(f"low-{i}", cpu="900m", prio=0)
        tw.s.schedule_pending()
        tw.add("hi", cpu="1500m", prio=10)
    out = _whatif_both(pair, "n0", "hi")
    assert out["kernel"] == {"error": str(failure)}
    assert out["feasible_after_preemption"] is True and "parity" not in out


# ---- explain between drains -------------------------------------------------


def test_explain_between_drains_changes_nothing():
    """Drain, explain a pod with labels the snapshot has never seen, drain
    again: the second drain's placements, FitErrors, route counts and wave
    metrics equal the JAX Scheduler's, and explain left the port's resident
    device cluster and its fast lineage alone."""
    from tests.test_torch_scheduler_wave import assert_same_wave

    pair = sides(batch_size=64)
    results = []
    for side in pair:
        api = side.api
        T, _ = api
        for n in basic_nodes(api, 20, zones=3):
            side.s.on_node_add(n)
        for p in spread_pods(api, 150, prefix="first"):
            side.s.on_pod_add(p)
        side.s.schedule_pending()
        before = None
        if api is PORT_API:
            c = side.s._dc_cache
            before = (c.full_uploads, c.delta_syncs, side.s._holder is None, id(side.s._chain))
        probe = _pod(T, "probe", {"team": "never-seen"}, topology_spread_constraints=(T.TopologySpreadConstraint(
            max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
            label_selector=T.LabelSelector(match_labels={"team": "never-seen"})),))
        ex = side.obs.explain_pod(side.s, probe)
        assert ex["n_feasible"] > 0
        if api is PORT_API:
            c = side.s._dc_cache
            assert (c.full_uploads, c.delta_syncs, side.s._holder is None, id(side.s._chain)) == before
        for p in spread_pods(api, 100, prefix="second") + [_pod(T, f"plain-{i}", {"app": "p"}) for i in range(30)]:
            side.s.on_pod_add(p)
        out = side.s.schedule_pending()
        results.append(({o.pod.name: o.node for o in out},
                        sorted(o.pod.name for o in out if o.node is None)))
    assert results[1] == results[0]
    js, ps = pair[0].s, pair[1].s
    assert {k: ps.metrics[k] for k in ROUTES} == {k: js.metrics.get(k, 0) for k in ROUTES}
    assert_same_wave(js, ps)
