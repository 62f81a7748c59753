"""DRA claim allocation, module level: the port's ops/dra.py, the DRA mode of
workloads_run, the DynamicResources plugin and the WorkloadOracle's DRA half
against the JAX package's.

Surfaces are made from a seed by one generator that builds either
package's objects (``dra_surface``): nodes with zero to two ResourceSlices
of zero to five devices whose attributes leave keys out (NotIn and
DoesNotExist on absent attributes), DeviceClasses with In / NotIn / Exists
/ DoesNotExist selectors, claims of one or two requests (ExactCount of one
to three, All), requests naming a class that does not exist (``req_bad``),
pre-allocated claims (referenced and not: their devices stay taken), a
claim allocated on a node outside the snapshot, claims shared by two pods
and pods naming a claim that does not exist.  The packed tables and every
function's outputs are integers or bools, so the tolerance is zero.

workloads_run runs on the tests/gen.py batches of tests/test_torch_wave.py
with claims laid over the pods, without and with gangs (a gang that rolls
back gives its devices and pins back).  On the CPU the port runs its plain
versions (K13's, K14's and K11's).
"""

import copy
import random
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import dra as j_dra
from kubernetes_tpu.framework.dynamicresources import DynamicResources as JDynamicResources
from kubernetes_tpu.framework.interface import CycleState as JCycleState
from kubernetes_tpu.ops import coscheduling as j_cos
from kubernetes_tpu.ops import dra as j_ops
from kubernetes_tpu.oracle.state import OracleState as JOracleState
from kubernetes_tpu.oracle.workloads import WorkloadOracle as JWorkloadOracle
from kubernetes_tpu.util.assumecache import AssumeCache as JAssumeCache
from kubernetes_tpu.workloads import gang as j_wlg
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.api import dra as p_dra
from kubernetes_tpu_torch.framework.dynamicresources import DynamicResources as PDynamicResources
from kubernetes_tpu_torch.framework.interface import CycleState as PCycleState
from kubernetes_tpu_torch.ops import coscheduling as p_cos
from kubernetes_tpu_torch.ops import dra as p_ops
from kubernetes_tpu_torch.oracle.state import OracleState as POracleState
from kubernetes_tpu_torch.oracle.workloads import WorkloadOracle as PWorkloadOracle
from kubernetes_tpu_torch.util.assumecache import AssumeCache as PAssumeCache
from kubernetes_tpu_torch.workloads import gang as p_wlg
from tests.test_torch_pack import JAX_API, PORT_API
from tests.test_torch_wave import CASES, IDS, assert_same, packed
from tests.test_torch_workloads import WT, _gang_kw, lay_gangs

SEEDS = [1, 2, 3, 4, 5, 6]
ARRAYS = ("dev_key", "dev_val", "dev_valid", "free0", "sel_key", "sel_op", "sel_vals", "req_count", "req_all",
          "req_cl", "req_bad", "q_valid", "ref_cl", "claim_node0")
ROWS = ("req_count", "req_all", "req_cl", "q_valid", "req_bad", "ref_cl")
VALUES = {"vendor": ("x", "y", "z"), "mem": ("16", "32", "80"), "model": ("a", "b"), "numa": ("0", "1")}


def _selector(D, rng):
    key = rng.choice(sorted(VALUES))
    op = rng.choice(["In", "In", "NotIn", "Exists", "DoesNotExist"])
    vals = tuple(rng.sample(VALUES[key], rng.randint(1, 2))) if op in ("In", "NotIn") else ()
    if rng.random() < 0.1:
        vals = vals + ("unseen",) if vals else vals  # a value no device carries
    return D.DeviceSelector(key, op, vals)


def dra_surface(D, seed, node_names, n_pods, n_claims=None, devices=(0, 5), shared=0.15, held=0.15):
    """One seeded DRA world in package ``D`` (either api/dra.py): (slices in
    lister order, classes by name, claims by key, per-pod claim names)."""
    rng = random.Random(seed)
    slices = []
    for i, node in enumerate(node_names + ["ghost-node"]):
        for s in range(rng.choice([0, 1, 1, 2])):
            devs = []
            for j in range(rng.randint(*devices)):
                attrs = tuple((k, rng.choice(VALUES[k])) for k in sorted(VALUES) if rng.random() < 0.75)
                devs.append(D.Device(name=f"d{j}", attributes=attrs))
            slices.append(D.ResourceSlice(name=f"sl-{i}-{s}", node_name=node, driver=f"drv{s}",
                                          pool=f"pool-{i}", devices=tuple(devs)))
    classes = {"any": D.DeviceClass(name="any")}
    for c in range(4):
        classes[f"cls{c}"] = D.DeviceClass(name=f"cls{c}",
                                           selectors=tuple(_selector(D, rng) for _ in range(rng.randint(1, 2))))
    all_devs = [(sl.driver, sl.pool, d.name, sl.node_name) for sl in slices for d in sl.devices]
    n_claims = n_claims if n_claims is not None else max(2, int(n_pods * 0.8))
    claims = {}
    taken = set()
    for c in range(n_claims):
        reqs = []
        for r in range(rng.choice([1, 1, 2])):
            cls = rng.choice(sorted(classes)) if rng.random() > 0.05 else "missing-class"
            mode = j_dra.ALLOCATION_MODE_ALL if rng.random() < 0.2 else j_dra.ALLOCATION_MODE_EXACT
            sels = tuple(_selector(D, rng) for _ in range(rng.choice([0, 0, 1, 2])))
            reqs.append(D.DeviceRequest(name=f"r{r}", device_class_name=cls, count=rng.randint(1, 3),
                                        allocation_mode=mode, selectors=sels))
        alloc = None
        if rng.random() < held and all_devs:
            drv, pool, dev, node = rng.choice(all_devs)
            if (drv, pool, dev) not in taken:
                taken.add((drv, pool, dev))
                alloc = D.AllocationResult(results=(D.DeviceRequestAllocationResult("r0", drv, pool, dev),),
                                           node_name=node)
        claim = D.ResourceClaim(name=f"claim-{c}", requests=tuple(reqs), allocation=alloc)
        claims[claim.key] = claim
    names = [k.split("/", 1)[1] for k in claims]
    per_pod = []
    for p in range(n_pods):
        r = rng.random()
        if r < 0.15:
            refs = ()
        elif r < 0.15 + shared:
            refs = (rng.choice(names[: max(1, len(names) // 3)]),)  # likely shared with another pod
        else:
            refs = tuple(rng.sample(names, min(len(names), rng.choice([1, 1, 2]))))
        if rng.random() < 0.04:
            refs = refs + ("no-such-claim",)
        per_pod.append(refs)
    return slices, classes, claims, per_pod


def _pods(per_pod, namespace="default"):
    return [SimpleNamespace(namespace=namespace, resource_claims=refs) for refs in per_pod]


def tables_pair(seed, n_nodes=12, n_pods=24, p_cap=32, **kw):
    """dra_tables on both sides over one surface: (reference dict, port dict)."""
    nodes = [f"node-{i}" for i in range(n_nodes)]
    name_to_idx = {n: i for i, n in enumerate(nodes)}
    n_cap = n_nodes + 4
    out = []
    for D, fn in ((j_dra, j_ops.dra_tables), (p_dra, p_ops.dra_tables)):
        slices, classes, claims, per_pod = dra_surface(D, seed, nodes, n_pods, **kw)
        out.append(fn(_pods(per_pod), name_to_idx, n_cap, p_cap, slices, classes, claims))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_dra_tables_match_reference(seed):
    """The packed surface, array for array, and the host bookkeeping."""
    want, got = tables_pair(seed)
    for k in ARRAYS:
        assert_same(want[k], got[k], k)
    assert got["claim_keys"] == want["claim_keys"]
    assert np.array_equal(got["has_claims"], want["has_claims"])
    conv = convert.dra_tables_from_numpy(want, "cpu")
    for k in ARRAYS:
        assert_same(want[k], conv[k], "converted " + k)


def test_dra_tables_cover_the_cases():
    """Across the seeds the surfaces hold what the equalities are for: All
    mode, missing classes, pre-allocated and shared claims, devices held by
    claims no pod of the batch references, a claim pinned outside the
    snapshot, NotIn / Exists / DoesNotExist selectors and PAD slots."""
    seen = {k: False for k in ("all", "bad", "pinned", "shared", "held_unref", "ghost", "ops", "pad")}
    for seed in SEEDS:
        want, _ = tables_pair(seed)
        seen["all"] |= bool(np.asarray(want["req_all"]).any())
        seen["bad"] |= bool(np.asarray(want["req_bad"]).any())
        cn0 = np.asarray(want["claim_node0"])
        seen["pinned"] |= bool(((cn0 >= 0) & (cn0 < 12)).any())
        seen["ghost"] |= bool((cn0 == 16).any())
        ref = np.asarray(want["ref_cl"])
        vals, counts = np.unique(ref[ref >= 0], return_counts=True)
        seen["shared"] |= bool((counts > 1).any())
        free0, valid = np.asarray(want["free0"]), np.asarray(want["dev_valid"])
        seen["held_unref"] |= bool((valid & ~free0).sum() > ((cn0 >= 0) & (cn0 < 16)).sum())
        ops = set(np.unique(np.asarray(want["sel_op"])).tolist())
        seen["ops"] |= {0, 1, 2, 3} <= ops
        seen["pad"] |= -2 in ops
    assert all(seen.values()), seen


def _random_state(rng, dev_valid, CL, N):
    free = dev_valid & (rng.random(dev_valid.shape) < 0.7)
    claim_node = np.where(rng.random(CL) < 0.3, rng.integers(0, N, size=CL), -1).astype(np.int32)
    return free, claim_node


@pytest.mark.parametrize("seed", SEEDS)
def test_match_verdict_and_commit_match_reference(seed):
    """selector_match (plain and wrapper), node_feasible_plain for every pod
    against the pre-batch state and a seeded random one, dra_commit_plain
    at a seeded choice (and at no node), and the speculation lane
    dra_spec_mask against the reference's vmap of node_feasible."""
    want, got = tables_pair(seed)
    sel = ("dev_key", "dev_val", "dev_valid", "sel_key", "sel_op", "sel_vals")
    j_match = j_ops.selector_match(*(want[k] for k in sel))
    for fn in (p_ops.selector_match_plain, p_ops.selector_match):
        assert_same(j_match, fn(*(got[k] for k in sel)), fn.__name__)
    p_match = p_ops.selector_match_plain(*(got[k] for k in sel))
    rng = np.random.default_rng(seed)
    P, DQ, N, DD = np.asarray(j_match).shape
    CL = np.asarray(want["claim_node0"]).shape[0]
    states = [(np.asarray(want["free0"]), np.asarray(want["claim_node0"]))]
    states.append(_random_state(rng, np.asarray(want["dev_valid"]), CL, N))
    for free, claim_node in states:
        jf, jc = jnp.asarray(free), jnp.asarray(claim_node)
        pf, pc = torch.from_numpy(free.copy()), torch.from_numpy(claim_node.copy())
        for p in range(P):
            ok_w, take_w = j_ops.node_feasible(j_match[p], jf, jc, *(want[k][p] for k in ROWS))
            ok_g, take_g = p_ops.node_feasible_plain(p_match[p], pf, pc, *(got[k][p] for k in ROWS))
            assert_same(ok_w, ok_g, f"ok p={p}")
            assert_same(take_w, take_g, f"take p={p}")
            choice = int(rng.integers(-1, N))
            cw = j_ops.dra_commit(jf, jc, jnp.asarray(choice, jnp.int32), take_w, want["ref_cl"][p])
            cg = p_ops.dra_commit_plain(pf, pc, choice, take_g, got["ref_cl"][p])
            assert_same(cw[0], cg[0], f"free after p={p}")
            assert_same(cw[1], cg[1], f"claim_node after p={p}")
    spec_w = jax.vmap(lambda p: j_ops.node_feasible(j_match[p], want["free0"], want["claim_node0"],
                                                    *(want[k][p] for k in ROWS))[0])(jnp.arange(P))
    lane = (p_match, got["free0"], got["claim_node0"], *(got[k] for k in ROWS))
    for fn in (p_ops.dra_spec_mask_plain, p_ops.dra_spec_mask):
        assert_same(spec_w, fn(*lane), fn.__name__)


# ---- workloads_run with claims ----------------------------------------------

GEN = [(c, i) for c, i in zip(CASES, IDS) if c[0] == "gen"]


def _claims_over(pk, seed, device_range=(0, 3)):
    """A DRA surface over a packed case's nodes and pending pods: the tables
    on both sides, the claim keys, and each pod's claim names."""
    nodes = list(pk.nt.names)
    name_to_idx = {n: i for i, n in enumerate(nodes)}
    n_cap, p_cap = pk.nt.label_vals.shape[0], pk.pb.valid.shape[0]
    out = []
    for D, fn in ((j_dra, j_ops.dra_tables), (p_dra, p_ops.dra_tables)):
        slices, classes, claims, per_pod = dra_surface(D, seed, nodes, len(pk.pending), devices=device_range,
                                                       shared=0.3, held=0.1)
        pods = _pods(per_pod)  # the claims' namespace: dra_tables reads nothing else of a pod
        out.append(fn(pods, name_to_idx, n_cap, p_cap, slices, classes, claims))
    return out


def _run_outputs(out):
    chosen, n_feas, rc, tallies, wl = out
    return [chosen, n_feas, rc, tallies["requested"], tallies["nonzero"], tallies["num_pods"], wl["spec"],
            wl["raw"], wl["gang_admit"], wl["gang_landed"], wl["claim_node"]]


RUN_NAMES = ("chosen", "n_feas", "reason_counts", "requested", "nonzero", "num_pods", "spec", "raw", "gang_admit",
             "gang_landed", "claim_node")


@pytest.mark.parametrize("case,gangs", [(c, g) for c, _ in GEN for g in (False, True)],
                         ids=[f"{i}-{'gangs' if g else 'plain'}" for _, i in GEN for g in (False, True)])
def test_workloads_run_with_claims_matches_reference(case, gangs):
    """workloads_run end to end with the DRA tables, and workloads_schedule
    (plain and wrapper) on the reference's statics, output for output,
    claim_node included."""
    from kubernetes_tpu.ops import gang as j_gang

    pk = packed(case)
    seed = case[1]
    want_t, got_t = _claims_over(pk, seed)
    jd = {k: want_t[k] for k in ARRAYS}
    pd = {k: got_t[k] for k in ARRAYS}
    if gangs:
        arrays = lay_gangs(seed, len(pk.pending), pk.pb.valid.shape[0])
    else:
        arrays = j_wlg.gang_arrays(pk.pb.valid.shape[0], {}, {})
    jg, pg = _gang_kw(arrays, True), _gang_kw(arrays, False)
    j_gcap, p_gcap = jg.pop("g_cap"), pg.pop("g_cap")
    jw, pw = [pk.wt[k] for k in WT], [pk.pwt[k] for k in WT]
    dk = dict(d_cap=pk.d_cap, d2_cap=pk.wt["d2_cap"])
    want = _run_outputs(j_cos.workloads_run(pk.jdc, pk.jdb, pk.jhk, pk.v_cap, j_gcap, *jw, **jg, **jd, **pk.tables,
                                            **dk))
    got = _run_outputs(p_cos.workloads_run(pk.pdc, pk.pdb, pk.hk, pk.v_cap, p_gcap, *pw, **pg, **pd, **pk.tables,
                                           **dk))
    for w, o, name in zip(want, got, RUN_NAMES):
        assert_same(w, o, "workloads_run " + name)
    g = j_gang.precompute(pk.jdc, pk.jdb, pk.jhk, pk.v_cap, has_ports=False, **pk.tables)
    pgs = convert.statics_from_numpy(g, "cpu")
    want_s = _run_outputs(j_cos.workloads_schedule(pk.jdc, pk.jdb, g, pk.jhk, pk.v_cap, j_gcap, *jw, **jg, **jd,
                                                   **dk))
    for fn in (p_cos.workloads_schedule_plain, p_cos.workloads_schedule):
        got_s = _run_outputs(fn(pk.pdc, pk.pdb, pgs, pk.hk, pk.v_cap, p_gcap, *pw, **pg, **pd, **dk))
        for w, o, name in zip(want_s, got_s, RUN_NAMES):
            assert_same(w, o, f"{fn.__name__} {name}")

    # the claims decided something: a pod failed in the DRA lane (NodePorts,
    # index 4 of the diagnosis) and claims were allocated
    rc, claim_node = np.asarray(want[2]), np.asarray(want[10])
    assert (rc[:, 4] > 0).any() and (claim_node >= 0).any()
    if gangs:
        assert (np.asarray(want[8]) == 0).any()  # a gang rolled back


def test_rolled_back_gang_gives_its_devices_back():
    """One device on every node and a claim per pod; the first pod that
    places and the pod after it form a gang that needs three members, so it
    rolls back after its first member took a device: that claim ends
    unpinned, and every later placement and pin equals the reference's."""
    pk = packed(GEN[0][0])
    p_cap = pk.pb.valid.shape[0]
    nodes = list(pk.nt.names)
    n_cap = pk.nt.label_vals.shape[0]
    jw, pw = [pk.wt[k] for k in WT], [pk.pwt[k] for k in WT]
    dk = dict(d_cap=pk.d_cap, d2_cap=pk.wt["d2_cap"])
    plain = j_wlg.gang_arrays(p_cap, {}, {})
    jg = _gang_kw(plain, True)
    first = np.asarray(j_cos.workloads_run(pk.jdc, pk.jdb, pk.jhk, pk.v_cap, jg.pop("g_cap"), *jw, **jg,
                                           **pk.tables, **dk)[0])
    a = int(np.nonzero(first >= 0)[0][0])
    out = []
    for D, fn in ((j_dra, j_ops.dra_tables), (p_dra, p_ops.dra_tables)):
        slices = [D.ResourceSlice(name=f"sl-{n}", node_name=n, driver="drv", pool=n,
                                  devices=(D.Device("d0", (("vendor", "x"),)),)) for n in nodes]
        classes = {"gpu": D.DeviceClass("gpu", (D.DeviceSelector("vendor", "In", ("x",)),))}
        claims = {f"default/c{i}": D.ResourceClaim(name=f"c{i}", requests=(D.DeviceRequest("r", "gpu"),))
                  for i in range(len(pk.pending))}
        out.append(fn(_pods([(f"c{i}",) for i in range(len(pk.pending))]), {n: i for i, n in enumerate(nodes)},
                      n_cap, p_cap, slices, classes, claims))
    want_t, got_t = out
    arrays = j_wlg.gang_arrays(p_cap, {"g/x": [a, a + 1]}, {"g/x": 3})
    jg, pg = _gang_kw(arrays, True), _gang_kw(arrays, False)
    want = _run_outputs(j_cos.workloads_run(pk.jdc, pk.jdb, pk.jhk, pk.v_cap, jg.pop("g_cap"), *jw, **jg,
                                            **{k: want_t[k] for k in ARRAYS}, **pk.tables, **dk))
    got = _run_outputs(p_cos.workloads_run(pk.pdc, pk.pdb, pk.hk, pk.v_cap, pg.pop("g_cap"), *pw, **pg,
                                           **{k: got_t[k] for k in ARRAYS}, **pk.tables, **dk))
    for w, o, name in zip(want, got, RUN_NAMES):
        assert_same(w, o, name)
    chosen, raw, claim_node = (np.asarray(want[i]) for i in (0, 7, 10))
    keys = want_t["claim_keys"]
    assert raw[a] >= 0 and chosen[a] == -1  # placed by the admission, then rolled back
    assert claim_node[keys.index(f"default/c{a}")] == -1
    placed = [i for i in range(len(pk.pending)) if chosen[i] >= 0]
    assert placed and all(claim_node[keys.index(f"default/c{i}")] == chosen[i] for i in placed)


# ---- the DynamicResources plugin ----------------------------------------------


class _Handle:
    """What DynamicResources reads of a scheduler: the claim cache, the
    slices, the classes and the claim write."""

    def __init__(self, cache, slices, classes, fail_writes=False):
        self.claim_cache = cache
        self._slices = slices
        self._classes = classes
        self.writes = []
        self.fail_writes = fail_writes

    def list_resource_slices(self):
        return list(self._slices)

    def get_device_class(self, name):
        return self._classes.get(name)

    def write_claim(self, claim):
        if self.fail_writes:
            raise RuntimeError("api down")
        self.writes.append(_claim_view(claim))


def _claim_view(c):
    alloc = None if c.allocation is None else (
        c.allocation.node_name, tuple((r.request, r.driver, r.pool, r.device) for r in c.allocation.results))
    return (c.key, alloc, tuple(c.reserved_for))


def _status(s):
    return (int(s.code), tuple(s.reasons), s.plugin)


def _plugin_run(D, Plugin, Cache, State, seed, fail_writes):
    nodes = [f"node-{i}" for i in range(8)]
    slices, classes, claims, per_pod = dra_surface(D, seed, nodes, 20, devices=(0, 3), held=0.2)
    cache = Cache("claims")
    for c in claims.values():
        cache.on_add(c)
    handle = _Handle(cache, slices, classes, fail_writes)
    plugin = Plugin(handle=handle)
    log = []
    n_reserved = 0
    node_states = [SimpleNamespace(node=SimpleNamespace(name=n)) for n in nodes]
    for i, refs in enumerate(per_pod):
        pod = SimpleNamespace(name=f"p{i}", namespace="default", uid=f"uid-{i}", resource_claims=refs)
        state = State()
        s = plugin.pre_filter(state, pod)
        log.append(("pre_filter", i, _status(s)))
        if not s.ok:
            continue
        verdicts = [_status(plugin.filter(state, pod, ns)) for ns in node_states]
        log.append(("filter", i, verdicts))
        ok_nodes = [n for n, v in zip(nodes, verdicts) if v[0] == 0]
        if not ok_nodes:
            continue
        node = ok_nodes[i % len(ok_nodes)]
        log.append(("reserve", i, _status(plugin.reserve(state, pod, node))))
        n_reserved += 1
        if n_reserved % 3 == 0:
            plugin.unreserve(state, pod, node)
            log.append(("unreserved", i))
        else:
            s = plugin.pre_bind(state, pod, node)
            log.append(("pre_bind", i, _status(s)))
            if not s.ok:
                plugin.unreserve(state, pod, node)
        log.append(("cache", i, sorted(_claim_view(c) for c in cache.list())))
    # a Reserve on a node the Filter never judged errors
    pod = SimpleNamespace(name="late", namespace="default", uid="uid-late", resource_claims=per_pod[1] or ("x",))
    state = State()
    if plugin.pre_filter(state, pod).ok:
        log.append(("reserve-unjudged", _status(plugin.reserve(state, pod, nodes[0]))))
    log.append(("writes", handle.writes))
    return log


@pytest.mark.parametrize("seed,fail_writes", [(s, False) for s in (1, 2, 3)] + [(4, True)])
def test_dynamic_resources_plugin_matches_reference(seed, fail_writes):
    """PreFilter, Filter on every node, Reserve, PreBind (its claim writes)
    and Unreserve, pod after pod over one claim cache: every Status and the
    cache's claims (allocation, node, reservedFor) after each pod, equal to
    the reference plugin's; with failing writes PreBind errors and
    Unreserve restores."""
    want = _plugin_run(j_dra, JDynamicResources, JAssumeCache, JCycleState, seed, fail_writes)
    got = _plugin_run(p_dra, PDynamicResources, PAssumeCache, PCycleState, seed, fail_writes)
    assert got == want
    kinds = {e[0] for e in want}
    assert {"pre_filter", "filter", "reserve", "cache"} <= kinds
    assert ("pre_bind" in kinds) and ("unreserved" in kinds)


def test_dynamic_resources_hints_match_reference():
    """The events DynamicResources registers and its claim hint."""
    want = JDynamicResources(handle=None).events_to_register()
    got = PDynamicResources(handle=None).events_to_register()
    assert [(e.event.resource.value, int(e.event.action)) for e in got] == \
        [(e.event.resource.value, int(e.event.action)) for e in want]
    pod = SimpleNamespace(namespace="default", resource_claims=("a",))
    for new in (None, SimpleNamespace(namespace="default", name="a"), SimpleNamespace(namespace="default", name="b"),
                SimpleNamespace(namespace="other", name="a")):
        assert int(got[0].hint_fn(pod, None, new)) == int(want[0].hint_fn(pod, None, new))


# ---- the serial oracle --------------------------------------------------------


def oracle_world(api, D, wlg, seed, n_nodes=10, n_pods=40):
    """Nodes, pods with claims (some gang members), the DRA surface and the
    PodGroups, in one package."""
    T, R = api
    rng = random.Random(seed)
    nodes = [T.Node(name=f"node-{i}", labels={"kubernetes.io/hostname": f"node-{i}"},
                    capacity=R.Resource.from_map({"cpu": rng.choice(["1", "2", "4"]), "memory": "8Gi",
                                                  "pods": 110}))
             for i in range(n_nodes)]
    slices, classes, claims, per_pod = dra_surface(D, seed, [n.name for n in nodes], n_pods, devices=(0, 3),
                                                   shared=0.25, held=0.1)
    groups, pods = {}, []
    for i, refs in enumerate(per_pod):
        group = ""
        if i % 10 in (3, 4, 5):
            group = f"g{i // 10}"
            groups.setdefault(f"default/{group}", wlg.PodGroup(name=group, min_member=3))
        pods.append(T.Pod(name=f"p{i}", containers=[T.Container(name="c", requests={
            "cpu": rng.choice(["100m", "300m", "900m"])})], resource_claims=refs, pod_group=group))
    return nodes, pods, slices, classes, claims, groups


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_workload_oracle_dra_half_matches_reference(seed):
    """The WorkloadOracle's placements, rollbacks, gang verdicts and claim
    pins, replaying the same queue on both sides."""
    out = []
    for api, D, wlg, Oracle, State in ((JAX_API, j_dra, j_wlg, JWorkloadOracle, JOracleState),
                                       (PORT_API, p_dra, p_wlg, PWorkloadOracle, POracleState)):
        nodes, pods, slices, classes, claims, groups = oracle_world(api, D, wlg, seed)
        oracle = Oracle(state=State.build(nodes), slices=slices, device_classes=classes, claims=claims,
                        groups=groups)
        res = oracle.schedule(copy.deepcopy(pods))
        out.append((res.placements, sorted(res.rolled_back), res.gang_admitted, res.claim_nodes,
                    sorted(_claim_view(c) for c in oracle.claims.values()), sorted(oracle.taken)))
    assert out[1] == out[0]
    placements, _, admitted, claim_nodes = out[0][:4]
    assert claim_nodes and admitted and any(v is None for v in placements.values())
