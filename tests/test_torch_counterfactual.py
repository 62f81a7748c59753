"""The counterfactual planner, module level: the port's pack_forks, fork
view, fork density, counterfactual_run, serial_plan and workloads_run with
``extra_score`` against the JAX package's.

pack_forks runs on twin schedulers (tests/test_torch_planner.py) over forks
with evictions (the usage rows recomputed), cordons, removals, scales 1/2
and 3/2, clones shared between forks by name, clones that grow the node
bucket, live masks and padding forks.  The op-level cases are the
tests/gen.py (cluster, batch) pairs of tests/test_torch_wave.py (spread,
inter-pod terms, taints) and one of tests/test_torch_volume.py (bound-PV
volume tables), packed by the reference and carried across by
kubernetes_tpu_torch.convert, with seeded fork planes (removed, cordoned,
scaled, evicted and partly live forks, and padding forks), gangs laid over
the batch (tests/test_torch_workloads.py: one rolls back in every fork,
others admit in some forks only) and, in one case, a target ``extra_score``.
On the CPU the port runs its plain versions.  Every output is an integer or
a bool, so the tolerance is zero.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import coscheduling as j_cos
from kubernetes_tpu.ops import counterfactual as j_cf
from kubernetes_tpu.oracle import planner as j_oracle_planner
from kubernetes_tpu.planner import forks as j_forks
from kubernetes_tpu.workloads import gang as j_wlg
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import coscheduling as p_cos
from kubernetes_tpu_torch.ops import counterfactual as p_cf
from kubernetes_tpu_torch.oracle import planner as p_oracle_planner
from kubernetes_tpu_torch.planner import forks as p_forks
from kubernetes_tpu_torch.snapshot.selectors import METADATA_NAME_KEY
from tests.test_torch_pack import JAX_API
from tests.test_torch_planner import Twin, build_env, random_env, twins
from tests.test_torch_volume import vol_packed
from tests.test_torch_wave import CASES, IDS, assert_same, packed
from tests.test_torch_workloads import OUT_NAMES, WT, _gang_kw, _outputs, lay_gangs

GEN = [(c, i) for c, i in zip(CASES, IDS) if c[0] == "gen"][:3]
PLANES = ("fk_alive", "fk_unsched", "fk_alloc", "fk_req", "fk_nz", "fk_npods", "fk_epod_valid", "fk_nvalid",
          "fk_pod_live")


# ---------------------------------------------------------------------------
# pack_forks
# ---------------------------------------------------------------------------


def _pack(tw: Twin, specs, batch, clones_kw):
    """Intern the batch's and the clones' labels, repack the mirror, then
    pack_forks, as simulate_forks does."""
    s = tw.s
    forks = tw.forks(specs)
    mod = j_forks if tw.api is JAX_API else p_forks
    vocab = s.mirror.vocab
    for p in batch:
        for k, v in p.labels.items():
            vocab.intern_label(k, v)
    s._sync_mirror_external()
    clones = mod.collect_clones(forks, {cn.node.name: cn.node for cn in s.cache.real_nodes()})
    for node in clones.values():
        for k, v in node.labels.items():
            vocab.intern_label(k, v)
        vocab.intern_label(METADATA_NAME_KEY, node.name)
    s._repack_mirror()
    return mod.pack_forks(s.mirror, s.cache, forks, [p.uid for p in batch], 8, clones=clones, **clones_kw)


@pytest.mark.parametrize("n_clones", [1, 40], ids=["few-clones", "grown-bucket"])
def test_pack_forks_matches_reference(n_clones):
    pair = twins()
    pods_of = build_env(pair, random_env(random.Random(3)))
    placed = sorted(p.name for p in pair[1].s.cache.placed_pods())
    names = sorted(cn.node.name for cn in pair[1].s.cache.real_nodes())
    on_first = [p.name for p in pair[1].s.cache.placed_pods() if p.node_name == names[0]]
    specs = [
        dict(label="baseline"),
        dict(label="evict", evict=tuple(placed[:3])),
        dict(label="evict-node", evict=tuple(on_first)),
        dict(label="cordon-remove", cordon=(names[1],), remove=(names[2],)),
        dict(label="scale", scale=((names[0], 1, 2), (names[3], 3, 2))),
        dict(label="add", add=tuple((names[1], f"{names[1]}~cf{i}") for i in range(n_clones))),
        dict(label="add-shared", add=((names[1], f"{names[1]}~cf0"), (names[0], f"{names[0]}~cf0"))),
        dict(label="live", live=("want-0", "pg-1"), evict=(placed[-1],)),
        dict(label="mix", evict=(placed[0],), cordon=(names[0],), add=((names[2], f"{names[2]}~cf0"),),
             scale=((names[1], 3, 2),)),
    ]
    got = []
    for tw in pair:
        batch = pods_of(tw)
        tw.batch_uid = {p.name: p.uid for p in batch}
        got.append(_pack(tw, specs, batch, dict(k_cap=16)))
    want, port = got
    for k in PLANES:
        assert_same(want.planes[k], port.planes[k], k)
    assert port.names == want.names and port.clone_slots == want.clone_slots and port.k_used == want.k_used
    for f in ("allocatable", "label_vals", "taint_key", "valid", "unschedulable", "requested", "nonzero_req"):
        assert_same(getattr(want.nt, f), getattr(port.nt, f), f"nt.{f}")
    fk = port.planes
    assert not fk["fk_pod_live"][len(specs):].any() and fk["fk_pod_live"][7].sum() == 2
    assert (fk["fk_req"][1] != fk["fk_req"][0]).any() and not fk["fk_epod_valid"][3].all()
    base = pair[1].s.mirror.nodes
    assert (port.nt.n_cap > base.n_cap) == (len(base.name_to_idx) + len(port.clone_slots) > base.n_cap)
    assert len(port.clone_slots) == n_clones + 2 and (port.nt.n_cap > base.n_cap or n_clones < 40)


# ---------------------------------------------------------------------------
# the fork view and the density
# ---------------------------------------------------------------------------


def seeded_planes(pk, seed, KF=8, n_real=5):
    """Seeded fork planes over a packed case: a baseline, a removal, a
    cordon with scales (1/2 and 3/2), an eviction of a third of the placed
    pods (their nodes' usage rows halved), a partly live fork, and padding
    forks with no live pods."""
    rng = np.random.default_rng(seed)
    nt = pk.nt
    N, R = nt.allocatable.shape
    valid = np.asarray(nt.valid, bool)
    live_nodes = np.nonzero(valid)[0]
    ep_node = np.asarray(pk.jdc.epod_node)
    ep_valid = np.asarray(pk.jdc.epod_valid, bool)
    P = pk.pb.valid.shape[0]
    n_live = len(pk.pending)
    fk = dict(
        fk_alive=np.broadcast_to(valid, (KF, N)).copy(),
        fk_unsched=np.broadcast_to(np.asarray(nt.unschedulable, bool), (KF, N)).copy(),
        fk_alloc=np.broadcast_to(nt.allocatable, (KF, N, R)).copy(),
        fk_req=np.broadcast_to(nt.requested, (KF, N, R)).copy(),
        fk_nz=np.broadcast_to(nt.nonzero_req, (KF, N, 2)).copy(),
        fk_npods=np.broadcast_to(nt.num_pods, (KF, N)).copy(),
        fk_epod_valid=np.broadcast_to(ep_valid, (KF, ep_valid.shape[0])).copy(),
        fk_pod_live=np.zeros((KF, P), bool),
    )
    fk["fk_pod_live"][:n_real, :n_live] = True
    gone = rng.choice(live_nodes, 2, replace=False)
    fk["fk_alive"][1, gone] = False
    fk["fk_epod_valid"][1] &= ~np.isin(ep_node, gone)
    fk["fk_unsched"][2, rng.choice(live_nodes, 2, replace=False)] = True
    for n, (num, den) in zip(rng.choice(live_nodes, 2, replace=False), ((1, 2), (3, 2))):
        fk["fk_alloc"][2, n] = fk["fk_alloc"][2, n].astype(np.int64) * num // den
    evict = np.nonzero(ep_valid & (rng.random(ep_valid.shape[0]) < 0.33))[0]
    fk["fk_epod_valid"][3, evict] = False
    for n in np.unique(ep_node[evict]):
        if n >= 0:
            fk["fk_req"][3, n] //= 2
            fk["fk_nz"][3, n] //= 2
            fk["fk_npods"][3, n] //= 2
    fk["fk_pod_live"][4, :n_live] = rng.random(n_live) < 0.5
    fk["fk_nvalid"] = fk["fk_alive"].sum(axis=1).astype(np.int32)
    return {k: (v.astype(np.int32) if v.dtype.kind == "i" else v) for k, v in fk.items()}


@pytest.mark.parametrize("case", [c for c, _ in GEN], ids=[i for _, i in GEN])
def test_fork_view_and_density_match_reference(case):
    pk = packed(case)
    fk = seeded_planes(pk, case[1])
    alive = torch.from_numpy(fk["fk_alive"])
    vr = np.asarray(pk.jdc.visit_rank)
    for fn in (p_cf.fork_cluster_view_plain, p_cf.fork_cluster_view):
        view = fn(pk.pdc, alive, visit_rank=torch.from_numpy(np.array(vr)))
        for k in range(alive.shape[0]):
            j = j_cf.fork_cluster_view(pk.jdc, *(jnp.asarray(fk[p][k]) for p in PLANES[:8]))
            for f, jf in (("node_labels", "node_labels"), ("taint_key", "taint_key"), ("taint_val", "taint_val"),
                          ("taint_effect", "taint_effect"), ("visit_rank", "visit_rank")):
                assert_same(getattr(j, jf), view[f][k], f"{fn.__name__} {f} fork {k}")
            # the compact domain ids: -1 where the fork has no node, else the
            # snapshot's, so nodes share an id exactly where they share a value
            dom = view["dom_ids"][k].numpy()
            assert (dom[:, ~fk["fk_alive"][k]] == -1).all()
            assert (dom[:, fk["fk_alive"][k]] == pk.pdc.dom_ids.numpy()[:, fk["fk_alive"][k]]).all()
            lab = np.asarray(j.node_labels).T
            assert ((dom >= 0) == (lab >= 0)).all()
    rng = np.random.default_rng(case[1])
    N, R = pk.nt.allocatable.shape
    for k in range(fk["fk_alive"].shape[0]):
        used = rng.integers(0, 4000, size=(N, R)).astype(np.int32)
        alloc = fk["fk_alloc"][k].copy()
        alloc[rng.random(N) < 0.1, 1] = 0  # nodes without memory are not counted
        want = j_cf.fork_density(jnp.asarray(fk["fk_alive"][k]), jnp.asarray(alloc), jnp.asarray(used))
        got = p_cf.fork_density_plain(alive[k], torch.from_numpy(alloc), torch.from_numpy(used))
        assert_same(want, got, f"fork_density fork {k}")
    assert int(want) > 0


# ---------------------------------------------------------------------------
# counterfactual_run
# ---------------------------------------------------------------------------


def _cf_case(pk, seed, gangs, target):
    fk = seeded_planes(pk, seed)
    P = pk.pb.valid.shape[0]
    arrays = lay_gangs(seed, len(pk.pending), P) if gangs else j_wlg.gang_arrays(P, {}, {})
    extra = None
    if target:
        rng = np.random.default_rng(seed)
        N = pk.nt.allocatable.shape[0]
        extra = rng.integers(0, 300, size=(P, N)).astype(np.int64)
        extra[:, int(np.nonzero(np.asarray(pk.nt.valid))[0][-1])] += 1 << 40
    return fk, arrays, extra


def _compare_run(pk, fk, arrays, extra, jvol=None, pvol=None):
    jw, pw = [pk.wt[k] for k in WT], [pk.pwt[k] for k in WT]
    dk = dict(d_cap=pk.d_cap, d2_cap=pk.wt["d2_cap"])
    jg, pg = _gang_kw(arrays, True), _gang_kw(arrays, False)
    want = j_cf.counterfactual_run(pk.jdc, pk.jdb, pk.jhk, pk.v_cap, jg.pop("g_cap"), *jw, **jg,
                                   **{k: jnp.asarray(v) for k, v in fk.items()}, **(jvol or {}), **pk.tables, **dk,
                                   extra_score=None if extra is None else jnp.asarray(extra))
    want = {k: np.asarray(v) for k, v in want.items()}
    planes = convert.fork_planes_from_numpy(fk, "cpu")
    g_cap = pg.pop("g_cap")
    es = None if extra is None else torch.from_numpy(extra)
    for fn in (p_cf.counterfactual_run_plain, p_cf.counterfactual_run):
        out = fn(pk.pdc, pk.pdb, pk.hk, pk.v_cap, g_cap, *pw, **pg, **planes.kwargs(), **(pvol or {}), **pk.tables,
                 **dk, extra_score=es)
        host = p_cf.readback(out)
        for k in p_cf.OUTPUT_KEYS:
            assert_same(want[k], out[k], f"{fn.__name__} {k}")
            assert_same(want[k], host[k], f"readback {k}")
    assert_same(pk.nt.requested, pk.pdc.requested, "dc.requested untouched")
    return want


@pytest.mark.parametrize("case,gangs,target", [(GEN[0][0], True, False), (GEN[1][0], True, True),
                                               (GEN[2][0], False, False)],
                         ids=[GEN[0][1] + "-gangs", GEN[1][1] + "-gangs-target", GEN[2][1]])
def test_counterfactual_run_matches_reference(case, gangs, target):
    pk = packed(case)
    want = _compare_run(pk, *_cf_case(pk, case[1], gangs, target))
    adm, chosen, verdict = want["admitted"], want["chosen"], want["gang_admit"][:5]
    assert (adm[5:] == 0).all() and (chosen[5:] < 0).all()  # padding forks place nothing
    assert len(set(adm[:5].tolist())) > 1  # the forks differ
    if gangs:
        assert (verdict[:, 1] == 0).all()  # the short gang rolls back in every fork
        assert (verdict == 1).any()
    if case == GEN[0][0]:  # a gang admitted in one fork rolls back in another
        assert ((verdict == 0).any(axis=0) & (verdict == 1).any(axis=0)).any()
    assert want["reasons"][:5].sum() > 0


def test_counterfactual_run_with_volumes_matches_reference():
    pk = vol_packed((41, 10, 20, 20))
    fk, arrays, _ = _cf_case(pk, 41, True, False)
    want = _compare_run(pk, fk, arrays, None, pk.volt, pk.pvolt)
    assert want["admitted"][:5].sum() > 0


def test_workloads_run_with_extra_score_matches_reference():
    """workloads_run with an extra score row per pod (random values and a
    dominating bonus at one node), with and without gangs."""
    case = GEN[0][0]
    pk = packed(case)
    P = pk.pb.valid.shape[0]
    _, _, extra = _cf_case(pk, 5, False, True)
    jw, pw = [pk.wt[k] for k in WT], [pk.pwt[k] for k in WT]
    dk = dict(d_cap=pk.d_cap, d2_cap=pk.wt["d2_cap"])
    for gangs in (False, True):
        arrays = lay_gangs(case[1], len(pk.pending), P) if gangs else j_wlg.gang_arrays(P, {}, {})
        jg, pg = _gang_kw(arrays, True), _gang_kw(arrays, False)
        want = _outputs(j_cos.workloads_run(pk.jdc, pk.jdb, pk.jhk, pk.v_cap, jg.pop("g_cap"), *jw, **jg, **pk.tables,
                                            **dk, extra_score=jnp.asarray(extra)))
        got = _outputs(p_cos.workloads_run(pk.pdc, pk.pdb, pk.hk, pk.v_cap, pg.pop("g_cap"), *pw, **pg, **pk.tables,
                                           **dk, extra_score=torch.from_numpy(extra)))
        for w, o, name in zip(want, got, OUT_NAMES):
            assert_same(w, o, f"workloads_run gangs={gangs} {name}")
    target = int(np.nonzero(np.asarray(pk.nt.valid))[0][-1])
    assert (np.asarray(want[0]) == target).sum() > 0


# ---------------------------------------------------------------------------
# the serial oracle
# ---------------------------------------------------------------------------


def test_serial_plan_matches_reference():
    """serial_plan over the same specs on both packages' objects, with a
    gang, clones, removals, evictions and a target node."""
    rng = random.Random(19)
    pair = twins()
    pods_of = build_env(pair, random_env(rng))
    placed = sorted(p.name for p in pair[1].s.cache.placed_pods())
    specs = [dict(label="baseline"), dict(label="evict", evict=tuple(placed[:4])),
             dict(label="remove", remove=("node-0",)), dict(label="scale", scale=(("node-1", 1, 2),)),
             dict(label="add", add=(("node-2", "node-2~cf0"), ("node-2", "node-2~cf1")), cordon=("node-2",))]
    outs = []
    for tw, mod in zip(pair, (j_oracle_planner, p_oracle_planner)):
        s = tw.s
        batch = pods_of(tw)
        tw.batch_uid = {p.name: p.uid for p in batch}
        kw = dict(nodes=[cn.node for cn in s.cache.real_nodes()], placed=s.cache.placed_pods(), pods=batch,
                  forks=tw.forks(specs), groups={"default/pg": s.gangs.get("default/pg")}, needs={"default/pg": 2})
        outs.append([mod.serial_plan(**kw), mod.serial_plan(**kw, target_node="node-3")])
    assert outs[1] == outs[0]
    assert len({o["admitted"] for o in outs[1][0]}) > 1 and any(o["target_ok"] for o in outs[1][1])


def test_fork_planes_from_numpy_keeps_dtypes():
    pk = packed(GEN[0][0])
    fk = seeded_planes(pk, 1)
    planes = convert.fork_planes_from_numpy(fk, "cpu")
    for k in PLANES:
        if k == "fk_nvalid":
            assert planes.fk_nvalid == tuple(int(x) for x in fk[k])
        else:
            assert_same(fk[k], getattr(planes, k), k)
