"""Preemption at module level: K10's plain version, the nominated-pod charge
of the shared per-pod step, and the evaluator, each against the JAX
package's.

* ``narrow_candidates_plain`` against the JAX root
  ``kubernetes_tpu.ops.preemption.narrow_candidates`` (run on the CPU as
  tests/test_preemption.py runs it) on six tests/gen.py clusters with
  numpy-seeded priorities: 1-4 priority groups with padded groups, victims
  on every node and on none, batch peers above, equal to and below each
  group, padded rows; plus the four hand cases of
  tests/test_preemption.py::test_narrow_candidates_charges_committed_batch_peers.
* gang_schedule / gang_run (tests/test_gang.py seeds), wave_schedule /
  wave_run (tests/test_wave.py seeds) and both branches of chain_dispatch
  with ``nom_node`` / ``nom_prio`` / ``nom_req`` set, nominations above,
  equal to and below the batch's priorities with pad rows; all-pad
  nominations equal none.
* The evaluator (framework/preemption.py) against the JAX one on seeded
  host states with PDBs and nominations: per node the victims in order and
  their PDB-violation count, the dry run's candidates, the chosen node.

Inputs are packed by the reference and carried across by
kubernetes_tpu_torch.convert.  Every output is an integer or a bool: the
tolerance is zero.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as j_types
from kubernetes_tpu.framework.preemption import Evaluator as JEvaluator
from kubernetes_tpu.ops import chain as j_chain
from kubernetes_tpu.ops import gang as j_gang
from kubernetes_tpu.ops import preemption as j_pre
from kubernetes_tpu.ops import wave as j_wave
from kubernetes_tpu.ops.common import DeviceBatch as JBatch
from kubernetes_tpu.ops.common import DeviceCluster as JCluster
from kubernetes_tpu.ops.common import I32 as J_I32
from kubernetes_tpu.oracle.state import OracleState as JState
from kubernetes_tpu.queue.nominator import Nominator as JNominator
from kubernetes_tpu.snapshot.cluster import pack_cluster
from kubernetes_tpu.snapshot.interner import Vocab
from kubernetes_tpu.snapshot.schema import ResourceLanes, pack_pod_batch
from kubernetes_tpu.snapshot.selectors import METADATA_NAME_KEY
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.framework.preemption import Evaluator as PEvaluator
from kubernetes_tpu_torch.ops import chain as p_chain
from kubernetes_tpu_torch.ops import gang as p_gang
from kubernetes_tpu_torch.ops import preemption as p_pre
from kubernetes_tpu_torch.ops import wave as p_wave
from kubernetes_tpu_torch.oracle.state import OracleState as PState
from kubernetes_tpu_torch.queue.nominator import Nominator as PNominator
from tests.gen import make_cluster, make_pod
from tests.test_gang import NS_LABELS
from tests.test_torch_gang import CASES as GANG_CASES
from tests.test_torch_gang import packed as gang_packed
from tests.test_torch_pack import JAX_API, PORT_API
from tests.test_torch_wave import CASES as WAVE_CASES
from tests.test_torch_wave import IDS as WAVE_IDS
from tests.test_torch_wave import OUT_NAMES
from tests.test_torch_wave import _outputs as wave_outputs
from tests.test_torch_wave import packed as wave_packed

INT32_MIN = -(2**31)
PRIOS = (0, 5, 10, 20, 50, 100, 200)
GROUP_PRIOS = (5, 10, 20, 50, 100)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(want, got, what):
    w, g = np.asarray(want), _np(got)
    assert w.shape == g.shape, f"{what}: shape {g.shape} != {w.shape}"
    assert w.dtype == g.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    assert np.array_equal(w, g), f"{what}: {np.argwhere(w != g)[:5].tolist()}"


# ---------------------------------------------------------------------------
# K10: narrow_candidates
# ---------------------------------------------------------------------------


class Narrow:
    """A tests/gen.py cluster whose placed pods and failed batch carry
    numpy-seeded priorities, packed by the reference on both sides, with
    the victim rows of every placed pod."""

    def __init__(self, seed, n_nodes, n_placed, n_pending, n_groups, victims="some"):
        rng = random.Random(seed)
        nprng = np.random.default_rng(seed)
        nodes, placed = make_cluster(rng, n_nodes, n_placed)
        pending = [make_pod(rng, f"pend-{i}") for i in range(n_pending)]
        groups = sorted(nprng.choice(GROUP_PRIOS, size=n_groups, replace=False).tolist())
        for p in pending:
            p.priority = int(nprng.choice(groups))
        for p in placed:
            # "every": a lower-priority pod on every node; "none": no victim
            p.priority = {"none": 1000, "every": 0}.get(victims, int(nprng.choice(PRIOS)))
        if victims == "every":
            placed += [
                j_types.Pod(name=f"low-{n.name}", node_name=n.name, priority=-1,
                            containers=[j_types.Container(name="c", requests={"cpu": "100m"})])
                for n in nodes
            ]
        state = JState.build(nodes, placed, namespace_labels=NS_LABELS)
        vocab = Vocab()
        pc = pack_cluster(state, vocab, pending_pods=pending)
        self.pb = pack_pod_batch(pending, vocab, k_cap=pc.nodes.k_cap, namespace_labels=NS_LABELS)
        nt = pc.nodes
        self.N = nt.valid.shape[0]
        R = nt.allocatable.shape[1]
        lanes = ResourceLanes(vocab)
        E = len(placed) + 3  # three pad rows
        self.vnode = np.full(E, -1, np.int32)
        self.vprio = np.zeros(E, np.int32)
        self.vreq = np.zeros((E, R), np.int32)
        for i, p in enumerate(placed):
            self.vnode[i] = nt.name_to_idx[p.node_name]
            self.vprio[i] = p.priority
            self.vreq[i] = lanes.request_row(p.compute_requests(), R)
        G = len(groups) + 1  # one pad group
        self.groups = np.full(G, INT32_MIN, np.int32)
        self.groups[: len(groups)] = groups
        self.pg = np.zeros(self.pb.valid.shape[0], np.int32)
        self.pg[: len(pending)] = [groups.index(p.priority) for p in pending]
        # batch peers: random nodes, priorities around every group's, pads
        B2 = 2 * len(pending) + 2
        self.bnode = nprng.integers(-1, len(nodes), size=B2).astype(np.int32)
        self.bprio = nprng.choice(sorted({g + d for g in groups for d in (-1, 0, 1)}), size=B2).astype(np.int32)
        self.breq = np.zeros((B2, R), np.int32)
        self.breq[:, 0] = nprng.integers(0, 3000, size=B2)
        self.breq[:, 1] = nprng.integers(0, 4096, size=B2)
        self.jdc = JCluster.from_host(nt, pc.existing, vocab)
        self.jdb = JBatch.from_host(self.pb)
        self.pdc = convert.cluster_from_numpy(
            nt, name_key=vocab.label_keys.lookup(METADATA_NAME_KEY),
            unsched_key=vocab.label_keys.lookup("node.kubernetes.io/unschedulable"),
            empty_val=vocab.label_vals.lookup(""), device="cpu", ep=pc.existing,
        )
        self.pdb = convert.batch_from_numpy(self.pb, "cpu")

    def run(self, peers: bool):
        rows = (self.vnode, self.vprio, self.vreq, self.groups, self.pg)
        kw = dict(batch_node=self.bnode, batch_prio=self.bprio, batch_req=self.breq) if peers else {}
        want = j_pre.narrow_candidates(self.jdc, self.jdb, *(jnp.asarray(a) for a in rows),
                                       **{k: jnp.asarray(v) for k, v in kw.items()})
        got = p_pre.narrow_candidates_plain(self.pdc, self.pdb, *(torch.from_numpy(a) for a in rows),
                                            **{k: torch.from_numpy(v) for k, v in kw.items()})
        return np.asarray(want), got


NARROW_CASES = [
    (31, 10, 20, 20, 1, "some"),
    (33, 10, 30, 16, 2, "some"),
    (101, 40, 80, 60, 3, "some"),
    (303, 40, 120, 60, 4, "some"),
    (7, 24, 40, 32, 2, "every"),
    (8, 24, 40, 32, 3, "none"),
]


@pytest.mark.parametrize("case", NARROW_CASES, ids=[f"{c[0]}-g{c[4]}-{c[5]}" for c in NARROW_CASES])
@pytest.mark.parametrize("peers", [False, True], ids=["no-peers", "peers"])
def test_narrow_candidates_plain_matches_reference(case, peers):
    nw = Narrow(*case)
    want, got = nw.run(peers)
    assert_same(want, got, "mask")
    # the wrapper takes the plain version for CPU tensors
    rows = (nw.vnode, nw.vprio, nw.vreq, nw.groups, nw.pg)
    kw = dict(batch_node=nw.bnode, batch_prio=nw.bprio, batch_req=nw.breq) if peers else {}
    via = p_pre.narrow_candidates(nw.pdc, nw.pdb, *(torch.from_numpy(a) for a in rows),
                                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert_same(want, via, "narrow_candidates")
    if case[5] == "none" and not peers:
        assert not want.any()
    if case[5] == "every":
        assert want[: case[3]].any()


def test_narrow_candidates_pads_change_nothing():
    """Extra pad victims, pad groups and pad peers leave the mask as it was."""
    nw = Narrow(101, 40, 80, 60, 3)
    base, _ = nw.run(peers=True)
    nw.vnode = np.concatenate([nw.vnode, np.full(9, -1, np.int32)])
    nw.vprio = np.concatenate([nw.vprio, np.full(9, 7, np.int32)])
    nw.vreq = np.concatenate([nw.vreq, np.full((9, nw.vreq.shape[1]), 5, np.int32)])
    nw.groups = np.concatenate([nw.groups, np.full(3, INT32_MIN, np.int32)])
    nw.bnode = np.concatenate([nw.bnode, np.full(5, -1, np.int32)])
    nw.bprio = np.concatenate([nw.bprio, np.zeros(5, np.int32)])
    nw.breq = np.concatenate([nw.breq, np.ones((5, nw.breq.shape[1]), np.int32)])
    want, got = nw.run(peers=True)
    assert_same(base, want, "reference with pads")
    assert_same(base, got, "port with pads")


def _hand_masks(batch_rows):
    """tests/test_preemption.py's hand cases: two empty 4-cpu nodes, one
    failed pod of 4 cpu at priority 50, no placed victims."""
    T, R = JAX_API
    jnodes = [T.Node(name=f"n{i}", labels={"kubernetes.io/hostname": f"n{i}"},
                     capacity=R.Resource.from_map({"cpu": "4", "memory": "16Gi", "pods": 50})) for i in range(2)]
    failed = j_types.Pod(name="f", priority=50,
                         containers=[j_types.Container(name="c", requests={"cpu": "4", "memory": "64Mi"})])
    vocab = Vocab()
    pc = pack_cluster(JState.build(jnodes), vocab, pending_pods=[failed])
    pb = pack_pod_batch([failed], vocab, k_cap=pc.nodes.k_cap)
    jdc = JCluster.from_host(pc.nodes, pc.existing, vocab)
    pdc = convert.cluster_from_numpy(
        pc.nodes, name_key=vocab.label_keys.lookup(METADATA_NAME_KEY),
        unsched_key=vocab.label_keys.lookup("node.kubernetes.io/unschedulable"),
        empty_val=vocab.label_vals.lookup(""), device="cpu", ep=pc.existing,
    )
    R = pc.nodes.allocatable.shape[1]
    rows = (np.full(4, -1, np.int32), np.zeros(4, np.int32), np.zeros((4, R), np.int32),
            np.asarray([50], np.int32), np.zeros(pb.valid.shape[0], np.int32))
    kw = {}
    if batch_rows is not None:
        bn, bp, br = batch_rows
        req = np.zeros((1, R), np.int32)
        req[0, 0] = br
        kw = dict(batch_node=np.asarray(bn, np.int32), batch_prio=np.asarray(bp, np.int32), batch_req=req)
    want = np.asarray(j_pre.narrow_candidates(jdc, JBatch.from_host(pb), *(jnp.asarray(a) for a in rows),
                                              **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = p_pre.narrow_candidates_plain(pdc, convert.batch_from_numpy(pb, "cpu"),
                                        *(torch.from_numpy(a) for a in rows),
                                        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert_same(want, got, "hand case")
    return got.numpy()


def test_narrow_candidates_hand_cases_charge_committed_batch_peers():
    assert not _hand_masks(None)[0].any()  # no victims anywhere
    m = _hand_masks(([0], [10], 4000))  # a lower peer: a future victim
    assert m[0, 0] and not m[0, 1]
    assert not _hand_masks(([0], [100], 4000))[0].any()  # a higher peer is kept
    assert not _hand_masks(([0], [50], 4000))[0].any()  # an equal peer is ignored


# ---------------------------------------------------------------------------
# The nominated-pod charge in the shared per-pod step
# ---------------------------------------------------------------------------


def _nominations(seed, pb, nt, n=12):
    """numpy-seeded nominations: priorities below, equal to and above the
    batch's, requests up to half a node, and two pad rows."""
    rng = np.random.default_rng(seed)
    prios = np.asarray(pb.priority)[np.asarray(pb.valid)]
    base = int(prios.max()) if prios.size else 0
    N = int(np.asarray(nt.valid).sum())
    R = nt.allocatable.shape[1]
    node = rng.integers(0, N, size=n).astype(np.int32)
    node[:2] = -1
    prio = rng.choice([base - 1, base, base + 1], size=n).astype(np.int32)
    req = np.zeros((n, R), np.int32)
    alloc = np.asarray(nt.allocatable)
    for g in range(n):
        req[g, 0] = int(alloc[max(node[g], 0), 0] * rng.uniform(0.2, 0.7))
        req[g, 1] = int(alloc[max(node[g], 0), 1] * rng.uniform(0.1, 0.5))
    return node, prio, req


def _nom_kw(nom, jax_side: bool):
    if nom is None:
        return {}
    conv = jnp.asarray if jax_side else torch.from_numpy
    return dict(nom_node=conv(nom[0]), nom_prio=conv(nom[1]), nom_req=conv(nom[2]))


@pytest.mark.parametrize("case", GANG_CASES)
def test_gang_schedule_with_nominations_matches_reference(case):
    pk = gang_packed(case)
    d_cap, tj = pk.ref_tables()
    _, tp = pk.port_tables()
    g = j_gang.precompute(pk.jdc, pk.jdb, jnp.asarray(pk.hk, J_I32), pk.v_cap, **tj)
    pg = convert.statics_from_numpy(g, "cpu")
    nom = _nominations(case[0], pk.pb, pk.nt)
    names = ("chosen", "n_feas", "reason_counts", "requested", "nonzero", "num_pods")

    def outs(o):
        chosen, n_feas, rc, t = o
        return [chosen, n_feas, rc, t["requested"], t["nonzero"], t["num_pods"]]

    want = outs(j_gang.gang_schedule(pk.jdc, pk.jdb, g, pk.v_cap, d_cap=d_cap, **_nom_kw(nom, True)))
    got = outs(p_gang.gang_schedule(pk.pdc, pk.pdb, pg, pk.v_cap, d_cap=d_cap, **_nom_kw(nom, False)))
    for w, o, name in zip(want, got, names):
        assert_same(w, o, name)
    run = outs(p_gang.gang_run(pk.pdc, pk.pdb, pk.hk, pk.v_cap, d_cap=d_cap, **tp, **_nom_kw(nom, False)))
    jrun = outs(j_gang.gang_run(pk.jdc, pk.jdb, jnp.asarray(pk.hk, J_I32), pk.v_cap, d_cap=d_cap, **tj,
                                **_nom_kw(nom, True)))
    for w, o, name in zip(jrun, run, names):
        assert_same(w, o, "gang_run " + name)
    # the charge moved something, and all-pad nominations equal none
    plain = outs(p_gang.gang_schedule(pk.pdc, pk.pdb, pg, pk.v_cap, d_cap=d_cap))
    assert not all(np.array_equal(_np(a), _np(b)) for a, b in zip(plain[:3], got[:3]))
    pads = (np.full(3, -1, np.int32), np.full(3, 99, np.int32), np.full((3, nom[2].shape[1]), 7, np.int32))
    padded = outs(p_gang.gang_schedule(pk.pdc, pk.pdb, pg, pk.v_cap, d_cap=d_cap, **_nom_kw(pads, False)))
    for w, o, name in zip(plain, padded, names):
        assert_same(_np(w), o, "all-pad " + name)


@pytest.mark.parametrize("case", WAVE_CASES, ids=WAVE_IDS)
def test_wave_schedule_with_nominations_matches_reference(case):
    pk = wave_packed(case)
    seed = case[1]
    nom = _nominations(seed, pk.pb, pk.nt)
    want = wave_outputs(j_wave.wave_schedule(pk.jdc, pk.jdb, pk.g, pk.jhk, pk.v_cap, *pk.wave_args(pk.wt),
                                             **pk.wave_kw(pk.wt), **_nom_kw(nom, True)))
    for fn in (p_wave.wave_schedule_plain, p_wave.wave_schedule):
        got = wave_outputs(fn(pk.pdc, pk.pdb, pk.pg, pk.hk, pk.v_cap, *pk.wave_args(pk.pwt), **pk.wave_kw(pk.pwt),
                              **_nom_kw(nom, False)))
        for w, o, name in zip(want, got, OUT_NAMES):
            assert_same(w, o, f"{fn.__name__} {name}")
    j_run = wave_outputs(j_wave.wave_run(pk.jdc, pk.jdb, pk.jhk, pk.v_cap, *pk.wave_args(pk.wt), **pk.tables,
                                         **pk.wave_kw(pk.wt), **_nom_kw(nom, True)))
    p_run = wave_outputs(p_wave.wave_run(pk.pdc, pk.pdb, pk.hk, pk.v_cap, *pk.wave_args(pk.pwt), **pk.tables,
                                         **pk.wave_kw(pk.pwt), **_nom_kw(nom, False)))
    for w, o, name in zip(j_run, p_run, OUT_NAMES):
        assert_same(w, o, "wave_run " + name)
    # the wave with nominations places as the gang scan with them
    gang = p_gang.gang_run(pk.pdc, pk.pdb, pk.hk, pk.v_cap, d_cap=pk.d_cap, has_ports=True, **pk.tables,
                           **_nom_kw(nom, False))
    assert_same(gang[0], p_run[0], "wave == gang scan")


@pytest.mark.parametrize("wave", [False, True], ids=["scan", "wave"])
def test_chain_dispatch_with_nominations_matches_reference(wave, monkeypatch):
    """tests/test_torch_chain.py's three chained batches, with nominations
    charged on every batch."""
    import tests.test_torch_chain as tc

    seen = []
    j_dispatch, p_dispatch = j_chain.chain_dispatch, p_chain.chain_dispatch

    def nominated(fn, jax_side):
        def call(dc, db, *a, **kw):
            n = int(np.asarray(dc.node_valid).sum())
            R = dc.allocatable.shape[1]
            rng = np.random.default_rng(len(seen) // 2)
            node = rng.integers(-1, n, size=10).astype(np.int32)
            prio = rng.choice([-1, 0, 1], size=10).astype(np.int32)
            req = np.zeros((10, R), np.int32)
            req[:, 0] = rng.integers(500, 4000, size=10)
            seen.append(1)
            return fn(dc, db, *a, **kw, **_nom_kw((node, prio, req), jax_side))

        return call

    monkeypatch.setattr(tc.j_chain, "chain_dispatch", nominated(j_dispatch, True))
    monkeypatch.setattr(tc.p_chain, "chain_dispatch", nominated(p_dispatch, False))
    tc._chain_three_batches(7, wave=wave)
    assert len(seen) == 6


# ---------------------------------------------------------------------------
# The evaluator
# ---------------------------------------------------------------------------


class _Handle:
    def __init__(self, state, nominator, pdbs):
        self.state = state
        self.nominator = nominator
        self.pdbs = pdbs
        self.deleted = []

    def oracle_state(self):
        return self.state

    def list_pdbs(self):
        return self.pdbs

    def delete_pod(self, pod):
        self.deleted.append(pod.name)

    def get_waiting_pod(self, uid):
        return None

    def activate(self, pods):
        pass

    def note_preemption(self, n):
        pass


def _evaluator_world(api, seed):
    """Numpy-seeded nodes full of pods at mixed priorities, labels that two
    PDBs select, start times with ties and gaps, and three nominations."""
    T, R = api
    rng = np.random.default_rng(seed)
    nodes = [
        T.Node(name=f"n{i}", labels={"kubernetes.io/hostname": f"n{i}", "zone": f"z{i % 3}"},
               capacity=R.Resource.from_map({"cpu": str(int(rng.choice([2, 4, 8]))), "memory": "16Gi",
                                             "pods": 20}))
        for i in range(16)
    ]
    placed = []
    for n in nodes:
        cpu = int(n.allocatable.milli_cpu)
        used = 0
        k = 0
        while used < cpu:
            req = int(rng.choice([250, 500, 1000]))
            placed.append(T.Pod(
                name=f"{n.name}-p{k}", node_name=n.name, priority=int(rng.choice([0, 5, 10, 50, 200])),
                labels={"app": str(rng.choice(["db", "web", "batch"]))},
                start_time=None if rng.random() < 0.2 else float(rng.integers(0, 5)),
                containers=[T.Container(name="c", requests={"cpu": f"{req}m", "memory": "128Mi"})],
            ))
            used += req
            k += 1
    st = (JState if api is JAX_API else PState).build(nodes, placed)
    nom = (JNominator if api is JAX_API else PNominator)()
    for i, node in enumerate(("n1", "n4", "n7")):
        np_ = T.Pod(name=f"nom-{i}", priority=int((40, 60, 300)[i]),
                    containers=[T.Container(name="c", requests={"cpu": "1", "memory": "128Mi"})])
        nom.add(np_, node)
    pdbs = [
        T.PodDisruptionBudget(name="db", selector=T.LabelSelector(match_labels={"app": "db"}),
                              disruptions_allowed=1),
        T.PodDisruptionBudget(name="web", selector=T.LabelSelector(match_labels={"app": "web"}),
                              disruptions_allowed=0),
    ]
    return st, nom, pdbs


def _victims(v):
    return None if v is None else ([p.name for p in v.pods], v.num_pdb_violations)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_evaluator_matches_reference(seed):
    sides = []
    for api, Ev in ((JAX_API, JEvaluator), (PORT_API, PEvaluator)):
        st, nom, pdbs = _evaluator_world(api, seed)
        h = _Handle(st, nom, pdbs)
        sides.append((api, Ev("DefaultPreemption", h, percentage=10, min_candidates=5), h, st, pdbs))
    for cpu, prio in (("1500m", 60), ("3", 100), ("500m", 7), ("6", 250)):
        per_side = []
        for api, ev, h, st, pdbs in sides:
            T, _ = api
            pod = T.Pod(name="pre", priority=prio,
                        containers=[T.Container(name="c", requests={"cpu": cpu, "memory": "256Mi"})])
            ev._fast_fit = True
            per_node = {n: _victims(ev.select_victims_on_node(pod, st, n, pdbs)) for n in st.nodes}
            potential = ev.potential_nodes(pod, st)
            cands = ev.dry_run(pod, st, potential, ev.offset_and_num_candidates(len(potential))[1], pdbs)
            best = ev.select_candidate(cands).name if cands else None
            name, _ = ev.preempt(pod)
            per_side.append((per_node, potential, [(c.name, _victims(c.victims)) for c in cands], best, name,
                             list(h.deleted)))
        want, got = per_side
        assert got == want
