"""The speculative wave, module level: the port's wave_tables, factored
algebra, wave_schedule, wave_run and interaction_groups against the JAX
package's, on the inputs of tests/test_wave.py.

Cases: the (cluster, batch) pairs of test_wave_matches_gang_and_serial
(tests/gen.py make_cluster / make_pod on seeds 41, 42, 43, 111, 222, 333:
spread, inter-pod terms, host ports, taints) and the port-heavy mixes of
test_port_heavy_wave_matches_serial (seeds 1, 7, 23 on ten zone nodes),
packed by the reference and carried across by kubernetes_tpu_torch.convert.
On the CPU the port runs its plain versions.  Every output is an integer or
a bool, so the tolerance is zero: the tables, every factored tensor, and the
five wave outputs (stats [3, P] included) must be identical.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.observability import kernels as j_kernels
from kubernetes_tpu.oracle.scores import HOSTNAME_LABEL
from kubernetes_tpu.oracle.state import OracleState
from kubernetes_tpu.ops import gang as j_gang
from kubernetes_tpu.ops import wave as j_wave
from kubernetes_tpu.ops.common import DeviceBatch as JBatch
from kubernetes_tpu.ops.common import DeviceCluster as JCluster
from kubernetes_tpu.ops.common import I32 as J_I32
from kubernetes_tpu.snapshot.cluster import pack_cluster
from kubernetes_tpu.snapshot.interner import Vocab
from kubernetes_tpu.snapshot.schema import bucket_cap, pack_pod_batch
from kubernetes_tpu.snapshot.selectors import METADATA_NAME_KEY
from kubernetes_tpu.tools.paritycheck import _port_heavy_pods
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import gang as p_gang
from kubernetes_tpu_torch.ops import wave as p_wave
from tests.gen import make_cluster, make_pod
from tests.test_wave import NS_LABELS, _zone_nodes, run_serial

GEN_CASES = [(41, 10, 20, 20), (42, 10, 20, 20), (43, 12, 24, 24), (111, 40, 80, 120), (222, 40, 80, 120),
             (333, 40, 80, 120)]
PORT_SEEDS = [1, 7, 23]
CASES = [("gen",) + c for c in GEN_CASES] + [("ports", s) for s in PORT_SEEDS]
IDS = [f"gen-{c[0]}" for c in GEN_CASES] + [f"ports-{s}" for s in PORT_SEEDS]
WT_ARRAYS = ("tid_sp", "rep_sp_p", "rep_sp_c", "tid_ip", "rep_ip_p", "rep_ip_u", "ip_cdv_tab", "tid_pt", "port_conf")


def _workload(case):
    """(nodes, placed, pending) of one case, fresh objects each call."""
    if case[0] == "gen":
        _, seed, n_nodes, n_placed, n_pending = case
        rng = random.Random(seed)
        nodes, placed = make_cluster(rng, n_nodes, n_placed)
        return nodes, placed, [make_pod(rng, f"pend-{i}") for i in range(n_pending)]
    return _zone_nodes(10), [], _port_heavy_pods(48, seed=case[1], apps=6, prefix="pt")


class Packed:
    """One case packed by the reference, on both sides, with the reference's
    statics and wave tables."""

    def __init__(self, case):
        j_kernels.deactivate()
        nodes, placed, self.pending = _workload(case)
        self.state = OracleState.build(nodes, placed, namespace_labels=NS_LABELS)
        vocab = Vocab()
        pc = pack_cluster(self.state, vocab, pending_pods=self.pending)
        self.pb = pack_pod_batch(self.pending, vocab, k_cap=pc.nodes.k_cap, namespace_labels=NS_LABELS)
        self.nt = pc.nodes
        self.v_cap = bucket_cap(len(vocab.label_vals))
        self.hk = vocab.label_keys.lookup(HOSTNAME_LABEL)
        self.jhk = jnp.asarray(self.hk, J_I32)
        tables = j_gang.batch_tables(self.pb.tsc_topo_key, self.pb.aff_topo_key, self.nt.label_vals, self.hk)
        self.d_cap = tables.pop("d_cap")
        self.tables = tables
        self.jdc = JCluster.from_host(self.nt, pc.existing, vocab)
        self.jdb = JBatch.from_host(self.pb)
        self.pdc = convert.cluster_from_numpy(
            self.nt, name_key=vocab.label_keys.lookup(METADATA_NAME_KEY),
            unsched_key=vocab.label_keys.lookup("node.kubernetes.io/unschedulable"),
            empty_val=vocab.label_vals.lookup(""), device="cpu", ep=pc.existing,
        )
        self.pdb = convert.batch_from_numpy(self.pb, "cpu")
        self.wt = j_wave.wave_tables(self.pb, self.nt.label_vals, self.hk)
        assert self.wt is not None
        self.pwt = convert.wave_tables_from_numpy(self.wt, "cpu")
        self.g = j_gang.precompute(self.jdc, self.jdb, self.jhk, self.v_cap, **tables)
        self.pg = convert.statics_from_numpy(self.g, "cpu")

    def wave_args(self, wt):
        return [wt[k] for k in WT_ARRAYS[:7]]

    def wave_kw(self, wt):
        return dict(d_cap=self.d_cap, d2_cap=wt["d2_cap"], has_ports=wt["has_ports"], tid_pt=wt["tid_pt"],
                    port_conf=wt["port_conf"])


_PACKED = {}


def packed(case) -> Packed:
    if case not in _PACKED:
        _PACKED[case] = Packed(case)
    return _PACKED[case]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(want, got, what):
    w, g = np.asarray(want), _np(got)
    assert w.shape == g.shape, f"{what}: shape {g.shape} != {w.shape}"
    assert w.dtype == g.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    assert np.array_equal(w, g), f"{what}: {np.argwhere(w != g)[:5].tolist()}"


def _outputs(out):
    chosen, n_feas, rc, tallies, stats = out
    return [chosen, n_feas, rc, tallies["requested"], tallies["nonzero"], tallies["num_pods"], stats]


OUT_NAMES = ("chosen", "n_feas", "reason_counts", "requested", "nonzero", "num_pods", "stats")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wave_tables_match_reference(case):
    pk = packed(case)
    got = p_wave.wave_tables(pk.pb, pk.nt.label_vals, pk.hk)
    assert set(got) == set(pk.wt)
    for k in WT_ARRAYS:
        assert_same(pk.wt[k], got[k], k)
    for k in ("d2_cap", "has_ports", "n_terms"):
        assert got[k] == pk.wt[k], k
    if case[0] == "ports":
        assert got["has_ports"] and got["port_conf"].shape[0] > 1


def _carry(rng, shape, hi=3):
    return rng.integers(0, hi, size=shape).astype(np.int32)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_factored_algebra_matches_reference(case):
    """term_match_rows, factored_carry_init and, for a sample of pods on
    seeded random carries, factored_spread_dyn, factored_interpod_dyn,
    factored_port_mask and factored_carry_update (to a placed and to no
    node) against the reference's, tensor for tensor."""
    pk = packed(case)
    wt, pwt = pk.wt, pk.pwt
    want = j_wave.term_match_rows(pk.g, wt["rep_sp_p"], wt["rep_sp_c"], wt["rep_ip_p"], wt["rep_ip_u"])
    got = p_wave.term_match_rows(pk.pg, pwt["rep_sp_p"], pwt["rep_sp_c"], pwt["rep_ip_p"], pwt["rep_ip_u"])
    for w, o, name in zip(want, got, ("m_sp_all", "m_ip_all", "t_anti", "t_w")):
        assert_same(w, o, name)
    m_sp_all, m_ip_all, t_anti, t_w = want
    pm_sp_all, pm_ip_all, pt_anti, pt_w = got
    P, N = pk.g.static_mask.shape
    C, AT = pk.g.sp_dv.shape[1], pk.g.ip_dv.shape[1]
    Tsp, Tip, Tpt = wt["rep_sp_p"].shape[0], wt["rep_ip_p"].shape[0], wt["port_conf"].shape[0]
    j_init = j_wave.factored_carry_init(Tsp, Tip, N, Tpt)
    p_init = p_wave.factored_carry_init(Tsp, Tip, N, Tpt)
    assert set(j_init) == set(p_init)
    for k in j_init:
        assert_same(j_init[k], p_init[k], "init " + k)

    rng = np.random.default_rng(case[1])
    carries = {k: _carry(rng, (T, N)) for k, T in (("cnt_sp", Tsp), ("cnt_ip", Tip), ("rev_cnt", Tip),
                                                   ("occ_pt", Tpt))}
    # sparse occupancy, so that some nodes stay free for every port term
    carries["occ_pt"] = np.where(rng.random((Tpt, N)) < 0.2, carries["occ_pt"], 0).astype(np.int32)
    jc = {k: jnp.asarray(v) for k, v in carries.items()}
    pc = {k: torch.as_tensor(v) for k, v in carries.items()}
    n_live = len(pk.pending)
    for p in sorted(set(rng.choice(n_live, size=min(n_live, 6), replace=False).tolist()) | {0, n_live - 1}):
        ip_aux = p_aux = None
        if C:
            w = j_wave.factored_spread_dyn(pk.g, p, wt["tid_sp"], jc["cnt_sp"], pk.d_cap)
            o = p_wave.factored_spread_dyn(pk.pg, p, pwt["tid_sp"], pc["cnt_sp"], pk.d_cap)
            for f in w._fields:
                assert_same(getattr(w, f), getattr(o, f), f"spread {f} p={p}")
        if AT:
            w, ip_aux = j_wave.factored_interpod_dyn(pk.g, pk.jdb, p, wt["tid_ip"], wt["ip_cdv_tab"], wt["d2_cap"],
                                                     pk.jhk, jc["cnt_ip"], jc["rev_cnt"], m_ip_all, t_anti, t_w)
            o, p_aux = p_wave.factored_interpod_dyn(pk.pg, pk.pdb, p, pwt["tid_ip"], pwt["ip_cdv_tab"],
                                                    pwt["d2_cap"], pk.hk, pc["cnt_ip"], pc["rev_cnt"], pm_ip_all,
                                                    pt_anti, pt_w)
            for f in w._fields:
                assert_same(getattr(w, f), getattr(o, f), f"interpod {f} p={p}")
        jpt = ppt = None
        if wt["has_ports"]:
            (mw, jpt), (mo, ppt) = (
                j_wave.factored_port_mask(wt["tid_pt"], wt["port_conf"], jc["occ_pt"], p),
                p_wave.factored_port_mask(pwt["tid_pt"], pwt["port_conf"], pc["occ_pt"], p),
            )
            assert_same(mw, mo, f"m_portb p={p}")
            assert_same(jpt, ppt, f"pt_cnt p={p}")
        jcar = {k: v for k, v in jc.items() if k != "occ_pt" or jpt is not None}
        pcar = {k: v for k, v in pc.items() if k != "occ_pt" or ppt is not None}
        for choice in (int(rng.integers(0, N)), -1):
            w = j_wave.factored_carry_update(jcar, p, jnp.asarray(choice, J_I32), m_sp_all, m_ip_all, ip_aux,
                                             pt_cnt=jpt)
            o = p_wave.factored_carry_update(pcar, p, torch.tensor(choice, dtype=torch.int32), pm_sp_all,
                                             pm_ip_all, p_aux, pt_cnt=ppt)
            assert set(w) == set(o)
            for k in w:
                assert_same(w[k], o[k], f"carry {k} p={p} choice={choice}")
        for k in pcar:  # the inputs are left as they were
            assert_same(carries[k], pcar[k], f"input {k}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_wave_schedule_matches_reference(case):
    """wave_schedule on the reference's own statics (carried across): the
    plain version and the dispatching wrapper; then wave_run end to end;
    all five outputs, stats [3, P] included.  The placements equal the
    port's gang scan's and the serial oracle's."""
    pk = packed(case)
    want = _outputs(j_wave.wave_schedule(pk.jdc, pk.jdb, pk.g, pk.jhk, pk.v_cap, *pk.wave_args(pk.wt),
                                         **pk.wave_kw(pk.wt)))
    for fn in (p_wave.wave_schedule_plain, p_wave.wave_schedule):
        got = _outputs(fn(pk.pdc, pk.pdb, pk.pg, pk.hk, pk.v_cap, *pk.wave_args(pk.pwt), **pk.wave_kw(pk.pwt)))
        for w, o, name in zip(want, got, OUT_NAMES):
            assert_same(w, o, f"{fn.__name__} {name}")
    j_run = _outputs(j_wave.wave_run(pk.jdc, pk.jdb, pk.jhk, pk.v_cap, *pk.wave_args(pk.wt), **pk.tables,
                                     **pk.wave_kw(pk.wt)))
    p_run = _outputs(p_wave.wave_run(pk.pdc, pk.pdb, pk.hk, pk.v_cap, *pk.wave_args(pk.pwt), **pk.tables,
                                     **pk.wave_kw(pk.pwt)))
    for w, o, name in zip(j_run, p_run, OUT_NAMES):
        assert_same(w, o, "wave_run " + name)
    assert_same(pk.nt.requested, pk.pdc.requested, "dc.requested untouched")

    gang = p_gang.gang_run(pk.pdc, pk.pdb, pk.hk, pk.v_cap, d_cap=pk.d_cap, has_ports=True, **pk.tables)
    assert_same(gang[0], p_run[0], "wave == gang scan")
    names = list(pk.state.nodes)
    got = [names[c] if c >= 0 else None for c in p_run[0][: len(pk.pending)].tolist()]
    nodes, placed, pending = _workload(case)
    assert got == run_serial(OracleState.build(nodes, placed, namespace_labels=NS_LABELS), pending)


def test_wave_schedule_stats_cover_every_kind():
    """Across the cases the attribution takes each demotion kind the
    workloads can cause, and the stats rows are consistent: no demotion
    where the admitted node is the speculative one, a term slot only for
    spread and affinity demotions."""
    kinds = set()
    for case in CASES:
        pk = packed(case)
        chosen, _, _, _, stats = p_wave.wave_schedule(pk.pdc, pk.pdb, pk.pg, pk.hk, pk.v_cap,
                                                      *pk.wave_args(pk.pwt), **pk.wave_kw(pk.pwt))
        spec, kind, term = stats
        assert ((kind == p_wave.DEMOTE_NONE) == (chosen == spec)).all()
        assert ((term >= 0) <= ((kind == p_wave.DEMOTE_SPREAD) | (kind == p_wave.DEMOTE_AFFINITY))).all()
        kinds |= set(kind.tolist())
    assert {p_wave.DEMOTE_SCORE, p_wave.DEMOTE_PORTS, p_wave.DEMOTE_SPREAD} <= kinds, kinds


@pytest.mark.parametrize("case", CASES[:3] + CASES[6:7], ids=IDS[:3] + IDS[6:7])
def test_interaction_groups_match_reference(case):
    from kubernetes_tpu_torch.api import types as p_types

    _, _, pending = _workload(case)
    want = j_wave.interaction_groups(pending)
    pods = [_port_pod(p_types, pod) for pod in pending]
    assert p_wave.interaction_groups(pods) == (list(want[0]), want[1])


def _port_pod(T, pod):
    """The reference pod's fields the probes read, as a port Pod."""
    return T.Pod(name=pod.name, namespace=pod.namespace, labels=dict(pod.labels),
                 topology_spread_constraints=tuple(_conv(T, c) for c in pod.topology_spread_constraints),
                 affinity=_conv(T, pod.affinity))


def _conv(T, obj):
    """Deep copy of a reference api object into the port's type of the same
    name (dataclasses field for field)."""
    import dataclasses

    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(_conv(T, x) for x in obj)
    if isinstance(obj, dict):
        return {k: _conv(T, v) for k, v in obj.items()}
    cls = getattr(T, type(obj).__name__)
    return cls(**{f.name: _conv(T, getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def test_duplicate_hostnames_disqualify_the_wave():
    pk = packed(CASES[0])
    lv = np.array(pk.nt.label_vals)
    lv[1, pk.hk] = lv[0, pk.hk]
    assert p_wave.wave_tables(pk.pb, lv, pk.hk) is None
    assert j_wave.wave_tables(pk.pb, lv, pk.hk) is None
    assert p_wave.wave_tables(pk.pb, pk.nt.label_vals, pk.hk, hostnames_unique=False) is None
