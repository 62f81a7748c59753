"""The gang scan, module level: the port's precompute / gang_schedule /
gang_run against the JAX package's, and against the serial oracle.

Inputs are the clusters and pending batches of tests/test_gang.py
(tests/gen.py make_cluster / make_pod: hard and soft spread on hostname and
zone with minDomains and both inclusion policies, required and preferred
(anti-)affinity with namespace lists and selectors, placed pods carrying
terms, host ports, taints and preferred node affinity), packed by the
reference and carried across by kubernetes_tpu_torch.convert.  On the CPU
the port runs its plain versions.  Every output is an integer or a bool, so
the tolerance is zero: all 39 GangStatics fields, chosen, n_feas, the
reason counts and the usage tallies must be identical.
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
from kubernetes_tpu.ops.common import DeviceBatch as JBatch
from kubernetes_tpu.ops.common import DeviceCluster as JCluster
from kubernetes_tpu.ops.common import I32 as J_I32
from kubernetes_tpu.snapshot.cluster import pack_cluster
from kubernetes_tpu.snapshot.interner import Vocab
from kubernetes_tpu.snapshot.schema import bucket_cap, pack_pod_batch
from kubernetes_tpu.snapshot.selectors import METADATA_NAME_KEY
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import gang as p_gang
from tests.gen import make_cluster, make_pod
from tests.test_gang import NS_LABELS, run_serial

# seeds and sizes of tests/test_gang.py::test_gang_matches_serial_oracle
CASES = [(31, 10, 20, 20), (33, 10, 20, 20), (101, 40, 80, 120), (303, 40, 80, 120)]

NO_SPREAD_IP = frozenset({"NodeName", "NodeUnschedulable", "NodeAffinity", "NodePorts", "NodeResourcesFit"})
NO_TAINTS = p_gang.ALL_FILTER_KERNELS - {"TaintToleration"}


class Packed:
    """One (cluster, batch) pair packed by the reference, on both sides."""

    def __init__(self, seed, n_nodes, n_placed, n_pending):
        j_kernels.deactivate()
        rng = random.Random(seed)
        nodes, placed = make_cluster(rng, n_nodes, n_placed)
        self.pending = [make_pod(rng, f"pend-{i}") for i in range(n_pending)]
        self.state = OracleState.build(nodes, placed, namespace_labels=NS_LABELS)
        self.vocab = vocab = Vocab()
        pc = pack_cluster(self.state, vocab, pending_pods=self.pending)
        self.pb = pack_pod_batch(self.pending, vocab, k_cap=pc.nodes.k_cap, namespace_labels=NS_LABELS)
        self.nt, self.ep = pc.nodes, pc.existing
        self.v_cap = bucket_cap(len(vocab.label_vals))
        self.hk = vocab.label_keys.lookup(HOSTNAME_LABEL)
        self.tables = j_gang.batch_tables(self.pb.tsc_topo_key, self.pb.aff_topo_key, self.nt.label_vals, self.hk)
        self.jdc = JCluster.from_host(self.nt, self.ep, vocab)
        self.jdb = JBatch.from_host(self.pb)
        self.pdc = convert.cluster_from_numpy(
            self.nt,
            name_key=vocab.label_keys.lookup(METADATA_NAME_KEY),
            unsched_key=vocab.label_keys.lookup("node.kubernetes.io/unschedulable"),
            empty_val=vocab.label_vals.lookup(""),
            device="cpu",
            ep=self.ep,
        )
        self.pdb = convert.batch_from_numpy(self.pb, "cpu")

    def ref_tables(self):
        t = dict(self.tables)
        return t.pop("d_cap"), t

    def port_tables(self):
        t = p_gang.batch_tables(self.pb.tsc_topo_key, self.pb.aff_topo_key, self.nt.label_vals, self.hk)
        return t.pop("d_cap"), t


_PACKED = {}


def packed(case) -> Packed:
    if case not in _PACKED:
        _PACKED[case] = Packed(*case)
    return _PACKED[case]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(want, got, what):
    w, g = np.asarray(want), _np(got)
    assert w.shape == g.shape, f"{what}: shape {g.shape} != {w.shape}"
    assert w.dtype == g.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    assert np.array_equal(w, g), f"{what}: {np.argwhere(w != g)[:5].tolist()}"


def test_batch_tables_match_reference():
    for case in CASES:
        pk = packed(case)
        want = pk.tables
        got = p_gang.batch_tables(pk.pb.tsc_topo_key, pk.pb.aff_topo_key, pk.nt.label_vals, pk.hk)
        assert got["d_cap"] == want["d_cap"]
        for k in ("sp_keys", "sp_cdv_tab", "ip_keys"):
            assert_same(want[k], got[k], k)


@pytest.mark.parametrize(
    "case,enabled",
    [(c, j_gang.F.ALL_FILTER_KERNELS) for c in CASES]
    + [(CASES[0], NO_SPREAD_IP), (CASES[2], NO_SPREAD_IP), (CASES[1], NO_TAINTS), (CASES[3], NO_TAINTS)],
    ids=[f"all-{c[0]}" for c in CASES] + ["no-spread-ip-31", "no-spread-ip-101", "no-taints-33", "no-taints-303"],
)
def test_precompute_matches_reference(case, enabled):
    """All 39 GangStatics fields, with every has_* flag on; the profiles
    with plugins disabled give zero-width axes and all-true masks."""
    pk = packed(case)
    _, tj = pk.ref_tables()
    _, tp = pk.port_tables()
    want = j_gang.precompute(pk.jdc, pk.jdb, jnp.asarray(pk.hk, J_I32), pk.v_cap, enabled=enabled, **tj)
    got = p_gang.precompute(pk.pdc, pk.pdb, pk.hk, pk.v_cap, enabled=enabled, **tp)
    assert p_gang.GangStatics._fields == j_gang.GangStatics._fields
    assert len(p_gang.GangStatics._fields) == 39
    for f in p_gang.GangStatics._fields:
        assert_same(getattr(want, f), getattr(got, f), f)


def _schedule_outputs(out):
    chosen, n_feas, rc, tallies = out
    return [chosen, n_feas, rc, tallies["requested"], tallies["nonzero"], tallies["num_pods"]]


@pytest.mark.parametrize("case", CASES)
def test_gang_schedule_matches_reference(case):
    """gang_schedule on the reference's own statics (carried across), so the
    scan is checked apart from precompute; then gang_run end to end."""
    pk = packed(case)
    d_cap, tj = pk.ref_tables()
    _, tp = pk.port_tables()
    g = j_gang.precompute(pk.jdc, pk.jdb, jnp.asarray(pk.hk, J_I32), pk.v_cap, **tj)
    want = _schedule_outputs(j_gang.gang_schedule(pk.jdc, pk.jdb, g, pk.v_cap, d_cap=d_cap))
    pg = convert.statics_from_numpy(g, "cpu")
    got = _schedule_outputs(p_gang.gang_schedule(pk.pdc, pk.pdb, pg, pk.v_cap, d_cap=d_cap))
    names = ("chosen", "n_feas", "reason_counts", "requested", "nonzero", "num_pods")
    for w, o, name in zip(want, got, names):
        assert_same(w, o, name)
    run = _schedule_outputs(p_gang.gang_run(pk.pdc, pk.pdb, pk.hk, pk.v_cap, d_cap=d_cap, **tp))
    for w, o, name in zip(want, run, names):
        assert_same(w, o, "gang_run " + name)
    # the cluster's own usage rows are read, not written
    assert_same(pk.nt.requested, pk.pdc.requested, "dc.requested untouched")


@pytest.mark.parametrize("case", CASES[:3])
def test_gang_run_matches_serial_oracle(case):
    """The port's gang_run places the batch exactly as the serial oracle's
    schedule-assume loop does (ROADMAP §C asks this of every gang slice)."""
    pk = packed(case)
    d_cap, tp = pk.port_tables()
    chosen = p_gang.gang_run(pk.pdc, pk.pdb, pk.hk, pk.v_cap, d_cap=d_cap, **tp)[0]
    names = list(pk.state.nodes)
    got = [names[c] if c >= 0 else None for c in chosen[: len(pk.pending)].tolist()]
    rng = random.Random(case[0])
    nodes, placed = make_cluster(rng, case[1], case[2])
    pending = [make_pod(rng, f"pend-{i}") for i in range(case[3])]
    want = run_serial(OracleState.build(nodes, placed, namespace_labels=NS_LABELS), pending)
    assert got == want


def test_precompute_requires_tables():
    pk = packed(CASES[0])
    with pytest.raises(ValueError, match="sp_keys"):
        p_gang.precompute(pk.pdc, pk.pdb, pk.hk, pk.v_cap, has_interpod=False)
    with pytest.raises(ValueError, match="ip_keys"):
        p_gang.precompute(pk.pdc, pk.pdb, pk.hk, pk.v_cap, has_spread=False)


@pytest.mark.parametrize("case", CASES)
def test_scan_domains_counts_match_max_domains(case):
    """K5's domain counts, both from one copy to the host: D over every
    spread and inter-pod key, and Dsp (the cluster launch's counted
    domains) as max_domains gives it over the live pods' non-hostname
    spread slots."""
    pk = packed(case)
    _, tp = pk.port_tables()
    g = p_gang.precompute(pk.pdc, pk.pdb, pk.hk, pk.v_cap, **tp)
    dc, db = pk.pdc, pk.pdb
    C, AT = g.sp_dv.shape[1], g.ip_dv.shape[1]
    *_, D, Dsp = p_gang._scan_domains(dc, db, g, C, AT)
    keys = torch.cat([db.tsc_topo[:, :C], db.aff_topo[:, :AT]], dim=1)
    assert D == p_gang.max_domains(dc, keys, torch.ones_like(keys, dtype=torch.bool))
    assert Dsp == p_gang.max_domains(dc, db.tsc_topo[:, :C], db.valid[:, None] & ~g.sp_is_host)
