"""The sampling window, its rotation cursor and the seeded tie-break: the
port against the JAX package, module level.

On the reference-packed inputs of tests/test_torch_wave.py (tests/gen.py
seed 43: 12 nodes in zones, 24 pending pods with spread, inter-pod terms,
host ports and taints; the statics on both sides are the port's
precompute_plain, which tests/test_torch_gang.py holds against the JAX
precompute, so no file pays the JAX precompute's compile twice): the plain
gang_schedule and wave_schedule against the JAX roots in three modes (the
compat window without a tie key, the window with one, the tie key alone),
with the choices, feasible counts, reason counts, usage tallies, the
advanced ``sample_start`` cursor and the wave's stats; and the port
oracle's num_feasible_nodes_to_find and sampling walk against the
reference oracle's.  The Scheduler-level cases are in
tests/test_torch_scheduler_sampling.py.  Every output is an integer: the
tolerance is zero.
"""

import copy
import dataclasses
import importlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.observability import kernels as j_kernels
from kubernetes_tpu.ops import gang as j_gang
from kubernetes_tpu.ops import wave as j_wave
from kubernetes_tpu.ops.common import I32 as J_I32
from kubernetes_tpu.oracle import pipeline as j_pipe
from kubernetes_tpu.oracle.state import OracleState as JState
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import gang as p_gang
from kubernetes_tpu_torch.ops import rng as p_rng
from kubernetes_tpu_torch.ops import wave as p_wave
from kubernetes_tpu_torch.oracle import pipeline as p_pipe
from kubernetes_tpu_torch.oracle.state import OracleState as PState
from tests import test_sampling_compat as tsc
from tests.test_torch_pack import PORT_API
from tests.test_torch_wave import OUT_NAMES, WT_ARRAYS, _outputs, _workload, assert_same
from tests.test_wave import NS_LABELS

CASE = ("gen", 43, 12, 24, 24)
SEED = 1234
# (sample_k, tie seed): the compat window, the window with a tie key, the
# tie key alone
MODES = {"compat": (5, None), "compat_tie": (5, SEED), "tie": (None, 2**40 + 3)}
START, ATTEMPT = 7, 70001


class Packed:
    """One tests/test_torch_wave.py case packed by the reference, on both
    sides, with the port's plain statics (carried to the JAX side) and the
    reference's wave tables."""

    def __init__(self, case, has_ports=True):
        from kubernetes_tpu.oracle.scores import HOSTNAME_LABEL
        from kubernetes_tpu.ops.common import DeviceBatch as JBatch
        from kubernetes_tpu.ops.common import DeviceCluster as JCluster
        from kubernetes_tpu.snapshot.cluster import pack_cluster
        from kubernetes_tpu.snapshot.interner import Vocab
        from kubernetes_tpu.snapshot.schema import bucket_cap, pack_pod_batch
        from kubernetes_tpu.snapshot.selectors import METADATA_NAME_KEY

        nodes, placed, self.pending = _workload(case)
        self.state = JState.build(nodes, placed, namespace_labels=NS_LABELS)
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
        self.pwt = convert.wave_tables_from_numpy(self.wt, "cpu")
        self.pg = p_gang.precompute_plain(
            self.pdc, self.pdb, self.hk, self.v_cap, hard_pod_affinity_weight=1, has_interpod=True,
            has_spread=True, has_ports=has_ports, has_images=True, enabled=p_gang.ALL_FILTER_KERNELS,
            **{k: torch.as_tensor(v) for k, v in tables.items()})
        self.g = j_gang.GangStatics(*(jnp.asarray(getattr(self.pg, f).numpy()) for f in j_gang.GangStatics._fields))

    def wave_args(self, wt):
        return [wt[k] for k in WT_ARRAYS[:7]]

    def wave_kw(self, wt):
        return dict(d_cap=self.d_cap, d2_cap=wt["d2_cap"], has_ports=wt["has_ports"], tid_pt=wt["tid_pt"],
                    port_conf=wt["port_conf"])


_PACKED = {}


def packed(case, has_ports=True) -> Packed:
    # the JAX roots run outside any dispatch ledger that a test of another
    # file left active on this worker (the ledger calls a jax.core hook
    # that jax 0.9 no longer has)
    j_kernels.deactivate()
    if (case, has_ports) not in _PACKED:
        _PACKED[case, has_ports] = Packed(case, has_ports)
    return _PACKED[case, has_ports]


def _mode(name, jax_side: bool) -> dict:
    k, seed = MODES[name]
    if jax_side:
        return dict(
            sample_k=None if k is None else jnp.asarray(k, J_I32),
            sample_start=None if k is None else jnp.asarray(START, J_I32),
            tie_key=None if seed is None else jax.random.PRNGKey(seed),
            attempt_base=jnp.asarray(ATTEMPT, J_I32),
        )
    return dict(sample_k=k, sample_start=None if k is None else START,
                tie_key=None if seed is None else p_rng.prng_key(seed), attempt_base=ATTEMPT)


@pytest.mark.parametrize("mode", list(MODES))
def test_gang_schedule_sampling_matches_reference(mode):
    pk = packed(CASE)
    assert (np.asarray(pk.nt.visit_rank)[np.asarray(pk.nt.valid)] >= 0).all()
    chosen, n_feas, rc, tallies = j_gang.gang_schedule(pk.jdc, pk.jdb, pk.g, pk.v_cap, d_cap=pk.d_cap,
                                                       **_mode(mode, True))
    got = p_gang.gang_schedule(pk.pdc, pk.pdb, pk.pg, pk.v_cap, d_cap=pk.d_cap, **_mode(mode, False))
    for w, o, name in zip((chosen, n_feas, rc), got[:3], OUT_NAMES):
        assert_same(w, o, name)
    for k in ("requested", "nonzero", "num_pods"):
        assert_same(tallies[k], got[3][k], k)
    if MODES[mode][0] is not None:
        assert int(got[3]["sample_start"]) == int(tallies["sample_start"])
        assert int(got[3]["sample_start"]) != START  # the cursor moved
    else:
        assert "sample_start" not in got[3]
    assert (np.asarray(chosen) >= 0).sum() > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_wave_schedule_sampling_matches_reference(mode):
    """K8 speculates every pod from the initial cursor, K9 carries it."""
    pk = packed(CASE)
    want = j_wave.wave_schedule(pk.jdc, pk.jdb, pk.g, pk.jhk, pk.v_cap, *pk.wave_args(pk.wt),
                                **pk.wave_kw(pk.wt), **_mode(mode, True))
    got = p_wave.wave_schedule(pk.pdc, pk.pdb, pk.pg, pk.hk, pk.v_cap, *pk.wave_args(pk.pwt),
                               **pk.wave_kw(pk.pwt), **_mode(mode, False))
    for w, o, name in zip(_outputs(want), _outputs(got), OUT_NAMES):
        assert_same(w, o, name)
    if MODES[mode][0] is not None:
        assert int(got[3]["sample_start"]) == int(want[3]["sample_start"])
    # the wave's placements equal the scan's in every mode
    scan = p_gang.gang_schedule(pk.pdc, pk.pdb, pk.pg, pk.v_cap, d_cap=pk.d_cap, **_mode(mode, False))
    assert_same(np.asarray(want[0]), scan[0], "wave == scan")


def test_oracle_sampling_walk_matches_reference():
    """num_feasible_nodes_to_find on the reference's examples and a sweep,
    and feasible_nodes' sampling walk (nodeTree order, rotation, cut,
    processed, n_considered, with and without a PreFilter narrowing) on
    zone-grouped nodes with a few infeasible ones."""
    for pct in (0, 1, 5, 10, 37, 50, 80, 99, 100):
        for n in (0, 1, 50, 99, 100, 101, 140, 5000, 10000, 20000):
            assert p_pipe.num_feasible_nodes_to_find(pct, n) == j_pipe.num_feasible_nodes_to_find(pct, n)
    assert p_pipe.num_feasible_nodes_to_find(0, 5000) == 500
    jn, pn = tsc._zoned_nodes(), _zoned_port_nodes()
    pod_j = copy.deepcopy(tsc._pods(1)[0])
    pod_p = _port_pods(1)[0]
    js, ps = JState.build(jn), PState.build(pn)
    allowed = frozenset(f"n{i:03d}" for i in range(0, 140, 3))
    for kw in (dict(sample_k=30, start_index=17), dict(sample_pct=0, start_index=133), dict(sample_pct=60),
               dict(sample_pct=0, start_index=5, allowed=allowed), dict(sample_k=200)):
        w = j_pipe.feasible_nodes(pod_j, js, **kw)
        o = p_pipe.feasible_nodes(pod_p, ps, **kw)
        assert (o.feasible, o.processed, o.n_considered) == (w.feasible, w.processed, w.n_considered), kw
        assert o.reasons == w.reasons


def _zoned_port_nodes(scale: int = 1):
    """tests/test_sampling_compat.py _zoned_nodes in the port's types."""
    T, R = PORT_API
    return [T.Node(name=n.name, labels=dict(n.labels),
                   capacity=R.Resource.from_map({"cpu": str(n.capacity.milli_cpu // 1000), "memory": "16Gi"}))
            for n in tsc._zoned_nodes(scale)]


def _port_pods(n):
    T, _ = PORT_API
    return [T.Pod(name=f"p{i}", containers=[T.Container(requests={"cpu": "100m", "memory": "64Mi"})])
            for i in range(n)]


def to_port(obj):
    """A JAX-package API object (a dataclass tree) as the port's: the class
    of the same name in the mirrored module, field for field."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        mod = type(obj).__module__
        assert mod.startswith("kubernetes_tpu."), mod
        cls = getattr(importlib.import_module("kubernetes_tpu_torch" + mod[len("kubernetes_tpu"):]), type(obj).__name__)
        return cls(**{f.name: to_port(getattr(obj, f.name)) for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    return obj
