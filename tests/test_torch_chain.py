"""Chained dispatch and the device mirror.

chain_dispatch, on the gang scan and on the wave: three consecutive batches
of tests/gen.py pods (spread, inter-pod terms, preferred terms) on one
cluster, each batch scheduled against the cluster the previous call
appended into.  The port's plain version must equal the JAX root exactly:
the placements and feasible counts, the reason counts, the wave's stats,
and every row of the cluster afterwards (usage
tallies, the appended placed-pod rows at the pod cursor and term rows at
the term cursor).  The tolerance is zero.

DeviceClusterCache: after drains that add, bind and forget placed pods, the
resident snapshot kept current by row-range copies must equal a fresh full
upload of the same host mirror, field for field.
"""

import random
from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.observability import kernels as j_kernels
from kubernetes_tpu.oracle.scores import HOSTNAME_LABEL
from kubernetes_tpu.ops import chain as j_chain
from kubernetes_tpu.ops import gang as j_gang
from kubernetes_tpu.ops import wave as j_wave
from kubernetes_tpu.ops.common import DeviceBatch as JBatch
from kubernetes_tpu.ops.common import DeviceCluster as JCluster
from kubernetes_tpu.ops.common import I32 as J_I32
from kubernetes_tpu.snapshot.cluster import accumulate_node_usage
from kubernetes_tpu.snapshot.interner import PAD, Vocab
from kubernetes_tpu.snapshot.schema import bucket_cap, pack_existing_pods, pack_nodes, pack_pod_batch
from kubernetes_tpu.snapshot.selectors import METADATA_NAME_KEY
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.framework.config import SchedulerConfiguration as PConfig
from kubernetes_tpu_torch.ops import chain as p_chain
from kubernetes_tpu_torch.ops.common import DeviceCluster as PCluster
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from tests.gen import make_cluster, make_pod
from tests.test_gang import NS_LABELS
from tests.test_torch_pack import PORT_API
from tests.test_torch_scheduler_gang import anti_pods, basic_nodes

P_CAP = 32


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(dc, prefix=""):
    out = {}
    for f in fields(dc):
        v = getattr(dc, f.name)
        if hasattr(v, "__dataclass_fields__"):
            out.update(_leaves(v, prefix + f.name + "."))
        elif not isinstance(v, (int, tuple)) or f.name in ("name_key", "unsched_key", "empty_val", "n_valid_nodes"):
            out[prefix + f.name] = v
    return out


def _assert_cluster(want, got):
    w, g = _leaves(want), _leaves(got)
    for name, v in w.items():
        if name not in g:
            continue  # reference-only fields (visit_rank) the port does not carry
        assert np.array_equal(np.asarray(v), _np(g[name])), name


def _batches(seed):
    rng = random.Random(seed)
    nodes, placed = make_cluster(rng, 24, 40)
    pending = [make_pod(rng, f"pend-{i}") for i in range(3 * P_CAP)]
    return nodes, placed, [pending[i * P_CAP : (i + 1) * P_CAP] for i in range(3)]


@pytest.mark.parametrize("seed", [7, 8])
def test_chain_dispatch_three_batches_match_reference(seed):
    _chain_three_batches(seed, wave=False)


def _chain_three_batches(seed, wave: bool):
    j_kernels.deactivate()
    nodes, placed, batches = _batches(seed)
    vocab = Vocab()
    for b in batches:
        for p in b:
            for k, v in p.labels.items():
                vocab.intern_label(k, v)
    nt = pack_nodes(nodes, vocab)
    placed_pods = placed
    accumulate_node_usage(nt, placed_pods, vocab)
    pbs = [pack_pod_batch(b, vocab, k_cap=nt.k_cap, p_cap=P_CAP, namespace_labels=NS_LABELS) for b in batches]
    AT = max(pb.aff_kind.shape[1] for pb in pbs)
    ep = pack_existing_pods(placed_pods, nt.name_to_idx, vocab, e_cap=bucket_cap(len(placed_pods) + 4 * P_CAP),
                            k_cap=nt.k_cap, namespace_labels=NS_LABELS, m_cap=256 + 3 * P_CAP * AT)
    jdc = JCluster.from_host(nt, ep, vocab)
    pdc = convert.cluster_from_numpy(
        nt, name_key=vocab.label_keys.lookup(METADATA_NAME_KEY),
        unsched_key=vocab.label_keys.lookup("node.kubernetes.io/unschedulable"),
        empty_val=vocab.label_vals.lookup(""), device="cpu", ep=ep,
    )
    hk = vocab.label_keys.lookup(HOSTNAME_LABEL)
    v_cap = bucket_cap(len(vocab.label_vals))
    e = int(ep.valid.sum())
    m = int((ep.term_kind != PAD).sum())
    shapes = (ep.term_table.req_key.shape[2], ep.term_table.req_vals.shape[3], ep.term_ns_ids.shape[1], nt.k_cap)
    for pb in pbs:
        assert p_chain.caps_compatible(shapes, pb) == j_chain.caps_compatible(shapes, pb)
        if not j_chain.caps_compatible(shapes, pb):
            pytest.skip("batch term widths exceed the cluster's")
        tables = j_gang.batch_tables(pb.tsc_topo_key, pb.aff_topo_key, nt.label_vals, hk)
        d_cap = tables.pop("d_cap")
        append = bool((pb.aff_kind != PAD).any())
        jkw = pkw = {}
        if wave:
            wt = j_wave.wave_tables(pb, nt.label_vals, hk)
            jkw = _wave_kw(wt)
            pkw = _wave_kw(convert.wave_tables_from_numpy(wt, "cpu"))
        jout = j_chain.chain_dispatch(
            jdc, JBatch.from_host(pb), jnp.asarray(hk, J_I32), jnp.asarray(e, J_I32), jnp.asarray(m, J_I32), v_cap,
            d_cap=d_cap, append_terms=append, **tables, **jkw,
        )
        pout = p_chain.chain_dispatch(
            pdc, convert.batch_from_numpy(pb, "cpu"), hk, e, m, v_cap, d_cap=d_cap, append_terms=append, **tables,
            **pkw,
        )
        assert len(jout) == len(pout) == (4 if wave else 3)
        (jdc, jres, jrc), (pdc, pres, prc) = jout[:3], pout[:3]
        for w, o in zip(jout[1:], pout[1:]):
            assert np.asarray(w).dtype == o.numpy().dtype
            assert np.array_equal(np.asarray(w), o.numpy())
        _assert_cluster(jdc, pdc)
        e += P_CAP
        m += P_CAP * pb.aff_kind.shape[1] if append else 0
    assert int((pres[0] >= 0).sum()) > 0


@pytest.mark.parametrize("seed", [7])
def test_chain_dispatch_wave_raises_b7(seed):
    """chain_dispatch(wave=True) (it raised before the wave was ported):
    three chained batches on the speculative wave equal the JAX root's four
    outputs (results, reason counts, the [3, P] wave stats) and the cluster
    it appends into, row for row."""
    _chain_three_batches(seed, wave=True)


def _wave_kw(wt):
    """chain_dispatch's wave arguments from a wave_tables dict; the chained
    route never carries host ports, so the port carry stays off."""
    keys = ("tid_sp", "rep_sp_p", "rep_sp_c", "tid_ip", "rep_ip_p", "rep_ip_u", "ip_cdv_tab", "d2_cap")
    return dict(wave=True, **{k: wt[k] for k in keys})


def _assert_synced(sched):
    m = sched.mirror
    synced = sched._dc_cache.sync(m, m.vocab)
    fresh = PCluster.from_host(m.nodes, m.vocab, "cpu", m.existing)
    for name, v in _leaves(fresh).items():
        got = _leaves(synced)[name]
        assert np.array_equal(_np(v), _np(got)), name


def test_device_mirror_delta_sync_matches_full_upload():
    """Host-port anti-affinity pods take the direct scan every batch, so each
    batch syncs the resident snapshot by row-range copies: usage rows, the
    appended placed pods and their terms.  (A bound pod holding two ports
    sizes the port slots at the first pack, and the axes are pre-sized, so
    no batch forces a repack.)  Then an informer add of a bound pod and a
    forgotten bind (a delete) move it again."""
    T, _ = PORT_API
    nodes = basic_nodes(PORT_API, 40)
    pods = anti_pods(PORT_API, 60, groups=8, prefix="aa")
    for p in pods:
        p.containers[0].ports = (T.ContainerPort(container_port=80, host_port=8080),)
    holder = T.Pod(name="holder", node_name="node-0", containers=[T.Container(
        name="c", ports=(T.ContainerPort(host_port=8080), T.ContainerPort(host_port=7070)))])
    sched = PScheduler(PConfig(batch_size=16, wave_dispatch=False), device="cpu")
    sched.mirror.e_cap_hint = 256
    sched.mirror._m_cap_max = 256
    for n in nodes:
        sched.on_node_add(n)
    sched.on_pod_add(holder)
    for p in pods:
        sched.on_pod_add(p)
    out = sched.schedule_pending()
    assert sched.metrics["scan_batches"] == 4
    assert sum(o.node is not None for o in out) == 39  # node-0 holds 8080
    assert sched._dc_cache.full_uploads == 1 and sched._dc_cache.delta_syncs == 3
    _assert_synced(sched)

    sched.on_pod_add(T.Pod(name="ext", node_name="node-3", labels={"group": "g1"},
                           containers=[T.Container(name="c", requests={"cpu": "1"})]))
    placed = next(o.pod for o in out if o.node is not None)
    sched.cache.forget_pod(placed)
    sched._external_mutations += 1
    sched._repack_mirror()
    _assert_synced(sched)
