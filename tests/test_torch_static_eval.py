"""Kernel K1's plain version against the JAX root ops/fastpath.static_eval.

The same packed inputs (the reference's packers on numpy-seeded specs) feed
kubernetes_tpu.ops.fastpath.static_eval on the CPU and, carried over by
kubernetes_tpu_torch.convert, the port's static_eval on CPU tensors (which
takes the plain PyTorch version).  All 8 outputs are bool or int64, so the
tolerance is zero.  The clusters carry NoSchedule, PreferNoSchedule and
NoExecute taints, unschedulable nodes, integer and non-integer labels and
images; the signatures use every toleration form, spec.nodeName, In / NotIn /
Exists / DoesNotExist / Gt / Lt requirements, metadata.name fields,
preferred terms and images.
"""

import numpy as np
import pytest

from kubernetes_tpu.ops import common as j_common
from kubernetes_tpu.ops import fastpath as j_ops_fp
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import fastpath as p_ops_fp
from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster
from tests.test_torch_pack import packed_pair

ALL = frozenset({"NodeName", "NodeUnschedulable", "TaintToleration", "NodeAffinity"})


@pytest.fixture(autouse=True)
def _no_jax_ledger():
    """Call the JAX roots directly, not through a dispatch ledger another
    test in this process may have left active."""
    from kubernetes_tpu.observability import kernels

    kernels.deactivate()


def _reference(jnt, jpb, jv, enabled, has_images):
    jdc = j_common.DeviceCluster.from_host(jnt, _empty_existing(jnt, jv), jv)
    jdb = j_common.DeviceBatch.from_host(jpb)
    out = j_ops_fp.static_eval(jdc, jdb, enabled=enabled, has_images=has_images)
    return jdc, {k: np.asarray(v) for k, v in out.items()}


def _empty_existing(jnt, jv):
    from kubernetes_tpu.snapshot.schema import pack_existing_pods

    return pack_existing_pods([], jnt.name_to_idx, jv, k_cap=jnt.k_cap)


def _port_from_reference(jnt, jpb, jdc):
    dc = convert.cluster_from_numpy(
        jnt,
        name_key=int(jdc.name_key),
        unsched_key=int(jdc.unsched_key),
        empty_val=int(jdc.empty_val),
        device="cpu",
    )
    return dc, convert.batch_from_numpy(jpb, "cpu")


def _assert_equal(want, got):
    assert set(got) == set(want) == set(p_ops_fp.STATIC_KEYS)
    for k in p_ops_fp.STATIC_KEYS:
        g = got[k].numpy()
        assert g.dtype == want[k].dtype, k
        assert g.shape == want[k].shape, k
        assert np.array_equal(g, want[k]), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_static_eval_matches_reference(seed):
    (jnt, jpb, jv), _ = packed_pair(seed, n_nodes=64, n_pods=48)
    jdc, want = _reference(jnt, jpb, jv, ALL, True)
    dc, db = _port_from_reference(jnt, jpb, jdc)
    _assert_equal(want, p_ops_fp.static_eval(dc, db, ALL, True))
    # every case the generators aim for shows up
    assert not want["m_taints"].all() and not want["m_unsched"].all()
    assert not want["m_nodeaff"].all() and not want["m_nodename"].all()
    assert want["taint_raw"].any() and want["naff_raw"].any() and want["img"].any()


@pytest.mark.parametrize(
    "enabled,has_images",
    [
        (frozenset({"TaintToleration"}), False),
        (frozenset({"NodeName", "NodeAffinity"}), True),
        (frozenset(), False),
    ],
)
def test_static_eval_plugin_subsets_match_reference(enabled, has_images):
    (jnt, jpb, jv), _ = packed_pair(7, n_nodes=40, n_pods=30)
    jdc, want = _reference(jnt, jpb, jv, enabled, has_images)
    dc, db = _port_from_reference(jnt, jpb, jdc)
    _assert_equal(want, p_ops_fp.static_eval(dc, db, enabled, has_images))


def test_port_packers_feed_the_same_answer():
    """End to end on the port's own packers: the same specs packed by each
    package give the same eight outputs."""
    (jnt, jpb, jv), (pnt, ppb, pv) = packed_pair(9, n_nodes=50, n_pods=33)
    _, want = _reference(jnt, jpb, jv, ALL, True)
    dc = DeviceCluster.from_host(pnt, pv, "cpu")
    db = DeviceBatch.from_host(ppb, "cpu")
    _assert_equal(want, p_ops_fp.static_eval(dc, db, ALL, True))


def test_cpu_tensors_take_the_plain_version_without_a_build():
    (jnt, jpb, jv), _ = packed_pair(1, n_nodes=30, n_pods=16)
    jdc, _ = _reference(jnt, jpb, jv, ALL, True)
    dc, db = _port_from_reference(jnt, jpb, jdc)
    before = dict(_build.launches)
    p_ops_fp.static_eval(dc, db, ALL, True)
    assert _build.launches == before
