"""The port's packers against the JAX package's, field by field.

Seeded node and pod specs (numpy) are built once as the reference's API
objects and once as the port's, packed by each package, and every field both
packings carry must be equal.  All packed fields are integer or bool, so the
tolerance is zero.

The spec generators here are shared by the other tests/test_torch_*.py files.
"""

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.resource as j_res
import kubernetes_tpu.api.types as j_types
import kubernetes_tpu.fastpath as j_fp
import kubernetes_tpu.snapshot.interner as j_int
import kubernetes_tpu.snapshot.schema as j_schema
import kubernetes_tpu_torch.api.resource as p_res
import kubernetes_tpu_torch.api.types as p_types
import kubernetes_tpu_torch.fastpath as p_fp
import kubernetes_tpu_torch.snapshot.interner as p_int
import kubernetes_tpu_torch.snapshot.schema as p_schema
from kubernetes_tpu_torch.ops import wire
from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster

JAX_API = (j_types, j_res)
PORT_API = (p_types, p_res)

_EFFECTS = ("NoSchedule", "PreferNoSchedule", "NoExecute")
_IMAGES = ("nginx:1", "redis:7", "pause:3")


# ---------------------------------------------------------------------------
# Seeded specs (plain data), built into either package's API objects
# ---------------------------------------------------------------------------


def node_specs(seed, n, prefer=True, images=True, unsched=True):
    """Nodes with zones, disks, an integer label (sometimes not an integer),
    taints of every effect (NoSchedule only with prefer=False), unschedulable
    nodes and images."""
    rng = np.random.default_rng(seed)
    effects = _EFFECTS if prefer else ("NoSchedule",)
    out = []
    for i in range(n):
        taints = [
            (
                str(rng.choice(["dedicated", "gpu", "spot"])),
                str(rng.choice(["a", "b", ""])),
                str(rng.choice(effects)),
            )
            for _ in range(int(rng.choice([0, 0, 0, 1, 2])))
        ]
        labels = {
            "kubernetes.io/hostname": f"n{i:03d}",
            "zone": f"z{i % 3}",
            "gen": str(int(rng.integers(0, 10))) if rng.random() > 0.1 else "x",
        }
        if rng.random() < 0.6:
            labels["disk"] = str(rng.choice(["ssd", "hdd"]))
        imgs = {}
        if images:
            for img in _IMAGES:
                if rng.random() < 0.3:
                    imgs[img] = int(rng.choice([10, 200, 800, 1500])) << 20
        alloc = {
            "cpu": str(rng.choice(["2", "4", "8"])),
            "memory": str(rng.choice(["4Gi", "8Gi", "16Gi"])),
            "pods": int(rng.choice([5, 20, 110])),
        }
        if rng.random() < 0.2:
            alloc["example.com/gpu"] = int(rng.integers(1, 4))
        out.append(
            dict(
                name=f"n{i:03d}",
                labels=labels,
                alloc=alloc,
                taints=taints,
                unschedulable=bool(unsched and rng.random() < 0.05),
                images=imgs,
            )
        )
    return out


def pod_specs(seed, n, n_nodes, prefer=True, images=True, rich=True):
    """Fast-path pods: requests (sometimes none, sometimes an extended
    resource), tolerations, nodeSelector, required affinity with every
    operator and metadata.name fields, preferred terms, spec.nodeName and
    images.  rich=False keeps to resources, tolerations and selectors."""
    rng = np.random.default_rng(seed)
    exprs = [
        [("zone", "In", ("z0", "z1"))],
        [("disk", "NotIn", ("hdd",))],
        [("disk", "Exists", ())],
        [("disk", "DoesNotExist", ()), ("zone", "In", ("z2",))],
        [("gen", "Gt", ("3",))],
        [("gen", "Lt", ("7",)), ("gen", "Gt", ("1",))],
        [("gen", "Gt", ("x",))],
    ]
    out = []
    for i in range(n):
        req = {}
        if rng.random() < 0.9:
            req["cpu"] = str(rng.choice(["100m", "250m", "500m", "1"]))
            req["memory"] = str(rng.choice(["64Mi", "256Mi", "1Gi"]))
        if rich and rng.random() < 0.1:
            req["example.com/gpu"] = 1
        tols = []
        if rng.random() < 0.4:
            kind = int(rng.integers(0, 5))
            if kind == 0:
                tols.append(("dedicated", "Equal", str(rng.choice(["a", "b"])), ""))
            elif kind == 1:
                tols.append(("gpu", "Exists", "", ""))
            elif kind == 2:
                tols.append(("", "Exists", "", ""))
            elif kind == 3:
                tols.append(("spot", "Exists", "", "PreferNoSchedule"))
            else:
                tols.append(("node.kubernetes.io/unschedulable", "Exists", "", "NoSchedule"))
        sel = {}
        if rng.random() < 0.3:
            sel["disk"] = str(rng.choice(["ssd", "hdd"]))
        required = None
        preferred = []
        node_name = ""
        imgs = ()
        if rich:
            if rng.random() < 0.3:
                k = int(rng.integers(1, 3))
                required = [exprs[int(j)] for j in rng.choice(len(exprs), size=k, replace=False)]
                if rng.random() < 0.2:
                    required.append([("metadata.name", "In", (f"n{int(rng.integers(0, n_nodes)):03d}",))])
            if prefer and rng.random() < 0.2:
                preferred = [(int(rng.integers(1, 10)), exprs[int(rng.integers(0, len(exprs)))])]
            if rng.random() < 0.08:
                node_name = f"n{int(rng.integers(0, n_nodes)):03d}"
            if images and rng.random() < 0.3:
                imgs = tuple(str(x) for x in rng.choice(_IMAGES + ("busybox:1",), size=int(rng.integers(1, 3)), replace=False))
        out.append(
            dict(
                name=f"p{i:04d}",
                labels={"app": f"a{i % 4}"},
                req=req,
                tols=tols,
                sel=sel,
                required=required,
                preferred=preferred,
                node_name=node_name,
                images=imgs,
                n_containers=1 + (i % 2),
            )
        )
    return out


def build_nodes(api, specs):
    T, R = api
    return [
        T.Node(
            name=s["name"],
            labels=dict(s["labels"]),
            capacity=R.Resource.from_map(s["alloc"]),
            taints=tuple(T.Taint(key=k, value=v, effect=e) for k, v, e in s["taints"]),
            unschedulable=s["unschedulable"],
            images=dict(s["images"]),
        )
        for s in specs
    ]


def _term(T, reqs):
    exprs = tuple(T.NodeSelectorRequirement(k, op, tuple(v)) for k, op, v in reqs if k != "metadata.name")
    fields = tuple(T.NodeSelectorRequirement(k, op, tuple(v)) for k, op, v in reqs if k == "metadata.name")
    return T.NodeSelectorTerm(match_expressions=exprs, match_fields=fields)


def build_pods(api, specs):
    T, _ = api
    pods = []
    for s in specs:
        aff = None
        if s["required"] is not None or s["preferred"]:
            aff = T.Affinity(
                node_affinity=T.NodeAffinity(
                    required_during_scheduling_ignored_during_execution=(
                        T.NodeSelector(tuple(_term(T, t) for t in s["required"]))
                        if s["required"] is not None
                        else None
                    ),
                    preferred_during_scheduling_ignored_during_execution=tuple(
                        T.PreferredSchedulingTerm(w, _term(T, t)) for w, t in s["preferred"]
                    ),
                )
            )
        containers = [T.Container(name="c", requests=dict(s["req"]) or None)]
        containers += [T.Container(name=f"s{j}") for j in range(1, s["n_containers"])]
        pods.append(
            T.Pod(
                name=s["name"],
                labels=dict(s["labels"]),
                containers=containers,
                tolerations=tuple(T.Toleration(key=k, operator=o, value=v, effect=e) for k, o, v, e in s["tols"]),
                node_selector=dict(s["sel"]),
                affinity=aff,
                node_name=s["node_name"],
                images=s["images"],
            )
        )
    return pods


def packed_pair(seed, n_nodes=48, n_pods=40, **kw):
    """(reference NodeTensors, PodBatch, Vocab), (port ...) on the same specs."""
    ns = node_specs(seed, n_nodes, **{k: v for k, v in kw.items() if k in ("prefer", "images")})
    ps = pod_specs(seed + 100, n_pods, n_nodes, **kw)
    out = []
    for api, schema, interner in ((JAX_API, j_schema, j_int), (PORT_API, p_schema, p_int)):
        vocab = interner.Vocab()
        nt = schema.pack_nodes(build_nodes(api, ns), vocab)
        pb = schema.pack_pod_batch(build_pods(api, ps), vocab, k_cap=nt.k_cap, p_cap=64)
        out.append((nt, pb, vocab))
    return out


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

NODE_FIELDS = (
    "allocatable",
    "requested",
    "nonzero_req",
    "num_pods",
    "allowed_pods",
    "label_vals",
    "val_ints",
    "taint_key",
    "taint_val",
    "taint_effect",
    "unschedulable",
    "valid",
    "img_sizes",
)
POD_FIELDS = (
    "requests",
    "nonzero_req",
    "ns_id",
    "priority",
    "label_vals",
    "valid",
    "pref_weight",
    "tol_key",
    "tol_op",
    "tol_val",
    "tol_effect",
    "target_name_val",
    "img_ids",
    "n_containers",
)
TABLE_FIELDS = ("req_key", "req_op", "req_vals", "req_rhs", "term_valid")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_nodes_matches_reference(seed):
    (jnt, _, jv), (pnt, _, pv) = packed_pair(seed)
    for f in NODE_FIELDS:
        _same(getattr(jnt, f), getattr(pnt, f), f)
    assert jnt.names == pnt.names
    assert jnt.name_to_idx == pnt.name_to_idx
    assert len(jv.label_keys) == len(pv.label_keys)
    assert len(jv.label_vals) == len(pv.label_vals)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_pod_batch_matches_reference(seed):
    (_, jpb, _), (_, ppb, _) = packed_pair(seed)
    for f in POD_FIELDS:
        _same(getattr(jpb, f), getattr(ppb, f), f)
    for table in ("node_sel", "pref_node"):
        for f in TABLE_FIELDS:
            _same(getattr(getattr(jpb, table), f), getattr(getattr(ppb, table), f), f"{table}.{f}")


@pytest.mark.parametrize("seed", [3, 4])
def test_signature_key_matches_reference(seed):
    """The resource half of the signature key (request row, non-zero
    defaults) and its eligibility verdict agree with the reference's."""
    ps = pod_specs(seed, 60, 20)
    jv, pv = j_int.Vocab(), p_int.Vocab()
    jl, pl = j_schema.ResourceLanes(jv), p_schema.ResourceLanes(pv)
    for jp, pp in zip(build_pods(JAX_API, ps), build_pods(PORT_API, ps)):
        jk = j_fp.signature_key(jp, jl, 4)
        pk = p_fp.signature_key(pp, pl, 4)
        assert jk is not None and pk is not None
        assert jk[:2] == pk[:2]
        assert jk[3] == pk[3] and jk[5] == pk[5] and jk[6] == pk[6]


def test_wire_roundtrip_keeps_every_leaf():
    (_, _, _), (pnt, ppb, pv) = packed_pair(5)
    host_dc = DeviceCluster.host_tree(pnt, pv)
    host_db = DeviceBatch.host_tree(ppb)
    dc = wire.device_put_packed(host_dc, "cpu")
    db = wire.device_put_packed(host_db, "cpu")
    assert dc.name_key == host_dc.name_key and dc.n_valid_nodes == host_dc.n_valid_nodes
    for f in ("allocatable", "node_labels", "val_ints", "taint_key", "unschedulable", "node_valid", "img_sizes"):
        t = getattr(dc, f)
        assert isinstance(t, torch.Tensor)
        _same(getattr(host_dc, f), t.numpy(), f)
    for f in ("valid", "pref_weight", "tol_key", "img_ids", "n_containers"):
        _same(getattr(host_db, f), getattr(db, f).numpy(), f)
    for f in TABLE_FIELDS:
        _same(getattr(host_db.node_sel, f), getattr(db.node_sel, f).numpy(), f)
