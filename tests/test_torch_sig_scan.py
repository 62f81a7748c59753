"""Kernels K2 (sig_scan) and K3 (usage_checksum) and the host FastCommitter
against the JAX package's.

numpy-seeded signature stacks and usage states (all-zero signatures, an
extended-resource lane, overcommitted nodes, padded nodes, -1 pod pads) feed
the JAX roots kubernetes_tpu.ops.fastpath.sig_scan and
kubernetes_tpu.ops.resident.usage_checksum on the CPU and the port's
wrappers on CPU tensors (their plain versions).  Choices, the final usage
state and checksums are integers, so the tolerance is zero.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.fastpath as j_fp
from kubernetes_tpu.ops import fastpath as j_ops_fp
from kubernetes_tpu.ops import resident as j_res
import kubernetes_tpu_torch.fastpath as p_fp
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import fastpath as p_ops_fp
from kubernetes_tpu_torch.ops import resident as p_res

STATE = ("used", "nz0", "nz1", "num_pods")


@pytest.fixture(autouse=True)
def _no_jax_ledger():
    from kubernetes_tpu.observability import kernels

    kernels.deactivate()


def scan_case(seed, N=96, R=4, S=8, P=512):
    rng = np.random.default_rng(seed)
    alloc = np.zeros((N, R), np.int64)
    alloc[:, 0] = rng.choice([2000, 4000, 8000], N)
    alloc[:, 1] = rng.choice([4096, 8192, 16384], N)
    alloc[::5, 3] = rng.integers(1, 4, len(alloc[::5]))
    alloc[-4:] = 0  # bucket padding: no capacity, never statics-feasible
    allowed = rng.choice([5, 20, 110], N).astype(np.int32)
    allowed[-4:] = 0
    used = (alloc * rng.integers(0, 70, (N, 1))) // 100
    used[::9, 1] = alloc[::9, 1] + 10  # overcommitted memory
    used[::13, 2] = 3  # overcommitted ephemeral storage
    nz0 = np.maximum(used[:, 0], 0).copy()
    nz1 = np.maximum(used[:, 1], 0).copy()
    num_pods = rng.integers(0, 4, N).astype(np.int32)
    req = np.zeros((S, R), np.int64)
    req[:, 0] = rng.choice([0, 100, 250, 500, 1000], S)
    req[:, 1] = rng.choice([0, 64, 256, 1024], S)
    req[0] = 0  # all-zero signature
    req[1, 3] = 1  # extended lane
    nz = np.stack([np.maximum(req[:, 0], 100), np.maximum(req[:, 1], 200)], axis=1)
    az = (req == 0).all(axis=1)
    ok = rng.random((S, N)) < 0.8
    ok[:, -4:] = False
    img = rng.integers(0, 101, (S, N)).astype(np.int64)
    ids = rng.integers(0, S, P).astype(np.int32)
    ids[rng.random(P) < 0.1] = -1
    ids[-32:] = -1
    fixed = dict(sig_ids=ids, sig_req=req, sig_nz=nz, sig_allzero=az, sig_ok=ok, sig_img=img,
                 alloc=alloc, allowed=allowed)
    state = dict(used=used, nz0=nz0, nz1=nz1, num_pods=num_pods)
    return fixed, state


def run_reference(fixed, state, **w):
    args = [jnp.asarray(fixed[k]) for k in
            ("sig_ids", "sig_req", "sig_nz", "sig_allzero", "sig_ok", "sig_img", "alloc", "allowed")]
    st = [jnp.asarray(state[k].copy()) for k in STATE]
    choices, new = j_ops_fp.sig_scan(*args, *st, **w)
    return np.asarray(choices), {k: np.asarray(v) for k, v in zip(STATE, new)}


def run_port(fixed, state, **w):
    t = convert.sig_stack_from_numpy(
        fixed["sig_req"], fixed["sig_nz"], fixed["sig_allzero"], fixed["sig_ok"], fixed["sig_img"], "cpu"
    )
    st = {k: torch.as_tensor(v.copy()) for k, v in state.items()}
    choices, new = p_ops_fp.sig_scan(
        torch.as_tensor(fixed["sig_ids"]), t["sig_req"], t["sig_nz"], t["sig_allzero"], t["sig_ok"],
        t["sig_img"], torch.as_tensor(fixed["alloc"]), torch.as_tensor(fixed["allowed"]),
        st["used"], st["nz0"], st["nz1"], st["num_pods"], **w,
    )
    assert all(a is b for a, b in zip(new, (st[k] for k in STATE)))  # updated in place
    return choices.numpy(), {k: st[k].numpy() for k in STATE}


@pytest.mark.parametrize(
    "seed,w_fit,w_bal,w_img,check_fit",
    [
        (0, 1, 1, 1, True),
        (1, 1, 1, 0, True),
        (2, 1, 1, 1, False),
        (3, 0, 1, 1, True),
        (4, 1, 0, 0, True),
        (5, 2, 3, 1, True),
    ],
)
def test_sig_scan_matches_reference(seed, w_fit, w_bal, w_img, check_fit):
    fixed, state = scan_case(seed)
    w = dict(w_fit=w_fit, w_bal=w_bal, w_img=w_img, check_fit=check_fit)
    want_c, want_s = run_reference(fixed, state, **w)
    got_c, got_s = run_port(fixed, state, **w)
    assert got_c.dtype == np.int32
    assert np.array_equal(got_c, want_c)
    for k in STATE:
        assert got_s[k].dtype == want_s[k].dtype, k
        assert np.array_equal(got_s[k], want_s[k]), k
    # the case exercises placements, failures and pads
    live = fixed["sig_ids"] >= 0
    assert (got_c[live] >= 0).any() and (got_c[~live] == -1).all()
    if check_fit:
        assert (got_c[live] == -1).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_usage_checksum_matches_reference(seed):
    _, state = scan_case(seed)
    want = int(j_res.usage_checksum(*(jnp.asarray(state[k]) for k in STATE)))
    got = p_res.usage_checksum(*(torch.as_tensor(state[k]) for k in STATE))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want


def _committer_inputs(seed, N=80, S=6):
    fixed, state = scan_case(seed, N=N, S=S)
    nodes = types.SimpleNamespace(
        valid=fixed["allowed"] > 0,
        allocatable=fixed["alloc"],
        requested=state["used"],
        nonzero_req=np.stack([state["nz0"], state["nz1"]], axis=1),
        num_pods=state["num_pods"],
        allowed_pods=fixed["allowed"],
    )
    sigs = []
    for mod in (j_fp, p_fp):
        row = []
        for s in range(S):
            sg = mod.Signature(
                req_row=tuple(int(v) for v in fixed["sig_req"][s]),
                nz0=int(fixed["sig_nz"][s, 0]),
                nz1=int(fixed["sig_nz"][s, 1]),
                all_zero=bool(fixed["sig_allzero"][s]),
                static_ok=fixed["sig_ok"][s],
                img=fixed["sig_img"][s].tolist() if s % 2 else None,
            )
            sg.sid = s
            row.append(sg)
        sigs.append(row)
    return fixed, state, nodes, sigs


@pytest.mark.parametrize("seed,check_fit", [(6, True), (7, False)])
def test_fast_committer_matches_reference(seed, check_fit):
    """Several runs on one committer (new and retired signatures between
    runs, so heaps are built, walked and evicted) give the reference's
    choices and usage."""
    _, _, nodes, (jsigs, psigs) = _committer_inputs(seed)
    weights = (3, 2, 2, 2, 1, 1, 1)
    jc = j_fp.FastCommitter(nodes, weights, check_fit=check_fit)
    pc = p_fp.FastCommitter(nodes, weights, check_fit=check_fit)
    rng = np.random.default_rng(seed)
    for run in range(4):
        pick = rng.choice(len(jsigs), size=int(rng.integers(2, len(jsigs) + 1)), replace=False)
        feed = rng.choice(pick, size=120)
        assert pc.run([psigs[i] for i in feed]) == jc.run([jsigs[i] for i in feed]), run
    for attr in ("used_rows", "nz0", "nz1", "num_pods"):
        assert getattr(pc, attr) == getattr(jc, attr), attr
    node_valid = np.asarray(nodes.valid)
    masks = {k: np.ones(nodes.allowed_pods.shape[0], bool) for k in ("m_unsched", "m_nodename", "m_taints", "m_nodeaff")}
    for js, ps in zip(jsigs, psigs):
        assert pc.diagnose(ps, masks, node_valid) == jc.diagnose(js, masks, node_valid)


def test_sig_scan_equals_the_host_committer():
    """The kernel's plain version and the host committer are two engines of
    one greedy: from the same state they choose the same nodes."""
    fixed, state, nodes, (_, psigs) = _committer_inputs(8)
    pc = p_fp.FastCommitter(nodes, (3, 2, 2, 2, 1, 1, 1), check_fit=True)
    for s in psigs:
        if s.img is None:
            fixed["sig_img"][s.sid] = 0
    ids = fixed["sig_ids"]
    want = pc.run([psigs[i] for i in ids if i >= 0])
    got, st = run_port(fixed, state, w_fit=1, w_bal=1, w_img=1, check_fit=True)
    assert got[ids >= 0].tolist() == want
    assert st["used"].tolist() == pc.used_rows
    assert st["num_pods"].tolist() == pc.num_pods


def test_convert_carries_committer_rows_unchanged():
    _, state, nodes, _ = _committer_inputs(9)
    jc = j_fp.FastCommitter(nodes, (3, 2, 2, 2, 1, 1, 1))
    t = convert.usage_from_committer(jc, "cpu")
    assert t["used"].dtype == torch.int64 and t["num_pods"].dtype == torch.int32
    assert np.array_equal(t["used"].numpy(), state["used"])
    assert np.array_equal(t["allowed"].numpy(), nodes.allowed_pods)
