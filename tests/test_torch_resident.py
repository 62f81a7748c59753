"""Kernel K4 (resident_run) against the JAX package's, on the CPU.

numpy-seeded signature stacks and usage states (an all-zero signature, an
extended-resource lane, overcommitted and padded nodes, a signature with no
feasible node, a -1 pad suffix) feed the JAX root
kubernetes_tpu.ops.resident.resident_run and the port's wrapper on CPU
tensors (its plain version).  Choices (all P entries, pads included), the
final usage state and the stats are integers, so the tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import fastpath as j_ops_fp
from kubernetes_tpu.ops import resident as j_res
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import fastpath as p_ops_fp
from kubernetes_tpu_torch.ops import resident as p_res

STATE = ("used", "nz0", "nz1", "num_pods")
FIXED = ("sig_req", "sig_nz", "sig_allzero", "sig_ok", "sig_img", "alloc", "allowed")


@pytest.fixture(autouse=True)
def _no_jax_ledger():
    from kubernetes_tpu.observability import kernels

    kernels.deactivate()


def resident_case(seed, N=48, R=4, S=6, P=256, n_pads=24):
    rng = np.random.default_rng(seed)
    alloc = np.zeros((N, R), np.int64)
    alloc[:, 0] = rng.choice([2000, 4000, 8000], N)
    alloc[:, 1] = rng.choice([4096, 8192, 16384], N)
    alloc[::5, 3] = rng.integers(1, 4, len(alloc[::5]))
    alloc[-3:] = 0  # bucket padding: no capacity, never statics-feasible
    allowed = rng.choice([4, 8, 110], N).astype(np.int32)
    allowed[-3:] = 0
    used = (alloc * rng.integers(0, 70, (N, 1))) // 100
    used[::9, 1] = alloc[::9, 1] + 10  # overcommitted memory
    used[::13, 2] = 3  # overcommitted ephemeral storage
    nz0 = np.maximum(used[:, 0], 0).copy()
    nz1 = np.maximum(used[:, 1], 0).copy()
    num_pods = rng.integers(0, 3, N).astype(np.int32)
    req = np.zeros((S, R), np.int64)
    req[:, 0] = rng.choice([100, 250, 500, 1000], S)
    req[:, 1] = rng.choice([64, 256, 1024], S)
    req[0] = 0  # all-zero signature
    req[1, 3] = 1  # extended lane
    nz = np.stack([np.maximum(req[:, 0], 100), np.maximum(req[:, 1], 200)], axis=1)
    az = (req == 0).all(axis=1)
    ok = rng.random((S, N)) < 0.8
    ok[:, -3:] = False
    ok[S - 1] = False  # a signature with no feasible node: dead every round
    img = rng.integers(0, 101, (S, N)).astype(np.int64)
    ids = rng.integers(0, S, P).astype(np.int32)
    ids[P - n_pads :] = -1  # pads are a suffix
    fixed = dict(sig_req=req, sig_nz=nz, sig_allzero=az, sig_ok=ok, sig_img=img,
                 alloc=alloc, allowed=allowed)
    state = dict(used=used, nz0=nz0, nz1=nz1, num_pods=num_pods)
    return ids, fixed, state


def adversarial_case(seed, N=48, P=256):
    """Two signatures on disjoint halves of the nodes, interleaved: the walk
    follows the head's half, so every round admits one pod and the adaptive
    stop fires."""
    ids, fixed, state = resident_case(seed, N=N, P=P)
    ok = np.zeros_like(fixed["sig_ok"])
    ok[0, 0 : N - 3 : 2] = True
    ok[1, 1 : N - 3 : 2] = True
    fixed["sig_ok"] = ok
    fixed["allowed"][: N - 3] = 110
    ids[: P - 24] = np.arange(P - 24) % 2
    return ids, fixed, state


def run_reference(ids, fixed, state, **kw):
    args = [jnp.asarray(fixed[k]) for k in FIXED]
    st = [jnp.asarray(state[k].copy()) for k in STATE]
    choices, new, stats = j_res.resident_run(jnp.asarray(ids), *args, *st, **kw)
    return np.asarray(choices), {k: np.asarray(v) for k, v in zip(STATE, new)}, np.asarray(stats)


def run_port(ids, fixed, state, **kw):
    t = convert.sig_stack_from_numpy(
        fixed["sig_req"], fixed["sig_nz"], fixed["sig_allzero"], fixed["sig_ok"], fixed["sig_img"], "cpu"
    )
    st = {k: torch.as_tensor(v.copy()) for k, v in state.items()}
    choices, new, stats = p_res.resident_run(
        torch.as_tensor(ids), t["sig_req"], t["sig_nz"], t["sig_allzero"], t["sig_ok"], t["sig_img"],
        torch.as_tensor(fixed["alloc"]), torch.as_tensor(fixed["allowed"]),
        st["used"], st["nz0"], st["nz1"], st["num_pods"], **kw,
    )
    assert all(a is b for a, b in zip(new, (st[k] for k in STATE)))  # updated in place
    return choices.numpy(), {k: st[k].numpy() for k in STATE}, stats.numpy()


def assert_same(got, want):
    (gc, gs, gstat), (wc, ws, wstat) = got, want
    assert gc.dtype == np.int32 and gc.shape == wc.shape
    assert np.array_equal(gc, wc), np.nonzero(gc != wc)[0][:10]
    for k in STATE:
        assert gs[k].dtype == ws[k].dtype, k
        assert np.array_equal(gs[k], ws[k]), k
    assert gstat.dtype == np.int64 and np.array_equal(gstat, wstat), (gstat, wstat)


@pytest.mark.parametrize(
    "seed,window,serial_tail,check_fit,w_img",
    [
        (0, 16, False, True, 1),  # W < N
        (1, 16, True, True, 0),
        (2, 48, False, True, 0),  # W == N: every node on the walk
        (3, 48, True, False, 1),
        (4, 100, False, False, 0),  # window > N, clamped
        (5, 100, True, True, 1),
        (6, 16, False, False, 1),
        (7, 48, True, True, 1),
    ],
)
def test_resident_run_matches_reference(seed, window, serial_tail, check_fit, w_img):
    ids, fixed, state = resident_case(seed)
    kw = dict(w_fit=1, w_bal=1, w_img=w_img, check_fit=check_fit, window=window, serial_tail=serial_tail)
    got = run_port(ids, fixed, state, **kw)
    assert_same(got, run_reference(ids, fixed, state, **kw))
    choices, _, stats = got
    live = ids >= 0
    assert stats[0] >= 1 and (choices[live] >= 0).any()
    # the dead signature's resolved pods are unschedulable
    q = int(stats[1])
    assert (choices[:q][ids[:q] == len(fixed["sig_req"]) - 1] == -1).all()
    if not stats[2]:
        assert q == live.sum()


@pytest.mark.parametrize("serial_tail", [False, True])
@pytest.mark.parametrize("window", [16, 48])
def test_adaptive_stop_hands_over_the_tail(serial_tail, window):
    ids, fixed, state = adversarial_case(8)
    kw = dict(w_fit=1, w_bal=1, w_img=0, check_fit=True, window=window, serial_tail=serial_tail)
    got = run_port(ids, fixed, state, **kw)
    assert_same(got, run_reference(ids, fixed, state, **kw))
    choices, _, stats = got
    assert stats[2] == 1 and stats[0] == p_res.STOP_GRACE  # stopped at the first checkpoint
    q = int(stats[1])
    live = ids >= 0
    if serial_tail:
        assert (choices[live] != p_res.UNRESOLVED).all() and (choices[~live] == -1).all()
    else:
        assert (choices[q:] == p_res.UNRESOLVED).all() and (choices[:q] != p_res.UNRESOLVED).all()


@pytest.mark.parametrize("seed", [9, 10])
def test_resident_run_equals_sig_scan(seed):
    """With the serial tail the run places every pod exactly as K2's plain
    version does, from the same state."""
    ids, fixed, state = resident_case(seed)
    w = dict(w_fit=1, w_bal=1, w_img=1, check_fit=True)
    res_c, res_s, _ = run_port(ids, fixed, state, window=16, serial_tail=True, **w)
    t = convert.sig_stack_from_numpy(
        fixed["sig_req"], fixed["sig_nz"], fixed["sig_allzero"], fixed["sig_ok"], fixed["sig_img"], "cpu"
    )
    st = {k: torch.as_tensor(v.copy()) for k, v in state.items()}
    scan_c, _ = p_ops_fp.sig_scan(
        torch.as_tensor(ids), t["sig_req"], t["sig_nz"], t["sig_allzero"], t["sig_ok"], t["sig_img"],
        torch.as_tensor(fixed["alloc"]), torch.as_tensor(fixed["allowed"]),
        st["used"], st["nz0"], st["nz1"], st["num_pods"], **w,
    )
    live = ids >= 0
    assert np.array_equal(res_c[live], scan_c.numpy()[live])
    for k in STATE:
        assert np.array_equal(res_s[k], st[k].numpy()), k
    # and the JAX sig_scan agrees with both
    want_c, _ = j_ops_fp.sig_scan(
        jnp.asarray(ids), *(jnp.asarray(fixed[k]) for k in FIXED),
        *(jnp.asarray(state[k].copy()) for k in STATE), **w,
    )
    assert np.array_equal(np.asarray(want_c)[live], res_c[live])
