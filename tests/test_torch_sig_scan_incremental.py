"""The premise of K2's incremental argmax (csrc/sig_scan.cu), on the CPU.

K2 keeps, per signature, a tournament tree of (key, lowest node) maxima
over the nodes: each 32-node group's first max, and the root over the
groups, where a node's key is its score when it is statics-feasible and
fits, else -1.  Per pod it reads the root of the pod's tree, commits, and
re-scores only the chosen node's leaf in every tree, repairing the node's
group entry and the root.  That is exact only if a commit changes no other
node's key.  Here, on numpy-seeded inputs:

  * sig_scan_plain's step runs one pod at a time, and the [S, N] key
    matrix, written out in numpy from the reference's formulas, changes
    only in the chosen node's column;
  * a tournament written here in numpy, updated as the kernel updates its
    trees (the same keep / take / re-reduce rules), picks the step's node at
    every pod and equals a fresh tree of the new keys after every commit:
    across ties, with no feasible node, with N not a multiple of 32 (and
    N = 1), with pads and a masked prefix, with an all-zero signature and
    with check_fit off;
  * on one case, the tournament's choices equal the JAX root
    kubernetes_tpu.ops.fastpath.sig_scan's.

Keys and choices are integers, so the tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import fastpath as j_ops_fp
from kubernetes_tpu_torch.ops import fastpath as p_ops_fp

STATE = ("used", "nz0", "nz1", "num_pods")
MAX = 100
NONE = np.iinfo(np.int64).min  # a child past the last node
BIG = np.iinfo(np.int64).max


@pytest.fixture(autouse=True)
def _no_jax_ledger():
    from kubernetes_tpu.observability import kernels

    kernels.deactivate()


def make_case(seed, N=96, R=4, S=8, P=256, ties=False, none_fit=False, pad_share=0.1, prefix=0,
              allowed_cap=None):
    rng = np.random.default_rng(seed)
    alloc = np.zeros((N, R), np.int64)
    if ties:  # every node alike: every score ties, the lowest node wins
        alloc[:, 0], alloc[:, 1] = 8000, 16384
        used = np.zeros((N, R), np.int64)
    else:
        alloc[:, 0] = rng.choice([2000, 4000, 8000], N)
        alloc[:, 1] = rng.choice([4096, 8192, 16384], N)
        alloc[::5, 3] = rng.integers(1, 4, len(alloc[::5]))
        used = (alloc * rng.integers(0, 70, (N, 1))) // 100
        used[::9, 1] = alloc[::9, 1] + 10  # overcommitted memory
    allowed = rng.choice([5, 20, 110], N).astype(np.int32)
    if allowed_cap is not None:
        allowed[:] = allowed_cap
    nz0 = used[:, 0].copy()
    nz1 = used[:, 1].copy()
    num_pods = np.zeros(N, np.int32) if ties else rng.integers(0, 4, N).astype(np.int32)
    req = np.zeros((S, R), np.int64)
    req[:, 0] = rng.choice([100, 250, 500, 1000], S)
    req[:, 1] = rng.choice([64, 256, 1024], S)
    req[0] = 0  # all-zero signature: the lanes are skipped, the pod count is not
    if S > 1:
        req[1, 3] = 1  # an extended lane
    nz = np.stack([np.maximum(req[:, 0], 100), np.maximum(req[:, 1], 200)], axis=1)
    az = (req == 0).all(axis=1)
    ok = np.ones((S, N), bool) if ties else rng.random((S, N)) < 0.8
    img = np.zeros((S, N), np.int64) if ties else rng.integers(0, 101, (S, N)).astype(np.int64)
    if none_fit and S > 2:
        req[2, 0] = 10**9  # fits nowhere
        ok[3 % S] = False  # statics-feasible nowhere
    ids = rng.integers(0, S, P).astype(np.int32)
    ids[rng.random(P) < pad_share] = -1
    ids[:prefix] = -1  # a masked prefix, as resident_run's serial tail passes
    fixed = dict(sig_ids=ids, sig_req=req, sig_nz=nz, sig_allzero=az, sig_ok=ok, sig_img=img, alloc=alloc,
                 allowed=allowed)
    return fixed, dict(used=used, nz0=nz0, nz1=nz1, num_pods=num_pods)


def key_matrix(fx, st, w_fit, w_bal, w_img, check_fit):
    """[S, N] keys: the score where statics-feasible and fitting, else -1
    (the reference's make_sig_step formulas, in numpy int64)."""
    req, alloc, used = fx["sig_req"], fx["alloc"], st["used"]
    R = req.shape[1]
    ext = np.arange(R) >= 3
    lane_ok = (ext[None, None, :] & (req[:, None, :] == 0)) | (req[:, None, :] <= (alloc - used)[None])
    fit = (st["num_pods"] + 1 <= fx["allowed"])[None, :] & (fx["sig_allzero"][:, None] | lane_ok.all(-1))
    feas = fx["sig_ok"] & fit if check_fit else fx["sig_ok"]
    a0, a1 = alloc[None, :, 0], alloc[None, :, 1]
    c0 = st["nz0"][None, :] + fx["sig_nz"][:, 0:1]
    c1 = st["nz1"][None, :] + fx["sig_nz"][:, 1:2]

    def lane(a, c):
        return np.where(a > 0, np.where(c > a, 0, (a - c) * MAX // np.maximum(a, 1)), 0)

    w = (a0 > 0).astype(np.int64) + (a1 > 0)
    least = np.where(w > 0, (lane(a0, c0) + lane(a1, c1)) // np.maximum(w, 1), 0)
    r0 = np.minimum(used[None, :, 0] + req[:, 0:1], a0)
    r1 = np.minimum(used[None, :, 1] + req[:, 1:2], a1)
    den = np.maximum(a0 * a1, 1)
    bal = np.where((a0 > 0) & (a1 > 0), MAX - (50 * np.abs(r0 * a1 - r1 * a0) + den - 1) // den, MAX)
    total = w_fit * least + w_bal * bal + w_img * fx["sig_img"]
    return np.where(feas, total, -1)


def reduce_groups(v, i):
    """Each 32-wide group's first max: the largest key, then the lowest node."""
    n = -(-len(v) // 32)
    vv = np.concatenate([v, np.full(n * 32 - len(v), NONE)]).reshape(n, 32)
    ii = np.concatenate([i, np.full(n * 32 - len(i), BIG)]).reshape(n, 32)
    m = vv.max(axis=1)
    return m, np.where(vv == m[:, None], ii, BIG).min(axis=1)


def beats(ov, oi, v, i):
    return ov > v or (ov == v and oi < i)


class Tournament:
    """One signature's tree of (key, lowest node) maxima: its 32-node
    groups' first maxima and the root over them, updated as
    csrc/sig_scan.cu updates its trees."""

    def __init__(self, row):
        self.leaves = row.copy()
        self.gv, self.gi = reduce_groups(self.leaves, np.arange(len(row), dtype=np.int64))
        self.rv, self.ri = self._root()

    def _root(self):
        m = self.gv.max()
        return m, np.where(self.gv == m, self.gi, BIG).min()

    def root(self):
        return int(self.ri) if self.rv >= 0 else -1

    def _root_moves(self, c, v, i):
        """c's group became (v, i): the root keeps its place, takes (v, i),
        or (True) lost the maximum its node held in c's group."""
        if (self.rv, self.ri) == (v, i):
            return False
        if beats(v, i, self.rv, self.ri):
            self.rv, self.ri = v, i
            return False
        return self.ri >> 5 == c >> 5

    def update(self, c, key):
        """Leaf c takes `key`; c's group entry and the root keep their
        place, take the new value, or are re-reduced from their children."""
        self.leaves[c] = key
        e = c >> 5
        if (self.gv[e], self.gi[e]) == (key, c):
            return  # c held its group's maximum and its key did not move
        if beats(key, c, self.gv[e], self.gi[e]):
            self.gv[e], self.gi[e] = key, c
        elif self.gi[e] == c:  # the group's maximum was c's: re-reduce its 32 leaves
            lo, hi = 32 * e, min(32 * e + 32, len(self.leaves))
            v, i = reduce_groups(self.leaves[lo:hi], np.arange(lo, hi, dtype=np.int64))
            self.gv[e], self.gi[e] = v[0], i[0]
        else:
            return
        if self._root_moves(c, self.gv[e], self.gi[e]):
            self.rv, self.ri = self._root()

    def equals(self, other):
        return (np.array_equal(self.gv, other.gv) and np.array_equal(self.gi, other.gi)
                and (self.rv, self.ri) == (other.rv, other.ri))


def torch_args(fx, st):
    f = {k: torch.as_tensor(v.copy()) for k, v in fx.items()}
    s = {k: torch.as_tensor(v.copy()) for k, v in st.items()}
    return f, s


def replay(fx, st0, w_fit=1, w_bal=1, w_img=1, check_fit=True):
    """Step sig_scan_plain's step pod by pod beside the trees; returns the
    step's choices, the trees' choices and the final state."""
    w = dict(w_fit=w_fit, w_bal=w_bal, w_img=w_img, check_fit=check_fit)
    f, s = torch_args(fx, st0)
    step = p_ops_fp.make_sig_step(f["sig_req"], f["sig_nz"], f["sig_allzero"], f["sig_ok"], f["sig_img"],
                                  f["alloc"], f["allowed"], **w)
    np_state = lambda: {k: s[k].numpy() for k in STATE}  # noqa: E731
    keys = key_matrix(fx, np_state(), **w)
    trees = {int(sg): Tournament(keys[sg]) for sg in np.unique(fx["sig_ids"]) if sg >= 0}
    got, want = [], []
    for sg in fx["sig_ids"].tolist():
        if sg < 0:  # a pad: nothing chosen, nothing committed
            got.append(-1)
            want.append(-1)
            continue
        row = keys[sg]
        first = int(np.argmax(row))
        assert trees[sg].root() == (first if row[first] >= 0 else -1)
        got.append(trees[sg].root())
        choice = int(step(s, torch.tensor(sg)))
        want.append(choice)
        new = key_matrix(fx, np_state(), **w)
        cols = np.nonzero((new != keys).any(axis=0))[0]
        assert set(cols.tolist()) <= {choice}, (choice, cols)  # only the chosen node's column changes
        if choice >= 0:
            for t_sig, tree in trees.items():
                tree.update(choice, new[t_sig, choice])
                assert tree.equals(Tournament(new[t_sig]))
        keys = new
    return np.array(want, np.int32), np.array(got, np.int32), np_state()


CASES = {
    # name: (make_case keywords, replay keywords)
    "ties": (dict(seed=1, N=70, ties=True), {}),
    "no_feasible_node": (dict(seed=2, N=64, none_fit=True, allowed_cap=3), {}),
    "n_odd": (dict(seed=3, N=1057, S=5, P=160), {}),
    "n_one": (dict(seed=4, N=1, S=3, P=24), {}),
    "pads_and_prefix": (dict(seed=5, N=77, pad_share=0.3, prefix=40), {}),
    "all_zero_signature": (dict(seed=6, N=40, S=2, P=200, allowed_cap=4), {}),
    "check_fit_off": (dict(seed=7, N=90), dict(check_fit=False)),
    "weights": (dict(seed=8, N=50), dict(w_fit=2, w_bal=3, w_img=0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_tournament_picks_the_steps_node(name):
    make_kw, w = CASES[name]
    fx, st0 = make_case(**make_kw)
    want, got, final = replay(fx, st0, **w)
    assert np.array_equal(got, want)
    # the whole batch through the plain version, from the same state
    f, s = torch_args(fx, st0)
    ch, _ = p_ops_fp.sig_scan_plain(f["sig_ids"], f["sig_req"], f["sig_nz"], f["sig_allzero"], f["sig_ok"],
                                    f["sig_img"], f["alloc"], f["allowed"], s["used"], s["nz0"], s["nz1"],
                                    s["num_pods"], **{"w_fit": 1, "w_bal": 1, "w_img": 1, "check_fit": True, **w})
    assert np.array_equal(ch.numpy(), want)
    for k in STATE:
        assert np.array_equal(s[k].numpy(), final[k]), k
    live = fx["sig_ids"] >= 0
    assert (want[~live] == -1).all()
    if name == "ties":  # the lowest node takes every tie
        assert want[live][0] == 0
    if name in ("no_feasible_node", "all_zero_signature"):
        assert (want[live] == -1).any() and (want[live] >= 0).any()
    if name == "pads_and_prefix":
        assert (want[:40] == -1).all()


@pytest.mark.parametrize("N", [1, 31, 32, 33, 1024, 1025, 1057, 10240 + 7])
def test_tree_entries_match_the_tournament(N):
    """The wrapper's tree geometry (the scratch it allocates) is the tree's:
    its groups, and one root above them."""
    n1, M = p_ops_fp.tree_entries(N)
    t = Tournament(np.zeros(N, np.int64))
    assert n1 == len(t.gv) and M == n1 + 1


def test_tournament_matches_the_jax_root():
    fx, st0 = make_case(seed=9, N=200, S=6, P=192, pad_share=0.2)
    _, got, final = replay(fx, st0)
    args = [jnp.asarray(fx[k]) for k in
            ("sig_ids", "sig_req", "sig_nz", "sig_allzero", "sig_ok", "sig_img", "alloc", "allowed")]
    choices, new = j_ops_fp.sig_scan(*args, *(jnp.asarray(st0[k].copy()) for k in STATE), w_fit=1, w_bal=1,
                                     w_img=1, check_fit=True)
    assert np.array_equal(got, np.asarray(choices))
    for k, v in zip(STATE, new):
        assert np.array_equal(final[k], np.asarray(v)), k
