"""The gang rollback by undo: the port's workloads_schedule (its plain
version, which K11 mirrors on the card) against the JAX package's, in gang
layouts the planner never makes as well as the ones it does.

The reference keeps one checkpoint of the carried state, taken before the
most recent gang's first member's step (the initial state before any), and
restores it whole when a gang's last member finds too few members placed.
The port subtracts the placements made since instead.  These cases hold
the two equal where the difference would show: gangs that roll back in a
row, a last member before any first member, a first member inside another
gang, pad rows inside a gang, claims whose takes and pins roll back, and
the planner's extra score.  Inputs: tests/gen.py's seed-41 batch of
tests/test_torch_wave.py (10 nodes, 20 pending pods in a batch of 32, host
ports left out as the workloads dispatch leaves them), packed by the
reference; the gang rows are numpy arrays from a seed.  Every output is an
integer or a bool, so the tolerance is zero.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import coscheduling as j_cos
from kubernetes_tpu.ops import gang as j_gang
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.ops import coscheduling as p_cos
from tests.test_torch_dra import ARRAYS, RUN_NAMES, _claims_over, _run_outputs
from tests.test_torch_wave import CASES, assert_same, packed
from tests.test_torch_workloads import WT

CASE = CASES[0]
SEEDS = [1, 2, 3, 4]
G_CAP = 8  # every layout's gang slots fit: one compiled reference for all


def _rows(p_cap):
    return (np.full(p_cap, -1, np.int32), np.zeros(p_cap, bool), np.zeros(p_cap, bool), np.zeros(p_cap, np.int32))


def _gang(rows, gid, positions, need, first=True, last=True):
    """Gang `gid` over `positions`, its first member the first position and
    its last the last one unless told otherwise."""
    g_id, g_first, g_last, g_need = rows
    for pos in positions:
        g_id[pos] = gid
        g_need[pos] = need
    if first:
        g_first[positions[0]] = True
    if last:
        g_last[positions[-1]] = True


def contiguous(rng, n_live, p_cap):
    """Gangs of two to five one after another, one plain pod between some,
    each needing 0 to size + 2 members, and at least two that need more than
    they have (each rolls back whatever it places): rollbacks in a row."""
    rows = _rows(p_cap)
    pos, gid = 0, 0
    while pos < n_live - 1 and gid < G_CAP:
        size = min(rng.randint(2, 5), n_live - pos)
        need = size + 1 if gid < 2 else rng.randint(0, size + 2)
        _gang(rows, gid, list(range(pos, pos + size)), need)
        pos += size + rng.randint(0, 1)
        gid += 1
    return rows


def last_before_first(rng, n_live, p_cap):
    """A gang whose last member comes before any first member (its rollback
    restores the initial state: the placements of the plain pods before it
    go too), then a gang whose last member comes before its own first, then
    contiguous gangs."""
    rows = _rows(p_cap)
    a = rng.randint(2, 4)
    _gang(rows, 0, list(range(0, a)), a + 1, first=False)
    b = a + rng.randint(2, 3)  # plain pods a .. b - 1
    _gang(rows, 1, [b, b + 2], 99, first=False, last=False)
    rows[2][b] = True  # gang 1's last member, before any first member
    rows[1][b + 2] = True  # and its first member after it
    pos, gid = b + 4, 2
    while pos < n_live - 1 and gid < G_CAP:
        size = min(rng.randint(2, 4), n_live - pos)
        _gang(rows, gid, list(range(pos, pos + size)), rng.randint(1, size + 1))
        pos += size
        gid += 1
    return rows


def overlapping(rng, n_live, p_cap):
    """Interleaved gangs: A on the even positions of a span and B on the odd
    ones (B's first member inside A moves the checkpoint), A needing more
    than it has; then a gang nested inside another."""
    rows = _rows(p_cap)
    span = rng.randint(6, 9)
    even, odd = list(range(0, span, 2)), list(range(1, span, 2))
    _gang(rows, 0, even, len(even) + 1)
    _gang(rows, 1, odd, rng.randint(0, len(odd) + 1))
    outer = list(range(span, min(span + 8, n_live)))
    inner = outer[2:5]
    _gang(rows, 2, [p for p in outer if p not in inner], rng.randint(2, 6))
    _gang(rows, 3, inner, rng.randint(1, 4))
    return rows


def pad_row(rng, n_live, p_cap):
    """Gangs whose members run past the batch's last live pod into its pad
    rows: the last member a pad row (it places nothing), and one gang with a
    pad row in its middle and its last member beyond."""
    rows = _rows(p_cap)
    _gang(rows, 0, list(range(0, 3)), rng.randint(1, 3))
    _gang(rows, 1, [n_live - 3, n_live - 2, n_live - 1, n_live], 4)  # rolls back at the pad row
    _gang(rows, 2, [n_live - 5, n_live - 4, n_live + 1, n_live + 2], rng.randint(1, 3))
    return rows


LAYOUTS = {"contiguous": contiguous, "last_before_first": last_before_first, "overlapping": overlapping,
           "pad_row": pad_row}


def _run(rows, dra=None, extra=None):
    """(reference outputs, port outputs) of workloads_schedule on CASE with
    the gang rows (and the DRA tables ``dra`` = (reference's, port's), or
    the extra score ``extra``, numpy i64 [P, N])."""
    pk = packed(CASE)
    g = j_gang.precompute(pk.jdc, pk.jdb, pk.jhk, pk.v_cap, has_ports=False, **pk.tables)
    pg = convert.statics_from_numpy(g, "cpu")
    g_id, g_first, g_last, g_need = rows
    jg = dict(gang_id=jnp.asarray(g_id), gang_first=jnp.asarray(g_first), gang_last=jnp.asarray(g_last),
              gang_need=jnp.asarray(g_need))
    pgk = {k: torch.from_numpy(v) for k, v in zip(("gang_id", "gang_first", "gang_last", "gang_need"), rows)}
    dk = dict(d_cap=pk.d_cap, d2_cap=pk.wt["d2_cap"])
    jx, px = {}, {}
    if dra is not None:
        jx, px = ({k: t[k] for k in ARRAYS} for t in dra)
    if extra is not None:
        jx["extra_score"], px["extra_score"] = jnp.asarray(extra), torch.from_numpy(extra)
    want = _run_outputs(j_cos.workloads_schedule(pk.jdc, pk.jdb, g, pk.jhk, pk.v_cap, G_CAP,
                                                 *[pk.wt[k] for k in WT], **jg, **dk, **jx))
    got = _run_outputs(p_cos.workloads_schedule(pk.pdc, pk.pdb, pg, pk.hk, pk.v_cap, G_CAP,
                                                *[pk.pwt[k] for k in WT], **pgk, **dk, **px))
    for w, o, name in zip(want, got, RUN_NAMES):
        if name == "claim_node" and dra is None:
            continue  # without claims the reference returns its untouched input, the port None
        assert_same(w, o, name)
    return want


def _layout(name, seed):
    pk = packed(CASE)
    return LAYOUTS[name](random.Random(seed), len(pk.pending), pk.pb.valid.shape[0])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_undo_matches_reference(layout, seed):
    """The layout's rollbacks, output for output; and they happened: a gang
    rolled back after placing members, whose members read -1 in chosen but
    keep their choices in raw."""
    want = _run(_layout(layout, seed))
    chosen, raw, admit = (np.asarray(want[i]) for i in (0, 7, 8))
    assert (admit == 0).any() and ((chosen < 0) & (raw >= 0)).any()
    assert not ((chosen >= 0) & (chosen != raw)).any()


def test_last_member_before_any_first_restores_the_initial_state():
    """The first gang's last member has no first member before it: its
    rollback takes back every placement made so far, as the reference's
    checkpoint still holds the initial state; the plain pods placed after
    it and before gang 1's last member (which also precedes any first
    member) go as well."""
    pk = packed(CASE)
    rows = _layout("last_before_first", 1)
    want = _run(rows)
    chosen, raw = np.asarray(want[0]), np.asarray(want[7])
    b = int(np.nonzero(rows[2])[0][1])  # gang 1's last member
    assert rows[0][b] == 1 and not rows[1][:b + 1].any()
    assert (chosen[:b + 1] == -1).all() and (raw[:b + 1] >= 0).sum() > 1
    assert len(pk.pending) > b + 1 and (chosen[b + 1:] >= 0).any()


def claim_gangs(rng, claimed, p_cap):
    """Gangs over the pods in `claimed`: the first two a gang that needs
    three (it rolls back their takes and pins), the next two a gang with a
    seeded need, the one after a gang of one that rolls back; the other
    pods plain."""
    rows = _rows(p_cap)
    for gid, (part, need) in enumerate(((claimed[0:2], 3), (claimed[2:4], rng.randint(0, 3)), (claimed[4:5], 2))):
        if part:
            _gang(rows, gid, part, need)
    return rows


@pytest.mark.parametrize("seed", SEEDS)
def test_undo_with_claims_matches_reference(seed):
    """Claims over the batch (ExactCount and All requests, shared and
    pre-allocated claims, held devices) and gangs of claim holders that
    roll back: the taken devices come free again and the pins made since
    the checkpoint are undone, claim_node included."""
    pk = packed(CASE)
    dra = _claims_over(pk, seed)
    ref_cl = np.asarray(dra[1]["ref_cl"])
    p_cap = pk.pb.valid.shape[0]
    placed = np.asarray(_run(_rows(p_cap), dra=dra)[0]) >= 0  # without gangs
    claimed = [p for p in range(len(pk.pending)) if placed[p] and (ref_cl[p] >= 0).any()]
    want = _run(claim_gangs(random.Random(seed), claimed, p_cap), dra=dra)
    chosen, raw, admit = (np.asarray(want[i]) for i in (0, 7, 8))
    undone = (chosen < 0) & (raw >= 0)
    assert (admit == 0).any() and undone.any()
    assert (ref_cl[undone] >= 0).any()  # an undone member had pinned or used a claim


@pytest.mark.parametrize("seed", SEEDS)
def test_undo_with_extra_score_matches_reference(seed):
    """The planner's extra score (seeded int64 per (pod, node), up to three
    times a score's range) under rolling-back gangs."""
    pk = packed(CASE)
    P, N = pk.pb.valid.shape[0], pk.nt.label_vals.shape[0]
    extra = np.random.default_rng(seed).integers(0, 300, size=(P, N)).astype(np.int64)
    want = _run(_layout("overlapping", seed), extra=extra)
    assert (np.asarray(want[8]) == 0).any()
