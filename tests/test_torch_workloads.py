"""Gang admission, module level: the port's plan_batch, gang_arrays,
workloads_schedule and workloads_run against the JAX package's.

Inputs are the tests/gen.py (cluster, batch) pairs of tests/test_torch_wave.py
(seeds 41, 42, 43, 111, 222, 333: spread, inter-pod terms, taints; the host
ports the pods want are left out on both sides, as the workloads dispatch
leaves them out), packed by the reference and carried across by
kubernetes_tpu_torch.convert, with gang arrays laid over each batch: a
one-member gang, a gang that rolls back after placing members (it needs more
members than it has), and gangs of two to five with seeded needs among the
spread and inter-pod pods.  One case adds open nominations.  On the CPU the
port runs its plain versions.  Every output is an integer or a bool, so the
tolerance is zero: chosen, n_feas, the reason counts, the tallies, spec,
raw, gang_admit and gang_landed must be identical.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as j_types
from kubernetes_tpu.ops import coscheduling as j_cos
from kubernetes_tpu.workloads import gang as j_wlg
from kubernetes_tpu_torch import convert
from kubernetes_tpu_torch.api import types as p_types
from kubernetes_tpu_torch.ops import coscheduling as p_cos
from kubernetes_tpu_torch.workloads import gang as p_wlg
from tests.test_torch_preemption import _nom_kw, _nominations
from tests.test_torch_wave import CASES, IDS, assert_same, packed

GEN = [(c, i) for c, i in zip(CASES, IDS) if c[0] == "gen"]
OUT_NAMES = ("chosen", "n_feas", "reason_counts", "requested", "nonzero", "num_pods", "spec", "raw", "gang_admit",
             "gang_landed")


def lay_gangs(seed: int, n_live: int, p_cap: int):
    """Gang positions over a batch of n_live pods: position 0 plain, a
    one-member gang at 1, a three-member gang at 2-4 that needs four (it
    rolls back whatever it places), then gangs of two to five separated by
    one plain pod, each needing 0 to size + 1 members.  Returns the
    reference's gang_arrays output."""
    rng = random.Random(seed)
    positions, needs = {}, {}
    positions["g/one"], needs["g/one"] = [1], 1
    positions["g/short"], needs["g/short"] = [2, 3, 4], 4
    pos = 6
    while pos < n_live - 1:
        size = min(rng.randint(2, 5), n_live - pos)
        key = f"g/{pos}"
        positions[key] = list(range(pos, pos + size))
        needs[key] = rng.randint(0, size + 1)
        pos += size + 1
    return j_wlg.gang_arrays(p_cap, positions, needs)


def _outputs(out):
    chosen, n_feas, rc, tallies, wl = out
    return [chosen, n_feas, rc, tallies["requested"], tallies["nonzero"], tallies["num_pods"], wl["spec"],
            wl["raw"], wl["gang_admit"], wl["gang_landed"]]


def _gang_kw(arrays, jax_side: bool):
    if jax_side:
        gid, first, last, need, g_cap = arrays[:5]
        return dict(g_cap=g_cap, gang_id=jnp.asarray(gid), gang_first=jnp.asarray(first),
                    gang_last=jnp.asarray(last), gang_need=jnp.asarray(need))
    return convert.gang_arrays_from_numpy(arrays, "cpu")


WT = ("tid_sp", "rep_sp_p", "rep_sp_c", "tid_ip", "rep_ip_p", "rep_ip_u", "ip_cdv_tab")


@pytest.mark.parametrize("case,nominated", [(c, False) for c, _ in GEN] + [(GEN[0][0], True)],
                         ids=[i for _, i in GEN] + [GEN[0][1] + "-nominations"])
def test_workloads_match_reference(case, nominated):
    """workloads_schedule on the reference's statics without ports (the
    plain version and the dispatching wrapper), then workloads_run end to
    end, against the JAX package's, output for output."""
    from kubernetes_tpu.ops import gang as j_gang

    pk = packed(case)
    nom = _nominations(case[1], pk.pb, pk.nt) if nominated else None
    arrays = lay_gangs(case[1], len(pk.pending), pk.pb.valid.shape[0])
    jt = dict(pk.tables)
    g = j_gang.precompute(pk.jdc, pk.jdb, pk.jhk, pk.v_cap, has_ports=False, **jt)
    pg = convert.statics_from_numpy(g, "cpu")
    jg, pgk = _gang_kw(arrays, True), _gang_kw(arrays, False)
    jw, pw = [pk.wt[k] for k in WT], [pk.pwt[k] for k in WT]
    dk = dict(d_cap=pk.d_cap, d2_cap=pk.wt["d2_cap"])
    want = _outputs(j_cos.workloads_schedule(pk.jdc, pk.jdb, g, pk.jhk, pk.v_cap, jg.pop("g_cap"), *jw, **jg, **dk,
                                             **_nom_kw(nom, True)))
    g_cap = pgk.pop("g_cap")
    for fn in (p_cos.workloads_schedule_plain, p_cos.workloads_schedule):
        got = _outputs(fn(pk.pdc, pk.pdb, pg, pk.hk, pk.v_cap, g_cap, *pw, **pgk, **dk, **_nom_kw(nom, False)))
        for w, o, name in zip(want, got, OUT_NAMES):
            assert_same(w, o, f"{fn.__name__} {name}")
    jg = _gang_kw(arrays, True)
    j_run = _outputs(j_cos.workloads_run(pk.jdc, pk.jdb, pk.jhk, pk.v_cap, jg.pop("g_cap"), *jw, **jg, **jt, **dk,
                                         **_nom_kw(nom, True)))
    p_run = _outputs(p_cos.workloads_run(pk.pdc, pk.pdb, pk.hk, pk.v_cap, g_cap, *pw, **pgk, **pk.tables, **dk,
                                         **_nom_kw(nom, False)))
    for w, o, name in zip(j_run, p_run, OUT_NAMES):
        assert_same(w, o, "workloads_run " + name)
    assert_same(pk.nt.requested, pk.pdc.requested, "dc.requested untouched")

    # the layout exercised what it is for: the one-member gang was judged,
    # the short gang rolled back with members placed, and rolled-back
    # members read -1 in chosen but keep their choice in raw
    chosen, raw, admit = (np.asarray(want[i]) for i in (0, 7, 8))
    assert admit[0] in (0, 1) and admit[1] == 0
    rolled = (chosen < 0) & (raw >= 0)
    assert rolled[2:5].any() and not ((chosen >= 0) & (chosen != raw)).any()


def test_plan_batch_and_gang_arrays_match_reference():
    """The canonical order and the gang rows of seeded batches: members by
    spec field and by label, unregistered groups, pods of other
    namespaces."""
    rng = random.Random(5)
    for trial in range(20):
        specs = []
        for i in range(rng.randint(1, 40)):
            g = rng.choice(["", "", "a", "b", "c", "lbl"])
            specs.append((f"p{i}", rng.choice(["default", "prod"]), g))

        def pods(T):
            out = []
            for name, ns, g in specs:
                if g == "lbl":
                    out.append(T.Pod(name=name, namespace=ns, labels={p_wlg.GROUP_LABEL: "viaLabel"}))
                else:
                    out.append(T.Pod(name=name, namespace=ns, pod_group=g))
            return out

        registered = {"default/a", "prod/b", "default/viaLabel"}
        for group_of in (None, "registered"):
            jkw = {} if group_of is None else dict(
                group_of=lambda p: (lambda k: k if k in registered else None)(j_wlg.group_key_of(p)))
            pkw = {} if group_of is None else dict(
                group_of=lambda p: (lambda k: k if k in registered else None)(p_wlg.group_key_of(p)))
            want = j_wlg.plan_batch(pods(j_types), **jkw)
            got = p_wlg.plan_batch(pods(p_types), **pkw)
            assert got == want, trial
            needs = {k: rng.randint(0, 4) for k in want[1]}
            p_cap = max(len(specs), 1) + rng.randint(0, 3)
            wa = j_wlg.gang_arrays(p_cap, want[1], needs)
            ga = p_wlg.gang_arrays(p_cap, got[1], needs)
            for w, o in zip(wa[:4], ga[:4]):
                assert_same(w, o, "gang row")
            assert wa[4:] == ga[4:]
            conv = convert.gang_arrays_from_numpy(wa, "cpu")
            assert conv["g_cap"] == wa[4] and conv["gang_id"].dtype == torch.int32
            assert conv["gang_first"].dtype == torch.bool


@pytest.mark.parametrize("arg,item", [("dev_key", "A8"), ("claim_node0", "A8"), ("sel_key", "A8"),
                                      ("req_count", "A8")])
def test_unported_arguments_raise(arg, item):
    """The DRA arguments (ROADMAP ``item``, ported since) come as one group
    (ops/dra.py DRA_ARGS): one of them alone raises ValueError naming the
    rest."""
    pk = packed(GEN[0][0])
    kw = convert.gang_arrays_from_numpy(lay_gangs(1, len(pk.pending), pk.pb.valid.shape[0]), "cpu")
    g_cap = kw.pop("g_cap")
    with pytest.raises(ValueError, match="the DRA arguments come together"):
        p_cos.workloads_run(pk.pdc, pk.pdb, pk.hk, pk.v_cap, g_cap, *[pk.pwt[k] for k in WT], **kw, **pk.tables,
                            **{arg: torch.zeros(1)})
