"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU
mode) and skips without one.  Outputs are integer or bool, so the tolerance
is zero.  The file imports no JAX, because the machine with the card has
none; run it there without the JAX suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The plain versions are held against the JAX package on the CPU by
tests/test_torch_static_eval.py, test_torch_sig_scan.py,
test_torch_resident.py, test_torch_scheduler.py, test_torch_gang.py,
test_torch_chain.py, test_torch_scheduler_gang.py, test_torch_wave.py,
test_torch_scheduler_wave.py, test_torch_preemption.py,
test_torch_scheduler_preempt.py, test_torch_workloads.py,
test_torch_scheduler_workloads.py, test_torch_volume.py,
test_torch_scheduler_volumes.py, test_torch_dra.py,
test_torch_scheduler_dra.py, test_torch_counterfactual.py,
test_torch_planner.py, test_torch_pipeline.py and test_torch_explain.py.
"""

import pytest
import torch

import chip_smoke
from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import coscheduling as ops_cos
from kubernetes_tpu_torch.ops import fastpath as ops_fp
from kubernetes_tpu_torch.ops import gang as ops_gang
from kubernetes_tpu_torch.ops import resident as ops_res

pytestmark = pytest.mark.cuda

ALL = frozenset({"NodeName", "NodeUnschedulable", "TaintToleration", "NodeAffinity"})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU mode)")
    return torch.device("cuda")


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


@pytest.mark.parametrize("has_images", [True, False])
def test_static_eval_kernel_matches_plain(cuda, has_images):
    _, dc, db = chip_smoke.k1_inputs(cuda, n_nodes=700)
    n0 = _build.launches["static_eval"]
    got = ops_fp.static_eval(dc, db, ALL, has_images)
    assert _build.launches["static_eval"] == n0 + 1
    want = ops_fp.static_eval_plain(dc, db, ALL, has_images)
    for k in ops_fp.STATIC_KEYS:
        _equal(got[k], want[k])


@pytest.mark.parametrize("check_fit,w_img", [(True, 1), (False, 0)])
def test_sig_scan_and_checksum_kernels_match_plain(cuda, check_fit, w_img):
    nt, dc, db = chip_smoke.k1_inputs(cuda, n_nodes=700)
    mask = ops_fp.static_eval_plain(dc, db, ALL, True)["mask"]
    fixed, state = chip_smoke.k2_inputs(torch, cuda, nt, mask, P=1024)
    w = dict(w_fit=1, w_bal=1, w_img=w_img, check_fit=check_fit)
    outs = []
    for fn in (ops_fp.sig_scan, ops_fp.sig_scan_plain):
        st = {k: v.clone() for k, v in state.items()}
        ch, _ = fn(fixed["sig_ids"], fixed["sig_req"], fixed["sig_nz"], fixed["sig_allzero"],
                   fixed["sig_ok"], fixed["sig_img"], fixed["alloc"], fixed["allowed"],
                   st["used"], st["nz0"], st["nz1"], st["num_pods"], **w)
        outs.append((ch, st))
    (ch_k, st_k), (ch_p, st_p) = outs
    _equal(ch_k, ch_p)
    for k in st_k:
        _equal(st_k[k], st_p[k])
    args = (st_k["used"], st_k["nz0"], st_k["nz1"], st_k["num_pods"])
    _equal(ops_res.usage_checksum(*args), ops_res.usage_checksum_plain(*args))


def test_scheduler_on_cuda_matches_the_host_committer(cuda):
    nodes = lambda: chip_smoke.mixed_nodes(150)  # noqa: E731
    pods = lambda: chip_smoke.mixed_pods(3000)  # noqa: E731
    _build.reset_launches()
    got, _, sched = chip_smoke.drain(cuda, nodes(), pods(), resident_drain=False)
    assert all(_build.launches[k] > 0 for k in ("static_eval", "sig_scan", "usage_checksum"))
    want, _, _ = chip_smoke.drain(torch.device("cpu"), nodes(), pods(), host_only=True)
    assert got == want
    chip_smoke.check_capacity(sched)


def _resident_feeds(cuda):
    fixed, state = chip_smoke.k4_inputs(torch, cuda, n_nodes=700, P=2048, n_pads=100)
    return {
        "north_star": fixed,
        "interleaved": chip_smoke.k4_interleaved(torch, fixed, P=1024),
        "one_signature": dict(fixed, sig_ids=fixed["sig_ids"].clamp(max=0)),
    }, state


@pytest.mark.parametrize("serial_tail", [False, True])
@pytest.mark.parametrize("window", [256, 1 << 20])  # W < N, and W == N (clamped)
@pytest.mark.parametrize("feed", ["north_star", "interleaved", "one_signature"])
def test_resident_run_kernel_matches_plain(cuda, feed, window, serial_tail):
    feeds, state = _resident_feeds(cuda)
    fx = feeds[feed]
    w = dict(w_fit=1, w_bal=1, w_img=0, check_fit=True, window=window, serial_tail=serial_tail)
    outs = []
    for fn in (ops_res.resident_run, ops_res.resident_run_plain):
        st = {k: v.clone() for k, v in state.items()}
        n0 = dict(_build.launches)
        ch, new, stats = fn(fx["sig_ids"], fx["sig_req"], fx["sig_nz"], fx["sig_allzero"], fx["sig_ok"],
                            fx["sig_img"], fx["alloc"], fx["allowed"],
                            st["used"], st["nz0"], st["nz1"], st["num_pods"], **w)
        assert all(a is st[k] for a, k in zip(new, ("used", "nz0", "nz1", "num_pods")))
        outs.append((ch, st, stats, {k: _build.launches[k] - n0[k] for k in n0}))
    (ch_k, st_k, stats_k, dl_k), (ch_p, st_p, stats_p, dl_p) = outs
    _equal(ch_k, ch_p)
    _equal(stats_k, stats_p)
    for k in st_k:
        _equal(st_k[k], st_p[k])
    # one K4 launch; the serial tail is one K2 launch; no other kernel; the
    # plain version none
    tail = bool(stats_k[2]) and serial_tail
    assert dl_k == {**{k: 0 for k in dl_k}, "sig_scan": int(tail), "resident_run": 1}
    assert not any(dl_p.values())
    if feed == "interleaved":
        assert int(stats_k[2]) == 1


def test_sig_scan_kernel_unchanged_by_the_shared_score(cuda):
    """K2 now scores through ktpu.cuh's shared fits / score_total: it still
    equals its plain version, and, from the same state, places every pod as
    K4 with its serial tail does."""
    feeds, state = _resident_feeds(cuda)
    fx = feeds["north_star"]
    w = dict(w_fit=1, w_bal=1, w_img=0, check_fit=True)
    outs = []
    for fn in (ops_fp.sig_scan, ops_fp.sig_scan_plain):
        st = {k: v.clone() for k, v in state.items()}
        ch, _ = fn(fx["sig_ids"], fx["sig_req"], fx["sig_nz"], fx["sig_allzero"], fx["sig_ok"], fx["sig_img"],
                   fx["alloc"], fx["allowed"], st["used"], st["nz0"], st["nz1"], st["num_pods"], **w)
        outs.append((ch, st))
    (ch_k, st_k), (ch_p, st_p) = outs
    _equal(ch_k, ch_p)
    for k in st_k:
        _equal(st_k[k], st_p[k])
    st = {k: v.clone() for k, v in state.items()}
    ch_r, _, _ = ops_res.resident_run(fx["sig_ids"], fx["sig_req"], fx["sig_nz"], fx["sig_allzero"],
                                      fx["sig_ok"], fx["sig_img"], fx["alloc"], fx["allowed"],
                                      st["used"], st["nz0"], st["nz1"], st["num_pods"], **w,
                                      window=256, serial_tail=True)
    live = fx["sig_ids"] >= 0
    _equal(ch_r[live], ch_k[live])
    for k in st:
        _equal(st[k], st_k[k])


@pytest.mark.parametrize("serial_tail", [False, True])
def test_default_scheduler_on_cuda_matches_the_host_committer(cuda, serial_tail):
    nodes = lambda: chip_smoke.mixed_nodes(150)  # noqa: E731
    pods = lambda: chip_smoke.mixed_pods(3000)  # noqa: E731
    _build.reset_launches()
    got, _, sched = chip_smoke.drain(cuda, nodes(), pods(), resident_serial_tail=serial_tail)
    assert _build.launches["resident_run"] > 0 and sched.metrics["resident_batches"] > 0
    want, _, _ = chip_smoke.drain(torch.device("cpu"), nodes(), pods(), host_only=True)
    assert got == want
    chip_smoke.check_capacity(sched)


# the tests/gen.py-style cases of tests/test_torch_gang.py, built with the
# port's own types (no JAX here): (seed, nodes, placed pods, pending pods)
GANG_CASES = [(31, 10, 20, 20), (33, 10, 20, 20), (101, 40, 80, 120), (303, 40, 80, 120)]
NO_SPREAD_IP = frozenset({"NodeName", "NodeUnschedulable", "NodeAffinity", "NodePorts", "NodeResourcesFit"})


@pytest.mark.parametrize("enabled", [ops_gang.ALL_FILTER_KERNELS, NO_SPREAD_IP], ids=["all", "no-spread-ip"])
@pytest.mark.parametrize("case", GANG_CASES)
def test_gang_kernels_match_plain(cuda, case, enabled):
    """K1 + K6 + K7 (precompute) on all 39 GangStatics fields, and K5
    (gang_schedule) on chosen, n_feas, reason counts and tallies."""
    dc, db, kw, d_cap, flags = chip_smoke.gang_inputs(torch, cuda, *chip_smoke.gen_cluster(*case), P=128)
    tab = {k: kw[k] for k in ("sp_keys", "sp_cdv_tab", "ip_keys")}
    n0 = {k: _build.launches[k] for k in ("gang_spread_statics", "gang_interpod_statics", "gang_scan")}
    got = ops_gang.precompute(dc, db, **kw, **flags, enabled=enabled)
    want = ops_gang.precompute_plain(
        dc, db, kw["hostname_key"], kw["v_cap"], hard_pod_affinity_weight=1, enabled=enabled,
        **dict(flags, has_spread=flags["has_spread"] and "PodTopologySpread" in enabled,
               has_interpod=flags["has_interpod"] and "InterPodAffinity" in enabled), **tab,
    )
    for f in ops_gang.GangStatics._fields:
        _equal(getattr(got, f), getattr(want, f))
    outs = [fn(dc, db, want, kw["v_cap"], d_cap=d_cap) for fn in (ops_gang.gang_schedule, ops_gang.gang_schedule_plain)]
    (ck, nk, rk, tk), (cp, np_, rp, tp) = outs
    for a, b in [(ck, cp), (nk, np_), (rk, rp)] + [(tk[k], tp[k]) for k in tk]:
        _equal(a, b)
    assert _build.launches["gang_scan"] == n0["gang_scan"] + 1
    if enabled == ops_gang.ALL_FILTER_KERNELS:
        assert _build.launches["gang_spread_statics"] == n0["gang_spread_statics"] + 1
        assert _build.launches["gang_interpod_statics"] == n0["gang_interpod_statics"] + 1


def test_gang_scheduler_on_cuda_matches_plain(cuda):
    """A mixed gang-path drain (direct, chained, and direct with ports) on
    the card equals the same drain with device="cpu", outcome for outcome."""
    chip_smoke.phase_gang_parity(torch, cuda, n_nodes=120, n_pods=1100, n_placed=60)


def _gang_check(cuda, nodes, placed, pending, P):
    """precompute (K1 + K6 + K7) and gang_schedule (K5) against their plain
    versions on one packed batch, exactly; returns K5's outputs."""
    dc, db, kw, d_cap, flags = chip_smoke.gang_inputs(torch, cuda, nodes, placed, pending, P=P)
    tab = {k: kw[k] for k in ("sp_keys", "sp_cdv_tab", "ip_keys")}
    got = ops_gang.precompute(dc, db, **kw, **flags)
    want = ops_gang.precompute_plain(dc, db, kw["hostname_key"], kw["v_cap"], hard_pod_affinity_weight=1,
                                     enabled=ops_gang.ALL_FILTER_KERNELS, **flags, **tab)
    for f in ops_gang.GangStatics._fields:
        _equal(getattr(got, f), getattr(want, f))
    n0 = _build.launches["gang_scan"]
    (ck, nk, rk, tk), (cp, np_, rp, tp) = [fn(dc, db, want, kw["v_cap"], d_cap=d_cap)
                                           for fn in (ops_gang.gang_schedule, ops_gang.gang_schedule_plain)]
    for a, b in [(ck, cp), (nk, np_), (rk, rp)] + [(tk[k], tp[k]) for k in tk]:
        _equal(a, b)
    assert _build.launches["gang_scan"] == n0 + 1
    return ck


@pytest.mark.parametrize("case", GANG_CASES)
def test_gang_scan_global_counters_match_plain(cuda, case, monkeypatch):
    """K5 with its peer counters in global memory (no shared memory allowed
    for them) equals its plain version, as with them in shared memory."""
    monkeypatch.setattr(ops_gang, "SCAN_SMEM_CAP", 0)
    _gang_check(cuda, *chip_smoke.gen_cluster(*case), P=128)


def _wide_pods(n, prefix, n_slots=10):
    """Pods with n_slots spread constraints and n_slots inter-pod terms each
    (zone and hostname keys, hard ones on the zone, all four term kinds)."""
    from kubernetes_tpu_torch.api import (
        Affinity, Container, LabelSelector, Pod, PodAffinity, PodAffinityTerm, PodAntiAffinity,
        TopologySpreadConstraint, WeightedPodAffinityTerm,
    )

    keys = (chip_smoke.ZONE, chip_smoke.HOSTNAME)
    pods = []
    for i in range(n):
        def sel(s):
            return LabelSelector(match_labels={"app": f"a{(i + s) % 4}"})

        spread = tuple(TopologySpreadConstraint(
            max_skew=1 + s % 3, topology_key=keys[s % 2],
            when_unsatisfiable="DoNotSchedule" if s % 4 == 0 else "ScheduleAnyway",
            label_selector=sel(s)) for s in range(n_slots))
        pref_aff = tuple(WeightedPodAffinityTerm(weight=1 + s, pod_affinity_term=PodAffinityTerm(
            topology_key=keys[s % 2], label_selector=sel(s))) for s in range(n_slots // 2))
        pref_anti = tuple(WeightedPodAffinityTerm(weight=2 + s, pod_affinity_term=PodAffinityTerm(
            topology_key=keys[(s + 1) % 2], label_selector=sel(s + 1))) for s in range(n_slots // 2 - 2))
        req_anti = (PodAffinityTerm(topology_key=chip_smoke.HOSTNAME,
                                    label_selector=LabelSelector(match_labels={"grp": f"g{i % 7}"})),)
        req_aff = (PodAffinityTerm(topology_key=chip_smoke.ZONE,
                                   label_selector=LabelSelector(match_labels={"app": "a0"})),)
        pods.append(Pod(
            name=f"{prefix}-{i}", labels={"app": f"a{i % 4}", "grp": f"g{i % 7}"},
            topology_spread_constraints=spread,
            affinity=Affinity(
                pod_affinity=PodAffinity(required_during_scheduling_ignored_during_execution=req_aff,
                                         preferred_during_scheduling_ignored_during_execution=pref_aff),
                pod_anti_affinity=PodAntiAffinity(required_during_scheduling_ignored_during_execution=req_anti,
                                                  preferred_during_scheduling_ignored_during_execution=pref_anti)),
            containers=[Container(name="c", requests={"cpu": "100m", "memory": "64Mi"})],
        ))
    return pods


@pytest.mark.parametrize("smem_cap", [1 << 30, 0], ids=["shared", "global"])
def test_gang_scan_wide_slots_match_plain(cuda, smem_cap, monkeypatch):
    """Ten spread constraints and ten inter-pod terms per pod (sixteen slots
    of each once bucketed): K5 takes any number of slots and equals its
    plain version, with its counters in shared or in global memory."""
    monkeypatch.setattr(ops_gang, "SCAN_SMEM_CAP", smem_cap)
    nodes = chip_smoke.basic_nodes(48, zones=4)
    placed = _wide_pods(60, "placed")
    for j, p in enumerate(placed):
        p.node_name = nodes[(5 * j + j // 4) % len(nodes)].name
    chosen = _gang_check(cuda, nodes, placed, _wide_pods(64, "new"), P=64)
    assert int((chosen >= 0).sum()) > 0


# (seed, nodes, placed pods, pending pods, first pending pod that may want
# host ports): with and without the port-occupancy carry
WAVE_CASES = [(5, 300, 30, 128, 0), (9, 200, 100, 128, 128), (13, 150, 40, 128, 64)]


def _wave_kernels_check(cuda, nodes, placed, pending, P):
    """K8 and K9 against their plain versions, and K9 against K5, on one
    packed batch (chip_smoke.wave_check), each kernel launched once."""
    dc, db, kw, d_cap, flags, wt = chip_smoke.wave_inputs(torch, cuda, nodes, placed, pending, P=P)
    n0 = dict(_build.launches)
    *_, adm, errs = chip_smoke.wave_check(torch, dc, db, kw, d_cap, flags, wt)
    assert errs == {"k8_err": 0, "k9_err": 0, "k9_vs_k5": 0}
    assert _build.launches["wave_speculate"] == n0["wave_speculate"] + 1
    assert _build.launches["wave_admit"] == n0["wave_admit"] + 1
    return wt, adm


@pytest.mark.parametrize("smem_cap", [1 << 30, 0], ids=["shared", "global"])
@pytest.mark.parametrize("case", WAVE_CASES)
def test_wave_kernels_match_plain(cuda, case, smem_cap, monkeypatch):
    """The gen-style cases, with K9's carries and per-pod sums in shared
    memory where they fit and, with the cap at 0, in global memory."""
    from kubernetes_tpu_torch.ops import wave as ops_wave

    monkeypatch.setattr(ops_wave, "ADMIT_SMEM_CAP", smem_cap)
    wt, adm = _wave_kernels_check(cuda, *chip_smoke.gen_cluster(*case), P=128)
    assert wt["has_ports"] == (case[4] < case[3])
    assert int((adm[0] >= 0).sum()) > 0


@pytest.mark.parametrize("smem_cap", [1 << 30, 0], ids=["shared", "global"])
@pytest.mark.parametrize("shape", range(4), ids=["config4", "config3", "ports", "mixed"])
def test_wave_kernels_match_plain_on_the_drain_shapes(cuda, shape, smem_cap, monkeypatch):
    """chip_smoke's four wave shapes at reduced size: config4's spread batch,
    config3's 50 anti-affinity terms (both from gang_shapes, on which
    chip_smoke also checks the wave), the port-contended batch (Tpt > 0) and
    the mixed batch without ports (wave_shapes)."""
    from kubernetes_tpu_torch.ops import wave as ops_wave

    monkeypatch.setattr(ops_wave, "ADMIT_SMEM_CAP", smem_cap)
    shapes = chip_smoke.gang_shapes(400, 150, 400, 400, P=128)[:2] + chip_smoke.wave_shapes(80, 400, P=128)
    _, nodes, placed, pending = shapes[shape]
    wt, _ = _wave_kernels_check(cuda, nodes, placed, pending, P=128)
    assert wt["has_ports"] == (shape == 2)


@pytest.mark.parametrize("smem_cap", [1 << 30, 0], ids=["shared", "global"])
def test_wave_kernels_wide_slots_match_plain(cuda, smem_cap, monkeypatch):
    """Ten spread constraints and ten inter-pod terms per pod: more than 8
    distinct terms of each kind, in shared and in global memory."""
    from kubernetes_tpu_torch.ops import wave as ops_wave

    monkeypatch.setattr(ops_wave, "ADMIT_SMEM_CAP", smem_cap)
    nodes = chip_smoke.basic_nodes(48, zones=4)
    placed = _wide_pods(60, "placed")
    for j, p in enumerate(placed):
        p.node_name = nodes[(5 * j + j // 4) % len(nodes)].name
    wt, adm = _wave_kernels_check(cuda, nodes, placed, _wide_pods(64, "new"), P=64)
    assert wt["n_terms"] > 16
    assert int((adm[0] >= 0).sum()) > 0


def test_wave_scheduler_on_cuda_matches_plain(cuda):
    """The mixed drain under the default configuration (direct wave, chained
    waves, a direct wave with ports) on the card equals the same drain with
    device="cpu", outcome for outcome."""
    chip_smoke.phase_gang_parity(torch, cuda, n_nodes=120, n_pods=1100, n_placed=60, wave=True)


# ---- preemption: K10, and K5 / K8 / K9 with open nominations ---------------


@pytest.mark.parametrize("peers", [False, True], ids=["no-peers", "peers"])
def test_narrow_candidates_kernel_matches_plain(cuda, peers):
    """K10 against narrow_candidates_plain on chip_smoke's inputs at a
    reduced size (mixed nodes, four priority groups, placed pods on every
    few nodes, batch peers with pads), one launch per call."""
    from kubernetes_tpu_torch.ops import preemption as pre

    dc, db, rows, peer_rows = chip_smoke.k10_inputs(torch, cuda, n_nodes=700, E=1500, P=96, B2=64)
    kw = peer_rows if peers else {}
    n0 = _build.launches["narrow_candidates"]
    got = pre.narrow_candidates(dc, db, *rows.values(), **kw)
    _equal(got, pre.narrow_candidates_plain(dc, db, *rows.values(), **kw))
    assert _build.launches["narrow_candidates"] == n0 + 1
    assert got.any()


def test_narrow_candidates_kernel_pads_change_nothing(cuda):
    """Pad victims, a pad group and pad peers leave K10's mask as it was."""
    from kubernetes_tpu_torch.ops import preemption as pre

    dc, db, rows, peers = chip_smoke.k10_inputs(torch, cuda, n_nodes=300, E=600, P=32, B2=32)
    base = pre.narrow_candidates(dc, db, *rows.values(), **peers)
    pad = dict(rows)
    pad["victim_node"] = torch.cat([rows["victim_node"], torch.full((7,), -1, dtype=torch.int32, device=cuda)])
    pad["victim_prio"] = torch.cat([rows["victim_prio"], torch.zeros((7,), dtype=torch.int32, device=cuda)])
    pad["victim_req"] = torch.cat([rows["victim_req"], torch.ones((7, rows["victim_req"].shape[1]),
                                                                  dtype=torch.int32, device=cuda)])
    pad["prio_groups"] = torch.cat([rows["prio_groups"], torch.tensor([-(2**31)], dtype=torch.int32, device=cuda)])
    _equal(pre.narrow_candidates(dc, db, *pad.values(), **peers), base)


@pytest.mark.parametrize("smem_cap", [1 << 30, 0], ids=["shared", "global"])
@pytest.mark.parametrize("case", GANG_CASES[:2])
def test_step_kernels_with_nominations_match_plain(cuda, case, smem_cap, monkeypatch):
    """K5, K8 and K9 with 64 open nominations (chip_smoke.nominated_row)
    against their plain versions, and K9 against K5, on one packed batch."""
    from kubernetes_tpu_torch.ops import wave as ops_wave

    monkeypatch.setattr(ops_gang, "SCAN_SMEM_CAP", smem_cap)
    monkeypatch.setattr(ops_wave, "ADMIT_SMEM_CAP", smem_cap)
    nodes, placed, pending = chip_smoke.gen_cluster(*case, ports_from=case[3])
    dc, db, kw, d_cap, flags, wt = chip_smoke.wave_inputs(torch, cuda, nodes, placed, pending, P=64)
    tab = {k: kw[k] for k in ("sp_keys", "sp_cdv_tab", "ip_keys")}
    g = ops_gang.precompute_plain(dc, db, kw["hostname_key"], kw["v_cap"], hard_pod_affinity_weight=1,
                                  enabled=ops_gang.ALL_FILTER_KERNELS, **dict(flags, has_ports=False), **tab)
    row = chip_smoke.nominated_row(torch, "gen", dc, db, kw, d_cap, g, wt, reps=1)
    assert row["k5_nom_err"] == row["k8_nom_err"] == row["k9_nom_err"] == row["k9_vs_k5_nom"] == 0


def test_preemption_drains_on_cuda_match_cpu(cuda):
    """bench_preemption's drain at 60 nodes on cuda and on the CPU: the same
    bindings, evictions and nominations, every invariant, K10 launched; and
    the gang-path drain with priorities, on the wave and on the scan."""
    out = chip_smoke.phase_preempt_drains(torch, cuda, n_small=60, n_large=200, large_preemptors=40)
    # the preemptors fail in fast harvests, which reach PostFilter unnarrowed
    assert out["bench_preemption"]["launches"]["narrow_candidates"] == 0
    for wave in (True, False):
        launches = chip_smoke.phase_preempt_parity(torch, cuda, n_nodes=60, n_placed=180, n_pods=240, wave=wave)
        assert launches["narrow_candidates"] > 0


# ---- gang coscheduling: K11 -------------------------------------------------


@pytest.mark.parametrize("smem_cap", [1 << 30, 0], ids=["shared", "global"])
@pytest.mark.parametrize("shape", range(3), ids=["config10", "config4", "mixed"])
def test_workloads_admit_kernel_matches_plain(cuda, shape, smem_cap, monkeypatch):
    """K11 against workloads_admit_plain on chip_smoke's three shapes at a
    reduced size (gangs of 8; on config4's and the mixed shape some roll
    back after placing members; the mixed shape with open nominations), and
    with the gang rows cleared against K9, its carries in shared and in
    global memory."""
    from kubernetes_tpu_torch.ops import wave as ops_wave

    monkeypatch.setattr(ops_wave, "ADMIT_SMEM_CAP", smem_cap)
    name, nodes, placed, pending, need, nominated = chip_smoke.workloads_shapes(100, 400, 400, P=128)[shape]
    dc, db, kw, d_cap, flags, wt = chip_smoke.wave_inputs(torch, cuda, nodes, placed, pending, P=128)
    rows = chip_smoke.gang_rows(torch, cuda, int(db.valid.sum().item()), 128, need)
    nom = chip_smoke.nominations(torch, dc, db, 16) if nominated else None
    n0 = _build.launches["workloads_admit"]
    row = chip_smoke.workloads_row(torch, name, dc, db, kw, d_cap, flags, wt, rows, reps=1, nom=nom)
    assert row["k11_err"] == 0 and row["k11_vs_k9"] == 0
    assert _build.launches["workloads_admit"] > n0


@pytest.mark.parametrize("size", [1, 3, 5], ids=["one-member", "three", "five"])
@pytest.mark.parametrize("case", WAVE_CASES[:2])
def test_workloads_admit_kernel_gang_sizes_match_plain(cuda, case, size):
    """Gangs of one, three and five members over a gen-style batch without
    ports, every other gang needing one more member than it has, and pad
    rows after the live pods."""
    seed, n_nodes, n_placed, n_pending, _ = case
    nodes, placed, pending = chip_smoke.gen_cluster(seed, n_nodes, n_placed, n_pending - 8, ports_from=n_pending)
    dc, db, kw, d_cap, flags, wt = chip_smoke.wave_inputs(torch, cuda, nodes, placed, pending, P=128)
    rows = chip_smoke.gang_rows(torch, cuda, len(pending), 128, lambda g: size + g % 2, size=size)
    row = chip_smoke.workloads_row(torch, "gen", dc, db, kw, d_cap, flags, wt, rows, reps=1)
    assert row["k11_err"] == 0 and row["k11_vs_k9"] == 0 and row["rolled_back"] > 0


def test_workloads_admit_kernel_restores_initial_state(cuda):
    """A gang whose last member comes before any gang's first member (no
    plan_batch layout, but a valid input) rolls back to the batch's initial
    state, as the reference's carry starts: K11 undoes every placement from
    the batch's first pod."""
    seed, n_nodes, n_placed, n_pending, _ = WAVE_CASES[0]
    nodes, placed, pending = chip_smoke.gen_cluster(seed, n_nodes, n_placed, n_pending - 8, ports_from=n_pending)
    dc, db, kw, d_cap, flags, wt = chip_smoke.wave_inputs(torch, cuda, nodes, placed, pending, P=128)
    rows = chip_smoke.gang_rows(torch, cuda, len(pending), 128, lambda g: 4 if g == 0 else 3, size=3)
    rows["gang_first"][0] = False
    row = chip_smoke.workloads_row(torch, "gen", dc, db, kw, d_cap, flags, wt, rows, reps=1)
    assert row["k11_err"] == 0 and row["k11_vs_k9"] == 0 and row["rolled_back_members"] > 0


def _undo_rows(cuda, layout, n_live, P):
    """Gang rows of the undo layouts: `overlapping` (gang A on the even
    positions of the first 12 pods, B on the odd ones, A needing one more
    member than it has; a gang nested in another), `last_first` (a gang's
    last member before any first member, then a gang whose last member
    precedes its own first), `pad_rows` (gangs running past the last live
    pod into the pad rows, one with a pad row in its middle)."""
    import numpy as np

    g_id, first, last, need = (np.full(P, -1, np.int32), np.zeros(P, bool), np.zeros(P, bool),
                               np.zeros(P, np.int32))

    def gang(gid, pos, k, f=True, l=True):
        g_id[pos], need[pos] = gid, k
        first[pos[0]] |= f
        last[pos[-1]] |= l

    if layout == "overlapping":
        gang(0, list(range(0, 12, 2)), 7)
        gang(1, list(range(1, 12, 2)), 3)
        gang(2, [12, 13, 17, 18], 2)
        gang(3, [14, 15, 16], 4)
    elif layout == "last_first":
        gang(0, [0, 1, 2], 4, f=False)
        gang(1, [5, 7], 99, f=False, l=False)
        last[5] = first[7] = True
        gang(2, [9, 10, 11], 2)
    else:
        gang(0, [0, 1, 2], 2)
        gang(1, [n_live - 3, n_live - 2, n_live - 1, n_live], 4)
        gang(2, [n_live - 6, n_live - 5, n_live + 1, n_live + 2], 2)
    rows = dict(gang_id=g_id, gang_first=first, gang_last=last, gang_need=need)
    return dict({k: torch.from_numpy(v).to(cuda) for k, v in rows.items()}, g_cap=8)


@pytest.mark.parametrize("cap", [16, 8], ids=["cluster16", "cluster8"])
@pytest.mark.parametrize("layout", ["overlapping", "last_first", "pad_rows"])
def test_workloads_admit_cluster_undo_layouts_match_plain(cuda, layout, cap, monkeypatch):
    """K11's rollback by undo on the layouts plan_batch never makes, on a
    cluster of 16 CTAs and of 8, against workloads_admit_plain (which the
    CPU tests hold against the JAX package's checkpoint in the same
    layouts), with open nominations; the placements it undid equal the
    rolled-back members that had placed."""
    from kubernetes_tpu_torch.ops import wave as ops_wave

    monkeypatch.setattr(ops_wave, "ADMIT_CLUSTER_CAP", cap)
    seed, n_nodes, n_placed, n_pending, _ = WAVE_CASES[0]
    nodes, placed, pending = chip_smoke.gen_cluster(seed, n_nodes, n_placed, n_pending - 8, ports_from=n_pending)
    dc, db, kw, d_cap, flags, wt = chip_smoke.wave_inputs(torch, cuda, nodes, placed, pending, P=128)
    rows = _undo_rows(cuda, layout, len(pending), 128)
    nom = chip_smoke.nominations(torch, dc, db, 16)
    row = chip_smoke.workloads_row(torch, layout, dc, db, kw, d_cap, flags, wt, rows, reps=1, nom=nom)
    assert row["k11_err"] == 0 and row["k11_cluster8_err"] == 0 and row["cluster"] == cap
    assert row["rolled_back"] > 0 and row["undone"] == row["rolled_back_members"] > 0


@pytest.mark.parametrize("cap", [16, 8], ids=["cluster16", "cluster8"])
def test_workloads_admit_cluster_extra_score_matches_plain(cuda, cap, monkeypatch):
    """K11 with the planner's extra score (seeded, up to three times a
    score's range, every fourth pod's best node lifted) under rolling-back
    gangs, at both cluster sizes."""
    from kubernetes_tpu_torch.ops import wave as ops_wave

    monkeypatch.setattr(ops_wave, "ADMIT_CLUSTER_CAP", cap)
    name, nodes, placed, pending, need, _ = chip_smoke.workloads_shapes(100, 400, 400, P=128)[1]
    dc, db, kw, d_cap, flags, wt = chip_smoke.wave_inputs(torch, cuda, nodes, placed, pending, P=128)
    rows = chip_smoke.gang_rows(torch, cuda, int(db.valid.sum().item()), 128, need)
    g = ops_gang.precompute(dc, db, **kw, **dict(flags, has_ports=False))
    gen = torch.Generator(device=cuda).manual_seed(11)
    es = torch.randint(0, 300, tuple(g.static_mask.shape), dtype=torch.int64, device=cuda, generator=gen)
    targs = [wt[k] for k in chip_smoke.WAVE_TABLES]
    gk = [rows[k] for k in ("gang_id", "gang_first", "gang_last", "gang_need", "g_cap")]
    tkw = dict(d_cap=d_cap, d2_cap=wt["d2_cap"], extra_score=es)
    got = ops_cos.workloads_admit(dc, db, g, kw["hostname_key"], *targs, *gk, **tkw)
    want = ops_cos.workloads_admit_plain(dc, db, g, kw["hostname_key"], *targs, *gk, **tkw)
    for a, b in zip(got[:4] + got[5:7], want[:4] + want[5:7]):
        _equal(a, b)
    for k in want[4]:
        _equal(got[4][k], want[4][k])
    assert ops_cos.admit_stats["cluster"] == cap and int((want[5] == 0).sum().item()) > 0


@pytest.mark.parametrize("shape", range(4), ids=["config4", "config3", "ports", "mixed"])
def test_wave_speculate_lanes_match_plain(cuda, shape):
    """K8 at chip_smoke's four wave shapes (reduced) against
    wave_speculate_plain with each optional input: none, 16
    open nominations, a seeded extra score, a port lane with a fifth of its
    cells false, each step mode (the window with and without a tie key,
    the window over every node, MostAllocated, RequestedToCapacityRatio)."""
    from kubernetes_tpu_torch.ops import wave as ops_wave

    shapes = chip_smoke.gang_shapes(400, 150, 400, 400, P=128)[:2] + chip_smoke.wave_shapes(80, 400, P=128)
    _, nodes, placed, pending = shapes[shape]
    dc, db, kw, d_cap, flags, wt = chip_smoke.wave_inputs(torch, cuda, nodes, placed, pending, P=128)
    g = ops_gang.precompute(dc, db, **kw, **dict(flags, has_ports=False))
    gen = torch.Generator(device=cuda).manual_seed(5)
    lanes = {"none": {}, "nominated": chip_smoke.nominations(torch, dc, db, 16),
             "extra_score": dict(extra_score=torch.randint(0, 300, tuple(g.static_mask.shape), dtype=torch.int64,
                                                           device=cuda, generator=gen)),
             "lane": dict(lane=torch.rand(tuple(g.static_mask.shape), device=cuda, generator=gen) < 0.8)}
    lanes.update(chip_smoke.step_modes(int(dc.node_valid.sum().item())))
    n0 = _build.launches["wave_speculate"]
    for name, extra in lanes.items():
        got = ops_wave.wave_speculate(dc, db, g, d_cap=d_cap, **extra)
        want = ops_wave.wave_speculate_plain(dc, db, g, d_cap=d_cap, **extra)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want.cpu()), name
    assert _build.launches["wave_speculate"] == n0 + len(lanes)


def test_workloads_scheduler_on_cuda_matches_cpu(cuda):
    """The contended gang drain at a reduced size on the card equals the same
    drain with device="cpu", outcome for outcome and in the gang metrics."""
    chip_smoke.phase_gang_parity_contended(torch, cuda, n_nodes=60, n_gangs=24, n_plain=48)


@pytest.mark.parametrize("n_nodes,P", [(700, 64), (5000, 512)], ids=["small", "config4"])
def test_volume_topology_mask_kernel_matches_plain(cuda, n_nodes, P):
    """K12 against its plain version on chip_smoke's k12_world batch (PV2 =
    2, nil-affinity, zone-labelled, zone-set and vol_bad rows), and K1 with
    K12's mask as the extra lane against K1's plain version."""
    sched, pb, dc, db, volt = chip_smoke.k12_inputs(cuda, n_nodes, P)
    n0 = _build.launches["volume_topology_mask"]
    got = ops_cos.volume_topology_mask(dc, **volt)
    assert _build.launches["volume_topology_mask"] == n0 + 1
    want = ops_cos.volume_topology_mask_plain(dc, **volt)
    _equal(got, want)
    assert bool(volt["vol_bad"].any()) and bool(got.any()) and not bool(got[: len(pb.valid)].all())
    enabled = sched.profiles["default-scheduler"].enabled
    for extra in (got, None):
        k1 = ops_fp.static_eval(dc, db, ALL, False, extra_mask=extra, mask_enabled=enabled)
        plain = ops_fp.static_eval_plain(dc, db, ALL, False, extra_mask=extra, mask_enabled=enabled)
        for k in ops_fp.STATIC_KEYS:
            _equal(k1[k], plain[k])


def test_volume_scheduler_on_cuda_matches_cpu(cuda):
    """A small StatefulSet drain through Scheduler() on cuda equals the same
    drain with device="cpu", outcome for outcome; K12 launched once per
    workloads batch."""
    runs = []
    for dev in (cuda, torch.device("cpu")):
        pvs, pvcs, pods, _ = chip_smoke.statefulset_world(1200)
        _build.reset_launches()
        got, outs, _, sched = chip_smoke.gang_drain(dev, chip_smoke.basic_nodes(300, zones=8), (), pods,
                                                    storage=(pvs, pvcs))
        runs.append(({k: (o.node, o.reason) for k, o in outs.items()}, dict(_build.launches),
                     sched.metrics["workload_batches"]))
    (want, launches, batches), (cpu, _, _) = runs
    assert want == cpu
    assert launches["volume_topology_mask"] == batches >= 3


@pytest.mark.parametrize("smem_cap", [1 << 30, 0], ids=["shared", "global"])
@pytest.mark.parametrize("n_nodes,P", [(300, 64), (5000, 512)], ids=["small", "config4"])
def test_dra_kernels_match_plain(cuda, n_nodes, P, smem_cap, monkeypatch):
    """K13 and K14 against their plain versions, and K11's DRA mode against
    workloads_admit_plain with the allocation carries (claim_node included),
    on chip_smoke's DRA check batch (8 devices of 4 attributes per node, DQ =
    2, All mode, shared, pre-allocated and held claims, gangs of 8 of which
    every fourth rolls back), K11's carries in shared and in global memory."""
    from kubernetes_tpu_torch.ops import wave as ops_wave

    monkeypatch.setattr(ops_wave, "ADMIT_SMEM_CAP", smem_cap)
    n13, n14 = _build.launches["dra_selector_match"], _build.launches["dra_spec_mask"]
    row = chip_smoke.phase_dra_kernels(torch, cuda, reps=1, n_nodes=n_nodes, P=P)
    assert row["k13_err"] == 0 and row["k14_err"] == 0 and row["k11_err"] == 0
    assert _build.launches["dra_selector_match"] > n13 and _build.launches["dra_spec_mask"] > n14


def test_dra_wave_lane_matches_plain(cuda):
    """K8 with K14's lane as its port lane against wave_speculate_plain with
    the same lane."""
    from kubernetes_tpu_torch.ops import dra as ops_dra
    from kubernetes_tpu_torch.ops import wave as ops_wave

    dc, db, kw, d_cap, flags, wt, dt, _ = chip_smoke.dra_inputs(torch, cuda, 300, 64)
    g = ops_gang.precompute(dc, db, **kw, **dict(flags, has_ports=False))
    match = ops_dra.selector_match(*(dt[k] for k in ("dev_key", "dev_val", "dev_valid", "sel_key", "sel_op",
                                                     "sel_vals")))
    lane = ops_dra.dra_spec_mask(match, dt["free0"], dt["claim_node0"],
                                 *(dt[k] for k in ("req_count", "req_all", "req_cl", "q_valid", "req_bad", "ref_cl")))
    _equal(ops_wave.wave_speculate(dc, db, g, d_cap=d_cap, lane=lane),
           ops_wave.wave_speculate_plain(dc, db, g, d_cap=d_cap, lane=lane))
    assert not bool(lane.all())


def test_dra_scheduler_on_cuda_matches_cpu(cuda):
    """The DRA parity drain at a reduced size on the card equals the same
    drain with device="cpu" and the serial oracle, claim pins included."""
    chip_smoke.phase_dra_parity(torch, cuda, n_nodes=60, n_pods=180)


def test_dra_drain_on_cuda(cuda):
    """bench_dra's drain at a reduced size: every pod placed, no device
    granted twice, every claim on its pod's node, K13, K14 and K11
    launched."""
    chip_smoke.phase_dra_drain(torch, cuda, n_nodes=60, n_pods=240)


# ---- the counterfactual planner: K15, K16; K8 and K11 with a score ---------


@pytest.mark.parametrize("KF,P", [(4, 16), (16, 64)], ids=["small", "wider"])
def test_fork_kernels_match_plain(cuda, KF, P):
    """K15 fork_view and K16 fork_summary against their plain versions, and
    K8 and K11 with a target extra_score against theirs (chip_smoke's
    phase 11 at a reduced size; it raises on any difference)."""
    n0 = dict(_build.launches)
    chip_smoke.phase_planner_kernels(torch, cuda, reps=1, n_nodes=300, KF=KF, P=P)
    for k in ("fork_view", "fork_summary", "wave_speculate", "workloads_admit"):
        assert _build.launches[k] > n0[k]


def test_planner_on_cuda_matches_serial_and_cpu(cuda):
    """bench_plan's forks at a reduced size: the batched kernel engine on
    the card equals the serial engine, the CPU's counterfactual_run_plain
    and each fork alone."""
    launches = chip_smoke.phase_config14(torch, cuda, k=12, n_nodes=60, n_fill=300, n_backlog=24)
    assert launches["fork_view"] == 1 and launches["fork_summary"] == 1 and launches["workloads_admit"] == 16


def test_planners_on_cuda_take_the_kernel_engine(cuda):
    """The three planners at a reduced size on the card, each on the kernel
    engine, and sampled forks of a batched run equal to the forks alone."""
    rows = chip_smoke.phase_planner_full(torch, cuda, n_nodes=200, sampled=3, k=10)
    assert rows["autoscale"]["recommendation"]["action"] == "scale_up"


# ---- explain and the independent pipeline: K17, K18; the DRA kernels past
# ---- the register words ----------------------------------------------------


def test_explain_and_pipeline_kernels_match_plain(cuda):
    """K17 against its plain version at config4's shape and the mixed shape
    (with a host-filter lane), K18 against its plain version, and the CUDA
    pipeline route (K1, K6, K7, K17, K18) against pipeline_plain, at
    reduced sizes (chip_smoke's phase 12; it raises on any difference)."""
    n0 = dict(_build.launches)
    rows, k18, _ = chip_smoke.phase_explain_kernels(torch, cuda, reps=1, n_config4=500, n_mixed=1000, n_k18=1000,
                                                    P=128)
    assert all(r["k17_err"] == 0 for r in rows.values()) and k18["k18_err"] == 0 and k18["route_err"] == 0
    assert all(rows["mixed"]["failing_pairs"].values())
    for k in ("explain_stack", "pipeline_score"):
        assert _build.launches[k] > n0[k]


def test_dra_kernels_past_the_register_words_match_plain(cuda):
    """K13, K14, K8 with the lane and K11's DRA mode at 320 device slots
    per node (K14's and K11's verdict words in their scratch rows) and at 8
    (registers), exact against the plain versions."""
    rows = chip_smoke.phase_dra_slots(torch, cuda, reps=1, n_nodes=1000, P=128)
    assert rows[320]["DD"] > 256 and rows[8]["DD"] <= 64
    assert all(r["k14_err"] == 0 and r["k11_err"] == 0 for r in rows.values())


def test_explain_path_on_cuda_matches_cpu(cuda):
    """explain_pod, explain_whatif and schedule_independent on cuda, the
    first two against a device="cpu" Scheduler's dicts, the last against
    the plain pipeline (chip_smoke's phase 12 at a reduced size)."""
    _, _, shape = chip_smoke.phase_explain_kernels(torch, cuda, reps=1, n_config4=200, n_mixed=400, n_k18=600, P=64)
    launches = chip_smoke.phase_explain(torch, cuda, n_nodes=500, n_placed=3000, n_preempt=60, k18=shape)
    assert launches["explain_stack"] == 5 and launches["pipeline_score"] == 1


def test_dra_drain_past_the_register_words_on_cuda_matches_cpu(cuda):
    """Nodes of 300 devices, pods of one ExactCount=10 claim: the drain on
    cuda equals the drain on the CPU, bindings and claim pins."""
    launches = chip_smoke.phase_dra_large(torch, cuda, n_nodes=10, devices=300, n_pods=300, count=10)
    assert launches["dra_spec_mask"] > 0 and launches["workloads_admit"] > 0


@pytest.mark.parametrize("smem_cap", [1 << 30, 0], ids=["shared", "global"])
@pytest.mark.parametrize("mode", ["compat_tie", "compat", "compat_all", "most_allocated", "rtcr"])
def test_step_modes_match_plain(cuda, mode, smem_cap, monkeypatch):
    """K5, K8 and K9 with the sampling window and the tie key, the window
    with no tie key (cut, and over every node), MostAllocated and
    RequestedToCapacityRatio against their plain versions (chip_smoke's
    phase 13 rows raise on any difference, the cursor included), with the
    counters and carries in shared and in global memory."""
    from kubernetes_tpu_torch.ops import wave as ops_wave

    monkeypatch.setattr(ops_gang, "SCAN_SMEM_CAP", smem_cap)
    monkeypatch.setattr(ops_wave, "ADMIT_SMEM_CAP", smem_cap)
    rows = chip_smoke.sampling_rows(torch, cuda, reps=1, n_nodes=700, P=64, modes=(mode,))
    assert rows[mode]["moved_from_default"] > 0


def test_strategy_workloads_and_tie_bits_match_plain(cuda):
    """K11 under MostAllocated and K19 against their plain versions, K19 at
    a block of attempts and at the one-pod cycle's shape."""
    assert chip_smoke.k11_strategy_row(torch, cuda, reps=1, n_nodes=200, P=64)["k11_err"] == 0
    assert chip_smoke.k19_row(torch, cuda, reps=1, A=33, N=1000, host_N=77)["k19_err"] == 0


def test_sampling_scheduler_on_cuda_matches_cpu(cuda):
    """Drains under reference_sampling_compat with a tie seed (the wave, the
    cursor read back from K9), under MostAllocated (the chained scan), with
    a host-scored strategy (the one-pod cycle, K19 per pod) and with no
    seed (the window cut and over every node; the wave and the direct
    scan), on the card and on the CPU, placed alike."""
    cfg = dict(reference_sampling_compat=True, tie_break_seed=chip_smoke.TIE_SEED)
    nodes = lambda: chip_smoke.basic_nodes(300, zones=3)  # noqa: E731
    got, _, s_cuda = chip_smoke.drain(cuda, nodes(), chip_smoke.spread_pods(700), **cfg)
    want, _, s_cpu = chip_smoke.drain(torch.device("cpu"), nodes(), chip_smoke.spread_pods(700), **cfg)
    assert got == want and s_cuda._next_start_node_index == s_cpu._next_start_node_index
    assert s_cuda.metrics["wave_batches"] == 2
    chip_smoke.phase_sampling_drains(torch, cuda, n_nodes=300, n_pods=700, n_host_nodes=60, n_host_pods=16,
                                     n_seedless_nodes=300, n_seedless_pods=64, n_small_nodes=40)


# ---- K9 as a thread-block cluster; K15 as a source-stationary copy ----------


def _k9_pods(n, prefix):
    """Pods with a hostname-keyed spread slot (DoNotSchedule on odd pods,
    ScheduleAnyway on even ones) beside a zone-keyed one, a required
    hostname anti-affinity term on every third pod and a preferred zone
    affinity on the next: K9's hostname-keyed carry rows beside its domain
    sums."""
    from kubernetes_tpu_torch.api import (
        Affinity, Container, LabelSelector, Pod, PodAffinity, PodAffinityTerm, PodAntiAffinity,
        TopologySpreadConstraint, WeightedPodAffinityTerm,
    )

    pods = []
    for i in range(n):
        app, grp = f"a{i % 5}", f"g{i % 7}"
        sel = LabelSelector(match_labels={"app": app})
        spread = (
            TopologySpreadConstraint(max_skew=2, topology_key=chip_smoke.HOSTNAME,
                                     when_unsatisfiable="DoNotSchedule" if i % 2 else "ScheduleAnyway",
                                     label_selector=sel),
            TopologySpreadConstraint(max_skew=3, topology_key=chip_smoke.ZONE, when_unsatisfiable="DoNotSchedule",
                                     label_selector=sel),
        )
        affinity = None
        if i % 3 == 0:
            affinity = Affinity(pod_anti_affinity=PodAntiAffinity(required_during_scheduling_ignored_during_execution=(
                PodAffinityTerm(topology_key=chip_smoke.HOSTNAME,
                                label_selector=LabelSelector(match_labels={"grp": grp})),)))
        elif i % 3 == 1:
            affinity = Affinity(pod_affinity=PodAffinity(preferred_during_scheduling_ignored_during_execution=(
                WeightedPodAffinityTerm(weight=5, pod_affinity_term=PodAffinityTerm(
                    topology_key=chip_smoke.ZONE, label_selector=sel)),)))
        pods.append(Pod(name=f"{prefix}-{i}", labels={"app": app, "grp": grp}, topology_spread_constraints=spread,
                        affinity=affinity,
                        containers=[Container(name="c", requests={"cpu": f"{100 + 50 * (i % 5)}m",
                                                                  "memory": "256Mi"})]))
    return pods


def _k9_world(case):
    """(nodes, placed, pending, P) of a K9 case: hostname-keyed pods on 10
    nodes (N = 16, below one 32-node slice), 200 nodes (N = 256: half of a
    16-CTA cluster's slices empty) and 2,100 nodes (N = 3,072: slices of
    192 or 384 nodes); the port-contended mix (Tpt > 0); a
    tests/gen.py-style mixed batch with ports."""
    if case == "ports":
        nodes = chip_smoke.basic_nodes(200, zones=4)
        placed = chip_smoke.place_round_robin(chip_smoke.port_heavy_pods(200, seed=3, prefix="placed"), nodes)
        return nodes, placed, chip_smoke.port_heavy_pods(128, seed=7), 128
    if case == "gen":
        return (*chip_smoke.gen_cluster(13, 150, 40, 128, 64), 128)
    n_nodes, n_placed, P = {"hostname16": (10, 12, 64), "hostname256": (200, 150, 128),
                            "hostname3072": (2100, 1000, 128)}[case]
    nodes = chip_smoke.basic_nodes(n_nodes, zones=4)
    return nodes, chip_smoke.place_round_robin(_k9_pods(n_placed, "placed"), nodes), _k9_pods(P, "new"), P


def _k9_check(cuda, world, cap, nominate=False, mode=None):
    """K9 against wave_admit_plain on one batch of `world`, exact on chosen,
    n_feas, the reason counts, the tallies (the usage rows and the cursor),
    kinds and conflicting terms, with the cluster capped at `cap` CTAs (and
    taking that many); with 64 open nominations when `nominate`, and the
    step `mode` (gang.step_mode's keywords).  Returns (c0, the plain
    outputs, the packed cluster)."""
    from kubernetes_tpu_torch.ops import wave as ops_wave

    nodes, placed, pending, P = world
    dc, db, kw, d_cap, flags, wt = chip_smoke.wave_inputs(torch, cuda, nodes, placed, pending, P=P)
    tab = {k: kw[k] for k in ("sp_keys", "sp_cdv_tab", "ip_keys")}
    hk = kw["hostname_key"]
    g = ops_gang.precompute_plain(dc, db, hk, kw["v_cap"], hard_pod_affinity_weight=1,
                                  enabled=ops_gang.ALL_FILTER_KERNELS, **dict(flags, has_ports=False), **tab)
    extra = dict(chip_smoke.nominations(torch, dc, db) if nominate else {}, **(mode or {}))
    targs = [wt[k] for k in chip_smoke.WAVE_TABLES]
    tkw = dict(d_cap=d_cap, d2_cap=wt["d2_cap"], has_ports=wt["has_ports"], tid_pt=wt["tid_pt"],
               port_conf=wt["port_conf"], **extra)
    c0 = ops_wave.wave_speculate_plain(dc, db, g, d_cap=d_cap, **extra)
    want = ops_wave.wave_admit_plain(dc, db, g, hk, c0, *targs, **tkw)
    n0 = _build.launches["wave_admit"]
    got = ops_wave.wave_admit(dc, db, g, hk, c0, *targs, **tkw)
    torch.cuda.synchronize()
    assert _build.launches["wave_admit"] == n0 + 1
    assert ops_wave.admit_stats["cluster"] == cap
    assert ops_wave.admit_stats["info"].tolist()[0] == cap
    for a, b in zip(got[:3] + got[4:], want[:3] + want[4:]):
        _equal(a, b)
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        _equal(got[3][k], want[3][k])
    return c0, want, dc


@pytest.mark.parametrize("smem_cap", [1 << 30, 0], ids=["shared", "global"])
@pytest.mark.parametrize("cap", [16, 8], ids=["cluster16", "cluster8"])
@pytest.mark.parametrize("case", ["hostname16", "hostname256", "hostname3072", "ports", "gen"])
def test_wave_admit_cluster_matches_plain(cuda, case, cap, smem_cap, monkeypatch):
    """K9 at both cluster sizes, its slices' rows and carries in shared
    memory and (ADMIT_SMEM_CAP = 0) in global memory, on clusters whose N
    is below one slice, leaves CTAs without nodes, or splits into slices of
    192 / 384 nodes; with hostname-keyed spread and inter-pod slots, the
    port carry and a mixed batch.  Where N spans several slices, some pod
    speculates on a node that a CTA other than rank 0 owns, and some pod is
    demoted (its attribution read from that CTA)."""
    from kubernetes_tpu_torch.ops import wave as ops_wave

    monkeypatch.setattr(ops_wave, "ADMIT_SMEM_CAP", smem_cap)
    monkeypatch.setattr(ops_wave, "ADMIT_CLUSTER_CAP", cap)
    c0, want, dc = _k9_check(cuda, _k9_world(case), cap)
    assert int((want[0] >= 0).sum()) > 0
    if case in ("hostname256", "hostname3072", "gen"):
        assert int((c0 >= 32).sum()) > 0
    if case in ("hostname256", "hostname3072", "ports"):
        assert int((want[4] != ops_wave.DEMOTE_NONE).sum()) > 0


@pytest.mark.parametrize("cap", [16, 8], ids=["cluster16", "cluster8"])
@pytest.mark.parametrize("mode", ["wrap", "wrap_tie", "compat_all", "most_allocated", "rtcr", "tie", "nominated"])
def test_wave_admit_cluster_step_modes_match_plain(cuda, mode, cap, monkeypatch):
    """K9 at both cluster sizes in the step's branches on 200 nodes (N =
    256): the sampling window from a cursor 10 nodes before the end, so the
    walk wraps across the slices (with and without a tie key); the window
    over every node (k = n); MostAllocated; RequestedToCapacityRatio; a tie
    key alone; 64 open nominations.  The cursor the tallies carry out is
    the plain version's."""
    from kubernetes_tpu_torch.ops import rng
    from kubernetes_tpu_torch.ops import wave as ops_wave

    monkeypatch.setattr(ops_wave, "ADMIT_CLUSTER_CAP", cap)
    n = 200
    tie = dict(tie_key=rng.prng_key(chip_smoke.TIE_SEED), attempt_base=4321)
    modes = {
        "wrap": dict(sample_k=100, sample_start=n - 10),
        "wrap_tie": dict(sample_k=100, sample_start=n - 10, **tie),
        "compat_all": dict(sample_k=n, sample_start=n - 10),
        "most_allocated": dict(fit_strategy=(1, (), (1, 1))),
        "rtcr": dict(fit_strategy=(2, chip_smoke.SHAPE_RTCR, (1, 1))),
        "tie": tie,
        "nominated": None,
    }
    _, want, _ = _k9_check(cuda, _k9_world("hostname256"), cap, nominate=mode == "nominated", mode=modes[mode])
    if mode.startswith("wrap"):  # the cursor went round past the last node
        assert int(want[3]["sample_start"]) < n - 10


def _fork_planes(cuda, N, L, T, KF, misaligned, seed=3):
    """Seeded node planes (labels [N, L], taints [N, T], dom_ids [L, N],
    visit_rank [N]) and fork alive rows [KF, N] on the card; with
    `misaligned`, every plane a view one int past a 16-byte boundary."""
    import types

    import numpy as np

    rng = np.random.default_rng(seed)

    def plane(shape):
        vals = torch.from_numpy(rng.integers(-2, 50, size=shape, dtype=np.int32))
        if not misaligned:
            return vals.to(cuda)
        buf = torch.empty((vals.numel() + 1,), dtype=torch.int32, device=cuda)
        out = buf[1:].view(shape)
        out.copy_(vals.to(cuda))
        return out

    dc = types.SimpleNamespace(node_labels=plane((N, L)), taint_key=plane((N, T)), taint_val=plane((N, T)),
                               taint_effect=plane((N, T)), dom_ids=plane((L, N)),
                               node_valid=torch.ones((N,), dtype=torch.bool, device=cuda))
    alive = torch.from_numpy(rng.random((KF, N)) < 0.7).to(cuda)
    return dc, alive, plane((N,))


@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("N,L,T,KF", [(5120, 8, 1, 64), (301, 3, 0, 13), (77, 5, 3, 9), (64, 4, 4, 8), (5, 1, 2, 3)])
def test_fork_view_kernel_matches_plain(cuda, N, L, T, KF, misaligned):
    """K15 against fork_cluster_view_plain, with and without the visit-rank
    plane: config4's planes (KF = 64, N = 5,120, L = 8, T = 1: every plane
    on the vector path); odd N, L and T, T = 0, a partial chunk of forks;
    widths that are multiples of 4; and planes one int off a 16-byte
    boundary (the cell-by-cell path)."""
    from kubernetes_tpu_torch.ops import counterfactual as cf

    dc, alive, vr = _fork_planes(cuda, N, L, T, KF, misaligned)
    for visit_rank in (vr, None):
        n0 = _build.launches["fork_view"]
        got = cf.fork_cluster_view(dc, alive, visit_rank)
        want = cf.fork_cluster_view_plain(dc, alive, visit_rank)
        torch.cuda.synchronize()
        assert _build.launches["fork_view"] == n0 + 1
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])


# ---- K5 on the thread-block cluster; K2 as an incremental argmax ------------


def _k5_check(cuda, world, cap, nominate=False, mode=None):
    """K5 against gang_schedule_plain on one batch of `world` (_k9_world's
    cases), exact on chosen, n_feas, the reason counts and the tallies (the
    usage rows and the cursor), with the cluster capped at `cap` CTAs (and
    taking that many); with 64 open nominations when `nominate`, and the
    step `mode` (gang.step_mode's keywords).  Returns the plain outputs."""
    nodes, placed, pending, P = world
    dc, db, kw, d_cap, flags = chip_smoke.gang_inputs(torch, cuda, nodes, placed, pending, P=P)
    tab = {k: kw[k] for k in ("sp_keys", "sp_cdv_tab", "ip_keys")}
    g = ops_gang.precompute_plain(dc, db, kw["hostname_key"], kw["v_cap"], hard_pod_affinity_weight=1,
                                  enabled=ops_gang.ALL_FILTER_KERNELS, **flags, **tab)
    extra = dict(chip_smoke.nominations(torch, dc, db) if nominate else {}, **(mode or {}))
    n0 = _build.launches["gang_scan"]
    got = ops_gang.gang_schedule(dc, db, g, kw["v_cap"], d_cap=d_cap, **extra)
    torch.cuda.synchronize()
    assert _build.launches["gang_scan"] == n0 + 1
    assert ops_gang.scan_stats["cluster"] == cap
    assert ops_gang.scan_stats["info"].tolist()[0] == cap
    want = ops_gang.gang_schedule_plain(dc, db, g, kw["v_cap"], d_cap=d_cap, **extra)
    for a, b in zip(got[:3], want[:3]):
        _equal(a, b)
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        _equal(got[3][k], want[3][k])
    return want


@pytest.mark.parametrize("smem_cap", [1 << 30, 0], ids=["shared", "global"])
@pytest.mark.parametrize("cap", [16, 8], ids=["cluster16", "cluster8"])
@pytest.mark.parametrize("case", ["hostname16", "hostname256", "hostname3072", "ports", "gen"])
def test_gang_scan_cluster_matches_plain(cuda, case, cap, smem_cap, monkeypatch):
    """K5 at both cluster sizes, its exchange slab, peer counters and
    slices' rows in shared memory and (SCAN_SMEM_CAP = 0) in global memory,
    on clusters whose N is below one 16-CTA cluster's 512 nodes (N = 16,
    256) or splits into slices of 192 / 384 nodes; with hostname-keyed
    spread and inter-pod slots (counters D = N wide), the host-port stamps
    and a mixed batch; some pod lands on a node a CTA other than rank 0
    owns."""
    monkeypatch.setattr(ops_gang, "SCAN_SMEM_CAP", smem_cap)
    monkeypatch.setattr(ops_gang, "SCAN_CLUSTER_CAP", cap)
    want = _k5_check(cuda, _k9_world(case), cap)
    assert int((want[0] >= 0).sum()) > 0
    if case in ("hostname256", "hostname3072", "gen"):
        assert int((want[0] >= 32).sum()) > 0


@pytest.mark.parametrize("cap", [16, 8], ids=["cluster16", "cluster8"])
@pytest.mark.parametrize("mode", ["wrap", "wrap_tie", "compat_all", "most_allocated", "rtcr", "tie", "nominated"])
def test_gang_scan_cluster_step_modes_match_plain(cuda, mode, cap, monkeypatch):
    """K5 at both cluster sizes in the step's branches on 200 nodes (N =
    256), as K9's cluster test: the sampling window from a cursor 10 nodes
    before the end (the walk wraps across the slices; with and without a
    tie key), the window over every node, MostAllocated,
    RequestedToCapacityRatio, a tie key alone, 64 open nominations.  The
    cursor the tallies carry out is the plain version's."""
    from kubernetes_tpu_torch.ops import rng

    monkeypatch.setattr(ops_gang, "SCAN_CLUSTER_CAP", cap)
    n = 200
    tie = dict(tie_key=rng.prng_key(chip_smoke.TIE_SEED), attempt_base=4321)
    modes = {
        "wrap": dict(sample_k=100, sample_start=n - 10),
        "wrap_tie": dict(sample_k=100, sample_start=n - 10, **tie),
        "compat_all": dict(sample_k=n, sample_start=n - 10),
        "most_allocated": dict(fit_strategy=(1, (), (1, 1))),
        "rtcr": dict(fit_strategy=(2, chip_smoke.SHAPE_RTCR, (1, 1))),
        "tie": tie,
        "nominated": None,
    }
    want = _k5_check(cuda, _k9_world("hostname256"), cap, nominate=mode == "nominated", mode=modes[mode])
    if mode.startswith("wrap"):  # the cursor went round past the last node
        assert int(want[3]["sample_start"]) < n - 10


def _k2_case(cuda, N, S, P, seed=19, pads=0.05, prefix=0, ties=False, none_fit=False, R=4):
    """A K2 feed made from a seed: S signatures (one all-zero, one asking
    for an extended lane) over N nodes with overcommitted rows, R resource
    lanes, P pod ids with a share of -1 pads and a masked prefix of `prefix`
    pads; `ties` makes every node alike (every score ties), `none_fit` asks
    more than any node has and leaves one signature statics-feasible
    nowhere."""
    g = torch.Generator().manual_seed(seed)
    alloc = torch.zeros((N, R), dtype=torch.int64)
    alloc[:, 0] = 8000 if ties else torch.randint(1, 5, (N,), generator=g) * 2000
    alloc[:, 1] = 16384 if ties else torch.randint(1, 5, (N,), generator=g) * 4096
    alloc[::7, 3] = 4
    used = torch.zeros_like(alloc) if ties else (alloc * torch.randint(0, 60, (N, 1), generator=g)) // 100
    if not ties:
        used[::11, 1] = alloc[::11, 1] + 1
    req = torch.zeros((S, R), dtype=torch.int64)
    req[:, 0] = torch.randint(100, 900, (S,), generator=g)
    req[:, 1] = torch.randint(64, 2048, (S,), generator=g)
    req[0] = 0
    if S > 1:
        req[1, 3] = 1
    if R > 4 and S > 2:  # a high extended lane on every third node
        alloc[::3, R - 1] = 2
        req[2, R - 1] = 1
    ok = torch.ones((S, N), dtype=torch.bool) if ties else torch.rand((S, N), generator=g) < 0.8
    if none_fit:
        req[:, 0] = 10**9
        ok[-1] = False
    ids = torch.randint(0, S, (P,), generator=g, dtype=torch.int32)
    ids[torch.rand(P, generator=g) < pads] = -1
    ids[:prefix] = -1
    fixed = dict(sig_ids=ids, sig_req=req, sig_nz=torch.stack([req[:, 0].clamp(min=100), req[:, 1].clamp(min=200)], 1),
                 sig_allzero=(req == 0).all(1), sig_ok=ok,
                 sig_img=torch.zeros((S, N), dtype=torch.int64) if ties else torch.randint(0, 101, (S, N), generator=g),
                 alloc=alloc, allowed=torch.full((N,), 110, dtype=torch.int32))
    state = dict(used=used, nz0=used[:, 0].clone(), nz1=used[:, 1].clone(),
                 num_pods=torch.zeros((N,), dtype=torch.int32) if ties else
                 torch.randint(0, 40, (N,), generator=g, dtype=torch.int32))
    to = lambda d: {k: v.to(cuda).contiguous() for k, v in d.items()}  # noqa: E731
    return to(fixed), to(state)


K2_CASES = {
    "s1": dict(N=700, S=1, P=1024),
    "s16": dict(N=10240 + 7, S=16, P=4096),
    "s512": dict(N=3000, S=512, P=2048),
    "all_pads": dict(N=700, S=16, P=512, pads=1.0),
    "one_pod": dict(N=700, S=16, P=1, pads=0.0),
    "ties": dict(N=700, S=4, P=1024, ties=True),
    "none_fit": dict(N=700, S=4, P=512, none_fit=True),
    "n1": dict(N=1, S=4, P=64),
    "masked_prefix": dict(N=700, S=16, P=1024, prefix=700),
    "wide_rows": dict(N=700, S=16, P=1024, R=16),  # a node's row is 2 R + 4 = 36 wide: no read-ahead
}


@pytest.mark.parametrize("smem_cap", [1 << 30, 0], ids=["shared", "global"])
@pytest.mark.parametrize("case", list(K2_CASES))
def test_sig_scan_incremental_matches_plain(cuda, case, smem_cap, monkeypatch):
    """K2's trees against sig_scan_plain, exact on the choices and the
    usage rows updated in place: 1, 16 and 512 signatures, all-pad and
    one-pod batches, every node tied, nothing fitting, N = 1 and N =
    10,240 + 7, a masked prefix as resident_run's serial tail passes, 16
    resource lanes (a row too wide for a lane each); the request rows and
    the trees' roots in shared memory, and the groups too where they fit
    (all but S = 512), or (SIG_TREE_SMEM_CAP = 0) all in global memory;
    three kernels enqueued a call."""
    monkeypatch.setattr(ops_fp, "SIG_TREE_SMEM_CAP", smem_cap)
    fx, state = _k2_case(cuda, **K2_CASES[case])
    shared = None
    w = dict(w_fit=1, w_bal=1, w_img=1, check_fit=True)
    outs = []
    for fn in (ops_fp.sig_scan, ops_fp.sig_scan_plain):
        st = {k: v.clone() for k, v in state.items()}
        n0 = _build.launches["sig_scan"]
        ch, _ = fn(fx["sig_ids"], fx["sig_req"], fx["sig_nz"], fx["sig_allzero"], fx["sig_ok"], fx["sig_img"],
                   fx["alloc"], fx["allowed"], st["used"], st["nz0"], st["nz1"], st["num_pods"], **w)
        torch.cuda.synchronize()
        assert _build.launches["sig_scan"] == n0 + (fn is ops_fp.sig_scan)
        if fn is ops_fp.sig_scan and int(fx["sig_ids"].numel()):
            shared = ops_fp.sig_scan_stats["tree_smem"]
            assert ops_fp.sig_scan_stats["launches"] == 3  # sig_mark, sig_build, the scan
        outs.append((ch, st))
    assert shared in (None, 0 if smem_cap == 0 else 2 if case != "s512" else 1)
    (ch_k, st_k), (ch_p, st_p) = outs
    _equal(ch_k, ch_p)
    for k in st_k:
        _equal(st_k[k], st_p[k])
    live = fx["sig_ids"] >= 0
    if case == "ties":
        assert int(ch_p[live][0]) == 0
    if case == "none_fit":
        assert bool((ch_p == -1).all())
    if case in ("s1", "s16", "s512", "masked_prefix"):
        assert int((ch_p >= 0).sum()) > 0


# ---------------------------------------------------------------------------
# K6 gang_spread_statics and K7 gang_interpod_statics: match bits, domain
# cells in shared memory (domain tiles past the budget), no host sync
# ---------------------------------------------------------------------------

STATICS_CASES = [(kind, seed) for kind in chip_smoke.STATICS_WORLDS for seed in (3, 8)]


def _statics_check(cuda, nodes, placed, pending, P, mutate=None, hard_weight=1, fork=None):
    """precompute (K1 + K6 + K7) against precompute_plain on every
    GangStatics field, exactly, and each kernel of the two launches
    recorded a span; `fork` maps the packed cluster to the one checked, and
    the batch's tables are then built off that cluster's labels (a fork's
    gone nodes have none), as tests/test_torch_gang_statics.py builds the
    reference's."""
    dc, db, kw, d_cap, flags = chip_smoke.gang_inputs(torch, cuda, nodes, placed, pending, P=P, mutate=mutate)
    if fork is not None:
        dc = fork(dc)
        tables = ops_gang.batch_tables(db.tsc_topo.cpu().numpy(), db.aff_topo.cpu().numpy(),
                                       dc.node_labels.cpu().numpy(), kw["hostname_key"])
        kw.update({k: torch.as_tensor(tables[k], device=cuda) for k in ("sp_keys", "sp_cdv_tab", "ip_keys")})
    tab = {k: kw[k] for k in ("sp_keys", "sp_cdv_tab", "ip_keys")}
    n0 = dict(_build.launches)
    got = ops_gang.precompute(dc, db, **kw, **flags, hard_pod_affinity_weight=hard_weight)
    want = ops_gang.precompute_plain(dc, db, kw["hostname_key"], kw["v_cap"], hard_pod_affinity_weight=hard_weight,
                                     enabled=ops_gang.ALL_FILTER_KERNELS, **flags, **tab)
    for f in ops_gang.GangStatics._fields:
        _equal(getattr(got, f), getattr(want, f))
    if flags["has_spread"]:
        assert _build.launches["gang_spread_statics"] == n0["gang_spread_statics"] + 1
        spans = ops_gang.statics_spans("spread")
        assert {"match", "domain", "all"} <= set(spans) and min(spans.values()) > 0
    if flags["has_interpod"]:
        assert _build.launches["gang_interpod_statics"] == n0["gang_interpod_statics"] + 1
        spans = ops_gang.statics_spans("interpod")
        assert {"ext", "ports", "all"} <= set(spans) and min(spans.values()) > 0
    return dc, db, got


@pytest.mark.parametrize("ratio", [2, 0], ids=["classes-auto", "classes"])
@pytest.mark.parametrize("kind,seed", STATICS_CASES, ids=[f"{k}-{s}" for k, s in STATICS_CASES])
def test_gang_statics_kernels_match_plain_on_the_scenarios(cuda, kind, seed, ratio, monkeypatch):
    """K6 and K7 on the scenarios tests/test_torch_gang_statics.py holds the
    plain versions to against the JAX package (negative symmetric weights
    under a hard weight of 100, dead placed terms, three keys, spread
    policies, namespace sets); with STATICS_CLASS_RATIO = 0 the selectors
    are always collapsed to their representatives first."""
    monkeypatch.setattr(ops_gang, "STATICS_CLASS_RATIO", ratio)
    nodes, placed, pending, mutate = chip_smoke.statics_world(kind, seed)
    _statics_check(cuda, nodes, placed, pending, P=32, mutate=mutate,
                   hard_weight=100 if kind == "preferred_anti" else 1)


@pytest.mark.parametrize("ratio", [2, 0], ids=["tiles", "tiles-classes"])
@pytest.mark.parametrize("world", ["gen", "three_keys"])
def test_gang_statics_domain_tiles_match_plain(cuda, world, ratio, monkeypatch):
    """With the shared budget capped (STATICS_SMEM_CAP = 512 bytes: one
    word of 32 cells a tile) K6's domain kernel, K7's ext and its domain
    kernel walk the hostname key's 200 domains (ext: every used key's) in
    tiles, carrying the sums across them, with and without the selector
    classes, and equal the plain versions."""
    monkeypatch.setattr(ops_gang, "STATICS_SMEM_CAP", 512)
    monkeypatch.setattr(ops_gang, "STATICS_CLASS_RATIO", ratio)
    if world == "gen":
        nodes, placed, pending = chip_smoke.gen_cluster(101, 200, 300, 128)
        mutate = None
    else:
        nodes, placed, pending, mutate = chip_smoke.statics_world(world, 5)
        extra = [chip_smoke.gen_node(chip_smoke.random.Random(7), i) for i in range(20, 220)]
        nodes = nodes + extra
    dc, _, got = _statics_check(cuda, nodes, placed, pending, P=128, mutate=mutate)
    assert max(dc.dom_counts) > 32 and bool(got.ip_viol_existing.any())


def test_gang_statics_ports_only_launch(cuda):
    """K7 with the inter-pod half off (the launch config4's batches make:
    NodePorts on, no inter-pod terms) equals port_masks_plain."""
    nodes, placed, pending = chip_smoke.gen_cluster(13, 150, 40, 128)
    dc, db, *_ = chip_smoke.gang_inputs(torch, cuda, nodes, placed, pending, P=128)
    n0 = _build.launches["gang_interpod_statics"]
    got = ops_gang.interpod_statics(dc, db, do_interpod=False, do_ports=True)
    d_ports, port_b = ops_gang.port_masks_plain(dc, db)
    _equal(got["d_ports"], d_ports)
    _equal(got["port_b"], port_b)
    assert bool((~d_ports).any()) and _build.launches["gang_interpod_statics"] == n0 + 1
    assert set(ops_gang.statics_spans("interpod")) == {"ports", "all"}


def test_gang_statics_on_a_fork_view(cuda):
    """K6 and K7 over a planner fork's cluster (K15's view: gone nodes with
    ABSENT labels and domain ids -1, their placed pods evicted) equal the
    plain versions on it."""
    from kubernetes_tpu_torch.ops import counterfactual as ops_cf

    def fork(dc):
        alive = dc.node_valid.clone()
        gone = torch.nonzero(alive).flatten()[torch.tensor([3, 17, 40])]
        alive[gone] = False
        ep_valid = dc.epod_valid & ~torch.isin(dc.epod_node, gone.to(dc.epod_node.dtype))
        planes = {k: v[None] for k, v in dict(
            fk_alive=alive, fk_unsched=dc.unschedulable, fk_alloc=dc.allocatable, fk_req=dc.requested,
            fk_nz=dc.nonzero_req, fk_npods=dc.num_pods, fk_epod_valid=ep_valid).items()}
        view = ops_cf.fork_cluster_view(dc, planes["fk_alive"], visit_rank=dc.visit_rank)
        out = ops_cf._fork_cluster(dc, view, planes, 0, int(alive.sum().item()))
        assert bool((out.dom_ids[:, gone] == -1).all()) and out.dom_size is dc.dom_size
        return out

    nodes, placed, pending = chip_smoke.gen_cluster(33, 120, 200, 64)
    _statics_check(cuda, nodes, placed, pending, P=64, fork=fork)


def test_gang_statics_wrappers_do_not_synchronize(cuda):
    """Neither wrapper waits for the card: launched behind a long
    torch.cuda._sleep, both return while the card is still busy, in a
    fraction of the sleep's time."""
    import time

    nodes, placed, pending = chip_smoke.gen_cluster(101, 200, 300, 128)
    dc, db, kw, d_cap, flags = chip_smoke.gang_inputs(torch, cuda, nodes, placed, pending, P=128)
    st = ops_fp.static_eval_plain(dc, db, frozenset({"TaintToleration", "NodeAffinity"}), False)
    naff, taints = st["m_nodeaff"].contiguous(), st["m_taints"].contiguous()

    def both():
        ops_gang.spread_statics(dc, db, naff, taints, kw["hostname_key"])
        ops_gang.interpod_statics(dc, db, do_interpod=True, do_ports=True)

    both()  # warm-up: the build and the first launches
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(200_000_000)
    b.record()
    torch.cuda.synchronize()
    sleep_s = a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    torch.cuda._sleep(200_000_000)
    both()
    host_s = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert busy and host_s < sleep_s / 2, (host_s, sleep_s)
