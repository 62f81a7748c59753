"""The workloads dispatch: gang admission, DRA claim allocation and the
bound-volume topology mask.

Port of the JAX package's ops/coscheduling.py (its jit roots
``workloads_run`` and ``workloads_schedule``, and ``volume_topology_mask``).
One dispatch schedules a batch in the wave's two passes (ops/wave.py):

  1. **speculation**: every pod against the frozen snapshot, exactly the
     wave's first pass (kernel K8, ``wave.wave_speculate``), with the
     batch's DRA verdict against the pre-batch allocation state (K14,
     ops/dra.py) as its port lane;
  2. **admission**: the serial recurrence ``choice_i = F_i(S + sum_{j<i}
     delta(choice_j))`` over the term-factored carries, as the wave's
     second pass, extended by the two allocation carries of ops/dra.py
     (``free [N, DD]``, ``claim_node [CL]``), with all-or-nothing gangs.
     Each pod's DRA verdict against the carries is its port lane (a DRA
     rejection lands in the NodePorts diagnosis lane, as in the
     reference), and a placement takes its devices at the chosen node and
     pins its claims there, so in-batch contention resolves in queue
     order.  The planner (workloads/gang.py ``plan_batch``) lays each
     gang's members out contiguously; at the gang's last member the pass
     admits the gang only when the members placed in this batch cover its
     remaining minMember need.  Otherwise the carried state returns to
     where it stood before the gang's first member's step (the reference
     snapshots it there; the port undoes the placements made since, which
     is the same state): later pods see a state in which the gang never
     happened (its devices free, its claims unpinned), and the members read
     -1 in ``chosen`` while ``raw`` keeps the choices the pass made for
     them.

Pods with bound PVCs ride the same dispatch: ``volume_topology_mask``
evaluates each bound PV's node-affinity DNF (and a zone-labelled PV's
``key In zone-set`` conjunctions) against the node rows into a [P, N] mask,
which the precompute folds into its host-filter lane (``extra_mask``:
static_mask and ``d_extra``), so a volume rejection carries that lane's
diagnosis.

The verdict is gang.pod_step, the same step as the scan and the wave, and
the factored carries are the wave's.  Each pass has a plain PyTorch version
(the reference's formulas), which the wrapper takes for CPU tensors; for
CUDA tensors it launches the hand-written kernel or raises:

  K11 workloads_admit        the admission pass with the gang rollback by
                             undo and, for a batch with claims, the
                             allocation carries, on K9's thread-block
                             cluster (csrc/workloads.cu)
  K12 volume_topology_mask   the bound-PV mask, a thread per (pod, node)
                             (csrc/volume.cu)

and the DRA match and speculation lane are K13 and K14 (ops/dra.py).
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import dra as dra_ops
from kubernetes_tpu_torch.ops import gang
from kubernetes_tpu_torch.ops import wave
from kubernetes_tpu_torch.ops.common import DTable, dnf_any, eval_table, usage_carry_update
from kubernetes_tpu_torch.ops.gang import N_DIAG
from kubernetes_tpu_torch.snapshot.interner import ABSENT

I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool


def _dra_group(kw) -> dict:
    """The DRA arguments of a workloads call: all of ops/dra.py DRA_ARGS or
    none of them (an empty dict)."""
    unknown = set(kw) - set(dra_ops.DRA_ARGS)
    if unknown:
        raise TypeError(f"unexpected arguments {sorted(unknown)}")
    given = {k: v for k, v in kw.items() if v is not None}
    if given and len(given) != len(dra_ops.DRA_ARGS):
        missing = [k for k in dra_ops.DRA_ARGS if k not in given]
        raise ValueError(f"workloads dispatch: the DRA arguments come together; missing {missing}")
    return given


# ---------------------------------------------------------------------------
# K12: volume_topology_mask
# ---------------------------------------------------------------------------


def volume_topology_mask(dc, vol_table: DTable, vol_valid, vol_bad):
    """The bound-PV topology filter as a [P, N] bool mask: every PV slot
    ``vol_valid`` marks (one PV's node-affinity DNF, or a zone-labelled PV's
    ``key In zone-set`` conjunctions, ORed terms on the table's term axis)
    must admit the node, and ``vol_bad`` pods (a bound claim whose PV is
    missing) admit none.  ``vol_table``'s fields are [P, PV2, T, R(, V)].
    K12 on CUDA tensors, its plain version on CPU."""
    if dc.node_valid.device.type == "cpu":
        return volume_topology_mask_plain(dc, vol_table, vol_valid, vol_bad)
    return _volume_topology_mask_cuda(dc, vol_table, vol_valid, vol_bad)


def volume_topology_mask_plain(dc, vol_table: DTable, vol_valid, vol_bad):
    """Plain version of K12: the reference's formula (ops/coscheduling.py:66)
    through eval_table and dnf_any."""
    vm = eval_table(vol_table, dc.node_labels, dc.val_ints)  # [P, PV2, T, N]
    per_pv = dnf_any(vm)  # [P, PV2, N]
    vol_mask = torch.where(vol_valid[:, :, None], per_pv, True).all(dim=1)  # [P, N]
    return vol_mask & ~vol_bad[:, None]


def _volume_topology_mask_cuda(dc, vol_table: DTable, vol_valid, vol_bad):
    dev = dc.node_valid.device
    lib = _build.load()
    P, PV2, T, R = vol_table.req_key.shape
    V = vol_table.req_vals.shape[-1]
    N, K = dc.node_labels.shape
    c = _build.check_cuda
    out = torch.empty((P, N), dtype=BOOL, device=dev)
    rc = lib.ktpu_volume_topology_mask(
        c("req_key", vol_table.req_key, dev, I32, (P, PV2, T, R)),
        c("req_op", vol_table.req_op, dev, I32, (P, PV2, T, R)),
        c("req_vals", vol_table.req_vals, dev, I32, (P, PV2, T, R, V)),
        c("req_rhs", vol_table.req_rhs, dev, I32, (P, PV2, T, R)),
        c("term_valid", vol_table.term_valid, dev, BOOL, (P, PV2, T)),
        c("vol_valid", vol_valid, dev, BOOL, (P, PV2)),
        c("vol_bad", vol_bad, dev, BOOL, (P,)),
        c("node_labels", dc.node_labels, dev, I32, (N, K)),
        c("val_ints", dc.val_ints, dev, I32),
        out.data_ptr(), P, PV2, T, R, V, N, K, dc.val_ints.shape[0], _build.stream_handle(dev))
    _build.check_launch(lib, rc, "volume_topology_mask")
    _build.launches["volume_topology_mask"] += 1
    return out


# the usage rows a placement commits
_USAGE = ("requested", "nonzero", "num_pods")
# a pod's request rows of ops/dra.py, in node_feasible_plain's order
_DRA_ROWS = ("req_count", "req_all", "req_cl", "q_valid", "req_bad", "ref_cl")


def workloads_admit_plain(dc, db, g, hostname_key, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u,
                          ip_cdv_tab, gang_id, gang_first, gang_last, gang_need, g_cap: int,
                          weights=gang.DEFAULT_WEIGHTS, check_fit=True, d_cap=8, d2_cap=8, nom_node=None,
                          nom_prio=None, nom_req=None, dra=None, extra_score=None,
                          fit_strategy=gang.DEFAULT_FIT_STRATEGY):
    """Plain version of K11: the admission recurrence of the reference's
    workloads_schedule (ops/coscheduling.py:297-432), one pod at a time,
    under the NodeResourcesFit strategy ``fit_strategy``.
    ``dra`` (None: no claims in the batch) holds the match tensor ``match``
    [P, DQ, N, DD], ``free0``, ``claim_node0`` and the request rows of
    ops/dra.py; the allocation carries start from free0 and claim_node0.
    ``extra_score`` (i64 [P, N], or None) adds to every node's total.

    A failed gang rolls back by undo, as K11 does: the reference restores
    the state saved before the most recent first member's step (the initial
    state before any first member), and every commit since is additive, so
    the pass subtracts the commits of the pods from that point, or from the
    pod after the last rollback, through the failing member, each from its
    recorded choice (usage, term columns and the reverse counts; with
    claims its take row at the node and the claims it pinned), and their
    ``assigned`` read -1 again.  Returns (chosen i32 [P] after rollback, raw
    i32 [P] before it, n_feas i64 [P], reason_counts i64 [P, N_DIAG],
    tallies, gang_admit i32 [g_cap] (-1 unjudged, 0 rolled back, 1
    admitted), gang_landed i32 [g_cap], claim_node i32 [CL] after the
    batch, or None without ``dra``)."""
    P, N = g.static_mask.shape
    nom = gang.nominations_onehot(nom_node, nom_prio, nom_req, N)
    C, AT = g.sp_dv.shape[1], g.ip_dv.shape[1]
    dev = g.static_mask.device
    Rn = dc.requested.shape[1]
    true_n = torch.ones((N,), dtype=BOOL, device=dev)
    m_sp_all, m_ip_all, t_anti, t_w = wave.term_match_rows(g, rep_sp_p, rep_sp_c, rep_ip_p, rep_ip_u)
    state = gang._state0(dc)  # pod_step commits the usage rows in place
    assigned = torch.full((P,), ABSENT, dtype=I32, device=dev)
    Tsp, Tip = rep_sp_p.shape[0], rep_ip_p.shape[0]
    carries = wave.factored_carry_init(Tsp, Tip, N, 0, dev)
    alloc = {} if dra is None else {"free": dra["free0"].clone(), "claim_node": dra["claim_node0"].clone()}
    raw = torch.full((P,), ABSENT, dtype=I32, device=dev)
    n_feas = torch.zeros((P,), dtype=I64, device=dev)
    reason_counts = torch.zeros((P, N_DIAG), dtype=I64, device=dev)
    gang_admit = torch.full((g_cap,), -1, dtype=I32, device=dev)
    gang_landed = torch.zeros((g_cap,), dtype=I32, device=dev)
    landed = 0
    log_start = 0  # the first pod whose commit a rollback undoes
    undo = {}  # pod -> (its carry deltas, its cleared free bits at the node, the claims it pinned)
    gid_all, first_all, last_all, need_all = (t.tolist() for t in (gang_id, gang_first, gang_last, gang_need))
    for p in range(P):
        in_gang = gid_all[p] >= 0
        is_first = bool(first_all[p]) and in_gang
        if is_first:
            log_start = p
        sdyn = wave.factored_spread_dyn(g, p, tid_sp, carries["cnt_sp"], d_cap) if C else wave._zero_sdyn(C, N, dev)
        idyn, ip_aux = wave._zero_idyn(AT, N, dev), None
        if AT:
            idyn, ip_aux = wave.factored_interpod_dyn(g, db, p, tid_ip, ip_cdv_tab, d2_cap, hostname_key,
                                                      carries["cnt_ip"], carries["rev_cnt"], m_ip_all, t_anti, t_w)
        m_dra, take = true_n, None
        if dra is not None:
            m_dra, take = dra_ops.node_feasible_plain(dra["match"][p], alloc["free"], alloc["claim_node"],
                                                      *(dra[k][p] for k in _DRA_ROWS))
        hv, _, _ = wave._build_hv(db, g, p, sdyn, idyn, m_dra)
        choice, nf, rc = gang.pod_step(dc, db, g, p, state, hv, check_fit=check_fit, weights=weights, d_cap=d_cap,
                                       nom=nom, extra_score=extra_score, fit_strategy=fit_strategy)
        assigned[p] = choice
        zero = wave.factored_carry_init(Tsp, Tip, N, 0, dev)
        delta = wave.factored_carry_update(zero, p, choice, m_sp_all, m_ip_all, ip_aux)
        carries = {k: carries[k] + delta[k] for k in carries}
        cleared = pinned = None
        if dra is not None:
            free, cn = alloc["free"], alloc["claim_node"]
            alloc["free"], alloc["claim_node"] = dra_ops.dra_commit_plain(free, cn, choice, take, dra["ref_cl"][p])
            cleared, pinned = free & ~alloc["free"], cn != alloc["claim_node"]
        undo[p] = (delta, cleared, pinned)
        raw[p] = choice
        n_feas[p] = nf
        reason_counts[p] = rc
        c = int(choice)
        landed = (0 if is_first else landed) + int(c >= 0 and in_gang)
        if bool(last_all[p]) and in_gang:
            fail = landed < need_all[p]
            if fail:  # undo the commits since the checkpoint
                for q in range(log_start, p + 1):
                    if int(raw[q]) < 0:
                        continue
                    delta, cleared, pinned = undo[q]
                    usage_carry_update({k: state[k] for k in _USAGE},
                                            {"requested": -db.requests[q][:Rn], "nonzero": -db.nonzero_req[q],
                                             "num_pods": -1}, raw[q], raw[q] >= 0)
                    carries = {k: carries[k] - delta[k] for k in carries}
                    if dra is not None:
                        alloc["free"] = alloc["free"] | cleared
                        alloc["claim_node"] = torch.where(pinned, ABSENT, alloc["claim_node"])
                    assigned[q] = ABSENT
                log_start = p + 1
            if gid_all[p] < g_cap:
                gang_admit[gid_all[p]] = 0 if fail else 1
                gang_landed[gid_all[p]] = landed
    tallies = {k: state[k] for k in _USAGE}
    return assigned, raw, n_feas, reason_counts, tallies, gang_admit, gang_landed, alloc.get("claim_node")


def workloads_admit(dc, db, g, hostname_key, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u, ip_cdv_tab,
                    gang_id, gang_first, gang_last, gang_need, g_cap: int, weights=gang.DEFAULT_WEIGHTS,
                    check_fit=True, d_cap=8, d2_cap=8, nom_node=None, nom_prio=None, nom_req=None, dra=None,
                    extra_score=None, fit_strategy=gang.DEFAULT_FIT_STRATEGY):
    """The admission pass: K11 on CUDA tensors, its plain version on CPU."""
    args = (dc, db, g, hostname_key, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u, ip_cdv_tab, gang_id,
            gang_first, gang_last, gang_need, g_cap, weights, check_fit, d_cap, d2_cap)
    kw = dict(nom_node=nom_node, nom_prio=nom_prio, nom_req=nom_req, dra=dra, extra_score=extra_score,
              fit_strategy=gang.step_mode(fit_strategy)["fit_strategy"])
    if dc.node_valid.device.type == "cpu":
        return workloads_admit_plain(*args, **kw)
    return _workloads_admit_cuda(*args, **kw)


def _schedule(admit, speculate, match_fn, lane_fn, dc, db, g, hostname_key, g_cap, tables, gang_arrays, weights,
              check_fit, d_cap, d2_cap, nom, extra_score, dra_kw):
    dra_kw = _dra_group(dra_kw)
    dra = lane = None
    if dra_kw:
        match = match_fn(*(dra_kw[k] for k in ("dev_key", "dev_val", "dev_valid", "sel_key", "sel_op", "sel_vals")))
        dra = dict(match=match, free0=dra_kw["free0"], claim_node0=dra_kw["claim_node0"],
                   **{k: dra_kw[k] for k in _DRA_ROWS})
        lane = lane_fn(match, dra["free0"], dra["claim_node0"], *(dra[k] for k in _DRA_ROWS))
    c0 = speculate(dc, db, g, weights, check_fit, d_cap, **nom, lane=lane, extra_score=extra_score)
    chosen, raw, n_feas, rc, tallies, gang_admit, gang_landed, claim_node = admit(
        dc, db, g, hostname_key, *tables, *gang_arrays, g_cap, weights, check_fit, d_cap, d2_cap, **nom, dra=dra,
        extra_score=extra_score)
    wl = {"spec": c0, "raw": raw, "gang_admit": gang_admit, "gang_landed": gang_landed, "claim_node": claim_node}
    return chosen, n_feas, rc, tallies, wl


def workloads_schedule_plain(dc, db, g, hostname_key, v_cap, g_cap, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p,
                             rep_ip_u, ip_cdv_tab, gang_id, gang_first, gang_last, gang_need,
                             weights=gang.DEFAULT_WEIGHTS, check_fit=True, nom_node=None, nom_prio=None,
                             nom_req=None, d_cap=8, d2_cap=8, extra_score=None, fit_strategy=gang.DEFAULT_FIT_STRATEGY,
                             **dra_kw):
    """Plain version of workloads_schedule: K13's, K14's, K8's and K11's
    plain versions."""
    return _schedule(workloads_admit_plain, wave.wave_speculate_plain, dra_ops.selector_match_plain,
                     dra_ops.dra_spec_mask_plain, dc, db, g, hostname_key, g_cap,
                     (tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u, ip_cdv_tab),
                     (gang_id, gang_first, gang_last, gang_need), weights, check_fit, d_cap, d2_cap,
                     dict(nom_node=nom_node, nom_prio=nom_prio, nom_req=nom_req, fit_strategy=fit_strategy),
                     extra_score, dra_kw)


def workloads_schedule(dc, db, g, hostname_key, v_cap, g_cap, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p,
                       rep_ip_u, ip_cdv_tab, gang_id, gang_first, gang_last, gang_need, weights=gang.DEFAULT_WEIGHTS,
                       check_fit=True, nom_node=None, nom_prio=None, nom_req=None, d_cap=8, d2_cap=8,
                       extra_score=None, fit_strategy=gang.DEFAULT_FIT_STRATEGY, **dra_kw):
    """One workloads dispatch: for a batch with claims the match (K13) and
    the speculation's DRA lane (K14), then the speculation (K8) and the
    admission (K11).  The cluster's usage rows are read, not written.
    ``gang_*`` are workloads/gang.py ``gang_arrays``' [P] rows (as tensors)
    and ``g_cap`` its slot count; ``nom_*`` the open nominations
    (ops/gang.py), charged in both passes; ``extra_score`` (i64 [P, N], or
    None) adds to every node's total in both passes (the planner's target
    bonus); ``fit_strategy`` is the NodeResourcesFit strategy (ops/gang.py)
    of both passes; ``dra_kw`` is ops/dra.py ``dra_tables``' tensors
    (ops/dra.py DRA_ARGS), all or none.

    Returns (chosen i32 [P] after rollback (-1 for failed and rolled-back
    pods), n_feas i64 [P], reason_counts i64 [P, N_DIAG], tallies, wl): wl
    holds spec i32 [P] (the speculative choices), raw i32 [P] (the
    admission's choices before rollback), gang_admit i32 [g_cap] (-1
    unjudged, 0 rolled back, 1 admitted), gang_landed i32 [g_cap] (the
    members placed in this batch) and claim_node i32 [CL] (each referenced
    claim's node after the batch, -1 unallocated; None without claims)."""
    return _schedule(workloads_admit, wave.wave_speculate, dra_ops.selector_match, dra_ops.dra_spec_mask, dc, db, g,
                     hostname_key, g_cap, (tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u, ip_cdv_tab),
                     (gang_id, gang_first, gang_last, gang_need), weights, check_fit, d_cap, d2_cap,
                     dict(nom_node=nom_node, nom_prio=nom_prio, nom_req=nom_req, fit_strategy=fit_strategy),
                     extra_score, dra_kw)


def workloads_run(dc, db, hostname_key: int, v_cap: int, g_cap: int, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p,
                  rep_ip_u, ip_cdv_tab, gang_id, gang_first, gang_last, gang_need, vol_table=None, vol_valid=None,
                  vol_bad=None, hard_pod_affinity_weight: int = 1, has_interpod: bool = True,
                  has_spread: bool = True, has_images: bool = True, enabled: frozenset = gang.ALL_FILTER_KERNELS,
                  weights: tuple = gang.DEFAULT_WEIGHTS, extra_mask=None, nom_node=None, nom_prio=None,
                  nom_req=None, sp_keys=None, sp_cdv_tab=None, ip_keys=None, d_cap: int = 8, d2_cap: int = 8,
                  extra_score=None, fit_strategy: tuple = gang.DEFAULT_FIT_STRATEGY, **dra_kw):
    """precompute + workloads_schedule for one batch: K12 for the volume
    mask when ``vol_table`` is given (ANDed into ``extra_mask``), K1 + K6 +
    K7 for the statics, then K13, K14, K8 and K11 (``dra_kw``: ops/dra.py
    DRA_ARGS, all or none).  The workloads gate admits no pod with host
    ports, so the port axis is left out (precompute with has_ports=False)
    and the port lane carries the DRA verdict.  ``extra_score`` (i64
    [P, N], or None) adds to every node's total in K8 and K11."""
    if vol_table is not None:
        vmask = volume_topology_mask(dc, vol_table, vol_valid, vol_bad)
        extra_mask = vmask if extra_mask is None else (extra_mask & vmask)
    g = gang.precompute(dc, db, hostname_key, v_cap, hard_pod_affinity_weight, has_interpod=has_interpod,
                        has_spread=has_spread, has_ports=False, has_images=has_images, enabled=enabled,
                        extra_mask=extra_mask, sp_keys=sp_keys, sp_cdv_tab=sp_cdv_tab, ip_keys=ip_keys)
    return workloads_schedule(dc, db, g, hostname_key, v_cap, g_cap, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p,
                              rep_ip_u, ip_cdv_tab, gang_id, gang_first, gang_last, gang_need, weights=weights,
                              check_fit="NodeResourcesFit" in enabled, nom_node=nom_node, nom_prio=nom_prio,
                              nom_req=nom_req, d_cap=d_cap, d2_cap=d2_cap, extra_score=extra_score,
                              fit_strategy=fit_strategy, **dra_kw)


# ---------------------------------------------------------------------------
# CUDA: K11
# ---------------------------------------------------------------------------

# K11's last launch: {"cluster": its CTAs, "claims_smem": whether the CTAs'
# claim copies sat in shared memory, "undone": int32 [1], the placements its
# rollbacks undid (read it after a synchronize)}.
admit_stats: dict = {}


def _workloads_admit_cuda(dc, db, g, hostname_key, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u,
                          ip_cdv_tab, gang_id, gang_first, gang_last, gang_need, g_cap, weights, check_fit, d_cap,
                          d2_cap, nom_node=None, nom_prio=None, nom_req=None, dra=None, extra_score=None,
                          fit_strategy=gang.DEFAULT_FIT_STRATEGY):
    """K11 launch: K9's argument blocks with no port carry, laid out for the
    thread-block cluster by ktpu_workloads_admit_plan under K9's knobs
    (ops/wave.py ADMIT_CLUSTER_CAP, ADMIT_SMEM_CAP, ADMIT_STAGE), plus the
    gang rows, the outputs, each CTA's row of the batch's choices and, with
    ``dra``, the match tensor, the request rows, the allocation carries
    (copies of free0 and claim_node0, updated in place), the take log and,
    where they do not fit in shared memory, the CTAs' claim copies."""
    dev = dc.node_valid.device
    lib = _build.load()
    P, N = g.static_mask.shape
    unused = torch.empty((P,), dtype=I32, device=dev)  # K9's c0 / kinds / cterms: not read or written
    nom = gang.nominations_csr(nom_node, nom_prio, nom_req, N, dev)
    a, w, state, outs = wave._admit_blocks(dc, db, g, hostname_key, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p,
                                           rep_ip_u, weights, check_fit, False, None, None, nom, unused, unused,
                                           unused, extra_score, gang.step_mode(fit_strategy))
    raw, n_feas, reason_counts = outs  # K11 writes each step's choice through GangScanArgs.chosen
    assigned = torch.empty((P,), dtype=I32, device=dev)
    gang_admit = torch.empty((g_cap,), dtype=I32, device=dev)
    gang_landed = torch.empty((g_cap,), dtype=I32, device=dev)
    undone = torch.zeros((1,), dtype=I32, device=dev)
    DQ = DD = CQ = CL = 0
    claim_node = None
    k = _build.WorkloadsArgs()
    ptrs = [
        ("gang_id", gang_id.to(I32).contiguous(), I32, (P,)),
        ("gang_first", gang_first.to(BOOL).contiguous(), BOOL, (P,)),
        ("gang_last", gang_last.to(BOOL).contiguous(), BOOL, (P,)),
        ("gang_need", gang_need.to(I32).contiguous(), I32, (P,)),
        ("assigned", assigned, I32, (P,)), ("gang_admit", gang_admit, I32, (g_cap,)),
        ("gang_landed", gang_landed, I32, (g_cap,)), ("undone", undone, I32, (1,)),
    ]
    if dra is not None:
        _, DQ, _, DD = dra["match"].shape
        CL, CQ = dra["claim_node0"].shape[0], dra["ref_cl"].shape[1]
        claim_node = dra["claim_node0"].clone()
        ptrs += [
            ("dra_match", dra["match"].contiguous(), BOOL, (P, DQ, N, DD)),
            ("req_count", dra["req_count"].contiguous(), I32, (P, DQ)),
            ("req_all", dra["req_all"].contiguous(), BOOL, (P, DQ)),
            ("req_cl", dra["req_cl"].contiguous(), I32, (P, DQ)),
            ("q_valid", dra["q_valid"].contiguous(), BOOL, (P, DQ)),
            ("req_bad", dra["req_bad"].contiguous(), BOOL, (P, DQ)),
            ("ref_cl", dra["ref_cl"].contiguous(), I32, (P, CQ)),
            ("free", dra["free0"].clone().contiguous(), BOOL, (N, DD)),
            ("claim_node", claim_node, I32, (CL,)),
            ("dra_row", torch.empty((N,), dtype=BOOL, device=dev), BOOL, (N,)),
            ("take_log", torch.empty((P * ((DD + 63) // 64),), dtype=torch.int64, device=dev), torch.int64, None),
        ]
    gang._set_ptrs(k, dev, ptrs)
    k.g_cap = int(g_cap)
    k.DQ, k.DD, k.CQ, k.CL = DQ, DD, CQ, CL
    rc = lib.ktpu_workloads_admit_plan(ctypes.byref(a), ctypes.byref(w), ctypes.byref(k),
                                       int(wave.ADMIT_CLUSTER_CAP), int(min(wave.ADMIT_SMEM_CAP, 2**31 - 1)),
                                       int(bool(wave.ADMIT_STAGE)))
    _build.check_launch(lib, rc, "workloads_admit")
    G = int(w.cluster)
    gang._set_ptrs(w, dev, [
        ("sums", wave._zeros(dev, 1 if w.sums_smem else G * w.xch_cells), I32, None),
        ("carries", wave._zeros(dev, 1 if w.carry_smem else wave._carry_cells(w, N)), I32, None),
    ])
    scratch = [("choice_log", torch.empty((G * P,), dtype=I32, device=dev), I32, None)]
    if dra is not None and not k.claims_smem:
        scratch.append(("claims", torch.empty((G * 2 * CL,), dtype=I32, device=dev), I32, None))
    if DD > dra_ops.REG_DD:  # the verdict words past the registers, a row per thread of the cluster
        rows = G * lib.ktpu_cluster_threads()
        scratch.append(("dra_scratch", torch.empty((rows * dra_ops.scratch_words(DD),), dtype=torch.int64,
                                                   device=dev), torch.int64, None))
    gang._set_ptrs(k, dev, scratch)
    rc = lib.ktpu_workloads_admit(ctypes.byref(a), ctypes.byref(w), ctypes.byref(k), _build.stream_handle(dev))
    _build.check_launch(lib, rc, "workloads_admit")
    _build.launches["workloads_admit"] += 1
    admit_stats.update(cluster=G, claims_smem=bool(k.claims_smem), undone=undone)
    return assigned, raw, n_feas, reason_counts, state, gang_admit, gang_landed, claim_node
