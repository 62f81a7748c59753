"""Chained batch dispatch: the gang scan or the speculative wave, plus the
append of the batch's own placements into the resident cluster.

Port of the JAX package's ops/chain.py (jit root ``chain_dispatch``), both
branches.  One call schedules the batch (the gang scan, or with
``wave=True`` the wave of ops/wave.py) and then writes its committed pods
into the DeviceCluster the call was given (rows of placed pods and of their
(anti-)affinity terms, the device analogue of
schema.append_existing_pods), so the next batch schedules against that
cluster without a host upload.  The reference donates the cluster and
returns a new one; here the usage tensors are replaced by the tallies and
the placed-pod and term rows are ``copy_``-ed in place at the host-checked
cursors.

Anything the device cannot see (informer events, bind failures, fast-path
commits) changes the scheduler's chain epoch and forces a fresh upload.

Layout note: like the reference, the append keeps each pod's term rows at a
fixed stride (P·AT rows per batch, PAD rows for empty term slots); term
evaluation is gated on term_kind / epod_valid, so PAD gaps are inert and
only consume capacity, which the scheduler's cursor check guards.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.ops import gang
from kubernetes_tpu_torch.ops import wave as ops_wave
from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster
from kubernetes_tpu_torch.snapshot.interner import ABSENT, PAD

I32 = torch.int32


def caps_compatible(dc_shapes, pb) -> bool:
    """Host-side check that the batch's term tables fit the cluster's row
    widths (else the append would truncate selector conjunctions)."""
    (Rc, Vc, NSc, Kc) = dc_shapes
    bt = pb.aff_table
    return (
        bt.req_key.shape[2] <= Rc
        and bt.req_vals.shape[3] <= Vc
        and pb.aff_ns_ids.shape[2] <= NSc
        and pb.label_vals.shape[1] == Kc
    )


def _pad_to(x, axis: int, target: int, fill):
    cur = x.shape[axis]
    if cur == target:
        return x
    shape = list(x.shape)
    shape[axis] = target - cur
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=axis)


def _put(full, rows, start: int) -> None:
    """full[start : start + len(rows)] = rows, in place."""
    full[start : start + rows.shape[0]].copy_(rows)


def chain_dispatch(
    dc: DeviceCluster,
    db: DeviceBatch,
    hostname_key: int,
    e_cursor: int,
    m_cursor: int,
    v_cap: int,
    hard_pod_affinity_weight: int = 1,
    has_interpod: bool = True,
    has_spread: bool = True,
    has_ports: bool = True,
    has_images: bool = True,
    enabled: frozenset = gang.ALL_FILTER_KERNELS,
    weights: tuple = gang.DEFAULT_WEIGHTS,
    sp_keys=None,
    sp_cdv_tab=None,
    ip_keys=None,
    d_cap: int = 8,
    append_terms: bool = True,
    wave: bool = False,
    tid_sp=None,
    rep_sp_p=None,
    rep_sp_c=None,
    tid_ip=None,
    rep_ip_p=None,
    rep_ip_u=None,
    ip_cdv_tab=None,
    d2_cap: int = 8,
    nom_node=None,
    nom_prio=None,
    nom_req=None,
    fit_strategy: tuple = gang.DEFAULT_FIT_STRATEGY,
):
    """Schedule the batch, then append its committed pods into ``dc`` at the
    given cursors (host ints the caller checked against the cluster's
    capacity).  ``append_terms=False`` skips the term-row splice for batches
    without affinity terms.

    ``wave=True`` schedules with the speculative wave (the tid_* / rep_* /
    ip_cdv_tab / d2_cap tables from wave.wave_tables) instead of the gang
    scan, with the same decisions, and returns a fourth output: the [3, P]
    wave stats.  The wave runs without its port-occupancy carry: the chained
    route refuses batches with host ports (the append does not splice port
    rows).  ``nom_*`` are the open nominations (ops/gang.py), charged on
    either branch, and ``fit_strategy`` the NodeResourcesFit strategy
    (ops/gang.py); the sampling window and the seeded tie-break never reach
    the chain (their cursor and attempt counter belong to the direct
    route).

    Returns (dc, stacked [2, P] i64 (chosen, n_feas), reason_counts
    [, wave_stats])."""
    P = db.valid.shape[0]
    E = dc.epod_node.shape[0]
    M = dc.term_pod.shape[0]
    AT = db.aff_kind.shape[1]
    if e_cursor + P > E or (AT and append_terms and m_cursor + P * AT > M):
        raise ValueError(f"chain_dispatch: cursors ({e_cursor}, {m_cursor}) + batch overflow ({E}, {M})")
    # the wave never reads the scan's pod×pod port matrix: in-batch ports
    # ride its occupancy carry
    g = gang.precompute(dc, db, hostname_key, v_cap, hard_pod_affinity_weight, has_interpod=has_interpod,
                        has_spread=has_spread, has_ports=has_ports and not wave, has_images=has_images,
                        enabled=enabled, sp_keys=sp_keys, sp_cdv_tab=sp_cdv_tab, ip_keys=ip_keys)
    check_fit = "NodeResourcesFit" in enabled
    nom = dict(nom_node=nom_node, nom_prio=nom_prio, nom_req=nom_req, fit_strategy=fit_strategy)
    wave_stats = None
    if wave:
        chosen, n_feas, reason_counts, tallies, wave_stats = ops_wave.wave_schedule(
            dc, db, g, hostname_key, v_cap, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u, ip_cdv_tab,
            weights=weights, check_fit=check_fit, d_cap=d_cap, d2_cap=d2_cap, has_ports=False, **nom,
        )
    else:
        chosen, n_feas, reason_counts, tallies = gang.gang_schedule(
            dc, db, g, v_cap, weights=weights, check_fit=check_fit, d_cap=d_cap, **nom
        )
    committed = (chosen >= 0) & db.valid
    dc.requested = tallies["requested"]
    dc.nonzero_req = tallies["nonzero"]
    dc.num_pods = tallies["num_pods"]
    _put(dc.epod_node, torch.where(committed, chosen, ABSENT), e_cursor)
    _put(dc.epod_ns, db.ns_id, e_cursor)
    _put(dc.epod_labels, db.labels, e_cursor)
    _put(dc.epod_valid, committed, e_cursor)
    _put(dc.epod_deleting, torch.zeros((P,), dtype=torch.bool, device=chosen.device), e_cursor)
    if AT and append_terms:
        real = db.aff_kind != PAD  # [P, AT]
        pod_idx = e_cursor + torch.arange(P, dtype=I32, device=chosen.device)[:, None]
        _put(dc.term_pod, torch.where(real, pod_idx, ABSENT).reshape(P * AT), m_cursor)
        _put(dc.term_kind, db.aff_kind.reshape(P * AT), m_cursor)
        _put(dc.term_topo, db.aff_topo.reshape(P * AT), m_cursor)
        _put(dc.term_weight, db.aff_weight.reshape(P * AT), m_cursor)
        _put(dc.term_ns_all, db.aff_ns_all.reshape(P * AT), m_cursor)
        NSc = dc.term_ns_ids.shape[1]
        _put(dc.term_ns_ids, _pad_to(db.aff_ns_ids.reshape(P * AT, -1), 1, NSc, PAD), m_cursor)
        tt, bt = dc.term_table, db.aff_table
        Rc = tt.req_key.shape[2]
        Vc = tt.req_vals.shape[3]
        _put(tt.req_key, _pad_to(bt.req_key.reshape(P * AT, 1, -1), 2, Rc, PAD), m_cursor)
        _put(tt.req_op, _pad_to(bt.req_op.reshape(P * AT, 1, -1), 2, Rc, PAD), m_cursor)
        _put(tt.req_rhs, _pad_to(bt.req_rhs.reshape(P * AT, 1, -1), 2, Rc, 0), m_cursor)
        rv = bt.req_vals.reshape(P * AT, 1, bt.req_vals.shape[2], bt.req_vals.shape[3])
        _put(tt.req_vals, _pad_to(_pad_to(rv, 3, Vc, PAD), 2, Rc, PAD), m_cursor)
        _put(tt.term_valid, bt.term_valid.reshape(P * AT, 1), m_cursor)
    results = torch.stack([chosen.to(torch.int64), n_feas])
    if wave:
        return dc, results, reason_counts, wave_stats
    return dc, results, reason_counts
