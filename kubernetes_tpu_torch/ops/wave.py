"""The speculative wave: cross-pod-constraint batches in two passes.

Port of the JAX package's ops/wave.py (its jit roots ``wave_run`` and
``wave_schedule``).  A batch whose pods carry spread terms, inter-pod terms
or host ports is scheduled by

  1. **speculation**: every pod's verdict against the FROZEN snapshot (no
     batch peer committed), the shared per-pod step (gang.pod_step with
     ``commit=False``) over the whole batch, giving each pod the node it
     would take if it were first in line;
  2. **admission**: the serial recurrence in queue order, each pod's verdict
     under the usage and topology counts of the peers committed before it.
     Its carried state is not the peer list but term-factored counts: the
     host partitioner (``wave_tables``) dedups the batch's constraint terms
     into T distinct terms, and the pass carries per-term per-node counts
     ([Tsp, N] spread, [Tip, N] inter-pod and its reverse direction, and a
     [Tpt, N] host-port occupancy), updated by one node column per matching
     term at each commit.

Admission replays ``choice_i = F_i(S + sum_{j<i} delta(choice_j))``, so its
placements equal the gang scan's, pod for pod.  A pod whose admitted node
differs from its speculative one is demoted; the pass attributes the
demotion (ports, spread, affinity, fit, score; or an upgrade when
speculation found no node) and the first violating term slot, against the
state the pod's own step saw.  ``stats`` [3, P] carries (speculative node,
kind, term).

Each function has a plain PyTorch version (the reference's formulas) which
the wrapper takes for CPU tensors; for CUDA tensors it launches the
hand-written kernels (csrc/wave.cu) or raises:

  K8 wave_speculate   the speculation pass, one block per pod
  K9 wave_admit       the admission pass, one thread-block cluster of 8 or
                      16 CTAs, each over a slice of the nodes

The factored algebra below (``term_match_rows``, ``factored_*``) is kept one
to one with the reference's functions of the same names.  Both passes take
every branch of the shared step (ops/gang.py): the nominated-pod charge
(``nom_node`` / ``nom_prio`` / ``nom_req``), the fit strategy, the sampling
window and the seeded tie-break (``fit_strategy``, ``sample_k`` /
``sample_start``, ``tie_key`` / ``attempt_base``).  In sampling mode every
pod speculates from the INITIAL rotation cursor; the admission pass alone
carries the advancing cursor and returns it in ``tallies["sample_start"]``.
Host-plugin masks and scores are not ported (ROADMAP A6b).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import gang
from kubernetes_tpu_torch.ops.gang import N_DIAG, InterpodDyn, SpreadDyn
from kubernetes_tpu_torch.snapshot.interner import ABSENT, PAD
from kubernetes_tpu_torch.snapshot.schema import N_FIXED_LANES, bucket_cap

I32 = torch.int32
I64 = torch.int64
BOOL = torch.bool

# demote-kind codes of the stats' second row (the host maps them to labels)
DEMOTE_NONE = 0
DEMOTE_SPREAD = 1
DEMOTE_AFFINITY = 2
DEMOTE_SCORE = 3
DEMOTE_FIT = 4
# not a demotion: infeasible in speculation, placed by the admission pass (a
# batch peer's commit satisfied a required affinity); never a conflict
DEMOTE_UPGRADE = 5
DEMOTE_PORTS = 6
DEMOTE_KINDS = {
    DEMOTE_SPREAD: "spread",
    DEMOTE_AFFINITY: "affinity",
    DEMOTE_SCORE: "score",
    DEMOTE_FIT: "fit",
    DEMOTE_PORTS: "ports",
}

# The most dynamic shared memory a CTA of K9's and K11's cluster may put its
# exchange slab, rows, staged planes and carries in (the card's own limit
# applies below it); above it they go to global scratch rows.
ADMIT_SMEM_CAP = 1 << 30
# The most CTAs in K9's and K11's cluster: 16 where the card admits a
# cluster of 16 at the kernel's shared memory, else 8 (the portable size);
# 8 here forces 8.
ADMIT_CLUSTER_CAP = 16
# K9 and K11 stage each pod's [P, N] and slot rows of its slice into shared
# memory, one pod ahead (bulk copies), and its node statics once; False
# reads them from global memory.
ADMIT_STAGE = True
ADMIT_PHASES = gang.CL_PHASES
# K9's last launch: {"cluster": its CTAs, "staged": whether it staged the
# planes, "info": int32 [2 + ADMIT_PHASES] on the card (the CTAs, the
# cluster-wide exchanges over the batch, then the rank-0 leader's cycles / 16
# per phase)}; read "info" after a synchronize.
admit_stats: Dict[str, object] = {}
# K8's phase clocks: per reduction (the min-match, the filter's counts, the
# window, the spread normalizers, the argmax) the pass before it and the
# reduction itself.
SPEC_PHASES = 10
# K8's last launch: {"info": int64 [P, 2 + SPEC_PHASES] on the card (each
# pod's group's start and end, globaltimer ns, then its thread 0's cycles
# per phase; a pad row stays 0)}; read "info" after a synchronize.
spec_stats: Dict[str, object] = {}


# ---------------------------------------------------------------------------
# Host half: the interaction partitioner
# ---------------------------------------------------------------------------


def _dedup_slots(mat, live):
    """Row-dedup of a [S, W] content matrix over the live slots.  Returns
    (tid [S] i64, -1 for dead slots; rep [T], the flat index of one live
    slot per distinct row).  Term ids follow np.unique's sorted row order."""
    tid = np.full(mat.shape[0], -1, np.int64)
    if not live.any():
        return tid, np.zeros((0,), np.int64)
    rows = np.ascontiguousarray(mat[live])
    _, first, inv = np.unique(rows, axis=0, return_index=True, return_inverse=True)
    live_idx = np.nonzero(live)[0]
    tid[live_idx] = inv.reshape(-1)
    return tid, live_idx[first]


def _slot_content(n_slots, parts):
    """Stack per-slot content columns into one [n_slots, W] i64 matrix."""
    cols = [np.asarray(p, np.int64).reshape(n_slots, -1) for p in parts]
    return np.concatenate(cols, axis=1)


def _reps(tid_flat, rep_flat, width: int, P: int):
    """(tid [P, width] i32, rep_p [T], rep_s [T], n distinct) with T the
    bucket of the distinct-term count."""
    tid = tid_flat.reshape(P, width).astype(np.int32)
    t_cap = bucket_cap(max(len(rep_flat), 1), 1)
    rep_p = np.full(t_cap, -1, np.int32)
    rep_s = np.zeros(t_cap, np.int32)
    rep_p[: len(rep_flat)] = rep_flat // width if width else 0
    rep_s[: len(rep_flat)] = rep_flat % width if width else 0
    return tid, rep_p, rep_s, len(rep_flat)


def wave_tables(pb, node_label_vals, hostname_id: int, hostnames_unique=None, device="cpu"):
    """Dedup the batch's constraint terms into distinct-term tables.

    Two pods share a spread term when (topology key, namespace, packed
    selector) coincide; inter-pod terms also key on (kind, weight, namespace
    scope), so a term's symmetric weight and polarity are term constants;
    host ports dedup on (proto-port key, hostIP, wildcard) with a static
    pairwise conflict matrix.

    None when the batch cannot take the wave: duplicate hostname label
    values among the nodes (the factored hostname counts assume one node
    per hostname).  ``hostnames_unique`` is the mirror's memoized bit; None
    derives it here.  Otherwise a dict (tensors on ``device``):

      tid_sp  i32 [P, C]   distinct spread-term id per slot (-1 empty)
      rep_sp_p/rep_sp_c  i32 [Tsp]  a representative slot per term
      tid_ip  i32 [P, AT]  distinct inter-pod-term id per slot
      rep_ip_p/rep_ip_u  i32 [Tip]
      ip_cdv_tab i32 [Kd2, N]  compact domain ids per inter-pod key (a -1
                 row for the hostname key: its domains are nodes)
      d2_cap  int   bucket over the inter-pod keys' domain counts
      tid_pt  i32 [P, W]   distinct port-term id per want slot (-1 empty)
      port_conf bool [Tpt, Tpt]  term-pair conflict matrix
      has_ports bool  the batch wants host ports
      n_terms int   distinct terms (spread + inter-pod + port)
    """
    lv = np.asarray(node_label_vals)
    n_cap, K = lv.shape
    if hostnames_unique is None and 0 <= hostname_id < K:
        col = lv[:, hostname_id]
        vals = col[col >= 0]
        hostnames_unique = len(vals) == len(np.unique(vals))
    if hostnames_unique is False:
        return None

    tsc_topo = np.asarray(pb.tsc_topo_key)
    P, C = tsc_topo.shape
    aff_kind = np.asarray(pb.aff_kind)
    AT = aff_kind.shape[1]
    ns_id = np.asarray(pb.ns_id)
    valid = np.asarray(pb.valid)

    tid_flat = rep_flat = np.zeros((0,), np.int64)
    if C:
        t = pb.tsc_table
        content = _slot_content(P * C, [tsc_topo, np.broadcast_to(ns_id[:, None], (P, C)), t.req_key, t.req_op,
                                        t.req_vals, t.req_rhs, t.term_valid])
        tid_flat, rep_flat = _dedup_slots(content, (tsc_topo != PAD).reshape(-1) & np.repeat(valid, C))
    tid_sp, rep_sp_p, rep_sp_c, n_sp = _reps(tid_flat, rep_flat, C, P)

    tid_flat = rep_flat = np.zeros((0,), np.int64)
    if AT:
        t = pb.aff_table
        content = _slot_content(P * AT, [aff_kind, pb.aff_topo_key, pb.aff_weight, pb.aff_ns_all, pb.aff_ns_ids,
                                         t.req_key, t.req_op, t.req_vals, t.req_rhs, t.term_valid])
        tid_flat, rep_flat = _dedup_slots(content, (aff_kind != PAD).reshape(-1) & np.repeat(valid, AT))
    tid_ip, rep_ip_p, rep_ip_u, n_ip = _reps(tid_flat, rep_flat, AT, P)

    want_ppk = np.asarray(pb.want_ppk)
    W = want_ppk.shape[1]
    n_pt = 0
    if W and (want_ppk != PAD).any():
        content = _slot_content(P * W, [want_ppk, pb.want_ip, pb.want_wild])
        tid_flat, rep_flat = _dedup_slots(content, (want_ppk != PAD).reshape(-1) & np.repeat(valid, W))
        tid_pt = tid_flat.reshape(P, W).astype(np.int32)
        n_pt = len(rep_flat)
        t_pt = bucket_cap(max(n_pt, 1), 1)
        r_ppk = want_ppk.reshape(-1)[rep_flat]
        r_ip = np.asarray(pb.want_ip).reshape(-1)[rep_flat]
        r_wild = np.asarray(pb.want_wild).reshape(-1)[rep_flat]
        port_conf = np.zeros((t_pt, t_pt), bool)
        port_conf[:n_pt, :n_pt] = (r_ppk[:, None] == r_ppk[None, :]) & (
            (r_ip[:, None] == r_ip[None, :]) | r_wild[:, None] | r_wild[None, :]
        )
    else:
        tid_pt = np.full((P, W), -1, np.int32)
        port_conf = np.zeros((1, 1), bool)

    # compact per-key domain ids of the inter-pod keys, in batch_tables'
    # key order (so ip_key_idx rows index both tables)
    ip_keys = [int(k) for k in np.unique(np.asarray(pb.aff_topo_key).reshape(-1)) if 0 <= int(k) < K]
    ip_cdv_tab = np.full((bucket_cap(max(len(ip_keys), 1), 1), n_cap), -1, np.int32)
    d2_max = 1
    for i, k in enumerate(ip_keys):
        if k == hostname_id:
            continue
        col = lv[:, k]
        pos = col >= 0
        if pos.any():
            uniq, inv = np.unique(col[pos], return_inverse=True)
            ip_cdv_tab[i, pos] = inv.astype(np.int32)
            d2_max = max(d2_max, len(uniq))

    def dev(x):
        return torch.as_tensor(x, device=device)

    return dict(
        tid_sp=dev(tid_sp), rep_sp_p=dev(rep_sp_p), rep_sp_c=dev(rep_sp_c),
        tid_ip=dev(tid_ip), rep_ip_p=dev(rep_ip_p), rep_ip_u=dev(rep_ip_u),
        ip_cdv_tab=dev(ip_cdv_tab), d2_cap=bucket_cap(d2_max, 8),
        tid_pt=dev(tid_pt), port_conf=dev(port_conf),
        has_ports=n_pt > 0, n_terms=n_sp + n_ip + n_pt,
    )


def interaction_groups(pods) -> Tuple[List[int], int]:
    """Partition a batch into components of interacting pods by their
    term and probe footprints.  Two pods share a group when they share a
    constraint term (spec content) or one pod's term selector admits the
    other (anti-affinity constrains pods that carry no terms).  Conservative:
    probes may claim interaction where there is none, never the reverse.
    Returns (group id per pod, number of groups)."""
    from kubernetes_tpu_torch.fastpath import _pod_probes

    n = len(pods)
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    def sel_key(sel):
        if sel is None:
            return None
        return (tuple(sorted((sel.match_labels or {}).items())), tuple(sel.match_expressions or ()))

    # probes deduped by content: template-stamped pods share one probe
    probe_owner: Dict[object, int] = {}
    probes = []  # (owner pod index, probe)
    for i, pod in enumerate(pods):
        for pr in _pod_probes(pod):
            try:
                key = (pr.ns_any, pr.namespaces, sel_key(pr.sel))
                hash(key)
            except TypeError:
                key = None
            if key is None:
                probes.append((i, pr))
                continue
            owner = probe_owner.get(key)
            if owner is None:
                probe_owner[key] = i
                probes.append((i, pr))
            else:
                union(i, owner)  # same term content: same group
    # past ~100k (probe, pod) pairs: one conservative all-interacting group
    if len(probes) * n > 100_000:
        return [0] * n, 1
    hit_cache: Dict[object, list] = {}
    for i, pod in enumerate(pods):
        try:
            lg = (pod.namespace, tuple(sorted(pod.labels.items())))
        except TypeError:
            lg = None
        hits = hit_cache.get(lg) if lg is not None else None
        if hits is None:
            hits = [j for j, (_, pr) in enumerate(probes) if pr.admits(pod)]
            if lg is not None:
                hit_cache[lg] = hits
        for j in hits:
            union(i, probes[j][0])
    roots: Dict[int, int] = {}
    gids = []
    for i in range(n):
        gids.append(roots.setdefault(find(i), len(roots)))
    return gids, len(roots)


# ---------------------------------------------------------------------------
# The term-factored algebra (plain torch, one to one with the reference)
# ---------------------------------------------------------------------------


def _rep_rows(mat, rp, rc):
    """mat[rp, rc] with -1 representatives masked to zeros / False."""
    rows = mat[rp.clamp(0, mat.shape[0] - 1).long(), rc.clamp(0, mat.shape[1] - 1).long()]
    live = (rp >= 0).reshape(rp.shape + (1,) * (rows.dim() - 1))
    if rows.dtype == BOOL:
        return rows & live
    return rows * live.to(rows.dtype)


def term_match_rows(g, rep_sp_p, rep_sp_c, rep_ip_p, rep_ip_u):
    """Which batch pods each distinct term matches (ip_bmatch[p, u, j]
    reads "pod j matches p's term u", so one gather serves both
    directions).  Returns (m_sp_all [Tsp, P], m_ip_all [Tip, P], t_anti
    [Tip], t_w [Tip] i64)."""
    P = g.static_mask.shape[0]
    dev = g.static_mask.device
    Tsp, Tip = rep_sp_p.shape[0], rep_ip_p.shape[0]
    if g.sp_dv.shape[1]:
        m_sp_all = _rep_rows(g.sp_bmatch, rep_sp_p, rep_sp_c)
    else:
        m_sp_all = torch.zeros((Tsp, P), dtype=BOOL, device=dev)
    if g.ip_dv.shape[1]:
        m_ip_all = _rep_rows(g.ip_bmatch, rep_ip_p, rep_ip_u)
        t_anti = _rep_rows(g.ip_is_anti, rep_ip_p, rep_ip_u)
        t_w = _rep_rows(g.ip_sym_w, rep_ip_p, rep_ip_u)
    else:
        m_ip_all = torch.zeros((Tip, P), dtype=BOOL, device=dev)
        t_anti = torch.zeros((Tip,), dtype=BOOL, device=dev)
        t_w = torch.zeros((Tip,), dtype=I64, device=dev)
    return m_sp_all, m_ip_all, t_anti, t_w


FACTORED_CARRY_KEYS = ("cnt_sp", "cnt_ip", "rev_cnt", "occ_pt")


def factored_carry_init(Tsp, Tip, N, Tpt=0, device="cpu"):
    """Zero carries for one admission pass: exactly the keys
    factored_carry_update advances."""
    out = dict(
        cnt_sp=torch.zeros((Tsp, N), dtype=I32, device=device),
        cnt_ip=torch.zeros((Tip, N), dtype=I32, device=device),
        rev_cnt=torch.zeros((Tip, N), dtype=I32, device=device),
    )
    if Tpt:
        out["occ_pt"] = torch.zeros((Tpt, N), dtype=I32, device=device)
    return out


def _term_rows(tid, carry):
    """carry[tid] per slot, zero rows for empty slots (the one-hot
    contraction "st,tn->sn" of the reference, as a gather)."""
    rows = carry[tid.clamp(min=0).long()]
    return torch.where((tid >= 0)[:, None], rows, 0)


def _dom_sums(vals, cdv, D: int):
    """[S, D] per-domain sums of vals [S, N] under the compact ids cdv
    [S, N] (ids outside [0, D) drop out): the "sn,snd->sd" contraction."""
    S = vals.shape[0]
    ok = (cdv >= 0) & (cdv < D)
    idx = torch.where(ok, cdv, D).long()
    out = torch.zeros((S, D + 1), dtype=vals.dtype, device=vals.device)
    out.scatter_add_(1, idx, torch.where(ok, vals, 0))
    return out[:, :D]


def _dom_read(sums, cdv):
    """sums[s, cdv[s, n]] where 0 <= cdv < D, else 0: the "sd,snd->sn"
    contraction."""
    D = sums.shape[1]
    ok = (cdv >= 0) & (cdv < D)
    return torch.where(ok, torch.gather(sums, 1, cdv.clamp(0, max(D - 1, 0)).long()), 0)


def factored_port_mask(tid_pt, port_conf, occ_pt, p):
    """NodePorts verdict for pod p from the port-occupancy carry occ_pt
    [Tpt, N].  Returns (m_portb [N], pt_cnt [Tpt] i32: p's own per-term
    slot counts, which factored_carry_update commits)."""
    Tpt = occ_pt.shape[0]
    tidw = tid_pt[p]  # [W]
    ohw = (tidw[:, None] == torch.arange(Tpt, dtype=I32, device=tidw.device)[None, :]) & (tidw >= 0)[:, None]
    mine = ohw.any(dim=0)
    conf_p = (mine[:, None] & port_conf).any(dim=0)
    blocked = (conf_p[:, None] & (occ_pt > 0)).any(dim=0)
    return ~blocked, ohw.to(I32).sum(dim=0).to(I32)


def factored_spread_dyn(g, p, tid_sp, cnt_sp, d_cap: int):
    """SpreadDyn for pod p from the spread carry cnt_sp [Tsp, N]."""
    cnt_rows = _term_rows(tid_sp[p], cnt_sp)  # [C, N]
    te = g.sp_te[p].to(I32)
    cting = g.sp_counting[p].to(I32)
    cdv = g.sp_cdv[p]
    dyn_f_dom = _dom_read(_dom_sums(cnt_rows * te, cdv, d_cap), cdv)
    dyn_dom = _dom_read(_dom_sums(cnt_rows * cting, cdv, d_cap), cdv)
    present = (g.sp_dv[p] >= 0).to(I32)
    dyn_f = torch.where(g.sp_is_host[p][:, None], cnt_rows * te * present, dyn_f_dom)
    return SpreadDyn(dyn_f, cnt_rows, dyn_dom)


def factored_interpod_dyn(g, db, p, tid_ip, ip_cdv_tab, d2_cap: int, hostname_key, cnt_ip, rev_cnt, m_ip_all,
                          t_anti, t_w):
    """InterpodDyn for pod p from the inter-pod carries, plus the aux tuple
    factored_carry_update needs to spread p's own terms over their domains
    (tidu, cdv2, dvip, is_host_u, ki)."""
    Kd2 = ip_cdv_tab.shape[0]
    tidu = tid_ip[p]  # [AT]
    fcnt = _term_rows(tidu, cnt_ip)  # [AT, N]
    ki = g.ip_key_idx[p]
    cdv2 = torch.where((ki >= 0)[:, None], ip_cdv_tab[ki.clamp(0, Kd2 - 1).long()], -1)
    ip_dyn_dom = _dom_read(_dom_sums(fcnt, cdv2, d2_cap), cdv2)
    dvip = g.ip_dv[p]
    is_host_u = db.aff_topo[p] == hostname_key
    ip_dyn = torch.where(is_host_u[:, None], fcnt * (dvip >= 0).to(I32), ip_dyn_dom)
    any_dyn = (g.ip_is_aff[p] & (fcnt.sum(dim=1) > 0)).any()
    m_rev = m_ip_all[:, p]  # [Tip]
    viol_b = ((m_rev & t_anti)[:, None] & (rev_cnt > 0)).any(dim=0)
    sym_b = torch.where(m_rev[:, None], t_w[:, None] * rev_cnt.to(I64), 0).sum(dim=0)
    return InterpodDyn(ip_dyn, viol_b, sym_b, any_dyn), (tidu, cdv2, dvip, is_host_u, ki)


def factored_carry_update(carries, p, choice, m_sp_all, m_ip_all, ip_aux, pt_cnt=None):
    """Commit pod p's placement into the factored carries (new tensors; the
    inputs are left as they are): one node column per matching term, and
    p's own inter-pod terms spread over their topology domains (the reverse
    direction later pods read).  ``ip_aux`` is factored_interpod_dyn's aux
    (None without inter-pod terms), ``pt_cnt`` factored_port_mask's counts
    (None without host ports)."""
    cnt_sp, cnt_ip, rev_cnt = carries["cnt_sp"], carries["cnt_ip"], carries["rev_cnt"]
    N = cnt_sp.shape[1]
    committed = choice >= 0
    onehot_n = ((torch.arange(N, dtype=I32, device=cnt_sp.device) == choice) & committed).to(I32)
    out = dict(
        cnt_sp=cnt_sp + m_sp_all[:, p, None].to(I32) * onehot_n[None, :],
        cnt_ip=cnt_ip + m_ip_all[:, p, None].to(I32) * onehot_n[None, :],
        rev_cnt=rev_cnt,
    )
    if pt_cnt is not None:
        out["occ_pt"] = carries["occ_pt"] + pt_cnt[:, None] * onehot_n[None, :]
    if ip_aux is None:
        return out
    tidu, cdv2, dvip, is_host_u, ki = ip_aux
    at = onehot_n[None, :] > 0
    val2_at = torch.where(at, cdv2, 0).sum(dim=1)  # [AT] compact id at the chosen node
    dval_at = torch.where(at, dvip, 0).sum(dim=1)  # [AT] label value there
    dom_row = torch.where(
        is_host_u[:, None],
        at & (dval_at >= 0)[:, None],
        (cdv2 == val2_at[:, None]) & (cdv2 >= 0) & (val2_at >= 0)[:, None],
    )
    dom_row = dom_row & committed & (ki >= 0)[:, None]
    live = tidu >= 0
    rev = rev_cnt.clone()
    rev.index_add_(0, tidu[live].long(), dom_row[live].to(I32))
    out["rev_cnt"] = rev
    return out


# ---------------------------------------------------------------------------
# wave_schedule: plain versions
# ---------------------------------------------------------------------------


def _zero_sdyn(C, N, dev):
    z = torch.zeros((C, N), dtype=I32, device=dev)
    return SpreadDyn(z, z, z)


def _zero_idyn(AT, N, dev):
    return InterpodDyn(torch.zeros((AT, N), dtype=I32, device=dev), torch.zeros((N,), dtype=BOOL, device=dev),
                       torch.zeros((N,), dtype=I64, device=dev), torch.zeros((), dtype=BOOL, device=dev))


def _build_hv(db, g, p, sdyn, idyn, m_portb):
    """pod_step's hv dict and the attribution tensors (c_ok, anti_viol)."""
    N = g.static_mask.shape[1]
    C, AT = g.sp_dv.shape[1], g.ip_dv.shape[1]
    dev = g.static_mask.device
    true_n = torch.ones((N,), dtype=BOOL, device=dev)
    if C:
        m_spread, sp_cnt, c_ok = gang.spread_constraints(db, g, p, sdyn)
    else:
        m_spread, sp_cnt = true_n, torch.zeros((C, N), dtype=I32, device=dev)
        c_ok = torch.ones((C, N), dtype=BOOL, device=dev)
    if AT:
        m_interpod, ip_raw, anti_viol = gang.interpod_constraints(g, p, idyn)
    else:
        m_interpod, ip_raw = true_n, g.ip_sym[p]
        anti_viol = torch.zeros((AT, N), dtype=BOOL, device=dev)
    hv = dict(m_portb=m_portb, m_spread=m_spread, sp_cnt=sp_cnt, m_interpod=m_interpod, ip_raw=ip_raw)
    return hv, c_ok, anti_viol


def _mode_kw(sample_start=None, **mode) -> dict:
    """pod_step's keywords of a step_mode dict (the cursor rides the state)."""
    return mode


def wave_speculate_plain(dc, db, g, weights=gang.DEFAULT_WEIGHTS, check_fit=True, d_cap=8, n_feas=None,
                         nom_node=None, nom_prio=None, nom_req=None, lane=None, extra_score=None, **mode):
    """Plain version of K8: every pod's step against the frozen snapshot,
    with zero batch-peer counts and every port free, or, with ``lane`` (bool
    [P, N]), the port lane read from it (the workloads dispatch puts its DRA
    verdict there).  ``extra_score`` (i64 [P, N], or None) adds to every
    node's total; ``mode`` (gang.step_mode) selects the step's branches,
    every pod from the initial cursor.  Returns c0 i32 [P]; fills
    ``n_feas`` [P], when given, with each pod's feasible-node count."""
    P, N = g.static_mask.shape
    nom = gang.nominations_onehot(nom_node, nom_prio, nom_req, N)
    C, AT = g.sp_dv.shape[1], g.ip_dv.shape[1]
    dev = g.static_mask.device
    mode = gang.step_mode(**mode)
    base = gang._state0(dc, mode["sample_start"])
    true_n = torch.ones((N,), dtype=BOOL, device=dev)
    c0 = torch.full((P,), ABSENT, dtype=I32, device=dev)
    for p in range(P):
        hv, _, _ = _build_hv(db, g, p, _zero_sdyn(C, N, dev), _zero_idyn(AT, N, dev),
                             true_n if lane is None else lane[p])
        c0[p], nf, _ = gang.pod_step(dc, db, g, p, base, hv, check_fit=check_fit, weights=weights, d_cap=d_cap,
                                     commit=False, nom=nom, extra_score=extra_score, **_mode_kw(**mode))
        if n_feas is not None:
            n_feas[p] = nf
    return c0


def wave_admit_plain(dc, db, g, hostname_key, c0, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u,
                     ip_cdv_tab, weights=gang.DEFAULT_WEIGHTS, check_fit=True, d_cap=8, d2_cap=8,
                     has_ports=False, tid_pt=None, port_conf=None, nom_node=None, nom_prio=None, nom_req=None,
                     **mode):
    """Plain version of K9: the admission recurrence over the factored
    carries, with each pod's demotion attribution against the state its own
    step saw (the usage alone: a fit lost to a nomination reports as a
    score demotion, as in the reference).  ``mode`` (gang.step_mode)
    selects the step's branches; the cursor rides the state.  Returns
    (chosen i32 [P], n_feas i64 [P], reason_counts i64 [P, N_DIAG],
    tallies, kinds i32 [P], cterms i32 [P])."""
    P, N = g.static_mask.shape
    nom = gang.nominations_onehot(nom_node, nom_prio, nom_req, N)
    mode = gang.step_mode(**mode)
    C, AT = g.sp_dv.shape[1], g.ip_dv.shape[1]
    dev = g.static_mask.device
    Tpt = port_conf.shape[0] if has_ports else 0
    true_n = torch.ones((N,), dtype=BOOL, device=dev)
    m_sp_all, m_ip_all, t_anti, t_w = term_match_rows(g, rep_sp_p, rep_sp_c, rep_ip_p, rep_ip_u)
    state = gang._state0(dc, mode["sample_start"])
    carries = factored_carry_init(rep_sp_p.shape[0], rep_ip_p.shape[0], N, Tpt, dev)
    chosen = torch.full((P,), ABSENT, dtype=I32, device=dev)
    n_feas = torch.zeros((P,), dtype=I64, device=dev)
    reason_counts = torch.zeros((P, N_DIAG), dtype=I64, device=dev)
    kinds = torch.zeros((P,), dtype=I32, device=dev)
    cterms = torch.full((P,), -1, dtype=I32, device=dev)
    Rn, Rp = dc.requested.shape[1], db.requests.shape[1]
    scalar_lane = torch.arange(Rp, device=dev) >= N_FIXED_LANES
    none = torch.tensor(-1, dtype=I32, device=dev)
    for p in range(P):
        sdyn = factored_spread_dyn(g, p, tid_sp, carries["cnt_sp"], d_cap) if C else _zero_sdyn(C, N, dev)
        idyn, ip_aux = _zero_idyn(AT, N, dev), None
        if AT:
            idyn, ip_aux = factored_interpod_dyn(g, db, p, tid_ip, ip_cdv_tab, d2_cap, hostname_key,
                                                 carries["cnt_ip"], carries["rev_cnt"], m_ip_all, t_anti, t_w)
        m_portb, pt_cnt = true_n, None
        if has_ports:
            m_portb, pt_cnt = factored_port_mask(tid_pt, port_conf, carries["occ_pt"], p)
        hv, c_ok, anti_viol = _build_hv(db, g, p, sdyn, idyn, m_portb)

        # attribution against the speculative node, read from the state this
        # pod's step sees (pod_step commits in place below)
        spec = c0[p]
        spec_live = spec >= 0
        at = spec.clamp(0, N - 1).long()
        pt_bad = spec_live & ~m_portb[at]
        sp_bad = spec_live & ~hv["m_spread"][at]
        ip_bad = spec_live & ~hv["m_interpod"][at]
        fit_bad = torch.zeros((), dtype=BOOL, device=dev)
        if check_fit:
            req = db.requests[p]
            avail = dc.allocatable[at] - state["requested"][at]  # [Rn]
            if Rp > Rn:
                avail = torch.cat([avail, torch.zeros((Rp - Rn,), dtype=I32, device=dev)])
            conflict = (req > avail[:Rp]) & (~scalar_lane | (req > 0))
            lane_bad = conflict.any() & ~(req == 0).all()
            pods_bad = state["num_pods"][at] + 1 > dc.allowed_pods[at]
            fit_bad = spec_live & (lane_bad | pods_bad)

        choice, nf, rc = gang.pod_step(dc, db, g, p, state, hv, check_fit=check_fit, weights=weights, d_cap=d_cap,
                                       nom=nom, **_mode_kw(**mode))
        carries = factored_carry_update(carries, p, choice, m_sp_all, m_ip_all, ip_aux, pt_cnt=pt_cnt)

        kind = torch.where(
            choice == spec, DEMOTE_NONE,
            torch.where(~spec_live, DEMOTE_UPGRADE,
                        torch.where(pt_bad, DEMOTE_PORTS,
                                    torch.where(sp_bad, DEMOTE_SPREAD,
                                                torch.where(ip_bad, DEMOTE_AFFINITY,
                                                            torch.where(fit_bad, DEMOTE_FIT, DEMOTE_SCORE))))),
        ).to(I32)
        sp_term = ip_term = none
        if C:
            sp_viol = g.sp_hard[p] & ~c_ok[:, at]
            sp_term = torch.where(sp_viol.any(), sp_viol.to(I32).argmax().to(I32), none)
        if AT:
            ip_viol = anti_viol[:, at]
            ip_term = torch.where(ip_viol.any(), ip_viol.to(I32).argmax().to(I32), none)
        cterms[p] = torch.where(kind == DEMOTE_SPREAD, sp_term, torch.where(kind == DEMOTE_AFFINITY, ip_term, none))
        kinds[p] = kind
        chosen[p] = choice
        n_feas[p] = nf
        reason_counts[p] = rc
    return chosen, n_feas, reason_counts, state, kinds, cterms


def wave_schedule_plain(dc, db, g, hostname_key, v_cap, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u,
                        ip_cdv_tab, weights=gang.DEFAULT_WEIGHTS, check_fit=True, d_cap=8, d2_cap=8,
                        has_ports=False, tid_pt=None, port_conf=None, nom_node=None, nom_prio=None, nom_req=None,
                        **mode):
    """Plain version of wave_schedule: K8's then K9's plain loop."""
    nom = dict(nom_node=nom_node, nom_prio=nom_prio, nom_req=nom_req)
    c0 = wave_speculate_plain(dc, db, g, weights, check_fit, d_cap, **nom, **mode)
    chosen, n_feas, rc, tallies, kinds, cterms = wave_admit_plain(
        dc, db, g, hostname_key, c0, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u, ip_cdv_tab,
        weights, check_fit, d_cap, d2_cap, has_ports, tid_pt, port_conf, **nom, **mode)
    return chosen, n_feas, rc, tallies, torch.stack([c0, kinds, cterms])


# ---------------------------------------------------------------------------
# wave_schedule / wave_run
# ---------------------------------------------------------------------------


def wave_speculate(dc, db, g, weights=gang.DEFAULT_WEIGHTS, check_fit=True, d_cap=8, nom_node=None,
                   nom_prio=None, nom_req=None, lane=None, extra_score=None, **mode):
    """The speculation pass: K8 on CUDA tensors, its plain version on CPU.
    ``lane`` (bool [P, N], None: all True) is read as the port lane;
    ``extra_score`` (i64 [P, N], None: nothing) adds to every total;
    ``mode`` is gang.step_mode's keywords."""
    nom = dict(nom_node=nom_node, nom_prio=nom_prio, nom_req=nom_req, lane=lane, extra_score=extra_score, **mode)
    if dc.node_valid.device.type == "cpu":
        return wave_speculate_plain(dc, db, g, weights, check_fit, d_cap, **nom)
    return _wave_speculate_cuda(dc, db, g, weights, check_fit, **nom)


def wave_admit(dc, db, g, hostname_key, c0, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u, ip_cdv_tab,
               weights=gang.DEFAULT_WEIGHTS, check_fit=True, d_cap=8, d2_cap=8, has_ports=False, tid_pt=None,
               port_conf=None, nom_node=None, nom_prio=None, nom_req=None, **mode):
    """The admission pass: K9 on CUDA tensors, its plain version on CPU."""
    args = (dc, db, g, hostname_key, c0, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u, ip_cdv_tab,
            weights, check_fit, d_cap, d2_cap, has_ports, tid_pt, port_conf)
    nom = dict(nom_node=nom_node, nom_prio=nom_prio, nom_req=nom_req, **mode)
    if dc.node_valid.device.type == "cpu":
        return wave_admit_plain(*args, **nom)
    return _wave_admit_cuda(*args, **nom)


def wave_schedule(dc, db, g, hostname_key, v_cap, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u,
                  ip_cdv_tab, weights=gang.DEFAULT_WEIGHTS, check_fit=True, d_cap=8, d2_cap=8, has_ports=False,
                  tid_pt=None, port_conf=None, nom_node=None, nom_prio=None, nom_req=None,
                  fit_strategy: tuple = gang.DEFAULT_FIT_STRATEGY, sample_k=None, sample_start=None, tie_key=None,
                  attempt_base=None):
    """One wave dispatch: speculation, then the factored admission pass.
    ``has_ports`` engages the [Tpt, N] port-occupancy carry (tid_pt and
    port_conf from wave_tables).  The cluster's usage rows are read, not
    written.

    Returns (chosen i32 [P], n_feas i64 [P], reason_counts i64 [P, N_DIAG],
    tallies, stats i32 [3, P]): stats rows are (speculative node, demote
    kind, conflicting term slot); ``chosen == stats[0]`` marks the pods
    admitted as speculated.  ``nom_*`` are the open nominations (see
    ops/gang.py), charged in both passes; ``fit_strategy``, ``sample_*``,
    ``tie_key`` and ``attempt_base`` select the step's branches (with
    ``sample_k`` the tallies carry the advanced ``sample_start``)."""
    nom = dict(nom_node=nom_node, nom_prio=nom_prio, nom_req=nom_req,
               **gang.step_mode(fit_strategy, sample_k, sample_start, tie_key, attempt_base))
    c0 = wave_speculate(dc, db, g, weights, check_fit, d_cap, **nom)
    chosen, n_feas, rc, tallies, kinds, cterms = wave_admit(
        dc, db, g, hostname_key, c0, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u, ip_cdv_tab,
        weights, check_fit, d_cap, d2_cap, has_ports, tid_pt, port_conf, **nom)
    return chosen, n_feas, rc, tallies, torch.stack([c0, kinds, cterms])


def wave_run(dc, db, hostname_key: int, v_cap: int, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u,
             ip_cdv_tab, hard_pod_affinity_weight: int = 1, has_interpod: bool = True, has_spread: bool = True,
             has_images: bool = True, enabled: frozenset = gang.ALL_FILTER_KERNELS,
             weights: tuple = gang.DEFAULT_WEIGHTS, sp_keys=None, sp_cdv_tab=None, ip_keys=None, d_cap: int = 8,
             d2_cap: int = 8, has_ports: bool = False, tid_pt=None, port_conf=None, nom_node=None, nom_prio=None,
             nom_req=None, fit_strategy: tuple = gang.DEFAULT_FIT_STRATEGY, sample_k=None, sample_start=None,
             tie_key=None, attempt_base=None):
    """precompute + wave_schedule for one batch (the wave's gang_run).  The
    gang scan's pod×pod port matrix stays out (precompute with
    has_ports=False): in-batch host ports ride the [Tpt, N] occupancy
    carry, which ``has_ports`` engages."""
    g = gang.precompute(dc, db, hostname_key, v_cap, hard_pod_affinity_weight, has_interpod=has_interpod,
                        has_spread=has_spread, has_ports=False, has_images=has_images, enabled=enabled,
                        sp_keys=sp_keys, sp_cdv_tab=sp_cdv_tab, ip_keys=ip_keys)
    return wave_schedule(dc, db, g, hostname_key, v_cap, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u,
                         ip_cdv_tab, weights=weights, check_fit="NodeResourcesFit" in enabled, d_cap=d_cap,
                         d2_cap=d2_cap, has_ports=has_ports, tid_pt=tid_pt, port_conf=port_conf, nom_node=nom_node,
                         nom_prio=nom_prio, nom_req=nom_req, fit_strategy=fit_strategy, sample_k=sample_k,
                         sample_start=sample_start, tie_key=tie_key, attempt_base=attempt_base)


# ---------------------------------------------------------------------------
# CUDA: K8 (speculation) and K9 (admission)
# ---------------------------------------------------------------------------


def _zeros(dev, n, dtype=I32):
    return torch.zeros((max(int(n), 1),), dtype=dtype, device=dev)


def _wave_speculate_cuda(dc, db, g, weights, check_fit, nom_node=None, nom_prio=None, nom_req=None, lane=None,
                         extra_score=None, **mode):
    """K8 launch: a group of warps per pod against the cluster's
    own usage rows (``lane``: the port lane, and ``extra_score``, null
    pointers when None); in sampling mode every pod reads the initial
    cursor.  No host sync: the domain bits are sized by the cluster's
    largest domain count, a host int."""
    dev = dc.node_valid.device
    lib = _build.load()
    g = gang.GangStatics(*(t.contiguous() for t in g))
    P, N = g.static_mask.shape
    mode = gang.step_mode(**mode)
    state = {"requested": dc.requested, "nonzero": dc.nonzero_req, "num_pods": dc.num_pods}  # read only
    if mode["sample_k"] is not None:
        state["sample_start"] = torch.tensor(mode["sample_start"], dtype=I32, device=dev)
    c0 = torch.empty((P,), dtype=I32, device=dev)
    outs = (c0, torch.empty((P,), dtype=I64, device=dev), torch.empty((P, N_DIAG), dtype=I64, device=dev))
    scratch = {k: _zeros(dev, 1, dt) for k, dt in (("cnt_h", I32), ("port_stamp", I32), ("feas", BOOL),
                                                   ("ip_raw", I64), ("sp_raw", I64), ("sp_cnt", I32))}
    nom = gang.nominations_csr(nom_node, nom_prio, nom_req, N, dev)
    Dsp = max(tuple(dc.dom_counts) + (1,))
    a = gang.step_args(dc, db, g, weights, check_fit, state, outs, scratch, nom, extra_score, mode, dsp=Dsp)
    w = _build.WaveArgs()
    info = torch.zeros((P, 2 + SPEC_PHASES), dtype=I64, device=dev)
    ptrs = [("spec_info", info, I64, (P, 2 + SPEC_PHASES))]
    if lane is not None:
        ptrs.append(("lane", lane.contiguous(), BOOL, (P, N)))
    gang._set_ptrs(w, dev, ptrs)
    w.Dsp = Dsp
    rc = lib.ktpu_wave_speculate(ctypes.byref(a), ctypes.byref(w), _build.stream_handle(dev))
    _build.check_launch(lib, rc, "wave_speculate")
    _build.launches["wave_speculate"] += 1
    spec_stats.update(info=info)
    return c0


def _admit_blocks(dc, db, g, hostname_key, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u, weights,
                  check_fit, has_ports, tid_pt, port_conf, nom, c0, kinds, cterms, extra_score=None, mode=None):
    """The argument blocks of the admission recurrence before its memory is
    placed: (GangScanArgs, WaveArgs, usage state, (chosen, n_feas,
    reason_counts)).  The usage state starts as copies of the cluster's rows.
    The domain sums use DeviceCluster.dom_ids, which numbers a key's domains
    as ip_cdv_tab does, so the table itself is not read.  ``extra_score``
    (i64 [P, N], or None) adds to every node's total; ``mode``
    (gang.step_mode, None: the default branch) selects the step's branches,
    with the cursor in the usage state."""
    dev = dc.node_valid.device
    g = gang.GangStatics(*(t.contiguous() for t in g))
    P, N = g.static_mask.shape
    C, AT = g.sp_dv.shape[1], g.ip_dv.shape[1]
    Tsp, Tip = rep_sp_p.shape[0], rep_ip_p.shape[0]
    Tpt = port_conf.shape[0] if has_ports else 0
    if tid_pt is None:
        tid_pt = torch.full((P, 0), -1, dtype=I32, device=dev)
    if port_conf is None:
        port_conf = torch.zeros((1, 1), dtype=BOOL, device=dev)
    W = tid_pt.shape[1]
    Dsp = gang.max_domains(dc, db.tsc_topo[:, :C], db.valid[:, None] & ~g.sp_is_host)
    D2 = gang.max_domains(dc, db.aff_topo[:, :AT], db.valid[:, None] & (db.aff_topo[:, :AT] != hostname_key))
    mode = gang.step_mode() if mode is None else mode
    state = gang._state0(dc, mode["sample_start"])
    outs = (torch.empty((P,), dtype=I32, device=dev), torch.empty((P,), dtype=I64, device=dev),
            torch.empty((P, N_DIAG), dtype=I64, device=dev))
    scratch = dict(cnt_h=_zeros(dev, 1), port_stamp=_zeros(dev, 1),
                   feas=_zeros(dev, N, BOOL), ip_raw=_zeros(dev, N, I64), sp_raw=_zeros(dev, N, I64),
                   sp_cnt=_zeros(dev, C * N))
    a = gang.step_args(dc, db, g, weights, check_fit, state, outs, scratch, nom, extra_score, mode)
    w = _build.WaveArgs()
    gang._set_ptrs(w, dev, [
        ("tid_sp", tid_sp, I32, (P, tid_sp.shape[1])), ("rep_sp_p", rep_sp_p, I32, (Tsp,)),
        ("rep_sp_c", rep_sp_c, I32, (Tsp,)), ("tid_ip", tid_ip, I32, (P, tid_ip.shape[1])),
        ("rep_ip_p", rep_ip_p, I32, (Tip,)), ("rep_ip_u", rep_ip_u, I32, (Tip,)),
        ("tid_pt", tid_pt, I32, (P, W)), ("port_conf", port_conf, BOOL, tuple(port_conf.shape)),
        ("c0", c0, I32, (P,)), ("kinds", kinds, I32, (P,)), ("cterms", cterms, I32, (P,)),
    ])
    if (C and tid_sp.shape[1] != C) or (AT and tid_ip.shape[1] != AT):
        raise ValueError("admission: the term tables' slot axes differ from the statics'")
    w.Tsp, w.Tip, w.Tpt, w.W, w.Dsp, w.D2 = Tsp, Tip, Tpt, W, Dsp, D2
    w.hostname_key = int(hostname_key)
    w.has_ports = int(bool(has_ports))
    return a, w, state, outs


def _carry_cells(w, N: int) -> int:
    return (w.Tsp + 2 * w.Tip + w.Tpt) * N


def _wave_admit_cuda(dc, db, g, hostname_key, c0, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p, rep_ip_u,
                     ip_cdv_tab, weights, check_fit, d_cap, d2_cap, has_ports, tid_pt, port_conf, nom_node=None,
                     nom_prio=None, nom_req=None, **mode):
    """K9 launch: the admission recurrence in one thread-block cluster, laid
    out by ktpu_wave_admit_plan (the cluster size under
    ADMIT_CLUSTER_CAP, shared memory under ADMIT_SMEM_CAP), with the
    exchange slabs and carries that do not fit in global scratch rows; the
    cursor comes back in the tallies."""
    dev = dc.node_valid.device
    lib = _build.load()
    P, N = g.static_mask.shape
    kinds = torch.empty((P,), dtype=I32, device=dev)
    cterms = torch.empty((P,), dtype=I32, device=dev)
    nom = gang.nominations_csr(nom_node, nom_prio, nom_req, N, dev)
    a, w, state, outs = _admit_blocks(dc, db, g, hostname_key, tid_sp, rep_sp_p, rep_sp_c, tid_ip, rep_ip_p,
                                      rep_ip_u, weights, check_fit, has_ports, tid_pt, port_conf, nom, c0, kinds,
                                      cterms, mode=gang.step_mode(**mode))
    rc = lib.ktpu_wave_admit_plan(ctypes.byref(a), ctypes.byref(w), int(ADMIT_CLUSTER_CAP),
                                  int(min(ADMIT_SMEM_CAP, 2**31 - 1)), int(bool(ADMIT_STAGE)))
    _build.check_launch(lib, rc, "wave_admit")
    info = torch.zeros((2 + ADMIT_PHASES,), dtype=I32, device=dev)
    gang._set_ptrs(w, dev, [
        ("sums", _zeros(dev, 1 if w.sums_smem else w.cluster * w.xch_cells), I32, None),
        ("carries", _zeros(dev, 1 if w.carry_smem else _carry_cells(w, N)), I32, None),
        ("admit_info", info, I32, (2 + ADMIT_PHASES,)),
    ])
    rc = lib.ktpu_wave_admit(ctypes.byref(a), ctypes.byref(w), _build.stream_handle(dev))
    _build.check_launch(lib, rc, "wave_admit")
    _build.launches["wave_admit"] += 1
    admit_stats.update(cluster=int(w.cluster), staged=bool(w.stage), info=info)
    return (*outs, state, kinds, cterms)
