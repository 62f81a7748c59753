"""The port's Scheduler: the signature fast path, the speculative wave and
the gang scan, synchronously.

Routes each batch the way the JAX package's scheduler.py does:

1. the CHAINED dispatch (``_chain_quickcheck`` → ``_try_dispatch_chained``):
   once the mirror is packed, a batch that is not a fast-path candidate is
   scheduled on the resident device cluster by ``chain_dispatch``, which
   also appends the batch's placed pods and their terms into it, so the
   next chained batch needs no upload;
2. the signature FAST path (``_fast_gate_ok`` → signature rows → dispatch):
   pods whose only batch-dynamic constraint is resources collapse into
   signatures; new signatures get their static rows from kernel K1; device-
   sized batches extend from the queue head and are placed by K4
   (resident_run) or, with ``residentDrain: false``, K2 (sig_scan), small
   ones on the host FastCommitter; K3 checks the usage checksum;
3. the DIRECT dispatch (``wave_run`` or ``gang_run``): everything else, on
   the snapshot the device mirror keeps current (K1 + K6 + K7 for the
   statics).

On the chained and the direct route, a batch whose pods carry their own
cross-pod constraints (spread, inter-pod terms, host ports) takes the
speculative wave under the default ``waveDispatch: true`` (K8 speculates
every pod against the frozen snapshot, K9 admits them in queue order over
the term-factored carries; ``_wave_resolve`` turns its stats into the
``wave_*`` metrics).  Such a batch takes the gang scan (K5) instead when
two nodes share a hostname label value or ``wave_dispatch=False``; both
fallbacks are counted (``wave_fallback_dup_hostname`` /
``wave_fallback_kill_switch``).  Other gang-path batches take the scan.

The drain is synchronous: each batch is harvested (placements assumed and
bound, failures diagnosed) before the next dispatch; the reference keeps up
to two chained batches in flight (ROADMAP A3).  Gang commits invalidate the
fast lineage and the mirror's usage rows; fast batches end the chain.

Pods outside the ported paths raise NotImplementedError naming the ROADMAP
item that ports them; a kernel failure or a checksum mismatch raises too.
Nothing falls back to another path by itself, and the batch goes back to
the queue unscheduled.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from kubernetes_tpu_torch import fastpath as fp
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.cache.cache import Cache
from kubernetes_tpu_torch.cache.device_mirror import DeviceClusterCache
from kubernetes_tpu_torch.cache.mirror import HOSTNAME_LABEL, SnapshotMirror
from kubernetes_tpu_torch.framework.config import Profile, SchedulerConfiguration
from kubernetes_tpu_torch.ops import chain as ops_chain
from kubernetes_tpu_torch.ops import fastpath as ops_fp
from kubernetes_tpu_torch.ops import gang as ops_gang
from kubernetes_tpu_torch.ops import resident as ops_res
from kubernetes_tpu_torch.ops import wave as ops_wave
from kubernetes_tpu_torch.ops import wire
from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster
from kubernetes_tpu_torch.queue.scheduling_queue import QueuedPodInfo, SchedulingQueue
from kubernetes_tpu_torch.snapshot.interner import PAD, Vocab
from kubernetes_tpu_torch.snapshot.schema import (
    NodeTensors,
    ResourceLanes,
    bucket_cap,
    pack_pod_batch,
)

GROUP_LABEL = "pod-group.scheduling.sigs.k8s.io/name"
# placed term pods beyond this make the fast gate's probes cost more than
# the scan they would save (the reference's cut-off)
MAX_PROBED_TERM_PODS = 64


@dataclass
class ScheduleOutcome:
    pod: Pod
    node: Optional[str]
    # "" when bound; else the FitError message or the bind error
    reason: str = ""
    # plugin name → count of nodes it rejected (unschedulable pods)
    diagnosis: Optional[Dict[str, int]] = None


# FitError reason strings keyed by diagnosis kernel (framework/types.go:420-465)
_DIAG_REASONS = {
    "NodeUnschedulable": "node(s) were unschedulable",
    "NodeName": "node(s) didn't match the requested node name",
    "TaintToleration": "node(s) had untolerated taints",
    "NodeAffinity": "node(s) didn't match Pod's node affinity/selector",
    "NodePorts": "node(s) didn't have free ports for the requested pod ports",
    "HostFilters": "node(s) were rejected by host filter plugins",
    "NodeResourcesFit": "node(s) had insufficient resources",
    "PodTopologySpread": "node(s) didn't match pod topology spread constraints",
    "InterPodAffinity": "node(s) didn't satisfy inter-pod affinity/anti-affinity rules",
}


def fit_error_message(num_nodes: int, diagnosis: Dict[str, int]) -> str:
    """FitError.Error() shape: '0/N nodes are available: <reasons>.'"""
    if not diagnosis:
        return f"0/{num_nodes} nodes are available"
    parts = [
        f"{c} {_DIAG_REASONS.get(k, k)}"
        for k, c in sorted(diagnosis.items(), key=lambda kv: -kv[1])
    ]
    return f"0/{num_nodes} nodes are available: " + ", ".join(parts)


@dataclass
class SigStack:
    """Per-signature rows stacked for K2 ([S_cap, ...], S_cap a bucket)."""

    req: np.ndarray  # i64 [S, R]
    nz: np.ndarray  # i64 [S, 2]
    az: np.ndarray  # bool [S]
    ok: np.ndarray  # bool [S, N]
    img: np.ndarray  # i64 [S, N]


@dataclass
class UsageState:
    """The committer's node usage as device tensors, uploaded once per
    host→device transition; K2 updates the last four in place."""

    alloc: np.ndarray  # i64 [N, R]
    allowed: np.ndarray  # i32 [N]
    used: np.ndarray  # i64 [N, R]
    nz0: np.ndarray  # i64 [N]
    nz1: np.ndarray  # i64 [N]
    num_pods: np.ndarray  # i32 [N]


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; CUDA asked for and
    absent raises (the port never moves to the CPU by itself)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "Scheduler(device=%r): CUDA is not available; pass device='cpu' "
            "to run the plain PyTorch path" % (device,)
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class Scheduler:
    def __init__(
        self,
        configuration: Optional[SchedulerConfiguration] = None,
        binding_sink: Optional[Callable[[Pod, str], None]] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = configuration or SchedulerConfiguration()
        self.config.validate()
        self.profiles: Dict[str, Profile] = {
            p.scheduler_name: p for p in self.config.profiles
        }
        self.cache = Cache()
        self.queue = SchedulingQueue()
        self.vocab = Vocab()
        # bind one pod (raises on failure), or, when set, bind a whole batch:
        # binding_sink_many(pairs) -> [None or error per pair]
        self.binding_sink = binding_sink
        self.binding_sink_many = None
        self.metrics = {
            "schedule_attempts": 0,
            "fast_batches": 0,
            "host_batches": 0,
            "device_batches": 0,
            "resident_batches": 0,
            "resident_pods": 0,  # pods the fixed point resolved
            "resident_rounds": 0,
            "resident_tail_pods": 0,  # unresolved pods the host committer finished
            "static_evals": 0,
            "state_uploads": 0,
            "scan_batches": 0,  # direct gang_run batches
            "chain_batches": 0,  # chain_dispatch batches
            "wave_batches": 0,  # wave_run and chain_dispatch(wave=True) batches
            "wave_pods": 0,
            "wave_admitted": 0,  # pods placed on their speculative node
            "wave_groups": 0,  # interaction groups over the wave batches
            "wave_conflicts": {},  # demotion kind → pods
            # wave-shaped batches the gang scan took, by reason
            "wave_fallback_dup_hostname": 0,
            "wave_fallback_kill_switch": 0,
        }
        # the packed host snapshot (nodes, placed pods, their terms) and its
        # device-resident image
        self.mirror = SnapshotMirror(self.vocab)
        self._dc_cache = DeviceClusterCache(self.device)
        self._external_mutations = 0  # cluster changes no committer tracked
        self._nonfast_commits = 0  # gang commits (the fast lineage's blind spot)
        self._mirror_sync = None  # (external, nonfast) at the last repack
        self._static_dc = None
        self._static_dc_key = None
        self._sig_cache: Dict[object, dict] = {}
        self._sig_cache_key = None
        self._speckey_cache: Dict[tuple, object] = {}
        self._holder: Optional[dict] = None
        self._term_probe_cache = None
        self._chain: Optional[dict] = None
        self._p_cap_max = 1  # sticky gang batch bucket
        self._tables = None
        self._tables_key = None
        self._wave_tables_memo = None

    @property
    def nodes(self) -> Optional[NodeTensors]:
        return self.mirror.nodes

    # ----- informer events ---------------------------------------------------

    def on_node_add(self, node: Node) -> None:
        self.cache.add_node(node)
        self._external_mutations += 1
        self.queue.move_all_to_active()

    def on_pod_add(self, pod: Pod) -> None:
        if pod.node_name:
            self.cache.add_pod(pod)
            self._external_mutations += 1
        elif pod.scheduler_name in self.profiles:
            self.queue.add(pod)

    # ----- the drain -----------------------------------------------------

    def schedule_pending(self) -> List[ScheduleOutcome]:
        """Drain the active queue; returns all outcomes."""
        # pre-size the placed-pod axes for the whole drain, so a growing
        # drain keeps one shape
        self.mirror.e_cap_hint = max(
            self.mirror.e_cap_hint, len(self.cache.pod_states) + len(self.queue) + self.config.batch_size
        )
        outcomes: List[ScheduleOutcome] = []
        while True:
            batch = self.queue.pop_batch(self.config.batch_size)
            if not batch:
                break
            groups: Dict[str, List[QueuedPodInfo]] = {}
            for qp in batch:
                groups.setdefault(qp.pod.scheduler_name, []).append(qp)
            for name, group in groups.items():
                outcomes.extend(self._schedule_group(self.profiles[name], group))
        return outcomes

    def _schedule_group(self, profile: Profile, batch: List[QueuedPodInfo]) -> List[ScheduleOutcome]:
        for qp in batch:
            why = self._refusal(qp.pod)
            if why is not None:
                self._refuse(batch, f"pod {qp.pod.key}: {why}")
        if self._chain_quickcheck(batch):
            out = self._try_dispatch_chained(profile, batch)
            if out is not None:
                return out
        out = self._try_fast(profile, batch)
        if out is not None:
            return out
        return self._schedule_direct(profile, batch)

    def _refusal(self, pod: Pod) -> Optional[str]:
        """Why a pod is outside the ported paths (None when it is inside)."""
        if pod.nominated_node_name:
            return "nominated pods take the nominated-node path (ROADMAP A7)"
        if pod.pod_group or pod.labels.get(GROUP_LABEL):
            return "gang members take the workloads tier (ROADMAP A8)"
        if pod.resource_claims:
            return "DRA claims take the workloads tier (ROADMAP A8)"
        if pod.volumes:
            return "volumes need the host Filter plugins (ROADMAP A6)"
        if pod.scheduling_gates:
            return "scheduling gates need the PreEnqueue queue tier (ROADMAP A5)"
        if (
            pod.preemption_policy != "Never"
            and self.cache.priorities
            and pod.priority > min(self.cache.priorities)
        ):
            return "a failure could preempt lower-priority pods (ROADMAP A7)"
        return None

    def _refuse(self, batch: List[QueuedPodInfo], why: str) -> None:
        self.queue.push_back(batch)
        raise NotImplementedError(why)

    # ----- the fast path -------------------------------------------------

    def _fast_gate_ok(self, batch) -> bool:
        """Per-batch fast-path eligibility: a placed pod's terms poison only
        the newcomers its selectors could admit, checked per label group
        against the cache's term-pod registry."""
        n_t = self.cache.n_term_pods
        if not n_t:
            return True
        if n_t > MAX_PROBED_TERM_PODS:
            return False
        probes = self._term_probes()
        memo: Dict[tuple, bool] = {}
        return not any(self._admitted(qp.pod, probes, memo) for qp in batch)

    @staticmethod
    def _admitted(pod: Pod, probes, memo: Dict[tuple, bool]) -> bool:
        """Could a placed pod's term admit ``pod``: one probe walk per label
        group (namespace and labels), memoized in ``memo``."""
        gk = (pod.namespace, tuple(sorted(pod.labels.items())))
        hit = memo.get(gk)
        if hit is None:
            hit = memo[gk] = any(pr.admits(pod) for pr in probes)
        return hit

    def _term_probes(self):
        key = self.cache.term_version
        if self._term_probe_cache is None or self._term_probe_cache[0] != key:
            probes = []
            for p in self.cache.term_pods.values():
                probes.extend(fp._pod_probes(p))
            self._term_probe_cache = (key, probes)
        return self._term_probe_cache[1]

    def _try_fast(self, profile: Profile, batch: List[QueuedPodInfo]) -> Optional[List[ScheduleOutcome]]:
        """The signature fast path; None when the batch is not eligible (a
        placed term could admit a pod, a pod has no signature, or a
        signature's static scores vary over its feasible nodes)."""
        if self.mirror.nodes is None:
            self._repack_mirror()
        if not self._fast_gate_ok(batch):
            return None
        keys = [self._sig_key(qp.pod) for qp in batch]
        if any(k is None for k in keys):
            return None
        self._sync_mirror_external()
        rows = self._fast_sig_rows(profile, batch, keys)
        if rows is None:
            return None

        # extend from the queue head with pods whose signatures are already
        # evaluated and argmax-neutral (a novel signature seeds a later batch);
        # a resident run rides one dispatch, so it extends further
        cfg = self.config
        cap = cfg.resident_run_max if cfg.resident_drain else cfg.fast_batch_max
        ext = cap - len(batch)
        if ext > 0:
            probes = self._term_probes() if self.cache.n_term_pods else ()
            group_hit: Dict[tuple, bool] = {}

            def known(qp: QueuedPodInfo) -> bool:
                p = qp.pod
                if p.scheduler_name != profile.scheduler_name or self._refusal(p) is not None:
                    return False
                if probes and self._admitted(p, probes, group_hit):
                    return False
                row = rows.get(self._sig_key(p))
                return row is not None and row["const_ok"]

            extra = self.queue.pop_batch_while(ext, known)
            batch = batch + extra
            keys = keys + [self._sig_key(qp.pod) for qp in extra]

        weights = profile.weights()
        check_fit = "NodeResourcesFit" in profile.enabled
        holder = self._lineage(profile, weights, check_fit)
        pod_sigs = self._signatures(holder, keys, rows, weights)
        choices = self._place(holder, batch, pod_sigs, weights, check_fit)
        return self._commit(holder, batch, keys, pod_sigs, choices, rows)

    # ----- snapshot ------------------------------------------------------

    def _repack_mirror(self) -> None:
        """mirror.update, plus one forced full repack when the label-key
        bucket outgrew the packed node tensors.  When the live fast lineage
        owns every usage change since the last repack, its committer's
        state is written into the mirror in one pass first."""
        h = self._holder
        if (
            h is not None
            and h["key"][:3] == (self._external_mutations, self._nonfast_commits, self.mirror._full_packs)
            and self.mirror.nodes is h["nt"]
        ):
            self.mirror.apply_fast_usage(h["fc"], self.cache)
        self.mirror.update(self.cache)
        if bucket_cap(len(self.vocab.label_keys)) > self.mirror.nodes.k_cap:
            self.mirror._force_full = True
            self.mirror.update(self.cache)
        self._mirror_sync = (self._external_mutations, self._nonfast_commits)

    def _sync_mirror_external(self) -> None:
        """Repack only when state the fast path reads could have moved:
        cluster events or gang commits, which no committer tracked."""
        if self.mirror.nodes is None or self._mirror_sync != (self._external_mutations, self._nonfast_commits):
            self._repack_mirror()

    def _static_device_cluster(self) -> DeviceCluster:
        """The node snapshot on the device, for static reads only: usage
        churn does not re-upload it."""
        m = self.mirror
        key = (m.static_generation, m._full_packs, len(self.vocab.label_vals), len(self.vocab.label_keys))
        if self._static_dc_key != key:
            self._static_dc = DeviceCluster.from_host(m.nodes, self.vocab, self.device)
            self._static_dc_key = key
        return self._static_dc

    # ----- signatures ----------------------------------------------------

    def _sig_key(self, pod: Pod):
        """signature_key, memoized on the pod and by spec content (pods
        stamped from one template share one computation)."""
        params = (self.nodes.allocatable.shape[1], len(self.vocab.resources))
        d = pod.__dict__
        memo = d.get("_sigkey_memo")
        if memo is not None and memo[0] == params:
            return memo[1]
        sk = fp.spec_key_memo(pod)
        if sk is not None and (params, sk) in self._speckey_cache:
            k = self._speckey_cache[(params, sk)]
        else:
            k = fp.signature_key(pod, ResourceLanes(self.vocab), params[0])
            if sk is not None:
                if len(self._speckey_cache) > 65536:
                    self._speckey_cache.clear()
                self._speckey_cache[(params, sk)] = k
        d["_sigkey_memo"] = (params, k)
        return k

    def _fast_sig_rows(self, profile: Profile, batch, keys) -> Optional[Dict[object, dict]]:
        """Static rows (masks + raw scores) per signature, cached until the
        static snapshot moves.  None when a signature's static score raws
        vary over its feasible set: normalization would then depend on the
        batch state, and the batch takes the gang scan."""
        dc_key = (self.mirror.static_generation, self.mirror._full_packs, profile.scheduler_name)
        if self._sig_cache_key != dc_key:
            self._sig_cache = {}
            self._sig_cache_key = dc_key
        cache = self._sig_cache
        order: Dict[object, int] = {}
        reps: List[Pod] = []
        for k, qp in zip(keys, batch):
            if k not in order and k not in cache:
                order[k] = len(reps)
                reps.append(qp.pod)
        if reps:
            # the pod packer interns selector values first, so the static
            # cluster below sees this batch's vocabulary
            pb = pack_pod_batch(
                reps,
                self.vocab,
                k_cap=self.nodes.k_cap,
                p_cap=bucket_cap(max(len(reps), 16), 1),
            )
            db = DeviceBatch.from_host(pb, self.device)
            dc = self._static_device_cluster()
            res = ops_fp.static_eval(
                dc, db, enabled=profile.enabled, has_images=any(p.images for p in reps)
            )
            res = {k: v.cpu().numpy() for k, v in res.items()}
            self.metrics["static_evals"] += 1
            w_taint, w_naff = profile.weights()[:2]
            for k, s in order.items():
                row = {name: res[name][s] for name in res}
                m = row["mask"]
                const_ok = True
                for w, raw in ((w_taint, row["taint_raw"]), (w_naff, row["naff_raw"])):
                    vals = raw[m]
                    if w and vals.size and int(vals.min()) != int(vals.max()):
                        const_ok = False
                row["const_ok"] = const_ok
                cache[k] = row
        if any(not cache[k]["const_ok"] for k in keys):
            return None
        return cache

    # ----- the committer lineage ------------------------------------------

    def _lineage(self, profile: Profile, weights, check_fit: bool) -> dict:
        """The host committer and its device twin.  Only an external cluster
        change, a gang commit, a full repack or another profile rebuilds it;
        fast commits keep it (the committer is the committed truth)."""
        key = (self._external_mutations, self._nonfast_commits, self.mirror._full_packs,
               profile.scheduler_name, weights, check_fit)
        h = self._holder
        if h is None or h["key"] != key:
            h = self._holder = {
                "key": key,
                "nt": self.nodes,
                "fc": fp.FastCommitter(self.nodes, weights, check_fit=check_fit),
                "sigs": {},  # signature key → fp.Signature
                "sig_list": [],
                "stack": None,  # device SigStack, rebuilt on a new signature
                "stack_np": None,
                "dev": None,  # device UsageState; None when stale
                "dev_sum": None,  # host-tracked exact sum of the device state
                "heaps_dirty": False,
                "p_cap": 64,
            }
        return h

    def _signatures(self, holder: dict, keys, rows, weights) -> List[fp.Signature]:
        sigs = holder["sigs"]
        for k in keys:
            if k in sigs:
                continue
            row = rows[k]
            req_row, nz = k[0], k[1]
            img = row["img"].tolist() if weights[6] and row["img"].any() else None
            sig = fp.Signature(
                req_row=req_row,
                nz0=nz[0],
                nz1=nz[1],
                all_zero=all(v == 0 for v in req_row),
                static_ok=row["mask"],
                img=img,
            )
            sig.sid = len(holder["sig_list"])
            sigs[k] = sig
            holder["sig_list"].append(sig)
            holder["stack"] = None
        return [sigs[k] for k in keys]

    def _stack_signatures(self, holder: dict) -> None:
        fc = holder["fc"]
        sig_list = holder["sig_list"]
        s_cap = bucket_cap(len(sig_list), 8)
        st = SigStack(
            req=np.zeros((s_cap, fc.rn), np.int64),
            nz=np.zeros((s_cap, 2), np.int64),
            az=np.zeros((s_cap,), bool),
            ok=np.zeros((s_cap, fc.n), bool),
            img=np.zeros((s_cap, fc.n), np.int64),
        )
        for i, sg in enumerate(sig_list):
            st.req[i, : len(sg.req_row)] = sg.req_row
            st.nz[i] = (sg.nz0, sg.nz1)
            st.az[i] = sg.all_zero
            st.ok[i] = sg.static_ok
            if sg.img is not None:
                st.img[i] = sg.img
        holder["stack_np"] = st
        holder["any_img"] = any(sg.img is not None for sg in sig_list)
        holder["stack"] = wire.device_put_packed(st, self.device)

    def _upload_state(self, holder: dict) -> None:
        """Materialize the committer's usage on the device (one upload per
        host→device transition) and start the checksum lineage."""
        fc = holder["fc"]
        us = UsageState(
            alloc=np.asarray(fc.alloc_rows, np.int64),
            allowed=np.asarray(fc.allowed, np.int32),
            used=np.asarray(fc.used_rows, np.int64),
            nz0=np.asarray(fc.nz0, np.int64),
            nz1=np.asarray(fc.nz1, np.int64),
            num_pods=np.asarray(fc.num_pods, np.int32),
        )
        holder["dev_sum"] = int(us.used.sum() + us.nz0.sum() + us.nz1.sum() + us.num_pods.sum(dtype=np.int64))
        holder["dev"] = wire.device_put_packed(us, self.device)
        self.metrics["state_uploads"] += 1

    # ----- placement -----------------------------------------------------

    def _place(self, holder: dict, batch, pod_sigs, weights, check_fit: bool) -> List[int]:
        fc = holder["fc"]
        self.metrics["fast_batches"] += 1
        if len(batch) < self.config.fast_device_min:
            # host path: the greedy answers locally, no device round trip
            if holder["heaps_dirty"]:
                fc.invalidate_heaps()  # device replays moved scores under the heaps
                holder["heaps_dirty"] = False
            self.metrics["host_batches"] += 1
            holder["dev"] = None  # the device copy (if any) is now stale
            return fc.run(pod_sigs)
        try:
            return self._place_device(holder, batch, pod_sigs, weights, check_fit)
        except BaseException:
            # the in-place usage tensors may be torn: drop the device
            # lineage, return the batch unscheduled, and re-raise
            holder["dev"] = None
            holder["dev_sum"] = None
            self.queue.push_back(batch)
            raise

    def _place_device(self, holder: dict, batch, pod_sigs, weights, check_fit: bool) -> List[int]:
        """One K4 launch (or, with residentDrain off, one K2 launch) for the
        whole batch, then K3, then the replay of the choices into the host
        committer; a resident run's unresolved tail is finished on it."""
        fc = holder["fc"]
        cfg = self.config
        resident = cfg.resident_drain
        if holder["stack"] is None:
            self._stack_signatures(holder)
        # p_cap quantized to the reference's kernel-shape levels: a resident
        # run's round cap depends on the padded P, so equal levels give
        # equal rounds
        need = len(batch)
        levels = [64, 512, cfg.fast_batch_max] + ([cfg.resident_run_max] if resident else [])
        for level in levels:
            if need <= level:
                need = level
                break
        else:
            need = bucket_cap(need, 1)
        p_cap = holder["p_cap"] = max(holder["p_cap"], need)
        ids_np = np.full((p_cap,), -1, np.int32)
        ids_np[: len(batch)] = [s.sid for s in pod_sigs]
        if holder["dev"] is None:
            self._upload_state(holder)
        st, us = holder["stack"], holder["dev"]
        ids = torch.from_numpy(ids_np).to(self.device)
        kw = dict(
            w_fit=weights[4],
            w_bal=weights[5],
            w_img=weights[6] if holder["any_img"] else 0,
            check_fit=check_fit,
        )
        args = (ids, st.req, st.nz, st.az, st.ok, st.img, us.alloc, us.allowed,
                us.used, us.nz0, us.nz1, us.num_pods)
        stats = None
        if resident:
            choices_dev, _, stats_dev = ops_res.resident_run(
                *args, **kw, window=min(cfg.resident_window, fc.n), serial_tail=cfg.resident_serial_tail
            )
            stats = stats_dev.tolist()
        else:
            choices_dev, _ = ops_fp.sig_scan(*args, **kw)
        csum_dev = None
        if cfg.resident_epoch_guard:
            csum_dev = ops_res.usage_checksum(us.used, us.nz0, us.nz1, us.num_pods)
        choices_np = choices_dev.cpu().numpy()[: len(batch)].astype(np.int64)
        if ((choices_np < ops_res.UNRESOLVED) | (choices_np >= fc.n)).any():
            raise RuntimeError("device placement returned a node index out of range")
        self.metrics["device_batches"] += 1
        if stats is not None:
            self.metrics["resident_batches"] += 1
            self.metrics["resident_pods"] += min(stats[1], len(batch))
            self.metrics["resident_rounds"] += stats[0]

        # per-node aggregates of this batch's resolved commits
        sel = choices_np >= 0
        nodes = choices_np[sel]
        stn = holder["stack_np"]
        sids = np.fromiter((s.sid for s in pod_sigs), np.int64, len(pod_sigs))[sel]
        agg = np.zeros((fc.n, fc.rn), np.int64)
        np.add.at(agg, nodes, stn.req[sids])
        add0 = np.zeros(fc.n, np.int64)
        np.add.at(add0, nodes, stn.nz[sids, 0])
        add1 = np.zeros(fc.n, np.int64)
        np.add.at(add1, nodes, stn.nz[sids, 1])
        cnt = np.bincount(nodes, minlength=fc.n)
        # epoch guard: the device state's checksum must equal the host sum
        # plus exactly this batch's commit delta, before the committer moves
        expected = holder["dev_sum"] + int(agg.sum() + add0.sum() + add1.sum() + cnt.sum())
        if csum_dev is not None:
            got = int(csum_dev.item())
            if got != expected:
                raise RuntimeError(
                    f"device usage checksum mismatch: usage_checksum {got} != "
                    f"host-tracked {expected}"
                )
        holder["dev_sum"] = expected
        for n in np.unique(nodes).tolist():
            row = fc.used_rows[n]
            for r in range(fc.rn):
                row[r] += int(agg[n, r])
            fc.nz0[n] += int(add0[n])
            fc.nz1[n] += int(add1[n])
            fc.num_pods[n] += int(cnt[n])
        holder["heaps_dirty"] = True
        choices = choices_np.tolist()
        tail = np.nonzero(choices_np == ops_res.UNRESOLVED)[0].tolist()
        if tail:
            # the host-committer tail: the fixed point handed back the pods
            # it did not resolve; the committer finishes them exactly, and
            # the device copy, which now lags its commits, is dropped
            fc.invalidate_heaps()
            self.metrics["resident_tail_pods"] += len(tail)
            for i, c in zip(tail, fc.run([pod_sigs[i] for i in tail])):
                choices[i] = c
            holder["heaps_dirty"] = False
            holder["dev"] = None
            holder["dev_sum"] = None
        return choices

    # ----- the gang scan: chained and direct ------------------------------

    def _chain_epoch(self):
        """What the chained device cluster cannot see: cluster events, fast
        commits, full repacks and vocabulary growth restart the chain."""
        return (
            self._external_mutations,
            self.metrics["fast_batches"],
            self.mirror._full_packs,
            len(self.vocab.label_vals),
            len(self.vocab.label_keys),
        )

    def _chain_quickcheck(self, batch) -> bool:
        """Spec-only gate of the chained path: the mirror is packed, no pod
        wants host ports (the append does not splice port rows), and the
        batch is not a fast-path candidate."""
        if self.mirror.nodes is None:
            return False
        if any(qp.pod.host_ports() for qp in batch):
            return False
        if self._fast_gate_ok(batch) and all(self._sig_key(qp.pod) is not None for qp in batch):
            return False
        return True

    def _gang_prep(self, batch):
        """Pack the batch at the sticky bucket; returns (pods, pb)."""
        for qp in batch:
            for k, v in qp.pod.labels.items():
                self.vocab.intern_label(k, v)
        pods = [qp.pod for qp in batch]
        self._p_cap_max = max(self._p_cap_max, bucket_cap(len(pods), 1))
        pb = pack_pod_batch(pods, self.vocab, k_cap=self.mirror.nodes.k_cap, p_cap=self._p_cap_max)
        return pods, pb

    def _gang_tables(self, pb) -> dict:
        """batch_tables, reused across batches with the same key sets and
        node labels."""
        key = (
            self.mirror.static_generation,
            self.mirror._full_packs,
            len(self.vocab.label_vals),
            tuple(np.unique(pb.tsc_topo_key).tolist()),
            tuple(np.unique(pb.aff_topo_key).tolist()),
        )
        if self._tables_key != key:
            t = ops_gang.batch_tables(
                pb.tsc_topo_key, pb.aff_topo_key, self.mirror.nodes.label_vals, self._hostname_key()
            )
            for k in ("sp_keys", "sp_cdv_tab", "ip_keys"):
                t[k] = torch.as_tensor(t[k], device=self.device)
            self._tables = t
            self._tables_key = key
        return self._tables

    def _hostname_key(self) -> int:
        return self.vocab.label_keys.lookup(HOSTNAME_LABEL)

    def _gang_flags(self, pb, any_terms: bool) -> dict:
        """The has_* flags of the reference (scheduler.py:1702-1710)."""
        return dict(
            has_interpod=bool((pb.aff_kind != PAD).any()) or any_terms,
            has_spread=bool((pb.tsc_topo_key != PAD).any()),
            has_images=bool((pb.img_ids >= 0).any()),
            has_ports=bool((pb.want_ppk != PAD).any() or (self.mirror.nodes.used_ppk != PAD).any()),
        )

    def _wave_route(self, pb) -> Optional[dict]:
        """The wave's tables when the batch takes the wave: it carries its
        own cross-pod constraints (spread, inter-pod terms, host ports), the
        wave is on, and no two nodes share a hostname.  None sends it to the
        gang scan; a wave-shaped batch sent there is counted by reason."""
        wave_shaped = bool(
            (pb.aff_kind != PAD).any() or (pb.tsc_topo_key != PAD).any() or (pb.want_ppk != PAD).any()
        )
        if not wave_shaped:
            return None
        if not self.config.wave_dispatch:
            self.metrics["wave_fallback_kill_switch"] += 1
            return None
        wt = self._wave_tables(pb)
        if wt is None:
            self.metrics["wave_fallback_dup_hostname"] += 1
        return wt

    def _wave_tables(self, pb) -> Optional[dict]:
        """wave_tables, memoized on the static snapshot and a digest of the
        batch's term content: template-stamped drains repeat the same terms
        batch after batch.  None when duplicate hostnames rule the wave out."""
        hk = self._hostname_key()
        h = hashlib.blake2b(digest_size=16)
        for a in (pb.valid, pb.ns_id, pb.want_ppk, pb.want_ip, pb.want_wild, pb.tsc_topo_key,
                  *(getattr(pb.tsc_table, f) for f in ("req_key", "req_op", "req_vals", "req_rhs", "term_valid")),
                  pb.aff_kind, pb.aff_topo_key, pb.aff_weight, pb.aff_ns_all, pb.aff_ns_ids,
                  *(getattr(pb.aff_table, f) for f in ("req_key", "req_op", "req_vals", "req_rhs", "term_valid"))):
            h.update(np.ascontiguousarray(a).tobytes())
        m = self.mirror
        key = (m.static_generation, m._full_packs, len(self.vocab.label_vals), hk, h.digest())
        memo = self._wave_tables_memo
        if memo is not None and memo[0] == key:
            return memo[1]
        wt = ops_wave.wave_tables(pb, m.nodes.label_vals, hk, hostnames_unique=m.hostnames_unique,
                                  device=self.device)
        self._wave_tables_memo = (key, wt)
        return wt

    @staticmethod
    def _wave_kw(wt: dict, ports: bool = True) -> dict:
        """The wave tables as wave_run's keyword arguments; without `ports`,
        as chain_dispatch's (the chained route carries no host ports)."""
        keys = ("tid_sp", "rep_sp_p", "rep_sp_c", "tid_ip", "rep_ip_p", "rep_ip_u", "ip_cdv_tab", "d2_cap")
        return {k: wt[k] for k in keys + (("tid_pt", "port_conf") if ports else ())}

    def _wave_resolve(self, batch, chosen, stats) -> None:
        """Harvest one wave's stats: the pods admitted at their speculative
        node, the demotions by kind (an upgrade, a pod placed although
        speculation found no node, is not a conflict), and the batch's
        interaction groups.  The port has no host Filter plugins, no
        Reserve/Permit and no extenders, so the groups are always formed,
        as the reference forms them under its default profile."""
        n = len(batch)
        stats = stats.cpu().numpy()
        spec, kinds = stats[0][:n], stats[1][:n]
        chosen_n = np.asarray(chosen)[:n]
        m = self.metrics
        conflicts = m["wave_conflicts"]
        for i in np.nonzero(chosen_n != spec)[0].tolist():
            code = int(kinds[i])
            if code != ops_wave.DEMOTE_UPGRADE:
                kind = ops_wave.DEMOTE_KINDS.get(code, "score")
                conflicts[kind] = conflicts.get(kind, 0) + 1
        m["wave_pods"] += n
        m["wave_admitted"] += int(np.sum((chosen_n == spec) & (chosen_n >= 0)))
        m["wave_groups"] += ops_wave.interaction_groups([qp.pod for qp in batch])[1]

    def _try_dispatch_chained(self, profile: Profile, batch) -> Optional[List[ScheduleOutcome]]:
        """chain_dispatch on the resident cluster, restarting the chain from
        the device mirror when its epoch moved; None when the batch's term
        tables do not fit the chained cluster's widths or its cursors cannot
        be grown (the direct path takes it)."""
        self._repack_mirror()
        pods, pb = self._gang_prep(batch)
        epoch = self._chain_epoch()
        ch = self._chain
        if ch is None or ch["epoch"] != epoch:
            ch = self._restart_chain(epoch)
        cdc = ch["dc"]
        dc_shapes = (
            cdc.term_table.req_key.shape[2],
            cdc.term_table.req_vals.shape[3],
            cdc.term_ns_ids.shape[1],
            cdc.epod_labels.shape[1],
        )
        if not ops_chain.caps_compatible(dc_shapes, pb):
            return None
        P = pb.valid.shape[0]
        append_terms = bool((pb.aff_kind != PAD).any())
        AT = pb.aff_kind.shape[1] if append_terms else 0
        if ch["e"] + P > cdc.epod_node.shape[0] or ch["m"] + P * AT > cdc.term_pod.shape[0]:
            # cursor overflow: grow the host axes, repack the placed pods,
            # and restart the chain once from that state
            self._chain = None
            m = self.mirror
            m._m_cap_max = max(m._m_cap_max, bucket_cap(max((ch["m"] + P * AT) * 2, 1), 1))
            m.e_cap_hint = max(m.e_cap_hint, ch["e"] + 2 * P)
            m._epod_slots = None
            m._existing_version = -1
            ch = self._restart_chain(epoch)
            cdc = ch["dc"]
            if ch["e"] + P > cdc.epod_node.shape[0] or ch["m"] + P * AT > cdc.term_pod.shape[0]:
                return None
        wt = self._wave_route(pb)
        wave_kw = {}
        if wt is not None:
            # no port batch reaches the chain, so the port carry stays off
            wave_kw = dict(wave=True, **self._wave_kw(wt, ports=False))
        db = DeviceBatch.from_host(pb, self.device)
        tables = self._gang_tables(pb)
        try:
            out = ops_chain.chain_dispatch(
                cdc,
                db,
                self._hostname_key(),
                ch["e"],
                ch["m"],
                bucket_cap(len(self.vocab.label_vals)),
                enabled=profile.enabled,
                weights=profile.weights(),
                append_terms=append_terms,
                # any term row in the chained cluster keeps inter-pod on
                **self._gang_flags(pb, ch["m"] > 0),
                **tables,
                **wave_kw,
            )
            dc2, results, reasons = out[:3]
            results = results.cpu()
        except BaseException:
            # the chained cluster may be torn: drop it, return the batch
            self._chain = None
            self.queue.push_back(batch)
            raise
        self._chain = {"dc": dc2, "e": ch["e"] + P, "m": ch["m"] + P * AT, "epoch": epoch}
        if wt is not None:
            self.metrics["wave_batches"] += 1
            self._wave_resolve(batch, results[0], out[3])
        else:
            self.metrics["chain_batches"] += 1
        return self._process_results(batch, results[0], results[1], reasons)

    def _restart_chain(self, epoch) -> dict:
        dc = self._dc_cache.sync(self.mirror, self.vocab)
        # the chain writes into these tensors: the device mirror must not
        # treat them as its own image again
        self._dc_cache.invalidate()
        return {"dc": dc, "e": self.mirror.e_used, "m": self.mirror.m_used, "epoch": epoch}

    def _schedule_direct(self, profile: Profile, batch) -> List[ScheduleOutcome]:
        """wave_run (a wave-shaped batch under waveDispatch) or gang_run on
        the snapshot the device mirror keeps current."""
        self._chain = None  # direct commits happen outside any chain
        self._repack_mirror()
        pods, pb = self._gang_prep(batch)
        try:
            wt = self._wave_route(pb)
            dc = self._dc_cache.sync(self.mirror, self.vocab)
            db = DeviceBatch.from_host(pb, self.device)
            tables = self._gang_tables(pb)
            any_terms = bool((self.mirror.existing.term_kind != PAD).any())
            flags = self._gang_flags(pb, any_terms)
            args = (dc, db, self._hostname_key(), bucket_cap(len(self.vocab.label_vals)))
            kw = dict(enabled=profile.enabled, weights=profile.weights(), **tables)
            stats = None
            if wt is not None:
                self.metrics["wave_batches"] += 1
                flags["has_ports"] = wt["has_ports"]  # the occupancy carry, not the pod×pod matrix
                chosen, n_feas, reasons, _, stats = ops_wave.wave_run(*args, **self._wave_kw(wt), **kw, **flags)
            else:
                self.metrics["scan_batches"] += 1
                chosen, n_feas, reasons, _ = ops_gang.gang_run(*args, **kw, **flags)
            chosen, n_feas = chosen.cpu(), n_feas.cpu()
        except BaseException:
            self._dc_cache.invalidate()
            self.queue.push_back(batch)
            raise
        if stats is not None:
            self._wave_resolve(batch, chosen, stats)
        return self._process_results(batch, chosen, n_feas, reasons)

    def _process_results(self, batch, chosen, n_feas, reasons) -> List[ScheduleOutcome]:
        """The gang path's harvest: placements are assumed and bound in bulk
        (the scan's decisions are final), every failure gets a FitError built
        from the first-failure reason counts."""
        names = self.nodes.names
        chosen = chosen.numpy()[: len(batch)]
        if ((chosen < -1) | (chosen >= len(names))).any():
            raise RuntimeError("gang scan returned a node index out of range")
        n = len(batch)
        self.metrics["schedule_attempts"] += n
        placed = [i for i in range(n) if chosen[i] >= 0]
        pairs = [(batch[i].pod, names[chosen[i]]) for i in placed]
        self.cache.assume_pods_bulk(pairs)
        self._nonfast_commits += len(pairs)
        errors = self._bind(pairs)
        out: List[Optional[ScheduleOutcome]] = [None] * n
        for i, (pod, node), err in zip(placed, pairs, errors):
            if err is None:
                out[i] = ScheduleOutcome(pod, node)
            else:
                self.cache.forget_pod(pod)
                self._external_mutations += 1
                self.queue.mark_unschedulable(batch[i])
                out[i] = ScheduleOutcome(pod, None, f"binding rejected: {err}")
        if len(placed) < n:
            counts = reasons.cpu().numpy()
            n_nodes = len(self.cache.real_nodes())
            for i in range(n):
                if chosen[i] >= 0:
                    continue
                diag = {k: int(c) for k, c in zip(ops_gang.DIAG_KERNELS, counts[i]) if c > 0}
                diag.pop("HostFilters", None)  # no host Filter plugins in the port
                self.queue.mark_unschedulable(batch[i])
                out[i] = ScheduleOutcome(batch[i].pod, None, fit_error_message(n_nodes, diag), diag)
        return out

    # ----- commit --------------------------------------------------------

    def _commit(self, holder: dict, batch, keys, pod_sigs, choices, rows) -> List[ScheduleOutcome]:
        """Bulk assume + bind of the placed pods; FitError outcomes (with
        per-plugin diagnosis at the committer's state) for the rest."""
        names = self.nodes.names
        n = len(batch)
        self.metrics["schedule_attempts"] += n
        placed = [i for i in range(n) if choices[i] >= 0]
        pairs = [(batch[i].pod, names[choices[i]]) for i in placed]
        self.cache.assume_pods_bulk(pairs)
        errors = self._bind(pairs)
        out: List[Optional[ScheduleOutcome]] = [None] * n
        for i, (pod, node), err in zip(placed, pairs, errors):
            if err is None:
                out[i] = ScheduleOutcome(pod, node)
            else:
                # the committer counted this pod: the forget is an external
                # change, so the next batch rebuilds the lineage
                self.cache.forget_pod(pod)
                self._external_mutations += 1
                self.queue.mark_unschedulable(batch[i])
                out[i] = ScheduleOutcome(pod, None, f"binding rejected: {err}")
        diag_cache: Dict[int, Dict[str, int]] = {}
        node_valid = self.nodes.valid
        n_nodes = len(self.cache.real_nodes())
        for i in range(n):
            if choices[i] >= 0:
                continue
            sig = pod_sigs[i]
            diag = diag_cache.get(id(sig))
            if diag is None:
                diag = diag_cache[id(sig)] = holder["fc"].diagnose(sig, rows[keys[i]], node_valid)
            self.queue.mark_unschedulable(batch[i])
            out[i] = ScheduleOutcome(batch[i].pod, None, fit_error_message(n_nodes, diag), diag)
        return out

    def _bind(self, pairs) -> List[Optional[str]]:
        if not pairs:
            return []
        if self.binding_sink_many is not None:
            return list(self.binding_sink_many(pairs))
        errors: List[Optional[str]] = []
        for pod, node in pairs:
            try:
                if self.binding_sink is not None:
                    self.binding_sink(pod, node)
                errors.append(None)
            except Exception as e:  # a rejected bind is this pod's outcome
                errors.append(str(e))
        return errors
