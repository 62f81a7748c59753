"""The port's Scheduler: the signature fast path, synchronously.

Follows the JAX package's fast route step for step (its scheduler.py
``_fast_gate_ok`` → ``_fast_sig_rows`` → ``_fast_dispatch`` →
``_finish_fast``), with ``residentDrain: false``:

1. pop a batch in queue order and gate it: every pod must be a fast-path
   pod (resources are its only batch-dynamic constraint);
2. key each pod by its signature (identical requests + static constraints);
3. evaluate the static rows of each NEW signature once (kernel K1), cached
   until the static snapshot changes;
4. extend the batch from the queue head with pods of known signatures;
5. place the batch: below ``fast_device_min`` pods on the host
   FastCommitter, else with kernel K2 on the device-resident usage tensors,
   followed by kernel K3's checksum against the host-tracked sum;
6. advance the committer, assume and bind in bulk, report outcomes.

Pods outside this slice raise NotImplementedError naming the ROADMAP item
that ports their path; a kernel failure or a checksum mismatch raises too.
Nothing falls back to another path by itself.  In both cases the batch goes
back to the queue unscheduled.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from kubernetes_tpu_torch import fastpath as fp
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.cache.cache import Cache, has_pod_terms
from kubernetes_tpu_torch.framework.config import Profile, SchedulerConfiguration
from kubernetes_tpu_torch.ops import fastpath as ops_fp
from kubernetes_tpu_torch.ops import resident as ops_res
from kubernetes_tpu_torch.ops import wire
from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster
from kubernetes_tpu_torch.queue.scheduling_queue import QueuedPodInfo, SchedulingQueue
from kubernetes_tpu_torch.snapshot.interner import Vocab
from kubernetes_tpu_torch.snapshot.schema import (
    NodeTensors,
    ResourceLanes,
    bucket_cap,
    pack_nodes,
    pack_pod_batch,
    write_usage_row,
)

GROUP_LABEL = "pod-group.scheduling.sigs.k8s.io/name"


@dataclass
class ScheduleOutcome:
    pod: Pod
    node: Optional[str]
    # "" when bound; else the FitError message or the bind error
    reason: str = ""
    # plugin name → count of nodes it rejected (unschedulable pods)
    diagnosis: Optional[Dict[str, int]] = None


# FitError reason strings keyed by plugin (framework/types.go:420-465)
_DIAG_REASONS = {
    "NodeUnschedulable": "node(s) were unschedulable",
    "NodeName": "node(s) didn't match the requested node name",
    "TaintToleration": "node(s) had untolerated taints",
    "NodeAffinity": "node(s) didn't match Pod's node affinity/selector",
    "NodeResourcesFit": "node(s) had insufficient resources",
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
            "static_evals": 0,
            "state_uploads": 0,
            "snapshot_packs": 0,
        }
        self.nodes: Optional[NodeTensors] = None
        self._external_mutations = 0  # cluster changes the committer can't see
        self._pack_token = 0  # bumped on every full pack
        self._packed_static = -1  # cache.static_version at the last pack
        self._packed_usage = -1  # _external_mutations at the last usage write
        self._static_dc = None
        self._static_dc_key = None
        self._sig_cache: Dict[object, dict] = {}
        self._sig_cache_key = None
        self._speckey_cache: Dict[tuple, object] = {}
        self._holder: Optional[dict] = None

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
        """Drain the active queue in fast batches; returns all outcomes."""
        outcomes: List[ScheduleOutcome] = []
        while True:
            batch = self.queue.pop_batch(self.config.batch_size)
            if not batch:
                break
            groups: Dict[str, List[QueuedPodInfo]] = {}
            for qp in batch:
                groups.setdefault(qp.pod.scheduler_name, []).append(qp)
            for name, group in groups.items():
                outcomes.extend(self._schedule_fast(self.profiles[name], group))
        return outcomes

    def _refusal(self, pod: Pod) -> Optional[str]:
        """Why a pod is outside this slice (None when it is a fast-path pod)."""
        if pod.topology_spread_constraints:
            return "topology spread constraints take the wave/gang path (ROADMAP A6)"
        if has_pod_terms(pod):
            return "inter-pod (anti-)affinity takes the wave/gang path (ROADMAP A6)"
        if pod.host_ports():
            return "host ports take the wave/gang path (ROADMAP A6)"
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
        if self.cache.n_term_pods:
            return "placed pods carry inter-pod terms, which the fast gate probes (ROADMAP A6)"
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

    def _schedule_fast(self, profile: Profile, batch: List[QueuedPodInfo]) -> List[ScheduleOutcome]:
        for qp in batch:
            why = self._refusal(qp.pod)
            if why is not None:
                self._refuse(batch, f"pod {qp.pod.key}: {why}")
        self._sync_snapshot()
        keys = [self._sig_key(qp.pod) for qp in batch]
        rows = self._fast_sig_rows(profile, batch, keys)

        # extend from the queue head with pods whose signatures are already
        # evaluated and argmax-neutral (a novel signature seeds a later batch)
        ext = self.config.fast_batch_max - len(batch)
        if ext > 0:
            def known(qp: QueuedPodInfo) -> bool:
                if qp.pod.scheduler_name != profile.scheduler_name:
                    return False
                if self._refusal(qp.pod) is not None:
                    return False
                row = rows.get(self._sig_key(qp.pod))
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

    def _sync_snapshot(self) -> None:
        """Pack the node snapshot when a Node object changed; rewrite the
        usage columns when placed pods changed outside the fast path."""
        real = self.cache.real_nodes()
        if self.nodes is None or self._packed_static != self.cache.static_version:
            self.nodes = pack_nodes([cn.node for cn in real], self.vocab)
            self._packed_static = self.cache.static_version
            self._packed_usage = -1
            self._pack_token += 1
            self.metrics["snapshot_packs"] += 1
        if self._packed_usage != self._external_mutations:
            for cn in real:
                write_usage_row(
                    self.nodes,
                    self.nodes.name_to_idx[cn.node.name],
                    cn.requested,
                    cn.non_zero_requested,
                    len(cn.pods),
                    self.vocab,
                )
            self._packed_usage = self._external_mutations

    def _static_device_cluster(self) -> DeviceCluster:
        """The node snapshot on the device, for static reads only: usage
        churn does not re-upload it."""
        key = (self._pack_token, len(self.vocab.label_vals))
        if self._static_dc_key != key:
            self._static_dc = DeviceCluster.from_host(self.nodes, self.vocab, self.device)
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

    def _fast_sig_rows(self, profile: Profile, batch, keys) -> Dict[object, dict]:
        """Static rows (masks + raw scores) per signature, cached until the
        snapshot is repacked.  Signatures whose static score raws vary over
        their feasible set are outside the fast path (normalization would
        depend on the batch state; JAX sends them to the gang scan)."""
        dc_key = (self._pack_token, profile.scheduler_name)
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
        for k, qp in zip(keys, batch):
            if not cache[k]["const_ok"]:
                self._refuse(
                    batch,
                    f"pod {qp.pod.key}: its static scores vary over its feasible "
                    "nodes, which takes the gang scan (ROADMAP A6)",
                )
        return cache

    # ----- the committer lineage ------------------------------------------

    def _lineage(self, profile: Profile, weights, check_fit: bool) -> dict:
        """The host committer and its device twin.  Only an external cluster
        change, a repack or another profile rebuilds it; fast commits keep
        it (the committer is the committed truth)."""
        key = (self._external_mutations, self._pack_token, profile.scheduler_name, weights, check_fit)
        h = self._holder
        if h is None or h["key"] != key:
            h = self._holder = {
                "key": key,
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
        if self.config.resident_drain:
            self._refuse(
                batch,
                "residentDrain: true places device batches with resident_run, "
                "which is not ported yet (ROADMAP B3); set resident_drain=False",
            )
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
        """One K2 launch for the whole batch, then K3, then the replay of
        the choices into the host committer."""
        fc = holder["fc"]
        if holder["stack"] is None:
            self._stack_signatures(holder)
        # p_cap quantized to three levels, as the reference's kernel shapes
        need = len(batch)
        for level in (64, 512, self.config.fast_batch_max):
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
        choices_dev, _ = ops_fp.sig_scan(
            ids, st.req, st.nz, st.az, st.ok, st.img, us.alloc, us.allowed,
            us.used, us.nz0, us.nz1, us.num_pods,
            w_fit=weights[4],
            w_bal=weights[5],
            w_img=weights[6] if holder["any_img"] else 0,
            check_fit=check_fit,
        )
        csum_dev = None
        if self.config.resident_epoch_guard:
            csum_dev = ops_res.usage_checksum(us.used, us.nz0, us.nz1, us.num_pods)
        choices_np = choices_dev.cpu().numpy()[: len(batch)].astype(np.int64)
        if ((choices_np < -1) | (choices_np >= fc.n)).any():
            raise RuntimeError("sig_scan returned a node index out of range")
        self.metrics["device_batches"] += 1

        # per-node aggregates of this batch's commits
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
        return choices_np.tolist()

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
