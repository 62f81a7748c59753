"""The port's Scheduler: the signature fast path, the speculative wave, the
gang scan and the workloads dispatch for PodGroup gangs, synchronously.

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
3. the DIRECT dispatch: everything else, on the snapshot the device mirror
   keeps current (K1 + K6 + K7 for the statics).  A batch with members of
   registered PodGroups takes the WORKLOADS dispatch first under the
   default ``gangDispatch: true`` (``_try_dispatch_workloads``: the quorum
   and timeout barrier, plan_batch's canonical order, one
   ``workloads_run``, K8 speculating and K11 admitting each gang all or
   nothing); the rest takes ``wave_run`` or ``gang_run``.  Gang members,
   registered or not, stay off the chained and the fast routes, and a
   popped batch pulls in the active siblings of its gangs.

Pods with bound PVCs (StatefulSet replicas on zonal disks) ride the
workloads dispatch too, beside gang members and plain pods: the profile's
host Filter plugins (framework/runtime.py, the four volume plugins) run
their PreFilter on the batch, K12 folds every bound PV's node-affinity DNF
(and a zone-labelled PV's zone set) into the precompute's host-filter lane,
a placed volume pod's PreFilter and host Filters are replayed on its chosen
node before Reserve, and a rejected one's FitError names the volume node
affinity conflict.  Under the DynamicResourceAllocation gate, pods with
ResourceClaims ride it as well: the DynamicResources host plugin runs its
PreFilter on the batch, ``_dra_tables`` packs the batch's claims over the
whole claim cache, K13 matches every request slot against every device,
K14 gives the speculation its DRA lane and K11 allocates in the admission
(the ``free`` and ``claim_node`` carries, in the gang checkpoint too); a
placed claims pod is replayed through PreFilter and Filter on its node
before Reserve and PreBind (the claim write, ``claim_writer``), and a
rejected one's FitError says "cannot allocate all devices".  With the gate
off, claims are ignored.  Pods a host Filter could act on stay off the
chained and the fast routes, and a batch the workloads dispatch declines is
split: such pods retry it one by one.

On the chained and the direct route, a batch whose pods carry their own
cross-pod constraints (spread, inter-pod terms, host ports) takes the
speculative wave under the default ``waveDispatch: true`` (K8 speculates
every pod against the frozen snapshot, K9 admits them in queue order over
the term-factored carries; ``_wave_resolve`` turns its stats into the
``wave_*`` metrics).  Such a batch takes the gang scan (K5) instead when
two nodes share a hostname label value or ``wave_dispatch=False``; both
fallbacks are counted (``wave_fallback_dup_hostname`` /
``wave_fallback_kill_switch``).  Other gang-path batches take the scan.

As in the reference's loop, a chained batch's harvest (placements assumed
and bound, failures diagnosed and sent to PostFilter) trails its dispatch:
up to two chained batches stay in flight, and a small fast batch waits for
the next dispatch; the pipeline settles before anything that reads the
committed state (a chain restart, a fast lineage rebuild, the direct path).
The device work itself is synchronous (ROADMAP A3).  Gang commits
invalidate the fast lineage and the mirror's usage rows; fast batches end
the chain.

Preemption (the default profile's PostFilter, DefaultPreemption): a gang
or wave harvest's failed pods are first narrowed by kernel K10
(``_batched_preemption_narrow``), as in the reference (fast and workloads
harvests are not: the dry run sizes its candidate window from the
potential-node list), then each failure in queue order runs the
evaluator's dry run on the host (framework/preemption.py).  Its victims are
evicted through ``pod_deleter`` and the pod is nominated; while the
nomination is open every gang-path batch charges it to its node for pods of
lower or equal priority (K5, K8, K9 and K11), pods of such priority stay off the
fast path, and the preemptor itself, back from its backoff, takes the
nominated-node path (``_schedule_one_nominated``).

The reference's bit-compat knobs route as there.  With the sampling window
or a tie-break seed active (``percentage_of_nodes_to_score`` > 0,
``reference_sampling_compat`` or ``tie_break_seed``) a batch stays off the
fast path, the chained and the workloads dispatch (gang members schedule
one by one) and takes the direct ``gang_run`` or ``wave_run`` with the
window's size ``sample_k``, the rotation cursor and the attempt counter;
after the batch the cursor comes back from the kernel's tallies and the
counter advances by the batch's length.  A profile's NodeResourcesFit
strategy other than LeastAllocated keeps batches off the fast path and
reaches every other route's kernels as ``fit_strategy``; one that weighs
resources beyond cpu and memory sends every pod to the one-pod host cycle,
which scores with the strategy on the host.  The one-pod host cycle
(``_schedule_one_host``) takes the window and the tie-break too, drawing
the tie bits with kernel K19.

Pods outside the ported paths raise NotImplementedError naming the ROADMAP
item that ports them (scheduling gates, or a ResourceClaim that does not
exist yet: A5, the PreEnqueue tier; an unbound, missing or
WaitForFirstConsumer PVC, a ReadWriteOncePod claim or an inline
single-attach disk, a CSI volume beside a CSINode, a volume or claims pod
with host ports, under duplicate hostnames or with ``gangDispatch`` off:
A6b, the host-veto split path); a kernel failure or a checksum mismatch
raises too.
Nothing falls back to another path by itself, and the batch goes back to
the queue unscheduled.
"""

from __future__ import annotations

import hashlib
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from kubernetes_tpu_torch import fastpath as fp
from kubernetes_tpu_torch.api import labels as k8slabels
from kubernetes_tpu_torch.api import dra as dra_api
from kubernetes_tpu_torch.api import storage as storage_api
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.cache.cache import Cache
from kubernetes_tpu_torch.cache.device_mirror import DeviceClusterCache
from kubernetes_tpu_torch.cache.mirror import HOSTNAME_LABEL, SnapshotMirror
from kubernetes_tpu_torch.framework.config import Profile, SchedulerConfiguration
from kubernetes_tpu_torch.framework.interface import ActionType, ClusterEvent, Code, CycleState, EventResource, Status
from kubernetes_tpu_torch.framework.dynamicresources import REASON_CANNOT_ALLOCATE
from kubernetes_tpu_torch.framework.plugins import QUEUEING_HINTS, DefaultPreemption, default_plugins
from kubernetes_tpu_torch.framework.runtime import Framework
from kubernetes_tpu_torch.framework.volume_plugins import SINGLE_ATTACH_KINDS, zone_value_set
from kubernetes_tpu_torch.observability.flightrecorder import FlightRecorder
from kubernetes_tpu_torch.ops import chain as ops_chain
from kubernetes_tpu_torch.ops import coscheduling as ops_cos
from kubernetes_tpu_torch.ops import dra as ops_dra
from kubernetes_tpu_torch.ops import fastpath as ops_fp
from kubernetes_tpu_torch.ops import gang as ops_gang
from kubernetes_tpu_torch.ops import preemption as ops_preemption
from kubernetes_tpu_torch.ops import resident as ops_res
from kubernetes_tpu_torch.ops import rng as ops_rng
from kubernetes_tpu_torch.ops import wave as ops_wave
from kubernetes_tpu_torch.ops import wire
from kubernetes_tpu_torch.ops.common import DeviceBatch, DeviceCluster, DTable
from kubernetes_tpu_torch.oracle.pipeline import feasible_nodes, num_feasible_nodes_to_find, prioritize, select_host
from kubernetes_tpu_torch.oracle.state import NodeState, OracleState
from kubernetes_tpu_torch.queue.nominator import Nominator
from kubernetes_tpu_torch.queue.scheduling_queue import QueuedPodInfo, SchedulingQueue
from kubernetes_tpu_torch.snapshot.interner import PAD, Vocab
from kubernetes_tpu_torch.snapshot.schema import (
    NodeTensors,
    ResourceLanes,
    bucket_cap,
    pack_conjunction_table,
    pack_pod_batch,
)
from kubernetes_tpu_torch.snapshot.selectors import METADATA_NAME_KEY, CompiledRequirements, compile_node_selector_dnf
from kubernetes_tpu_torch.util.assumecache import AssumeCache
from kubernetes_tpu_torch.workloads import gang as wlg

INT32_MIN = -(2**31)
# the host-filter lane of a workloads batch is the volume-topology mask
VOLUME_CONFLICT = "node(s) had volume node affinity conflict"
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


class _Handle:
    """What the preemption evaluator and the host plugins read of the
    scheduler (framework.Handle): the host view, the nominator, the eviction
    and PDB hooks, queue activation, the preemption metrics, the profile's
    host plugins, and the storage and DRA caches and listers."""

    def __init__(self, sched: "Scheduler"):
        self._s = sched

    @property
    def claim_cache(self) -> AssumeCache:
        return self._s.claim_cache

    def list_resource_slices(self):
        return list(self._s.resource_slices.values())

    def get_device_class(self, name: str):
        return self._s.device_classes.get(name)

    def write_claim(self, claim) -> None:
        """The claim's status write (PreBind's allocation and reservation,
        Unreserve's rollback)."""
        self._s.claim_writer(claim)

    @property
    def pv_cache(self) -> AssumeCache:
        return self._s.pv_cache

    @property
    def pvc_cache(self) -> AssumeCache:
        return self._s.pvc_cache

    def get_storage_class(self, name: str):
        return self._s.storage_classes.get(name)

    def get_csinode(self, name: str):
        return self._s.csinodes.get(name)

    def framework_for(self, pod: Pod) -> Optional[Framework]:
        return self._s.frameworks.get(pod.scheduler_name)

    def oracle_state(self) -> OracleState:
        return self._s.oracle_view()

    @property
    def nominator(self) -> Nominator:
        return self._s.nominator

    def delete_pod(self, pod: Pod) -> None:
        """Victim eviction, the preemption API write (preemption.go:380)."""
        self._s.pod_deleter(pod)

    def list_pdbs(self):
        return self._s.pdb_lister()

    def activate(self, pods) -> None:
        self._s.queue.activate(pods)

    def note_preemption(self, n_victims: int) -> None:
        m = self._s.metrics
        m["preemption_attempts"] += 1
        m["preemption_victims"] += n_victims


class Scheduler:
    def __init__(
        self,
        configuration: Optional[SchedulerConfiguration] = None,
        binding_sink: Optional[Callable[[Pod, str], None]] = None,
        device=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.device = resolve_device(device)
        self.config = configuration or SchedulerConfiguration()
        self.config.validate()
        self.profiles: Dict[str, Profile] = {
            p.scheduler_name: p for p in self.config.profiles
        }
        self.clock = clock
        self.cache = Cache()
        self.queue = SchedulingQueue(QUEUEING_HINTS, clock)
        self.nominator = Nominator()
        self.vocab = Vocab()
        # bind one pod (raises on failure), or, when set, bind a whole batch:
        # binding_sink_many(pairs) -> [None or error per pair]
        self.binding_sink = binding_sink
        self.binding_sink_many = None
        # victim eviction (often on_pod_delete itself), the PDBs the dry run
        # honours, and the pod-status write of a nomination
        self.pod_deleter: Callable[[Pod], None] = lambda pod: None
        self.pdb_lister: Callable[[], list] = lambda: []
        self.status_patcher: Callable[[Pod], None] = lambda pod: None
        # PVs and PVCs (assume caches), StorageClasses and CSINodes by name
        self.pv_cache: AssumeCache = AssumeCache("pv")
        self.pvc_cache: AssumeCache = AssumeCache("pvc")
        self.storage_classes: Dict[str, storage_api.StorageClass] = {}
        self.csinodes: Dict[str, storage_api.CSINode] = {}
        # ResourceClaims (an assume cache), ResourceSlices and DeviceClasses
        # by name, in informer order (the slices' order is the allocator's
        # enumeration order), and the claim status write
        self.claim_cache: AssumeCache = AssumeCache("resource claims")
        self.resource_slices: Dict[str, dra_api.ResourceSlice] = {}
        self.device_classes: Dict[str, dra_api.DeviceClass] = {}
        self.claim_writer: Callable[[dra_api.ResourceClaim], None] = lambda claim: None
        handle = _Handle(self)
        # each profile's host plugins (the volume plugins, and DynamicResources
        # under the DynamicResourceAllocation gate)
        self.frameworks: Dict[str, Framework] = {
            p.scheduler_name: Framework(default_plugins(self.config.feature_gates), handle)
            for p in self.config.profiles
        }
        self._post_filters: Dict[str, DefaultPreemption] = {
            p.scheduler_name: DefaultPreemption(
                handle, p.min_candidate_nodes_percentage, p.min_candidate_nodes_absolute
            )
            for p in self.config.profiles
            if p.post_filter
        }
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
            "preemption_attempts": 0,  # PostFilters that chose a node
            "preemption_victims": 0,  # pods those evicted
            "narrow_batches": 0,  # harvests whose failures K10 narrowed
            "nominated_binds": 0,  # preemptors bound on the nominated-node path
            "host_cycles": 0,  # one-pod host scheduling cycles
            "workload_batches": 0,  # workloads_run dispatches
            "workload_spec_admitted": 0,  # placed pods whose admitted node is the speculative one
            "gang_admitted": 0,  # members placed by admitted gangs
            "gang_rolled_back": 0,  # gangs rolled back whole
            "dra_pods": 0,  # claims pods the workloads dispatch placed
            "dra_claims_allocated": 0,  # claims it allocated (a shared claim once)
            "plan_runs": 0,  # simulate_forks calls (planner/plan.py)
            "plan_forks": 0,  # forks they simulated
            "plan_seconds": 0.0,  # their wall time
            # kernel-engine planner runs the serial engine took, by reason
            "plan_serial_dup_hostname": 0,
            "plan_serial_wave_tables": 0,
        }
        # PodGroups and the members placed per gang
        self.gangs = wlg.GangDirectory(clock)
        # the per-pod flight recorder (the wave's demotions and upgrades)
        self.flight = FlightRecorder()
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
        self._oracle_cache: Optional[OracleState] = None
        # (queued pod, node, outcome) assumed but not yet bound
        self._bind_buffer: List[tuple] = []
        # the sampling window's rotation cursor (nextStartNodeIndex), the
        # tie-break's attempt counter and its key, built once from the seed
        self._next_start_node_index = 0
        self._attempt_counter = 0
        self._tie_key = None if self.config.tie_break_seed is None else ops_rng.prng_key(self.config.tie_break_seed)

    @property
    def nodes(self) -> Optional[NodeTensors]:
        return self.mirror.nodes

    # ----- informer events ---------------------------------------------------

    def on_node_add(self, node: Node) -> None:
        self._invalidate_view()
        self._external_mutations += 1
        self.cache.add_node(node)
        self.queue.move_all_on_event(ClusterEvent(EventResource.NODE, ActionType.ADD), None, node)

    def on_pod_add(self, pod: Pod) -> None:
        if pod.node_name:
            self.gangs.note_placed(pod)
            if pod.uid in self.cache.pod_states:
                self._invalidate_view()
            else:
                self._view_pod_added(pod)
            self.cache.add_pod(pod)
            self._external_mutations += 1
            self.queue.move_all_on_event(ClusterEvent(EventResource.ASSIGNED_POD, ActionType.ADD), None, pod)
        elif pod.scheduler_name in self.profiles:
            self.queue.add(pod)
            # a new member can complete a waiting gang's quorum: its
            # siblings leave the unschedulable pods on the group's event
            key = wlg.group_key_of(pod)
            pg = self.gangs.get(key) if key is not None else None
            if pg is not None:
                self.queue.move_all_on_event(ClusterEvent(EventResource.POD_GROUP, ActionType.UPDATE), pg, pg)

    def on_pod_delete(self, pod: Pod) -> None:
        """Informer delete (and the usual ``pod_deleter`` of an eviction): a
        placed pod leaves the cache, the host view, the mirror's usage and
        placed-pod tensors at the next sync, and the chain (its epoch moves);
        pods its rejecting plugins registered for requeue.  A pending pod
        leaves the queue.  Either way its nomination ends and, for a gang
        member, its gang's count of placed members forgets it."""
        self.gangs.note_removed(pod)
        if pod.node_name:
            self._external_mutations += 1
            old = self.cache.pod_states.get(pod.uid)
            self._view_pod_removed(old if old is not None else pod)
            self.cache.remove_pod(pod)
            self.queue.move_all_on_event(ClusterEvent(EventResource.ASSIGNED_POD, ActionType.DELETE), pod, None)
        else:
            self.queue.delete(pod)
        self.nominator.delete(pod)

    def on_pod_group_add(self, pg: wlg.PodGroup) -> None:
        """PodGroup informer add: the group registers, and pods its gate
        rejected requeue on the event (the Coscheduling hint)."""
        self.gangs.upsert(pg)
        self.queue.move_all_on_event(ClusterEvent(EventResource.POD_GROUP, ActionType.ADD), None, pg)

    def on_pod_group_update(self, old: wlg.PodGroup, new: wlg.PodGroup) -> None:
        self.gangs.upsert(new)
        self.queue.move_all_on_event(ClusterEvent(EventResource.POD_GROUP, ActionType.UPDATE), old, new)

    def on_pod_group_delete(self, pg: wlg.PodGroup) -> None:
        """The group unregisters: its members schedule as ordinary pods."""
        self.gangs.delete(pg.key)
        self.queue.move_all_on_event(ClusterEvent(EventResource.POD_GROUP, ActionType.DELETE), pg, None)

    # storage informers (eventhandlers.go:431-602): feed the cache or the
    # lister, then requeue through the volume plugins' queueing hints

    def _storage_event(self, resource: EventResource, action: ActionType, old, new) -> None:
        self.queue.move_all_on_event(ClusterEvent(resource, action), old, new)

    def on_pv_add(self, pv: storage_api.PersistentVolume) -> None:
        self.pv_cache.on_add(pv)
        self._storage_event(EventResource.PV, ActionType.ADD, None, pv)

    def on_pv_update(self, old: storage_api.PersistentVolume, new: storage_api.PersistentVolume) -> None:
        self.pv_cache.on_update(old, new)
        self._storage_event(EventResource.PV, ActionType.UPDATE, old, new)

    def on_pv_delete(self, pv: storage_api.PersistentVolume) -> None:
        self.pv_cache.on_delete(pv)
        self._storage_event(EventResource.PV, ActionType.DELETE, pv, None)

    def on_pvc_add(self, pvc: storage_api.PersistentVolumeClaim) -> None:
        self.pvc_cache.on_add(pvc)
        self._storage_event(EventResource.PVC, ActionType.ADD, None, pvc)

    def on_pvc_update(self, old: storage_api.PersistentVolumeClaim, new: storage_api.PersistentVolumeClaim) -> None:
        self.pvc_cache.on_update(old, new)
        self._storage_event(EventResource.PVC, ActionType.UPDATE, old, new)

    def on_pvc_delete(self, pvc: storage_api.PersistentVolumeClaim) -> None:
        self.pvc_cache.on_delete(pvc)
        self._storage_event(EventResource.PVC, ActionType.DELETE, pvc, None)

    def on_storage_class_add(self, sc: storage_api.StorageClass) -> None:
        self.storage_classes[sc.key] = sc
        self._storage_event(EventResource.STORAGE_CLASS, ActionType.ADD, None, sc)

    def on_storage_class_update(self, old: storage_api.StorageClass, new: storage_api.StorageClass) -> None:
        self.storage_classes[new.key] = new
        self._storage_event(EventResource.STORAGE_CLASS, ActionType.UPDATE, old, new)

    def on_storage_class_delete(self, sc: storage_api.StorageClass) -> None:
        self.storage_classes.pop(sc.key, None)
        self._storage_event(EventResource.STORAGE_CLASS, ActionType.DELETE, sc, None)

    def on_csinode_add(self, cn: storage_api.CSINode) -> None:
        self.csinodes[cn.key] = cn
        self._storage_event(EventResource.CSI_NODE, ActionType.ADD, None, cn)

    def on_csinode_update(self, old: storage_api.CSINode, new: storage_api.CSINode) -> None:
        self.csinodes[new.key] = new
        self._storage_event(EventResource.CSI_NODE, ActionType.UPDATE, old, new)

    def on_csinode_delete(self, cn: storage_api.CSINode) -> None:
        self.csinodes.pop(cn.key, None)
        self._storage_event(EventResource.CSI_NODE, ActionType.DELETE, cn, None)

    # DRA informers: claims feed the assume cache, slices and classes their
    # listers; then the DynamicResources hints requeue

    def on_resource_claim_add(self, claim: dra_api.ResourceClaim) -> None:
        self.claim_cache.on_add(claim)
        self._storage_event(EventResource.RESOURCE_CLAIM, ActionType.ADD, None, claim)

    def on_resource_claim_update(self, old: dra_api.ResourceClaim, new: dra_api.ResourceClaim) -> None:
        self.claim_cache.on_update(old, new)
        self._storage_event(EventResource.RESOURCE_CLAIM, ActionType.UPDATE, old, new)

    def on_resource_claim_delete(self, claim: dra_api.ResourceClaim) -> None:
        self.claim_cache.on_delete(claim)
        self._storage_event(EventResource.RESOURCE_CLAIM, ActionType.DELETE, claim, None)

    def on_resource_slice_add(self, sl: dra_api.ResourceSlice) -> None:
        self.resource_slices[sl.key] = sl
        self._storage_event(EventResource.RESOURCE_SLICE, ActionType.ADD, None, sl)

    def on_resource_slice_update(self, old: dra_api.ResourceSlice, new: dra_api.ResourceSlice) -> None:
        self.resource_slices[new.key] = new
        self._storage_event(EventResource.RESOURCE_SLICE, ActionType.UPDATE, old, new)

    def on_resource_slice_delete(self, sl: dra_api.ResourceSlice) -> None:
        self.resource_slices.pop(sl.key, None)
        self._storage_event(EventResource.RESOURCE_SLICE, ActionType.DELETE, sl, None)

    def on_device_class_add(self, cls: dra_api.DeviceClass) -> None:
        self.device_classes[cls.key] = cls
        self._storage_event(EventResource.DEVICE_CLASS, ActionType.ADD, None, cls)

    def on_device_class_update(self, old: dra_api.DeviceClass, new: dra_api.DeviceClass) -> None:
        self.device_classes[new.key] = new
        self._storage_event(EventResource.DEVICE_CLASS, ActionType.UPDATE, old, new)

    def on_device_class_delete(self, cls: dra_api.DeviceClass) -> None:
        self.device_classes.pop(cls.key, None)
        self._storage_event(EventResource.DEVICE_CLASS, ActionType.DELETE, cls, None)

    # ----- the host view -----------------------------------------------------

    def _invalidate_view(self) -> None:
        self._oracle_cache = None

    def _view_pod_added(self, pod: Pod) -> None:
        st = self._oracle_cache
        if st is None:
            return
        ns = st.nodes.get(pod.node_name)
        if ns is None:
            self._oracle_cache = None
        else:
            ns.add_pod(pod)

    def _view_pod_removed(self, pod: Pod) -> None:
        st = self._oracle_cache
        if st is None:
            return
        ns = st.nodes.get(pod.node_name)
        if ns is None or not ns.remove_pod(pod):
            self._oracle_cache = None

    def oracle_view(self) -> OracleState:
        """The cache as host objects (nodes and their placed pods, in cache
        order) for the preemption dry run and the one-pod host cycle.  Built
        on first use and patched in place by every assume, forget and pod
        event; a node event drops it."""
        if self._oracle_cache is None:
            st = OracleState()
            for cn in self.cache.real_nodes():
                ns = NodeState(node=cn.node)
                for p in cn.pods.values():
                    ns.add_pod(p)
                st.nodes[cn.node.name] = ns
            self._oracle_cache = st
        return self._oracle_cache

    # ----- the explain surface (observability/explain.py) -------------------

    def post_filter(self, profile: Profile) -> Optional[DefaultPreemption]:
        """The profile's PostFilter plugin (its preemption ``evaluator``), or
        None when the profile has none."""
        return self._post_filters.get(profile.scheduler_name)

    def run_pre_filter(self, profile: Profile, state: CycleState, pods) -> Dict[str, Status]:
        """The profile's PreFilter point in the reference's plugin order
        (runtime/framework.go:698): NodeAffinity first, a Skip for a pod
        with neither required node affinity nor a nodeSelector, else its
        metadata.name narrowing (node_affinity.go:140-171), an empty one
        rejecting the pod as unresolvable; then the host plugins'
        PreFilters.  uid → the rejecting Status; a pod that passes with a
        narrowing gets it in ``state`` as ("pre_filter_result", uid)."""
        fwk = self.frameworks[profile.scheduler_name]
        failures: Dict[str, Status] = {}
        for pod in pods:
            allowed = None
            if "NodeAffinity" in profile.enabled:
                aff = pod.affinity
                required = aff.node_affinity.required_during_scheduling_ignored_during_execution if (
                    aff and aff.node_affinity) else None
                if required is None and not pod.node_selector:
                    state.mark_skip_filter(pod.uid, "NodeAffinity")
                else:
                    allowed = self._prefilter_allowed(pod)
                    if allowed is not None and not allowed:
                        failures[pod.uid] = Status.unresolvable(
                            "node(s) didn't satisfy plugin NodeAffinity's node-name narrowing", plugin="NodeAffinity")
                        continue
            host = fwk.run_pre_filter(state, [pod])
            if host:
                failures.update(host)
                continue
            if allowed is not None:
                state.write(("pre_filter_result", pod.uid), allowed)
        return failures

    # ----- the drain -----------------------------------------------------

    def schedule_pending(self) -> List[ScheduleOutcome]:
        """Drain the active queue (backoff expired by the clock included);
        returns all outcomes."""
        # pre-size the placed-pod axes for the whole drain, so a growing
        # drain keeps one shape
        self.mirror.e_cap_hint = max(
            self.mirror.e_cap_hint, len(self.cache.pod_states) + len(self.queue) + self.config.batch_size
        )
        outcomes: List[ScheduleOutcome] = []
        pending: deque = deque()  # dispatched batches awaiting their harvest

        def flush(keep: int = 0) -> None:
            while len(pending) > keep:
                rec = pending.popleft()
                if rec["kind"] == "fast":
                    outcomes.extend(self._finish_fast(rec))
                else:
                    outcomes.extend(self._finish_chained(rec))

        try:
            while True:
                batch = self.queue.pop_batch(self.config.batch_size)
                if batch and self.config.gang_dispatch:
                    # a gang split across popped batches is judged in one
                    batch.extend(self._pull_gang_siblings(batch))
                if not batch:
                    break
                groups: Dict[str, List[QueuedPodInfo]] = {}
                for qp in batch:
                    groups.setdefault(qp.pod.scheduler_name, []).append(qp)
                for name, group in groups.items():
                    self._schedule_group(self.profiles[name], group, pending, flush, outcomes)
                self._flush_binds()
            flush(0)
        except BaseException:
            # what was dispatched is still harvested, and what was committed
            # is bound (their decisions stand)
            flush(0)
            self._flush_binds()
            raise
        return outcomes

    def _schedule_group(self, profile: Profile, batch, pending, flush, outcomes) -> None:
        """One profile's share of a popped batch, routed as the reference's
        loop routes it: the chained dispatch, else the fast path, else (the
        pipeline settled) the direct path."""
        for qp in batch:
            why = self._refusal(qp.pod)
            if why is not None:
                flush(0)
                self._refuse(batch, f"pod {qp.pod.key}: {why}")
        fwk = self.frameworks[profile.scheduler_name]
        if any(fwk.maybe_relevant(qp.pod) for qp in batch):
            # such a batch takes the direct path (the pipelined gates exclude
            # it): settle the pipeline, then read the workloads dispatch's
            # precondition from the mirror it dispatches on
            flush(0)
            self._sync_mirror_external()
            if not self.mirror.hostnames_unique:
                self._refuse(batch, "volume and claims pods under duplicate hostname labels need the host-veto "
                                    "split path (ROADMAP A6b)")
        if self._chain_quickcheck(profile, batch):
            rec = self._try_dispatch_chained(profile, batch, can_restart=not pending)
            if rec == "flush":
                flush(0)
                rec = self._try_dispatch_chained(profile, batch, can_restart=True)
            if rec is not None:
                pending.append(rec)
                flush(2)
                return
        rec = self._try_fast(
            profile,
            batch,
            chain_settled=not any(r["kind"] != "fast" for r in pending),
            pipeline_empty=not pending,
        )
        if rec == "flush":
            flush(0)
            rec = self._try_fast(profile, batch, chain_settled=True, pipeline_empty=True)
        if rec is not None:
            pending.append(rec)
            # a resident run may finish its tail on the host committer, after
            # which the device state is stale: harvest it at once
            flush(0 if rec["resident"] and not self.config.resident_serial_tail else 2)
            return
        flush(0)
        self._chain = None
        outcomes.extend(self._schedule_batch(profile, batch))

    def _refusal(self, pod: Pod) -> Optional[str]:
        """Why a pod is outside the ported paths (None when it is inside).
        A pod no host Filter could act on (no volumes, or only emptyDir /
        configMap ones, and claims only with the DynamicResourceAllocation
        gate off, which ignores them) is inside; a volume pod is inside when
        its claims take the workloads route's K12 mask (all bound, their PVs
        present), a claims pod when all its ResourceClaims exist, and
        nothing else keeps either on the reference's host-veto split path."""
        if pod.scheduling_gates:
            return "scheduling gates need the PreEnqueue queue tier (ROADMAP A5)"
        fwk = self.frameworks.get(pod.scheduler_name)
        if fwk is None or not fwk.maybe_relevant(pod):
            return None
        profile = self.profiles[pod.scheduler_name]
        if self._sampling_active(profile) and not self._host_fit(profile):
            # the reference vetoes such a pod's nodes on the host into the
            # direct dispatch (the workloads dispatch is off under sampling)
            return ("a volume or claims pod under the sampling window or a tie-break seed needs the host-veto "
                    "split path (ROADMAP A6b)")
        if pod.resource_claims and self.config.dra_enabled():
            for name in pod.resource_claims:
                if self.claim_cache.get(f"{pod.namespace}/{name}") is None:
                    return (f'resourceclaim "{name}" does not exist: the pod waits for it in the '
                            "PreEnqueue queue tier (ROADMAP A5)")
            why = self._claims_refusal(pod)
            if why is not None:
                return f"{why} (ROADMAP A6b: the host-veto split path)"
        if not any(p.maybe_relevant(pod) for p in fwk.host_filter_plugins() if p.name != "DynamicResources"):
            return None
        why = self._volume_refusal(pod)
        return None if why is None else f"{why} (ROADMAP A6b: the host-veto split path)"

    def _claims_refusal(self, pod: Pod) -> Optional[str]:
        if not self.config.gang_dispatch:
            return "claims pods need the workloads dispatch, and gangDispatch is off"
        if pod.host_ports():
            return "a claims pod with host ports needs the host Filter plugins beside the port carry"
        return None

    def _volume_refusal(self, pod: Pod) -> Optional[str]:
        if not self.config.gang_dispatch:
            return "volume pods need the workloads dispatch, and gangDispatch is off"
        if any(v.source_kind in SINGLE_ATTACH_KINDS for v in pod.volumes):
            return "an inline single-attach disk needs VolumeRestrictions' host Filter"
        if not pod.pvc_names():
            return "an inline CSI volume needs NodeVolumeLimits' host Filter"
        if self.csinodes:
            return "a CSI volume beside a registered CSINode needs NodeVolumeLimits' host Filter"
        if pod.host_ports():
            return "a volume pod with host ports needs the host Filter plugins beside the port carry"
        for name in pod.pvc_names():
            pvc = self.pvc_cache.get(f"{pod.namespace}/{name}")
            if pvc is None:
                return f"claim {name} is missing"
            if not pvc.is_fully_bound():
                sc = self.storage_classes.get(pvc.storage_class_name or "")
                mode = "WaitForFirstConsumer" if sc is not None and sc.is_wait_for_first_consumer() else "unbound"
                return f"claim {name} is {mode}"
            if storage_api.RWOP in pvc.access_modes:
                return f"claim {name} is ReadWriteOncePod, which needs VolumeRestrictions' host Filter"
            if self.pv_cache.get(pvc.volume_name) is None:
                return f"claim {name}'s PV {pvc.volume_name} is missing"
        return None

    # ----- sampling, tie-break and fit strategy --------------------------

    def _window_pct(self, profile: Profile) -> Optional[int]:
        """The percentage the sampling window is sized with (the profile's,
        else the configuration's; 0 is adaptive), or None when it is off."""
        pct = profile.percentage_of_nodes_to_score
        if pct is None:
            pct = self.config.percentage_of_nodes_to_score
        return pct if pct > 0 or self.config.reference_sampling_compat else None

    def _sampling_active(self, profile: Profile) -> bool:
        """The sampling window or the seeded tie-break is on."""
        return self._window_pct(profile) is not None or self.config.tie_break_seed is not None

    def _sampling_args(self, profile: Profile) -> dict:
        """gang_run's / wave_run's sampling keywords ({} when neither the
        window nor the tie-break is on): the window's size over the real
        nodes (k = n still takes the visit-order branch: the reference walks
        and breaks ties in nodeTree order even when nothing is cut), the
        cursor, the tie key and the attempt counter."""
        if not self._sampling_active(profile):
            return {}
        out = dict(tie_key=self._tie_key, attempt_base=self._attempt_counter)
        pct = self._window_pct(profile)
        n_valid = len(self.cache.real_nodes())
        if pct is not None and n_valid:
            out.update(sample_k=min(num_feasible_nodes_to_find(pct, n_valid), n_valid),
                       sample_start=self._next_start_node_index)
        return out

    def _host_fit(self, profile: Profile) -> bool:
        """NodeResourcesFit scores on the host: its strategy weighs
        resources beyond the kernels' cpu and memory lanes (the reference's
        normalizing-score split)."""
        return ("NodeResourcesFit" in profile.enabled and profile.score_weights.get("NodeResourcesFit", 0) > 0
                and not profile.fit_plugin().device_score)

    def _refuse(self, batch: List[QueuedPodInfo], why: str) -> None:
        self.queue.push_back(batch)
        raise NotImplementedError(why)

    # ----- the fast path -------------------------------------------------

    def _max_nomination(self) -> Optional[int]:
        """The highest priority among open nominations (None: none)."""
        if not len(self.nominator):
            return None
        return max(p.priority for _, p in self.nominator.entries())

    def _fast_gate_ok(self, batch) -> bool:
        """Per-batch fast-path eligibility.  Nominations count only for pods
        of priority <= the nomination's (runtime:973), and the signature
        committer does not charge them: a batch with such a pod takes the
        gang path.  A placed pod's terms poison only the newcomers its
        selectors could admit, checked per label group against the cache's
        term-pod registry.  Gang members need the workloads dispatch's
        all-or-nothing admission (the committer has no rollback), whether
        their group is registered or not, as in the reference."""
        if self.config.gang_dispatch and any(wlg.group_key_of(qp.pod) is not None for qp in batch):
            return False
        max_nom = self._max_nomination()
        if max_nom is not None and any(qp.pod.priority <= max_nom for qp in batch):
            return False
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

    def _try_fast(self, profile: Profile, batch: List[QueuedPodInfo], chain_settled: bool = True,
                  pipeline_empty: bool = True, extend: bool = True):
        """The signature fast path's dispatch: its record (the choices are
        made, the harvest is ``_finish_fast``), "flush" when the pipeline
        must settle first (a chained batch is unharvested, or the lineage
        must rebuild under unharvested fast batches), or None when the batch
        is not eligible (a nominated pod, a pod a nomination or a placed
        term could affect, a pod without a signature, or a signature whose
        static scores vary over its feasible nodes)."""
        if self.mirror.nodes is None:
            self._repack_mirror()
        # the signature committer scores with LeastAllocated on the device,
        # full width and first max
        if (self._sampling_active(profile) or self._host_fit(profile)
                or profile.fit_strategy() != ops_gang.DEFAULT_FIT_STRATEGY):
            return None
        fwk = self.frameworks[profile.scheduler_name]
        if any(qp.pod.nominated_node_name or fwk.maybe_relevant(qp.pod) for qp in batch):
            return None
        if not self._fast_gate_ok(batch):
            return None
        keys = [self._sig_key(qp.pod) for qp in batch]
        if any(k is None for k in keys):
            return None
        if not chain_settled:
            return "flush"
        if not pipeline_empty:
            h = self._holder
            if h is None or h["key"] != self._lineage_key(profile):
                return "flush"
        self._sync_mirror_external()
        rows = self._fast_sig_rows(profile, batch, keys)
        if rows is None:
            return None

        # extend from the queue head with pods whose signatures are already
        # evaluated and argmax-neutral (a novel signature seeds a later batch);
        # a resident run rides one dispatch, so it extends further
        cfg = self.config
        cap = cfg.resident_run_max if cfg.resident_drain else cfg.fast_batch_max
        ext = cap - len(batch) if extend else 0
        if ext > 0:
            probes = self._term_probes() if self.cache.n_term_pods else ()
            group_hit: Dict[tuple, bool] = {}
            max_nom = self._max_nomination()
            gang_on = self.config.gang_dispatch

            def known(qp: QueuedPodInfo) -> bool:
                p = qp.pod
                if p.scheduler_name != profile.scheduler_name or self._refusal(p) is not None:
                    return False
                if fwk.maybe_relevant(p):
                    return False  # host Filters need the per-pod commit walk
                if gang_on and wlg.group_key_of(p) is not None:
                    return False  # gang members need the workloads dispatch
                if p.nominated_node_name or (max_nom is not None and p.priority <= max_nom):
                    return False
                if probes and self._admitted(p, probes, group_hit):
                    return False
                row = rows.get(self._sig_key(p))
                return row is not None and row["const_ok"]

            extra = self.queue.pop_batch_while(ext, known)
            batch = batch + extra
            keys = keys + [self._sig_key(qp.pod) for qp in extra]

        # fast commits happen outside the chain's device state
        self._chain = None
        weights = profile.weights()
        check_fit = "NodeResourcesFit" in profile.enabled
        holder = self._lineage(profile, weights, check_fit)
        pod_sigs = self._signatures(holder, keys, rows, weights)
        choices, resident = self._place(holder, batch, pod_sigs, weights, check_fit)
        return {
            "kind": "fast", "profile": profile, "batch": batch, "keys": keys, "pod_sigs": pod_sigs,
            "choices": choices, "rows": rows, "holder": holder, "resident": resident,
        }

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

    def _intern_node_labels(self, nodes) -> None:
        """Intern nodes' labels and metadata.name values that the snapshot
        does not hold yet (the planner's clones), before a repack, so a
        grown value bucket takes the mirror's full pack."""
        for node in nodes:
            for k, v in node.labels.items():
                self.vocab.intern_label(k, v)
            self.vocab.intern_label(METADATA_NAME_KEY, node.name)

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

    def _lineage_key(self, profile: Profile) -> tuple:
        return (self._external_mutations, self._nonfast_commits, self.mirror._full_packs,
                profile.scheduler_name, profile.weights(), "NodeResourcesFit" in profile.enabled)

    def _lineage(self, profile: Profile, weights, check_fit: bool) -> dict:
        """The host committer and its device twin.  Only an external cluster
        change, a gang commit, a full repack or another profile rebuilds it;
        fast commits keep it (the committer is the committed truth)."""
        key = self._lineage_key(profile)
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

    def _place(self, holder: dict, batch, pod_sigs, weights, check_fit: bool):
        """(choices, resident): the committer's or the device's choices, and
        whether a resident run made them."""
        fc = holder["fc"]
        self.metrics["fast_batches"] += 1
        if len(batch) < self.config.fast_device_min:
            # host path: the greedy answers locally, no device round trip
            if holder["heaps_dirty"]:
                fc.invalidate_heaps()  # device replays moved scores under the heaps
                holder["heaps_dirty"] = False
            self.metrics["host_batches"] += 1
            holder["dev"] = None  # the device copy (if any) is now stale
            return fc.run(pod_sigs), False
        try:
            return self._place_device(holder, batch, pod_sigs, weights, check_fit), self.config.resident_drain
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

    def _chain_quickcheck(self, profile: Profile, batch) -> bool:
        """Spec-only gate of the chained path: the mirror is packed, no pod
        wants host ports (the append does not splice port rows) or carries a
        nomination, no pod is a gang member or one a host Filter could act
        on (those take the direct path's workloads dispatch), and the batch
        is not a fast-path candidate."""
        if self.mirror.nodes is None:
            return False
        # the sampling cursor threads every attempt: the direct path owns it;
        # a host-scored fit strategy takes the one-pod cycle
        if self._sampling_active(profile) or self._host_fit(profile):
            return False
        if self.config.gang_dispatch and any(wlg.group_key_of(qp.pod) is not None for qp in batch):
            return False
        if any(qp.pod.host_ports() for qp in batch):
            return False
        fwk = self.frameworks[profile.scheduler_name]
        if any(fwk.maybe_relevant(qp.pod) for qp in batch):
            return False
        # nominated pods take the direct path's nominated-node split
        if any(qp.pod.nominated_node_name for qp in batch):
            return False
        if (self._fast_gate_ok(batch) and profile.fit_strategy() == ops_gang.DEFAULT_FIT_STRATEGY
                and all(self._sig_key(qp.pod) is not None for qp in batch)):
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
        speculation found no node, is not a conflict), a ``wave_demoted``
        flight-recorder event per demoted pod (the conflict's kind and term,
        the speculative and the final node) and a ``wave_upgraded`` one per
        upgraded pod, and the batch's interaction groups.  No pod a host
        Filter could act on reaches the wave (it takes the workloads
        dispatch or is refused), and the port has no extenders, so the
        groups are always formed, as the reference forms them for
        host-filter-clean batches under its default profile."""
        n = len(batch)
        stats = stats.cpu().numpy()
        spec, kinds, cterms = stats[0][:n], stats[1][:n], stats[2][:n]
        chosen_n = np.asarray(chosen)[:n]
        m = self.metrics
        conflicts = m["wave_conflicts"]
        fr = self.flight
        names = self.mirror.nodes.names
        for i in np.nonzero(chosen_n != spec)[0].tolist():
            code = int(kinds[i])
            upgraded = code == ops_wave.DEMOTE_UPGRADE
            if not upgraded:
                kind = ops_wave.DEMOTE_KINDS.get(code, "score")
                conflicts[kind] = conflicts.get(kind, 0) + 1
            c = int(chosen_n[i])
            if upgraded:
                # infeasible alone, placed once a batch peer committed
                # (required affinity met): not a conflict
                fr.record(batch[i].pod.uid, "wave_upgraded", {"node": names[c]} if 0 <= c < len(names) else {})
                continue
            detail = {"kind": kind, "term": int(cterms[i])}
            s = int(spec[i])
            if 0 <= s < len(names):
                detail["spec_node"] = names[s]
            if 0 <= c < len(names):
                detail["node"] = names[c]
            fr.record(batch[i].pod.uid, "wave_demoted", detail)
        m["wave_pods"] += n
        m["wave_admitted"] += int(np.sum((chosen_n == spec) & (chosen_n >= 0)))
        m["wave_groups"] += ops_wave.interaction_groups([qp.pod for qp in batch])[1]

    def _try_dispatch_chained(self, profile: Profile, batch, can_restart: bool = True):
        """chain_dispatch on the resident cluster.  Returns the pending
        record (its harvest is ``_finish_chained``), "flush" when the chain
        must restart from the committed state while batches are still
        unharvested, or None when the batch's term tables do not fit the
        chained cluster's widths or its cursors cannot be grown (the direct
        path takes it)."""
        for qp in batch:
            for k, v in qp.pod.labels.items():
                self.vocab.intern_label(k, v)
        epoch = self._chain_epoch()
        ch = self._chain
        if (ch is None or ch["epoch"] != epoch) and not can_restart:
            return "flush"
        self._repack_mirror()
        pods, pb = self._gang_prep(batch)
        epoch = self._chain_epoch()  # packing may have grown the vocabulary
        ch = self._chain
        if ch is None or ch["epoch"] != epoch:
            if not can_restart:
                return "flush"
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
            if not can_restart:
                return "flush"
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
        nom = self._nominated_arrays({qp.pod.uid for qp in batch})
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
                fit_strategy=profile.fit_strategy(),
                append_terms=append_terms,
                # any term row in the chained cluster keeps inter-pod on
                **self._gang_flags(pb, ch["m"] > 0),
                **tables,
                **wave_kw,
                **nom,
            )
        except BaseException:
            # the chained cluster may be torn: drop it, return the batch
            self._chain = None
            self.queue.push_back(batch)
            raise
        self._chain = {"dc": out[0], "e": ch["e"] + P, "m": ch["m"] + P * AT, "epoch": epoch}
        self.metrics["wave_batches" if wt is not None else "chain_batches"] += 1
        return {
            "kind": "chain", "profile": profile, "batch": batch, "results": out[1], "reasons": out[2],
            "wave_stats": out[3] if wt is not None else None,
        }

    def _finish_chained(self, rec) -> List[ScheduleOutcome]:
        """Harvest one chained batch: fetch its results and walk them."""
        results = rec["results"].cpu()
        batch = rec["batch"]
        if rec["wave_stats"] is not None:
            self._wave_resolve(batch, results[0], rec["wave_stats"])
        out = self._process_results(rec["profile"], batch, results[0], rec["reasons"],
                                    wave=rec["wave_stats"] is not None)
        self._flush_binds()
        return out

    def _restart_chain(self, epoch) -> dict:
        dc = self._dc_cache.sync(self.mirror, self.vocab)
        # the chain writes into these tensors: the device mirror must not
        # treat them as its own image again
        self._dc_cache.invalidate()
        return {"dc": dc, "e": self.mirror.e_used, "m": self.mirror.m_used, "epoch": epoch}

    def _schedule_batch(self, profile: Profile, batch, try_workloads: bool = True) -> List[ScheduleOutcome]:
        """The direct path (schedule_one.go:65 granularity where it must): a
        batch with members of registered PodGroups takes the workloads
        dispatch first (a mixed batch that the workloads gate refuses is
        peeled: its members alone take it, the rest the paths below).  Then
        the split: nominated pods take the nominated-node path one by one, a
        pod a host Filter could act on retries the workloads dispatch alone,
        and the runs of other pods between them are scheduled as batches; a
        batch the fast gate admits takes the signature fast path (no
        extension), the rest ``wave_run`` or ``gang_run``."""
        self._chain = None  # direct commits happen outside any chain
        if self._host_fit(profile):
            # every pod is score-relevant to a host-scored fit strategy: the
            # one-pod cycle, in queue order
            outcomes: List[ScheduleOutcome] = []
            for i, qp in enumerate(batch):
                try:
                    if qp.pod.nominated_node_name:
                        outcomes.extend(self._schedule_one_nominated(profile, qp))
                    else:
                        outcomes.extend(self._schedule_one_host(profile, qp))
                except BaseException:
                    self.queue.push_back(batch[i:])
                    raise
            return outcomes
        if try_workloads and self.config.gang_dispatch:
            out = self._try_dispatch_workloads(profile, batch)
            if out is not None:
                return out
            # one disqualifying pod (a nomination, host ports) must not drop
            # the quorum semantics of the members beside it
            members = [qp for qp in batch if self._workloads_group_of(qp.pod) is not None]
            if members and len(members) < len(batch):
                out = self._try_dispatch_workloads(profile, members)
                if out is not None:
                    rest = [qp for qp in batch if self._workloads_group_of(qp.pod) is None]
                    return out + self._schedule_batch(profile, rest)
        fwk = self.frameworks[profile.scheduler_name]
        if len(batch) > 1 and any(qp.pod.nominated_node_name or fwk.maybe_relevant(qp.pod) for qp in batch):
            # host-stateful Filters judge against state that earlier commits
            # of the same batch move: such pods take one-pod cycles, in queue
            # order (schedule_one.go:65)
            # (a sub-run that raises has pushed its own pods back; the pods
            # after it go back too, and the placements committed before it
            # are bound where schedule_pending unwinds)
            outcomes: List[ScheduleOutcome] = []
            run: List[QueuedPodInfo] = []
            for i, qp in enumerate(batch):
                if not qp.pod.nominated_node_name and not fwk.maybe_relevant(qp.pod):
                    run.append(qp)
                    continue
                try:
                    if run:
                        outcomes.extend(self._schedule_batch(profile, run))
                        run = []
                    if qp.pod.nominated_node_name:
                        outcomes.extend(self._schedule_one_nominated(profile, qp))
                    else:
                        outcomes.extend(self._schedule_batch(profile, [qp]))
                except BaseException:
                    self.queue.push_back(batch[i + 1:] if not run else batch[i:])
                    raise
            if run:
                outcomes.extend(self._schedule_batch(profile, run))
            return outcomes
        if len(batch) == 1 and batch[0].pod.nominated_node_name:
            return self._schedule_one_nominated(profile, batch[0])
        rec = self._try_fast(profile, batch, extend=False)
        if rec is not None:
            return self._finish_fast(rec, flush_binds=False)
        return self._schedule_direct(profile, batch)

    def _schedule_direct(self, profile: Profile, batch) -> List[ScheduleOutcome]:
        """wave_run (a wave-shaped batch under waveDispatch) or gang_run on
        the snapshot the device mirror keeps current."""
        fwk = self.frameworks[profile.scheduler_name]
        for qp in batch:
            if fwk.maybe_relevant(qp.pod):
                # a guard: _schedule_group's checks hold every precondition
                # of the workloads dispatch, so it takes such a pod first;
                # the reference would veto nodes on the host into K5/K8/K9
                self._refuse(batch, f"pod {qp.pod.key}: a volume or claims pod the workloads dispatch declined "
                                    "needs the host-veto split path (ROADMAP A6b)")
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
            sampling = self._sampling_args(profile)
            kw = dict(enabled=profile.enabled, weights=profile.weights(), fit_strategy=profile.fit_strategy(),
                      **tables, **self._nominated_arrays({qp.pod.uid for qp in batch}), **sampling)
            stats = None
            if wt is not None:
                self.metrics["wave_batches"] += 1
                flags["has_ports"] = wt["has_ports"]  # the occupancy carry, not the pod×pod matrix
                chosen, _, reasons, tallies, stats = ops_wave.wave_run(*args, **self._wave_kw(wt), **kw, **flags)
            else:
                self.metrics["scan_batches"] += 1
                chosen, _, reasons, tallies = ops_gang.gang_run(*args, **kw, **flags)
            chosen = chosen.cpu()
            if sampling.get("sample_k") is not None:
                # the cursor is the kernel's cross-launch carry: one readback
                self._next_start_node_index = int(tallies["sample_start"])
            if sampling:
                self._attempt_counter += len(batch)
        except BaseException:
            self._dc_cache.invalidate()
            self.queue.push_back(batch)
            raise
        if stats is not None:
            self._wave_resolve(batch, chosen, stats)
        return self._process_results(profile, batch, chosen, reasons, wave=stats is not None)

    def _process_results(self, profile: Profile, batch, chosen, reasons, wave: bool) -> List[ScheduleOutcome]:
        """The gang path's harvest, in the reference's order: K10 narrows
        the failures against the placed pods and this batch's committed
        peers, then the walk in queue order assumes each placement and sends
        each failure (a FitError from the first-failure reason counts) to
        PostFilter.  A wave batch's placements are assumed after its
        failures (the reference commits them in bulk after the walk)."""
        names = self.nodes.names
        chosen = chosen.numpy()[: len(batch)]
        if ((chosen < -1) | (chosen >= len(names))).any():
            raise RuntimeError("gang scan returned a node index out of range")
        n = len(batch)
        self.metrics["schedule_attempts"] += n
        profile_pf = self._post_filters.get(profile.scheduler_name)
        state = CycleState()
        failed = [qp for i, qp in enumerate(batch) if chosen[i] < 0]
        if failed and profile_pf is not None:
            self._batched_preemption_narrow(state, failed, batch, chosen, names)
        out: List[Optional[ScheduleOutcome]] = [None] * n
        counts = reasons.cpu().numpy() if failed else None
        n_nodes = len(self.cache.real_nodes())
        later = []
        for i, qp in enumerate(batch):
            if chosen[i] >= 0:
                if wave:
                    later.append(i)
                else:
                    out[i] = self._assume(qp, names[chosen[i]])
                continue
            diag = {k: int(c) for k, c in zip(ops_gang.DIAG_KERNELS, counts[i]) if c > 0}
            diag.pop("HostFilters", None)  # the gang and wave paths carry no host-filter lane
            out[i] = self._post_filter_or_fail(profile, state, qp, fit_error_message(n_nodes, diag), diag, set(diag))
        for i in later:
            out[i] = self._assume(batch[i], names[chosen[i]])
        return out

    # ----- the workloads dispatch: PodGroup gangs ---------------------------

    def _workloads_group_of(self, pod: Pod) -> Optional[str]:
        """A pod's gang key, or None when it names no REGISTERED PodGroup
        (such a pod schedules as an ordinary pod)."""
        key = wlg.group_key_of(pod)
        if key is None or self.gangs.get(key) is None:
            return None
        return key

    def _pull_gang_siblings(self, batch) -> List[QueuedPodInfo]:
        """The gang sibling-pull: when a popped batch holds members of gangs
        whose quorum it cannot cover, pop those gangs' other ACTIVE members
        into it (in queue order).  Members backing off or parked stay where
        they are, so a gang that cannot be covered still meets the waiting
        and timeout barrier."""
        present: Dict[str, int] = {}
        for qp in batch:
            key = self._workloads_group_of(qp.pod)
            if key is not None:
                present[key] = present.get(key, 0) + 1
        wanted = set()
        for key, n in present.items():
            if n + self.gangs.bound_count(key) < self.gangs.get(key).min_member:
                wanted.add(key)
        if not wanted:
            return []
        return self.queue.pop_siblings(lambda qp: self._workloads_group_of(qp.pod) in wanted)

    def _workloads_eligible(self, batch) -> bool:
        """The workloads gate on the pods' specs: gangDispatch is on, some pod
        is a member of a registered PodGroup, has PVCs or (under the
        DynamicResourceAllocation gate) ResourceClaims, and no pod carries a
        nomination or wants host ports (the dispatch has no port carry).
        ``_refusal`` already holds every PVC to what K12 covers (bound, its
        PV present: the reference's ``_vol_kernel_ok``) and every claim to
        existing; whether a host Filter is still active is asked after
        PreFilter (``_workloads_covered``)."""
        if not self.config.gang_dispatch:
            return False
        dra_on = self.config.dra_enabled()
        if not any(self._workloads_group_of(qp.pod) is not None or qp.pod.pvc_names()
                   or (dra_on and qp.pod.resource_claims) for qp in batch):
            return False
        return not any(qp.pod.nominated_node_name or qp.pod.host_ports() for qp in batch)

    def _workloads_covered(self, fwk: Framework, state: CycleState, pods) -> bool:
        """After PreFilter: every host Filter still active for some pod is
        one the dispatch replaces: DynamicResources (K13, K14 and K11's
        allocation carries), VolumeBinding and VolumeZone (K12's mask),
        NodeVolumeLimits while no CSINode advertises limits (its Filter is
        then a constant success)."""
        for p in fwk.host_filter_plugins():
            if p.name in ("DynamicResources", "VolumeBinding", "VolumeZone"):
                continue
            if p.name == "NodeVolumeLimits" and not self.csinodes:
                continue
            if any(not state.is_filter_skipped(pod.uid, p.name) for pod in pods):
                return False
        return True

    def _vol_kernel_ok(self, pod: Pod) -> bool:
        """True when every PVC of the pod exists, is fully bound and its PV
        is present: the volume shape K12's mask covers."""
        for name in pod.pvc_names():
            pvc = self.pvc_cache.get(f"{pod.namespace}/{name}")
            if pvc is None or not pvc.is_fully_bound() or self.pv_cache.get(pvc.volume_name) is None:
                return False
        return True

    def _vol_tables(self, pods, p_cap: int) -> Optional[dict]:
        """The K12 tables: each bound PV's node-affinity DNF in its own PV2
        slot (ORed terms on the term axis), and, for a PV carrying zone or
        region labels (VolumeZone's form), one more slot whose conjunction
        requires ``key In zone-set`` for each such label, so the AND over
        slots is volume_zone.go's every-label-must-match.  A nil affinity
        adds no slot (it matches everywhere); a claim whose PV is missing
        marks the pod ``vol_bad``.  None when no pod has such a row."""
        per_pod: List[list] = []
        bad = np.zeros((p_cap,), bool)
        for i, pod in enumerate(pods):
            rows = []
            for name in pod.pvc_names():
                pvc = self.pvc_cache.get(f"{pod.namespace}/{name}")
                pv = self.pv_cache.get(pvc.volume_name) if pvc is not None and pvc.is_fully_bound() else None
                if pv is None:
                    bad[i] = True
                    continue
                zone_c = CompiledRequirements()
                for key in storage_api.VOLUME_TOPOLOGY_LABELS:
                    if key in pv.labels:
                        zone_c.add(key, k8slabels.IN, sorted(zone_value_set(pv.labels[key])), self.vocab)
                if zone_c.n_reqs:
                    rows.append([zone_c])
                if pv.node_affinity is not None:
                    rows.append(compile_node_selector_dnf(pv.node_affinity, self.vocab))
            per_pod.append(rows)
        if not any(per_pod) and not bad.any():
            return None
        pv_cap = bucket_cap(max((len(r) for r in per_pod), default=1) or 1, 1)
        flat: List[list] = []
        valid = np.zeros((p_cap, pv_cap), bool)
        for i in range(p_cap):
            rows = per_pod[i] if i < len(per_pod) else []
            for j in range(pv_cap):
                flat.append(rows[j] if j < len(rows) else [])
                valid[i, j] = j < len(rows)
        ct = pack_conjunction_table(flat)
        T, R, V = ct.req_key.shape[1], ct.req_key.shape[2], ct.req_vals.shape[3]

        def dev(a, tail):
            return torch.from_numpy(np.ascontiguousarray(a).reshape((p_cap, pv_cap) + tail)).to(self.device)

        table = DTable(req_key=dev(ct.req_key, (T, R)), req_op=dev(ct.req_op, (T, R)),
                       req_vals=dev(ct.req_vals, (T, R, V)), req_rhs=dev(ct.req_rhs, (T, R)),
                       term_valid=dev(ct.term_valid, (T,)))
        return dict(vol_table=table, vol_valid=torch.from_numpy(valid).to(self.device),
                    vol_bad=torch.from_numpy(bad).to(self.device))

    def _try_dispatch_workloads(self, profile: Profile, batch) -> Optional[List[ScheduleOutcome]]:
        """The workloads dispatch (the reference's _try_dispatch_workloads):
        the host plugins' PreFilter, the quorum and timeout barrier, the
        canonical order (plan_batch), the DRA tables over the whole claim
        cache, one ``workloads_run`` (K12 for the volume mask, K1 + K6 + K7,
        K13 + K14 for the claims, K8, K11) and the result walk.  None when
        the batch is not eligible, two nodes share a hostname (the factored
        hostname domains need one node per hostname) or a host Filter the
        dispatch does not replace is active: the caller schedules it on the
        other paths, with nothing committed or failed."""
        if self._sampling_active(profile) or not self._workloads_eligible(batch):
            return None
        for qp in batch:
            for k, v in qp.pod.labels.items():
                self.vocab.intern_label(k, v)
        self._sync_mirror_external()
        if not self.mirror.hostnames_unique:
            return None

        # 0. PreFilter (a claim being deleted rejects here); its failures are
        # emitted only once the coverage check commits to this path
        fwk = self.frameworks[profile.scheduler_name]
        state = CycleState()
        pf_failures = fwk.run_pre_filter(state, [qp.pod for qp in batch])
        if not self._workloads_covered(fwk, state, [qp.pod for qp in batch if qp.pod.uid not in pf_failures]):
            return None
        outcomes: List[ScheduleOutcome] = []
        if pf_failures:
            live = []
            for qp in batch:
                st = pf_failures.get(qp.pod.uid)
                if st is None:
                    live.append(qp)
                    continue
                self.metrics["schedule_attempts"] += 1
                outcomes.append(self._post_filter_or_fail(profile, state, qp, st.merge_reason(), None,
                                                          {st.plugin} if st.plugin else set(), code=st.code))
            batch = live
            if not batch:
                return outcomes

        # 1. the gang barrier: quorum and timeout verdicts before dispatch
        keys = [self._workloads_group_of(qp.pod) for qp in batch]
        present: Dict[str, int] = {}
        for key in keys:
            if key is not None:
                present[key] = present.get(key, 0) + 1
        needs: Dict[str, int] = {}
        rejected: Dict[str, str] = {}
        for key, n_present in present.items():
            pg = self.gangs.get(key)
            bound = self.gangs.bound_count(key)
            if self.gangs.timed_out(key):
                rejected[key] = f'pod group "{key}" scheduling timed out after {pg.schedule_timeout_s:.0f}s'
                self.gangs.close_window(key)
            elif n_present + bound < pg.min_member:
                rejected[key] = (f'pod group "{key}" has {n_present + bound}/{pg.min_member} members; '
                                 "waiting for the rest")
                self.gangs.note_attempt(key)
            else:
                needs[key] = max(0, pg.min_member - bound)
                self.gangs.note_attempt(key)
        if rejected:
            live = []
            for qp, key in zip(batch, keys):
                if key in rejected:
                    self.metrics["schedule_attempts"] += 1
                    self._handle_failure(qp, {"Coscheduling"})
                    outcomes.append(ScheduleOutcome(qp.pod, None, rejected[key]))
                else:
                    live.append(qp)
            batch = live
            if not batch:
                return outcomes

        # 2. the canonical order: each gang's members contiguous
        order, gang_positions = wlg.plan_batch([qp.pod for qp in batch], group_of=self._workloads_group_of)
        ordered = [batch[i] for i in order]

        # 3. pack and dispatch
        self._repack_mirror()
        _, pb = self._gang_prep(ordered)
        wt = self._wave_tables(pb)
        if wt is None:  # unreachable after the hostname check; finish the live pods elsewhere
            return outcomes + self._schedule_batch(profile, ordered, try_workloads=False)
        gid, gfirst, glast, gneed, g_cap, slot_keys = wlg.gang_arrays(pb.valid.shape[0], gang_positions, needs)
        self.metrics["workload_batches"] += 1
        try:
            dc = self._dc_cache.sync(self.mirror, self.vocab)
            db = DeviceBatch.from_host(pb, self.device)
            v_cap = bucket_cap(len(self.vocab.label_vals))  # before the volume rows intern their values
            tables = self._gang_tables(pb)
            flags = self._gang_flags(pb, bool((self.mirror.existing.term_kind != PAD).any()))
            del flags["has_ports"]
            rows = {k: torch.from_numpy(v).to(self.device) for k, v in dict(
                gang_id=gid, gang_first=gfirst, gang_last=glast, gang_need=gneed).items()}
            volt = self._vol_tables([qp.pod for qp in ordered], pb.valid.shape[0]) or {}
            dra = self._dra_tables(fwk, [qp.pod for qp in ordered], pb.valid.shape[0])
            claims = dra.pop("claims", None)
            chosen, _, reasons, _, wl = ops_cos.workloads_run(
                dc, db, self._hostname_key(), v_cap, g_cap, **self._wave_kw(wt, ports=False), **rows, **volt, **dra,
                enabled=profile.enabled, weights=profile.weights(), fit_strategy=profile.fit_strategy(), **tables,
                **self._nominated_arrays({qp.pod.uid for qp in ordered}), **flags)
            fetched = [t.cpu().numpy() for t in (chosen, wl["raw"], wl["spec"], wl["gang_admit"], wl["gang_landed"])]
            claim_node = None if claims is None else wl["claim_node"].cpu().numpy()
        except BaseException:
            self._dc_cache.invalidate()
            self.queue.push_back(ordered)
            raise
        if claims is not None:
            self._count_allocations(claims, claim_node)
        self._process_workloads_results(profile, state, ordered, *fetched, reasons, gang_positions, slot_keys,
                                        outcomes)
        return outcomes

    def _dra_tables(self, fwk: Framework, pods, p_cap: int) -> dict:
        """ops/dra.py dra_tables over the WHOLE claim cache (free0 excludes
        the devices any allocated claim holds, as the plugin's
        _allocated_devices does, not only the batch's claims) when
        DynamicResources is active and a pod has claims: its tensors, and
        under ``claims`` (claim keys by slot, the claims by key) what the
        allocation count reads.  Empty otherwise."""
        if not any(p.name == "DynamicResources" for p in fwk.host_filter_plugins()):
            return {}
        if not any(p.resource_claims for p in pods):
            return {}
        claims_by_key = {c.key: c for c in self.claim_cache.list()}
        dt = ops_dra.dra_tables(pods, self.nodes.name_to_idx, self.nodes.n_cap, p_cap,
                                list(self.resource_slices.values()), self.device_classes, claims_by_key,
                                device=self.device)
        if dt is None:
            return {}
        dt.pop("has_claims")
        dt["claims"] = (dt.pop("claim_keys"), claims_by_key)
        return dt

    def _count_allocations(self, claims, claim_node) -> None:
        """dra_claims_allocated: each claim the batch allocated, once (a
        shared claim is one allocation however many pods reference it; a
        claim allocated before the batch does not count)."""
        keys, by_key = claims
        self.metrics["dra_claims_allocated"] += sum(
            1 for i, key in enumerate(keys) if int(claim_node[i]) >= 0 and by_key[key].allocation is None)

    def _process_workloads_results(self, profile: Profile, state: CycleState, ordered, chosen, raw, spec,
                                   gang_admit, gang_landed, reasons, gang_positions, slot_keys, outcomes) -> None:
        """The workloads result walk in the canonical order: the gang
        verdicts (metrics, and an admitted gang's window closes); then per
        pod, a member its gang rolled back fails without PostFilter (a dry
        run for it would only churn victims), a genuine failure gets its
        FitError (the host-filter lane named as the volume node affinity
        conflict, VolumeBinding's; for a claims pod the port lane, which
        carries the DRA verdict in a workloads batch, named "cannot allocate
        all devices", DynamicResources') and goes to PostFilter (unnarrowed,
        as in the reference), and a placement is assumed and counted for its
        gang; a volume or claims pod's placement is replayed through
        PreFilter and the host Filters on its node first, so Reserve reads
        decisions made on the live cache (``_wl_host_replay``)."""
        names = self.nodes.names
        n = len(ordered)
        chosen = chosen[:n]
        if ((chosen < -1) | (chosen >= len(names))).any():
            raise RuntimeError("workloads dispatch returned a node index out of range")
        m = self.metrics
        m["schedule_attempts"] += n
        m["workload_spec_admitted"] += int(np.sum((chosen == spec[:n]) & (chosen >= 0)))
        pos_gang = {pos: key for key, positions in gang_positions.items() for pos in positions}
        slot_of = {key: i for i, key in enumerate(slot_keys)}
        for key in gang_positions:
            admit, landed = int(gang_admit[slot_of[key]]), int(gang_landed[slot_of[key]])
            if admit == 1:
                self.gangs.close_window(key)
                m["gang_admitted"] += landed
            elif admit == 0:
                m["gang_rolled_back"] += 1
        fwk = self.frameworks[profile.scheduler_name]
        counts = None
        n_nodes = len(self.cache.real_nodes())
        for i, qp in enumerate(ordered):
            idx = int(chosen[i])
            if idx >= 0:
                if qp.pod.pvc_names() or qp.pod.resource_claims:
                    st = self._wl_host_replay(fwk, state, qp.pod, names[idx])
                    if not st.ok:
                        # the ground truth moved between dispatch and commit
                        outcomes.append(self._post_filter_or_fail(profile, state, qp, st.merge_reason(), None,
                                                                  {st.plugin} if st.plugin else set(), code=st.code))
                        continue
                out = self._assume(qp, names[idx], state=state)
                outcomes.append(out)
                if out.node is not None:
                    self.gangs.note_placed(qp.pod)
                    if qp.pod.resource_claims:
                        m["dra_pods"] += 1
                continue
            key = pos_gang.get(i)
            if key is not None and int(raw[i]) >= 0:
                pg = self.gangs.get(key)
                self._handle_failure(qp, {"Coscheduling"})
                outcomes.append(ScheduleOutcome(qp.pod, None, (
                    f'pod group "{key}" admission rolled back: {int(gang_landed[slot_of[key]])}/'
                    f"{pg.min_member if pg else 0} members schedulable")))
                continue
            if counts is None:
                counts = reasons.cpu().numpy()
            diag = {k: int(c) for k, c in zip(ops_gang.DIAG_KERNELS, counts[i]) if c > 0}
            plugins = set(diag)
            if "NodePorts" in diag and qp.pod.resource_claims:
                # no workloads pod wants host ports: the port lane is the DRA verdict
                diag[REASON_CANNOT_ALLOCATE] = diag.pop("NodePorts")
                plugins.discard("NodePorts")
                plugins.add("DynamicResources")
            if "HostFilters" in diag:  # the host-filter lane is K12's volume mask
                diag[VOLUME_CONFLICT] = diag.pop("HostFilters")
                plugins.discard("HostFilters")
                plugins.add("VolumeBinding")
            outcomes.append(self._post_filter_or_fail(profile, state, qp, fit_error_message(n_nodes, diag), diag,
                                                      plugins))

    def _wl_host_replay(self, fwk: Framework, state: CycleState, pod: Pod, node_name: str) -> Status:
        """PreFilter again (fresh claim ledgers) and the chosen node's host
        Filter walk for a volume or claims pod the dispatch placed: the
        kernel proved feasibility; this records the plugins' per-node
        decisions (the claims' device picks) in the CycleState that Reserve
        and PreBind read, claim contention resolving in the batch order the
        kernel replayed."""
        pf = fwk.run_pre_filter(state, [pod])
        if pod.uid in pf:
            return pf[pod.uid]
        ns = self.oracle_view().nodes.get(node_name)
        if ns is None:
            return Status.error(f"node {node_name} vanished", plugin="Workloads")
        return fwk.run_host_filters(state, pod, ns)

    # ----- commit --------------------------------------------------------

    def _finish_fast(self, rec, flush_binds: bool = True) -> List[ScheduleOutcome]:
        """Harvest one fast batch in queue order: placements are assumed,
        each failure gets a FitError with the per-plugin diagnosis at the
        committer's state and goes to PostFilter unnarrowed, as in the
        reference (the dry run sizes its candidate count from the potential-
        node list, so a K10 shortlist would change its window).  A pipelined
        batch binds at its harvest; the direct path's binds wait for the end
        of the popped batch, as the reference's do."""
        profile, batch, choices = rec["profile"], rec["batch"], rec["choices"]
        holder, rows, keys, pod_sigs = rec["holder"], rec["rows"], rec["keys"], rec["pod_sigs"]
        names = self.nodes.names
        n = len(batch)
        self.metrics["schedule_attempts"] += n
        state = CycleState()
        out: List[Optional[ScheduleOutcome]] = [None] * n
        diag_cache: Dict[int, Dict[str, int]] = {}
        node_valid = self.nodes.valid
        n_nodes = len(self.cache.real_nodes())
        for i, qp in enumerate(batch):
            if choices[i] >= 0:
                out[i] = self._assume(qp, names[choices[i]], fast=True)
                continue
            sig = pod_sigs[i]
            diag = diag_cache.get(id(sig))
            if diag is None:
                diag = diag_cache[id(sig)] = holder["fc"].diagnose(sig, rows[keys[i]], node_valid)
            out[i] = self._post_filter_or_fail(profile, state, qp, fit_error_message(n_nodes, diag), diag, set(diag))
        if flush_binds:
            self._flush_binds()
        return out

    def _assume(self, qp: QueuedPodInfo, node: str, fast: bool = False,
                state: Optional[CycleState] = None) -> ScheduleOutcome:
        """Assume one placement (the host view follows) and buffer its bind;
        the outcome is final once ``_flush_binds`` ran (at a pipelined
        harvest, else at the end of the popped batch: until then a bound
        preemptor's nomination stays open, as in the reference, whose bind
        workers start there).  A non-fast commit moves state the fast
        lineage did not track.  A pod with PVCs or ResourceClaims runs the
        host plugins' Reserve against ``state`` (the CycleState its host
        Filters wrote), and its bind waits for their PreBind; a bind that
        fails runs their Unreserve."""
        (assumed,) = self.cache.assume_pods_bulk([(qp.pod, node)])
        self._view_pod_added(assumed)
        if not fast:
            self._nonfast_commits += 1
        fwk = None
        if state is not None and (qp.pod.pvc_names() or qp.pod.resource_claims):
            fwk = self.frameworks[qp.pod.scheduler_name]
            st = fwk.run_reserve(state, qp.pod, node)
            if not st.ok:
                self._external_mutations += 1  # the committers' state diverges
                self._view_pod_removed(assumed)
                self.cache.forget_pod(qp.pod)
                self._handle_failure(qp, set() if st.code == Code.ERROR else {st.plugin})
                return ScheduleOutcome(qp.pod, None, st.merge_reason())
        outcome = ScheduleOutcome(qp.pod, node)
        self._bind_buffer.append((qp, node, outcome, fwk, state))
        return outcome

    def _flush_binds(self) -> None:
        """Bind the buffered placements (binding_sink_many in one call when
        set).  A bound pod's attempt ends and its nomination closes; a
        rejected bind forgets the pod, which backs off."""
        buf, self._bind_buffer = self._bind_buffer, []
        if not buf:
            return
        # PreBind (the host plugins' volume binding) before the bind; a
        # failure unreserves and takes the bind's failure path
        pre = [None] * len(buf)
        for i, (qp, node, _, fwk, state) in enumerate(buf):
            if fwk is not None:
                st = fwk.run_pre_bind(state, qp.pod, node)
                if not st.ok:
                    fwk.run_unreserve(state, qp.pod, node)
                    pre[i] = st.merge_reason()
        todo = [i for i in range(len(buf)) if pre[i] is None]
        pairs = [(buf[i][0].pod, buf[i][1]) for i in todo]
        if self.binding_sink_many is not None:
            got = list(self.binding_sink_many(pairs)) if pairs else []
        else:
            got = []
            for pod, node in pairs:
                try:
                    if self.binding_sink is not None:
                        self.binding_sink(pod, node)
                    got.append(None)
                except Exception as e:  # a rejected bind is this pod's outcome
                    got.append(str(e))
        errors = list(pre)
        for i, err in zip(todo, got):
            errors[i] = err
        for i, ((qp, node, outcome, fwk, state), err) in enumerate(zip(buf, errors)):
            pod = qp.pod
            if err is None:
                self.queue.done(pod.uid)
                if self.nominator.nominated_node(pod.uid) is not None:
                    self.metrics["nominated_binds"] += 1
                    self.nominator.delete(pod)
                continue
            if fwk is not None and pre[i] is None:
                fwk.run_unreserve(state, pod, node)  # a failed bind unreserves (schedule_one.go:342)
            # the forget is an external change: the next batch rebuilds the
            # fast lineage and restarts the chain
            self._view_pod_removed(self.cache.pod_states[pod.uid])
            self.cache.forget_pod(pod)
            self.gangs.note_removed(pod)  # the gang's count of placed members unwinds too
            self._external_mutations += 1
            self._handle_failure(qp, set())
            outcome.node = None
            outcome.reason = err  # bare, as the reference's DefaultBinder and PreBind statuses report it

    # ----- PostFilter: preemption -------------------------------------------

    def _nominated_arrays(self, exclude_uids) -> dict:
        """The open nominations (minus this batch's own pods) as the gang
        path's nom_node / nom_prio / nom_req keyword arguments, {} when
        there are none.  Node indices are the current mirror's."""
        nt = self.mirror.nodes
        lanes = ResourceLanes(self.vocab)
        R = nt.allocatable.shape[1]
        rows = []
        for node, pod in self.nominator.entries():
            if pod.uid in exclude_uids:
                continue
            idx = nt.name_to_idx.get(node)
            if idx is None:
                continue
            rows.append((idx, pod.priority, lanes.request_row(pod.compute_requests(), R)))
        if not rows:
            return {}
        G = len(rows)
        return dict(
            nom_node=torch.tensor([r[0] for r in rows], dtype=torch.int32, device=self.device),
            nom_prio=torch.tensor([r[1] for r in rows], dtype=torch.int32, device=self.device),
            nom_req=torch.from_numpy(np.stack([r[2] for r in rows]).astype(np.int32).reshape(G, R)).to(self.device),
        )

    def _batched_preemption_narrow(self, state: CycleState, failed, batch, chosen, node_names) -> None:
        """ONE K10 launch shortlisting preemption candidates for every failed
        pod of a harvest (the batched front of DryRunPreemption,
        preemption.go:548); each shortlist lands in ``state`` under
        ("preemption_potential", uid) for DefaultPreemption.

        The victim rows are the cache's placed pods; the batch's own
        placements (``chosen`` over ``node_names``, the dispatch-time name
        list), not yet assumed, ride as the batch-peer rows.  The mirror
        update below may repack and move node slots, so a peer is resolved
        by node NAME to its current index.  A build or launch failure
        raises: nothing falls back to the unnarrowed host walk."""
        self.mirror.update(self.cache)
        nt = self.mirror.nodes
        pods = [qp.pod for qp in failed]
        pb = pack_pod_batch(pods, self.vocab, k_cap=nt.k_cap, p_cap=bucket_cap(len(pods), 1))
        dc = self._static_device_cluster()
        lanes = ResourceLanes(self.vocab)
        R = nt.allocatable.shape[1]
        placed = self.cache.placed_pods()
        E = max(len(placed), 1)
        vnode = np.full(E, -1, np.int32)
        vprio = np.zeros(E, np.int32)
        vreq = np.zeros((E, R), np.int32)
        for i, p in enumerate(placed):
            idx = nt.name_to_idx.get(p.node_name)
            if idx is None:
                continue
            vnode[i] = idx
            vprio[i] = p.priority
            vreq[i] = lanes.request_row(p.compute_requests(), R)
        distinct = sorted({p.priority for p in pods})
        groups = np.full(bucket_cap(len(distinct), 1), INT32_MIN, np.int32)
        groups[: len(distinct)] = distinct
        gidx = {pr: i for i, pr in enumerate(distinct)}
        pod_group = np.zeros(pb.valid.shape[0], np.int32)
        pod_group[: len(pods)] = [gidx[p.priority] for p in pods]
        B2 = max(len(batch), 1)
        bnode = np.full(B2, -1, np.int32)
        bprio = np.zeros(B2, np.int32)
        breq = np.zeros((B2, R), np.int32)
        for i, qp in enumerate(batch):
            c = int(chosen[i])
            if c < 0 or c >= len(node_names):
                continue
            idx = nt.name_to_idx.get(node_names[c])  # dispatch index → name → current slot
            if idx is None:
                continue
            bnode[i] = idx
            bprio[i] = qp.pod.priority
            breq[i] = lanes.request_row(qp.pod.compute_requests(), R)
        t = {k: torch.from_numpy(v).to(self.device) for k, v in dict(
            vnode=vnode, vprio=vprio, vreq=vreq, groups=groups, pg=pod_group, bnode=bnode, bprio=bprio, breq=breq,
        ).items()}
        masks = ops_preemption.narrow_candidates(
            dc, DeviceBatch.from_host(pb, self.device), t["vnode"], t["vprio"], t["vreq"], t["groups"], t["pg"],
            batch_node=t["bnode"], batch_prio=t["bprio"], batch_req=t["breq"],
        ).cpu().numpy()
        self.metrics["narrow_batches"] += 1
        names = nt.names
        for i, qp in enumerate(failed):
            state.write(("preemption_potential", qp.pod.uid),
                        {names[j] for j in np.nonzero(masks[i])[0] if j < len(names)})

    def _post_filter_or_fail(self, profile: Profile, state: CycleState, qp: QueuedPodInfo, reason: str,
                             diagnosis: Optional[Dict[str, int]], plugins: Optional[set],
                             code: Code = Code.UNSCHEDULABLE) -> ScheduleOutcome:
        """A filter failure (a FitError, Unschedulable) goes to the profile's
        PostFilter (schedule_one.go:135-180): a chosen node nominates the
        pod (the victims are already evicted); "" clears a stale nomination.
        An UnschedulableAndUnresolvable failure (a PreFilter rejection)
        skips PostFilter and clears a stale nomination; an error parks the
        pod with no rejecting plugin (plain backoff).  Then the pod parks in
        the queue with the plugins that rejected it."""
        pod = qp.pod
        pf = self._post_filters.get(profile.scheduler_name)
        if code == Code.ERROR:
            plugins = set()
        if code != Code.UNSCHEDULABLE:
            if code == Code.UNSCHEDULABLE_AND_UNRESOLVABLE and pod.nominated_node_name:
                pod.nominated_node_name = ""
                self.nominator.delete(pod)
                self.status_patcher(pod)
        elif pf is not None:
            nominated, _ = pf.post_filter(state, pod)
            if nominated:
                pod.nominated_node_name = nominated
                self.nominator.add(pod, nominated)
                self.status_patcher(pod)
            elif nominated == "" and pod.nominated_node_name:
                pod.nominated_node_name = ""
                self.nominator.delete(pod)
                self.status_patcher(pod)
        self._handle_failure(qp, plugins)
        return ScheduleOutcome(pod, None, reason, diagnosis)

    def _handle_failure(self, qp: QueuedPodInfo, plugins: Optional[set]) -> None:
        """handleSchedulingFailure (schedule_one.go:1020): the pod parks
        with its rejecting plugins (none: it backs off)."""
        self.queue.add_unschedulable(qp, plugins or set())

    # ----- the nominated-node path and the one-pod host cycle --------------

    @staticmethod
    def _prefilter_allowed(pod: Pod) -> Optional[set]:
        """NodeAffinity's PreFilterResult (node_affinity.go:140-171): the
        node names a required metadata.name In term narrows to; None when
        any node may pass."""
        aff = pod.affinity
        required = (
            aff.node_affinity.required_during_scheduling_ignored_during_execution
            if aff and aff.node_affinity
            else None
        )
        if required is None or not required.node_selector_terms:
            return None
        node_names = None
        for t in required.node_selector_terms:
            term_names = None
            for r in t.match_fields:
                if r.key == "metadata.name" and r.operator == "In":
                    vals = set(r.values)
                    term_names = vals if term_names is None else (term_names & vals)
            if term_names is None:
                return None  # ORed terms: this one admits every node
            node_names = term_names if node_names is None else (node_names | term_names)
        return node_names

    def _schedule_one_nominated(self, profile: Profile, qp: QueuedPodInfo) -> List[ScheduleOutcome]:
        """The nominated-node path (schedule_one.go:490-499): a pod whose
        preemption nominated a node checks THAT node only, with the other
        nominations of >= priority counted there and then, when any were,
        without them (a node feasible only through an unbound nomination may
        never materialize), and binds there when it passes.  A pod a host
        Filter could act on runs the host plugins' PreFilter first (a
        rejection fails it unresolvably) and their Filters on the node in
        both passes.  Otherwise the full one-pod host cycle runs."""
        pod = qp.pod
        nom = pod.nominated_node_name
        fwk = self.frameworks[profile.scheduler_name]
        state = None
        if fwk.maybe_relevant(pod):
            state = CycleState()
            pf = fwk.run_pre_filter(state, [pod])
            if pod.uid in pf:
                s_ = pf[pod.uid]
                self.metrics["schedule_attempts"] += 1
                return [self._post_filter_or_fail(profile, state, qp, s_.merge_reason(), None,
                                                  {s_.plugin} if s_.plugin else set(), code=s_.code)]
        st = self.oracle_view()
        ns = st.nodes.get(nom)
        allowed = self._prefilter_allowed(pod)
        ok = ns is not None and (allowed is None or nom in allowed)

        def fits() -> bool:
            if not feasible_nodes(pod, st, enabled=profile.enabled, allowed=frozenset({nom})).feasible:
                return False
            return state is None or fwk.run_host_filters(state, pod, ns).ok

        if ok:
            added = [
                np_ for node, np_ in self.nominator.entries()
                if node == nom and np_.uid != pod.uid and np_.priority >= pod.priority
            ]
            for np_ in added:
                ns.add_pod(np_)
            try:
                ok = fits()
            finally:
                for np_ in added:
                    ns.remove_pod(np_)
            if ok and added:
                ok = fits()
        if ok:
            self.metrics["schedule_attempts"] += 1
            return [self._assume(qp, nom, state=state)]
        return self._schedule_one_host(profile, qp)

    def _schedule_one_host(self, profile: Profile, qp: QueuedPodInfo) -> List[ScheduleOutcome]:
        """One pod's full cycle on the host view (the reference's one-pod
        cycle without extenders): the host plugins' PreFilter (a rejection
        fails the pod unresolvably), every filter with the nominations of >=
        priority counted on their nodes, the second pass without them on
        those nodes, the host Filters on the nodes left, then the weighted
        scores (NodeResourcesFit under the profile's strategy) and the first
        best node, or, with a tie-break seed, the best by (score, bits).
        Under the sampling window the walk visits nodes in nodeTree order
        from the rotation cursor and stops at the window's size.  No host
        Score plugin is active for the claims this path admits (all bound:
        VolumeBinding's capacity score is off and has no binding to
        weigh)."""
        pod = qp.pod
        self.metrics["schedule_attempts"] += 1
        self.metrics["host_cycles"] += 1
        # one tie-break attempt per pod, consumed up front so an early
        # failure keeps the sequence aligned with the batched routes
        attempt = self._attempt_counter
        if self._tie_key is not None:
            self._attempt_counter = attempt + 1
        fwk = self.frameworks[profile.scheduler_name]
        state = CycleState()
        relevant = fwk.maybe_relevant(pod)
        if relevant:
            pf = fwk.run_pre_filter(state, [pod])
            if pod.uid in pf:
                s_ = pf[pod.uid]
                return [self._post_filter_or_fail(profile, state, qp, s_.merge_reason(), None,
                                                  {s_.plugin} if s_.plugin else set(), code=s_.code)]
        st = self.oracle_view()
        allowed = self._prefilter_allowed(pod)
        # the window is sized over the PreFilterResult-narrowed node list
        sample_pct = self._window_pct(profile)
        added = []
        for node, np_ in self.nominator.entries():
            if np_.uid != pod.uid and np_.priority >= pod.priority and node in st.nodes:
                st.nodes[node].add_pod(np_)
                added.append((node, np_))
        try:
            fit = feasible_nodes(pod, st, enabled=profile.enabled,
                                 allowed=frozenset(allowed) if allowed is not None else None,
                                 sample_pct=sample_pct, start_index=self._next_start_node_index)
        finally:
            for node, np_ in added:
                st.nodes[node].remove_pod(np_)
        if added and fit.feasible:
            nominated_nodes = {n for n, _ in added}
            recheck = [n for n in fit.feasible if n in nominated_nodes]
            if recheck:
                ok2 = set(feasible_nodes(pod, st, enabled=profile.enabled, allowed=frozenset(recheck)).feasible)
                dropped = [n for n in recheck if n not in ok2]
                fit.feasible = [n for n in fit.feasible if n not in dropped]
                for n in dropped:
                    fit.reasons.setdefault(n, []).append("node(s) only feasible with unbound nominated pods")
        if sample_pct is not None:
            # the rotation advances modulo the narrowed list's length
            # (findNodesThatPassFilters, schedule_one.go:625)
            self._next_start_node_index = (self._next_start_node_index + fit.processed) % max(fit.n_considered, 1)
        diag: Dict[str, int] = {}
        for rs in fit.reasons.values():
            for r in rs:
                diag[r] = diag.get(r, 0) + 1
        feasible, plugins = fit.feasible, set()
        if relevant:
            kept = []
            for n in feasible:
                s_ = fwk.run_host_filters(state, pod, st.nodes[n])
                if s_.ok:
                    kept.append(n)
                    continue
                reason = s_.merge_reason() or s_.plugin
                diag[reason] = diag.get(reason, 0) + 1
                plugins.add(s_.plugin)
            feasible = kept
        if not feasible:
            return [self._post_filter_or_fail(profile, state, qp, fit_error_message(len(st.nodes), diag),
                                              diag, plugins or None)]
        totals = prioritize(pod, st, feasible, weights=profile.score_weights, fit_scorer=profile.fit_plugin().score)
        if self._tie_key is not None and totals:
            # the batched routes' rule: the (score, bits) maximum, the bits
            # indexed by the node's place in the host view (K19 draws them)
            bits = ops_rng.tie_bits(self._tie_key, attempt, 1, len(st.nodes), self.device)[0].cpu().tolist()
            idx_of = {n: i for i, n in enumerate(st.nodes)}
            node = max(totals, key=lambda n: (totals[n], bits[idx_of[n]]))
        else:
            node = select_host(totals) if totals else feasible[0]
        return [self._assume(qp, node, state=state if relevant else None)]
