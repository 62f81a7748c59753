"""Scheduler-relevant object model (the subset the signature fast path reads).

A copy of the JAX package's object model, kept in this package so the port
imports nothing of it.  Field names are snake_case versions of the corev1
fields.  Pods carry every field the fast gate inspects (spread constraints,
inter-pod terms, host ports, volumes, claims, gangs) so the scheduler can
refuse the ones whose paths are not ported yet.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

from kubernetes_tpu_torch.api.resource import Resource

# ---------------------------------------------------------------------------
# Selectors (API-shape; converted to labels.Selector for matching)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LabelSelectorRequirement:
    key: str
    operator: str  # In / NotIn / Exists / DoesNotExist
    values: Tuple[str, ...] = ()


@dataclass(frozen=True)
class LabelSelector:
    match_labels: Optional[Mapping[str, str]] = None
    match_expressions: Tuple[LabelSelectorRequirement, ...] = ()


@dataclass(frozen=True)
class NodeSelectorRequirement:
    key: str
    operator: str  # In / NotIn / Exists / DoesNotExist / Gt / Lt
    values: Tuple[str, ...] = ()


@dataclass(frozen=True)
class NodeSelectorTerm:
    """Requirements are ANDed. An empty term matches nothing
    (component-helpers nodeaffinity: nil/empty term ⇒ no match)."""

    match_expressions: Tuple[NodeSelectorRequirement, ...] = ()
    match_fields: Tuple[NodeSelectorRequirement, ...] = ()


@dataclass(frozen=True)
class NodeSelector:
    """Terms are ORed."""

    node_selector_terms: Tuple[NodeSelectorTerm, ...] = ()


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass(frozen=True)
class NodeAffinity:
    required_during_scheduling_ignored_during_execution: Optional[NodeSelector] = None
    preferred_during_scheduling_ignored_during_execution: Tuple[
        PreferredSchedulingTerm, ...
    ] = ()


@dataclass(frozen=True)
class PodAffinityTerm:
    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: Tuple[str, ...] = ()
    namespace_selector: Optional[LabelSelector] = None
    match_label_keys: Tuple[str, ...] = ()
    mismatch_label_keys: Tuple[str, ...] = ()


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    pod_affinity_term: PodAffinityTerm


@dataclass(frozen=True)
class PodAffinity:
    required_during_scheduling_ignored_during_execution: Tuple[PodAffinityTerm, ...] = ()
    preferred_during_scheduling_ignored_during_execution: Tuple[
        WeightedPodAffinityTerm, ...
    ] = ()


@dataclass(frozen=True)
class PodAntiAffinity:
    required_during_scheduling_ignored_during_execution: Tuple[PodAffinityTerm, ...] = ()
    preferred_during_scheduling_ignored_during_execution: Tuple[
        WeightedPodAffinityTerm, ...
    ] = ()


@dataclass(frozen=True)
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


# ---------------------------------------------------------------------------
# Taints and tolerations
# ---------------------------------------------------------------------------

TAINT_NO_SCHEDULE = "NoSchedule"
TAINT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_NO_EXECUTE = "NoExecute"

TOLERATION_OP_EXISTS = "Exists"
TOLERATION_OP_EQUAL = "Equal"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = TAINT_NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    key: str = ""  # empty key + Exists tolerates everything
    operator: str = TOLERATION_OP_EQUAL
    value: str = ""
    effect: str = ""  # empty effect matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        """api/core/v1/toleration.go ToleratesTaint semantics."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        # Empty key with Exists tolerates every taint (wildcard).
        if not self.key:
            return self.operator == TOLERATION_OP_EXISTS
        if self.operator == TOLERATION_OP_EXISTS:
            return True
        return self.operator in ("", TOLERATION_OP_EQUAL) and self.value == taint.value


# ---------------------------------------------------------------------------
# Topology spread
# ---------------------------------------------------------------------------

DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"

NODE_INCLUSION_HONOR = "Honor"
NODE_INCLUSION_IGNORE = "Ignore"


@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule / ScheduleAnyway
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None
    node_affinity_policy: str = NODE_INCLUSION_HONOR
    node_taints_policy: str = NODE_INCLUSION_IGNORE
    match_label_keys: Tuple[str, ...] = ()


# ---------------------------------------------------------------------------
# Containers / ports / volumes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ContainerPort:
    container_port: int = 0
    host_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class Container:
    name: str = ""
    requests: Optional[Mapping[str, str | int | float]] = None
    limits: Optional[Mapping[str, str | int | float]] = None
    ports: Tuple[ContainerPort, ...] = ()
    restart_policy: Optional[str] = None  # "Always" ⇒ restartable (sidecar) init


@dataclass(frozen=True)
class Volume:
    """One pod volume.  Either a PVC reference or an inline source
    (gcePersistentDisk / awsElasticBlockStore / azureDisk / csi …) collapsed
    to (kind, opaque id) — what VolumeRestrictions/NodeVolumeLimits compare."""

    name: str = ""
    pvc_name: Optional[str] = None  # persistentVolumeClaim.claimName
    source_kind: str = ""  # "" for PVC-backed; gce-pd / aws-ebs / azure-disk / csi
    source_id: str = ""  # disk name / volume id / driver-scoped handle
    driver: str = ""  # inline CSI volumes: spec.csi.driver
    read_only: bool = False


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


@dataclass
class Node:
    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    capacity: Resource = field(default_factory=Resource)
    allocatable: Resource = field(default_factory=Resource)
    taints: Tuple[Taint, ...] = ()
    unschedulable: bool = False
    # image name → size bytes (NodeStatus.Images, for ImageLocality)
    images: Dict[str, int] = field(default_factory=dict)
    # NodeStatus.conditions[Ready] + lastHeartbeatTime, collapsed to the
    # two fields the node-lifecycle tier reads (kubelet heartbeats write
    # them through the node status subresource)
    ready: bool = True
    last_heartbeat: float = 0.0

    def __post_init__(self):
        # kubelet defaults allocatable to capacity when no reservation.
        if (
            self.allocatable.milli_cpu == 0
            and self.allocatable.memory == 0
            and self.allocatable.allowed_pod_number == 0
            and not self.allocatable.scalars
            and (self.capacity.milli_cpu or self.capacity.memory)
        ):
            self.allocatable = self.capacity.clone()


# ---------------------------------------------------------------------------
# Pod
# ---------------------------------------------------------------------------

DEFAULT_SCHEDULER_NAME = "default-scheduler"

_uid_counter = itertools.count(1)


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)

    # spec
    node_name: str = ""  # assigned node ("" = pending)
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    priority: int = 0
    priority_class_name: str = ""
    preemption_policy: str = "PreemptLowerPriority"  # or "Never"
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    overhead: Optional[Mapping[str, str | int | float]] = None
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: Tuple[Toleration, ...] = ()
    topology_spread_constraints: Tuple[TopologySpreadConstraint, ...] = ()
    scheduling_gates: Tuple[str, ...] = ()
    volumes: Tuple[Volume, ...] = ()
    # spec.resourceClaims[*].resourceClaimName (DRA)
    resource_claims: Tuple[str, ...] = ()
    # gang membership (coscheduling): PodGroup name in the pod's namespace
    # (the pod-group.scheduling.sigs.k8s.io/name label works too — see
    # workloads/gang.py group_key_of)
    pod_group: str = ""
    host_network: bool = False
    images: Tuple[str, ...] = ()

    # status
    phase: str = "Pending"
    nominated_node_name: str = ""
    deletion_timestamp: Optional[float] = None
    start_time: Optional[float] = None  # status.startTime (preemption tie-break)

    def __post_init__(self):
        if not self.uid:
            self.uid = f"{self.namespace}/{self.name}#{next(_uid_counter)}"

    # -- derived ------------------------------------------------------------

    def compute_requests(self) -> Resource:
        """Pod-level resource request (framework/types.go:926 calculateResource):
        sum of container requests, elementwise-max with each non-restartable
        init container, restartable (sidecar) inits added to the running sum,
        plus pod overhead.  Memoized — callers must treat the result as
        read-only (spec updates arrive as NEW Pod objects)."""
        cached = self.__dict__.get("_req_memo")
        if cached is not None:
            return cached
        total = Resource()
        for c in self.containers:
            total.add(Resource.from_map(c.requests))
        restartable_sum = Resource()
        init_max = Resource()
        for c in self.init_containers:
            r = Resource.from_map(c.requests)
            if c.restart_policy == "Always":
                restartable_sum.add(r)
                init_max.max_with(restartable_sum.clone())
            else:
                peak = restartable_sum.clone().add(r)
                init_max.max_with(peak)
        total.add(restartable_sum)
        total.max_with(init_max)
        if self.overhead:
            total.add(Resource.from_map(self.overhead))
        self.__dict__["_req_memo"] = total
        return total

    def non_zero_requests(self) -> Resource:
        """compute_requests() with the spreading defaults floored in
        (GetNonzeroRequests) — memoized like compute_requests: the cache
        adds/removes it on every assume/bind/forget."""
        cached = self.__dict__.get("_nzreq_memo")
        if cached is not None:
            return cached
        total = self.compute_requests().non_zero_defaulted()
        self.__dict__["_nzreq_memo"] = total
        return total

    def host_ports(self) -> List[ContainerPort]:
        out = []
        for c in self.containers:
            for p in c.ports:
                if p.host_port > 0:
                    out.append(p)
                elif self.host_network and p.container_port > 0:
                    out.append(
                        ContainerPort(
                            container_port=p.container_port,
                            host_port=p.container_port,
                            protocol=p.protocol,
                            host_ip=p.host_ip,
                        )
                    )
        return out

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"
