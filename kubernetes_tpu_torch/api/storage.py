"""Storage API objects the volume plugins read.

A copy of the part of the JAX package's api/storage.py that the port's
volume route uses (corev1 PersistentVolume / PersistentVolumeClaim, storagev1
StorageClass / CSINode, scoped to what pkg/scheduler/framework/plugins/
volumebinding, volumezone, volumerestrictions and nodevolumelimits read).

Every object carries a ``resource_version``: the assume cache
(util/assumecache.py) uses it to decide whether an informer event supersedes
an assumed object.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from kubernetes_tpu_torch.api.resource import parse_int_quantity
from kubernetes_tpu_torch.api.types import LabelSelector, NodeSelector

# volume binding modes (storagev1.StorageClass)
BINDING_IMMEDIATE = "Immediate"
BINDING_WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"

# PV / PVC phases
PV_AVAILABLE = "Available"
PV_BOUND = "Bound"
PV_RELEASED = "Released"
PVC_PENDING = "Pending"
PVC_BOUND = "Bound"
PVC_LOST = "Lost"

# access modes
RWO = "ReadWriteOnce"
ROX = "ReadOnlyMany"
RWX = "ReadWriteMany"
RWOP = "ReadWriteOncePod"

# the StorageClass provisioner that means "no dynamic provisioning"
NO_PROVISIONER = "kubernetes.io/no-provisioner"

# zone / region label keys VolumeZone compares (volume_zone.go
# topologyLabels, the GA and the legacy beta forms)
ZONE_LABELS = (
    "topology.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/zone",
)
REGION_LABELS = (
    "topology.kubernetes.io/region",
    "failure-domain.beta.kubernetes.io/region",
)
VOLUME_TOPOLOGY_LABELS = ZONE_LABELS + REGION_LABELS


@dataclass
class ObjectRef:
    """PV.spec.claimRef: the claim a PV is bound to."""

    namespace: str = ""
    name: str = ""
    uid: str = ""


@dataclass
class PersistentVolume:
    """corev1.PersistentVolume, scheduler view.  ``source_kind`` /
    ``source_id`` collapse the volume-source union (gcePersistentDisk,
    awsElasticBlockStore, csi, local, ...) to (kind, opaque id)."""

    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    capacity: int = 0  # spec.capacity["storage"], bytes
    access_modes: Tuple[str, ...] = (RWO,)
    storage_class_name: str = ""
    node_affinity: Optional[NodeSelector] = None  # spec.nodeAffinity.required
    claim_ref: Optional[ObjectRef] = None
    phase: str = PV_AVAILABLE
    volume_mode: str = "Filesystem"
    source_kind: str = "csi"
    source_id: str = ""
    csi_driver: str = ""  # source_kind == "csi": spec.csi.driver
    read_only: bool = False
    resource_version: int = 0

    @classmethod
    def make(cls, name: str, capacity: str | int = "1Gi", **kw) -> "PersistentVolume":
        return cls(name=name, capacity=parse_int_quantity(capacity), **kw)

    @property
    def key(self) -> str:
        return self.name

    def clone(self) -> "PersistentVolume":
        return copy.deepcopy(self)


@dataclass
class PersistentVolumeClaim:
    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    # spec.storageClassName; None means "no class"
    storage_class_name: Optional[str] = None
    access_modes: Tuple[str, ...] = (RWO,)
    request: int = 0  # spec.resources.requests["storage"], bytes
    selector: Optional[LabelSelector] = None
    volume_mode: str = "Filesystem"
    volume_name: str = ""  # spec.volumeName: the bound PV
    phase: str = PVC_PENDING
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0

    @classmethod
    def make(cls, name: str, request: str | int = "1Gi", **kw) -> "PersistentVolumeClaim":
        return cls(name=name, request=parse_int_quantity(request), **kw)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def is_fully_bound(self) -> bool:
        """binder.go isPVCFullyBound: a bound volume name and the Bound phase."""
        return bool(self.volume_name) and self.phase == PVC_BOUND

    def clone(self) -> "PersistentVolumeClaim":
        return copy.deepcopy(self)


@dataclass
class StorageClass:
    name: str
    provisioner: str = "test.csi.example.com"
    volume_binding_mode: str = BINDING_IMMEDIATE
    resource_version: int = 0

    @property
    def key(self) -> str:
        return self.name

    def is_wait_for_first_consumer(self) -> bool:
        return self.volume_binding_mode == BINDING_WAIT_FOR_FIRST_CONSUMER


@dataclass
class CSINodeDriver:
    name: str
    node_id: str = ""
    # spec.drivers[].allocatable.count: attachable volumes; None = no limit
    allocatable_count: Optional[int] = None


@dataclass
class CSINode:
    """storagev1.CSINode: one per node, named as the node."""

    name: str
    drivers: Tuple[CSINodeDriver, ...] = ()
    resource_version: int = 0

    @property
    def key(self) -> str:
        return self.name

    def driver(self, name: str) -> Optional[CSINodeDriver]:
        for d in self.drivers:
            if d.name == name:
                return d
        return None
