"""Dynamic Resource Allocation API objects (resource.k8s.io v1alpha3).

A copy of the JAX package's api/dra.py: the structured-parameters DRA
surface the DynamicResources plugin and the workloads dispatch read
(staging/src/k8s.io/api/resource/v1alpha3/types.go: ResourceClaim :311,
DeviceRequest :393, ResourceSlice :65, Device :190, DeviceClass :944,
AllocationResult :701).

Device selectors are (attribute, op, values) requirements rather than CEL
expressions (the reference evaluates CEL against device attributes, :487);
the matching semantics, every selector must admit the device, are kept.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

ALLOCATION_MODE_EXACT = "ExactCount"
ALLOCATION_MODE_ALL = "All"


@dataclass(frozen=True)
class DeviceSelector:
    """All requirements must hold for a device to match."""

    attribute: str
    operator: str = "In"  # In / NotIn / Exists / DoesNotExist
    values: Tuple[str, ...] = ()

    def matches(self, attributes: Dict[str, str]) -> bool:
        has = self.attribute in attributes
        if self.operator == "Exists":
            return has
        if self.operator == "DoesNotExist":
            return not has
        if self.operator == "In":
            return has and attributes[self.attribute] in self.values
        if self.operator == "NotIn":
            return not has or attributes[self.attribute] not in self.values
        return False


@dataclass
class DeviceClass:
    name: str
    selectors: Tuple[DeviceSelector, ...] = ()
    resource_version: int = 0

    @property
    def key(self) -> str:
        return self.name

    def admits(self, attributes: Dict[str, str]) -> bool:
        return all(s.matches(attributes) for s in self.selectors)


@dataclass(frozen=True)
class Device:
    """One device in a ResourceSlice pool (types.go:190)."""

    name: str
    attributes: Tuple[Tuple[str, str], ...] = ()

    def attr_map(self) -> Dict[str, str]:
        return dict(self.attributes)


@dataclass
class ResourceSlice:
    """Driver-published devices for one node's pool (types.go:65)."""

    name: str
    node_name: str = ""
    driver: str = ""
    pool: str = ""
    devices: Tuple[Device, ...] = ()
    resource_version: int = 0

    @property
    def key(self) -> str:
        return self.name


@dataclass(frozen=True)
class DeviceRequest:
    """One request inside a claim (types.go:393)."""

    name: str
    device_class_name: str
    count: int = 1
    allocation_mode: str = ALLOCATION_MODE_EXACT
    selectors: Tuple[DeviceSelector, ...] = ()


@dataclass(frozen=True)
class DeviceRequestAllocationResult:
    """types.go:756 — which concrete device satisfied which request."""

    request: str
    driver: str
    pool: str
    device: str


@dataclass
class AllocationResult:
    results: Tuple[DeviceRequestAllocationResult, ...] = ()
    node_name: str = ""  # nodeSelector collapsed to the single chosen node


@dataclass
class ResourceClaim:
    name: str
    namespace: str = "default"
    requests: Tuple[DeviceRequest, ...] = ()
    # status
    allocation: Optional[AllocationResult] = None
    reserved_for: Tuple[str, ...] = ()  # pod uids (ReservedFor consumers)
    deallocation_requested: bool = False
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0

    MAX_RESERVED = 32  # resourceapi.ResourceClaimReservedForMaxSize

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def clone(self) -> "ResourceClaim":
        return copy.deepcopy(self)
