"""DynamicResources (DRA): structured-parameters claim allocation as a host
plugin.

A copy of the JAX package's framework/dynamicresources.py
(pkg/scheduler/framework/plugins/dynamicresources/dynamicresources.go:
:709 PreFilter, :902 Filter, :1156 Reserve, :1306 Unreserve, :1367
PreBind, :379 EventsToRegister) over the claim AssumeCache, with the
structured allocator reduced to its scheduling semantics: a claim's device
requests are met by free devices from the node's ResourceSlices whose
attributes pass the DeviceClass and request selectors; cross-claim
exclusivity comes from the devices every other allocated claim in the cache
holds.

It joins a profile's host plugins only under the DynamicResourceAllocation
gate (framework/config.py), after VolumeZone, the reference's order before
DefaultBinder.  On the port's route the workloads dispatch proves a claims
pod's node with kernels K13, K14 and K11 (ops/dra.py); the Filter here runs
for the chosen node only (the scheduler's ``_wl_host_replay``), in the
nominated-node path and in the preemption dry run, so that Reserve reads a
per-node allocation.  PreEnqueue (a pod whose claim does not exist yet
waits outside the queue) is ROADMAP A5: the scheduler refuses such a pod.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from kubernetes_tpu_torch.api import dra
from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.framework.interface import (
    ActionType,
    ClusterEvent,
    ClusterEventWithHint,
    CycleState,
    EventResource,
    FilterPlugin,
    PreBindPlugin,
    PreFilterPlugin,
    QueueingHint,
    ReservePlugin,
    Status,
)

REASON_CANNOT_ALLOCATE = "cannot allocate all devices"


def allocate_on_node(claim: dra.ResourceClaim, node_name: str, node_slices: List[dra.ResourceSlice],
                     device_classes: Dict[str, dra.DeviceClass],
                     taken: Set[Tuple[str, str, str]]) -> Optional[dra.AllocationResult]:
    """The structured allocator's walk for one (claim, node), as
    DynamicResources._allocate_on_node: ``taken`` gathers the grants (a
    pod's earlier claims and requests shadow its later ones) and gives this
    claim's back when it fails."""
    results: List[dra.DeviceRequestAllocationResult] = []
    granted: List[Tuple[str, str, str]] = []

    def fail() -> None:
        for key in granted:
            taken.discard(key)

    for req in claim.requests:
        device_class = device_classes.get(req.device_class_name)
        if device_class is None:
            fail()
            return None
        found: List[dra.DeviceRequestAllocationResult] = []
        want = req.count if req.allocation_mode == dra.ALLOCATION_MODE_EXACT else None
        ok = True
        for sl in node_slices:
            for dev in sl.devices:
                key = (sl.driver, sl.pool, dev.name)
                attrs = dev.attr_map()
                if not device_class.admits(attrs) or not all(s.matches(attrs) for s in req.selectors):
                    continue
                if key in taken:
                    if want is None:
                        ok = False  # All: one matching device in use fails the node
                        break
                    continue
                found.append(dra.DeviceRequestAllocationResult(request=req.name, driver=sl.driver, pool=sl.pool,
                                                               device=dev.name))
                taken.add(key)
                granted.append(key)
                if want is not None and len(found) >= want:
                    break
            if not ok or (want is not None and len(found) >= want):
                break
        if not ok or (want is not None and len(found) < want) or (want is None and not found):
            fail()
            return None
        results.extend(found)
    return dra.AllocationResult(results=tuple(results), node_name=node_name)


class _Classes:
    """The handle's DeviceClass lister as a mapping (``.get``)."""

    def __init__(self, handle):
        self._handle = handle

    def get(self, name: str):
        return self._handle.get_device_class(name)


class DynamicResources(PreFilterPlugin, FilterPlugin, ReservePlugin, PreBindPlugin):
    name = "DynamicResources"
    _STATE_KEY = "DynamicResources"

    def maybe_relevant(self, pod: Pod) -> bool:
        return bool(pod.resource_claims)

    # -- PreFilter (:709) -----------------------------------------------------

    def pre_filter(self, state: CycleState, pod: Pod) -> Status:
        if not pod.resource_claims:
            return Status.skip()
        claims: List[dra.ResourceClaim] = []
        for name in pod.resource_claims:
            claim = self.handle.claim_cache.get(f"{pod.namespace}/{name}")
            if claim is None:
                return Status.unresolvable(f'resourceclaim "{name}" not found', plugin=self.name)
            if claim.deletion_timestamp is not None:
                return Status.unresolvable(f'resourceclaim "{name}" is being deleted', plugin=self.name)
            if (claim.allocation is not None and pod.uid not in claim.reserved_for
                    and len(claim.reserved_for) >= dra.ResourceClaim.MAX_RESERVED):
                return Status.unschedulable(f'resourceclaim "{name}" is reserved by too many pods',
                                            plugin=self.name)
            claims.append(claim)
        # per-cycle precomputes, so that Filter walks the node's slices only:
        # the cluster-wide allocated devices (the pod's own allocated claims'
        # too) and the slices by node
        slices_by_node: Dict[str, List] = {}
        for sl in self.handle.list_resource_slices():
            slices_by_node.setdefault(sl.node_name, []).append(sl)
        state.write((self._STATE_KEY, pod.uid), {"claims": claims, "by_node": {},
                                                 "taken_base": self._allocated_devices(),
                                                 "slices_by_node": slices_by_node})
        return Status.success()

    def _allocated_devices(self) -> Set[Tuple[str, str, str]]:
        """(driver, pool, device) of every device an allocated claim holds:
        the structured allocator's in-memory allocated state."""
        out: Set[Tuple[str, str, str]] = set()
        for claim in self.handle.claim_cache.list():
            if claim.allocation is None:
                continue
            for r in claim.allocation.results:
                out.add((r.driver, r.pool, r.device))
        return out

    # -- Filter (:902) --------------------------------------------------------

    def filter(self, state: CycleState, pod: Pod, node_state) -> Status:
        data = state.read((self._STATE_KEY, pod.uid))
        if data is None:
            return Status.success()
        node_name = node_state.node.name
        taken = set(data["taken_base"])
        node_slices = data["slices_by_node"].get(node_name, [])
        classes = _Classes(self.handle)
        allocations: List[Optional[dra.AllocationResult]] = []
        for claim in data["claims"]:
            if claim.allocation is not None:
                # already allocated: usable on the allocation's node only
                if claim.allocation.node_name and claim.allocation.node_name != node_name:
                    return Status.unschedulable(f'resourceclaim "{claim.name}" is allocated for node '
                                                f"{claim.allocation.node_name}", plugin=self.name)
                allocations.append(None)  # nothing new to allocate
                continue
            alloc = allocate_on_node(claim, node_name, node_slices, classes, taken)
            if alloc is None:
                return Status.unschedulable(f'{REASON_CANNOT_ALLOCATE} for resourceclaim "{claim.name}"',
                                            plugin=self.name)
            allocations.append(alloc)
        data["by_node"][node_name] = allocations
        return Status.success()

    # -- Reserve / Unreserve (:1156, :1306) -----------------------------------

    def reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        data = state.read((self._STATE_KEY, pod.uid))
        if data is None:
            return Status.success()
        allocations = data["by_node"].get(node_name)
        if allocations is None:
            return Status.error(f"no DRA decisions recorded for node {node_name}", plugin=self.name)
        assumed: List[Tuple[dra.ResourceClaim, bool]] = []
        for claim, alloc in zip(data["claims"], allocations):
            nc = claim.clone()
            if alloc is not None:
                nc.allocation = alloc
            if pod.uid not in nc.reserved_for:
                nc.reserved_for = nc.reserved_for + (pod.uid,)
            self.handle.claim_cache.assume(nc)
            assumed.append((nc, alloc is not None))
        data["assumed"] = assumed
        return Status.success()

    def unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        """Restore the cache view and undo what PreBind already wrote (the
        reference's Unreserve drops the reservation and deallocates an
        allocation the scheduler made)."""
        data = state.read((self._STATE_KEY, pod.uid))
        if data is None:
            return
        for claim, allocated_by_us in data.get("assumed", []):
            self.handle.claim_cache.restore(claim.key)
            api_obj = self.handle.claim_cache.get_api_obj(claim.key)
            if api_obj is None or pod.uid not in api_obj.reserved_for:
                continue  # never written: the cache restore is enough
            rb = api_obj.clone()
            rb.reserved_for = tuple(u for u in rb.reserved_for if u != pod.uid)
            if allocated_by_us and not rb.reserved_for:
                rb.allocation = None
            try:
                self.handle.write_claim(rb)
            except Exception:  # noqa: BLE001 — the rollback is best-effort
                pass
        data.pop("assumed", None)

    # -- PreBind (:1367): the allocation and the reservation through the API --

    def pre_bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        data = state.read((self._STATE_KEY, pod.uid))
        if data is None:
            return Status.success()
        for claim, _ in data.get("assumed", []):
            try:
                self.handle.write_claim(claim)
            except Exception as e:  # noqa: BLE001 — surfaced as the Status
                return Status.error(str(e), plugin=self.name)
        return Status.success()

    # -- queueing hints (:379 EventsToRegister) -------------------------------

    def events_to_register(self) -> List[ClusterEventWithHint]:
        def claim_hint(pod: Pod, old, new) -> QueueingHint:
            # a claim's change helps only the pods that reference it (:434)
            if new is None or new.namespace != pod.namespace:
                return QueueingHint.SKIP
            return QueueingHint.QUEUE if new.name in pod.resource_claims else QueueingHint.SKIP

        return [
            ClusterEventWithHint(ClusterEvent(EventResource.RESOURCE_CLAIM,
                                              ActionType.ADD | ActionType.UPDATE | ActionType.DELETE), claim_hint),
            ClusterEventWithHint(ClusterEvent(EventResource.RESOURCE_SLICE, ActionType.ADD | ActionType.UPDATE)),
            ClusterEventWithHint(ClusterEvent(EventResource.DEVICE_CLASS, ActionType.ADD | ActionType.UPDATE)),
            ClusterEventWithHint(ClusterEvent(EventResource.NODE, ActionType.ADD)),
        ]
