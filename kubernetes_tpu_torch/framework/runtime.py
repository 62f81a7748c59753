"""Framework runtime: one profile's host plugins, runnable.

A copy of the host-plugin surface of the JAX package's framework/runtime.py
(pkg/scheduler/framework/runtime/framework.go): the plugins whose Filter
runs on the host (the volume plugins and DynamicResources,
framework/plugins.py ``default_plugins``) and the Run* methods of their extension points.  The
device-backed Filter and Score plugins stay where the port has them: kernel
names in the profile's ``enabled`` set, evaluated by the kernels.

Left out: PreFilter extensions (AddPod / RemovePod) and Permit's waiting
pods (no default plugin has them; ROADMAP A7), host Score plugins (A6b).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.framework.interface import (
    Code,
    CycleState,
    FilterPlugin,
    PreBindPlugin,
    PreFilterPlugin,
    ReservePlugin,
    Status,
)


class Framework:
    """One profile's host plugins, in the profile's order (the reference's
    default multi-point order: VolumeRestrictions, NodeVolumeLimits,
    VolumeBinding, VolumeZone, then DynamicResources under the
    DynamicResourceAllocation gate)."""

    def __init__(self, plugin_classes: Sequence[type], handle=None):
        self.plugins = [cls(handle) for cls in plugin_classes]

    def host_filter_plugins(self) -> List[FilterPlugin]:
        return [p for p in self.plugins if isinstance(p, FilterPlugin)]

    def has_host_filters(self) -> bool:
        return bool(self.host_filter_plugins())

    def maybe_relevant(self, pod: Pod) -> bool:
        """Could any host Filter act on the pod (a spec-only check)?"""
        return any(p.maybe_relevant(pod) for p in self.host_filter_plugins())

    def run_pre_filter(self, state: CycleState, pods: Sequence[Pod]) -> Dict[str, Status]:
        """RunPreFilterPlugins per pod (runtime/framework.go:698): uid → the
        rejecting Status of pods that must not reach Filter; a Skip marks
        the plugin's Filter skipped for that pod."""
        failures: Dict[str, Status] = {}
        plugins = [p for p in self.plugins if isinstance(p, PreFilterPlugin)]
        for pod in pods:
            for p in plugins:
                s = p.pre_filter(state, pod)
                if s.code == Code.SKIP:
                    state.mark_skip_filter(pod.uid, p.name)
                    continue
                if not s.ok:
                    if not s.plugin:
                        s.plugin = p.name
                    failures[pod.uid] = s
                    break
        return failures

    def run_host_filters(self, state: CycleState, pod: Pod, node_state) -> Status:
        """The host Filter plugins not skipped for the pod, on one node; the
        first rejection (runtime:861)."""
        for p in self.host_filter_plugins():
            if state.is_filter_skipped(pod.uid, p.name):
                continue
            s = p.filter(state, pod, node_state)
            if not s.ok:
                if not s.plugin:
                    s.plugin = p.name
                return s
        return Status.success()

    def active_host_filters(self, state: CycleState, pods: Sequence[Pod]) -> List[FilterPlugin]:
        """The host Filter plugins PreFilter did not skip for some pod."""
        return [p for p in self.host_filter_plugins()
                if any(not state.is_filter_skipped(pod.uid, p.name) for pod in pods)]

    def run_reserve(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self.plugins:
            if isinstance(p, ReservePlugin):
                s = p.reserve(state, pod, node_name)
                if not s.ok:
                    self.run_unreserve(state, pod, node_name)
                    return s
        return Status.success()

    def run_unreserve(self, state: CycleState, pod: Pod, node_name: str) -> None:
        for p in reversed(self.plugins):
            if isinstance(p, ReservePlugin):
                p.unreserve(state, pod, node_name)

    def run_pre_bind(self, state: CycleState, pod: Pod, node_name: str) -> Status:
        for p in self.plugins:
            if isinstance(p, PreBindPlugin):
                s = p.pre_bind(state, pod, node_name)
                if not s.ok:
                    return s
        return Status.success()
