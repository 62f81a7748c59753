"""Host scheduler cache (pkg/scheduler/backend/cache/cache.go), the part the
signature fast path needs: node infos with their usage accounting, informer
adds of nodes and placed pods, and the bulk assume of one fast batch.

Every change to a Node object bumps ``static_version``, which keys the
scheduler's packed snapshot and its per-signature static rows.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.resource import Resource
from kubernetes_tpu_torch.api.types import Node, Pod


class CacheError(RuntimeError):
    """Cache invariant violation (the reference fatals on these)."""


@dataclass
class CachedNode:
    """NodeInfo analogue: node + accounting of the pods placed on it."""

    node: Optional[Node]  # None while only pods bound to it are known
    pods: Dict[str, Pod] = field(default_factory=dict)  # uid → pod
    requested: Resource = field(default_factory=Resource)
    non_zero_requested: Resource = field(default_factory=Resource)

    def add_pod(self, pod: Pod) -> None:
        self.requested.add(pod.compute_requests())
        self.non_zero_requested.add(pod.non_zero_requests())
        self.pods[pod.uid] = pod

    def remove_pod(self, pod: Pod) -> bool:
        old = self.pods.pop(pod.uid, None)
        if old is None:
            return False
        self.requested.sub(old.compute_requests())
        self.non_zero_requested.sub(old.non_zero_requests())
        return True


def has_pod_terms(pod: Pod) -> bool:
    aff = pod.affinity
    return aff is not None and (
        aff.pod_affinity is not None or aff.pod_anti_affinity is not None
    )


class Cache:
    def __init__(self):
        self.nodes: Dict[str, CachedNode] = {}
        self.pod_states: Dict[str, Pod] = {}  # uid → placed (or assumed) pod
        self.assumed: set = set()
        self.static_version = 0  # bumped on every Node object change
        self.n_term_pods = 0  # placed pods carrying (anti-)affinity terms
        self.priorities: Counter = Counter()  # priority → placed pods

    # ----- nodes (informer) -----------------------------------------------

    def add_node(self, node: Node) -> None:
        cn = self.nodes.get(node.name)
        if cn is None:
            self.nodes[node.name] = CachedNode(node=node)
        else:
            cn.node = node
        self.static_version += 1

    def real_nodes(self) -> List[CachedNode]:
        return [cn for cn in self.nodes.values() if cn.node is not None]

    # ----- placed pods ----------------------------------------------------

    def _place(self, pod: Pod) -> None:
        cn = self.nodes.get(pod.node_name)
        if cn is None:
            cn = self.nodes[pod.node_name] = CachedNode(node=None)
        cn.add_pod(pod)
        self.pod_states[pod.uid] = pod
        self.priorities[pod.priority] += 1
        if has_pod_terms(pod):
            self.n_term_pods += 1

    def _unplace(self, pod: Pod) -> None:
        cn = self.nodes.get(pod.node_name)
        if cn is None or not cn.remove_pod(pod):
            raise CacheError(f"pod {pod.key} not found on node {pod.node_name!r}")
        del self.pod_states[pod.uid]
        self.priorities[pod.priority] -= 1
        if not self.priorities[pod.priority]:
            del self.priorities[pod.priority]
        if has_pod_terms(pod):
            self.n_term_pods -= 1
        if cn.node is None and not cn.pods:
            del self.nodes[pod.node_name]

    def add_pod(self, pod: Pod) -> None:
        """Informer add of a placed pod; confirms an assumed one."""
        old = self.pod_states.get(pod.uid)
        if old is not None:
            if pod.uid not in self.assumed:
                raise CacheError(f"pod {pod.key} added twice")
            self._unplace(old)
            self.assumed.discard(pod.uid)
        self._place(pod)

    def assume_pods_bulk(self, pairs) -> List[Pod]:
        """Assume one fast batch's placements in one pass: each pod is
        charged to its node as a COPY bound to that node, so the queued
        object stays pristine.  The fast gate guarantees these pods carry no
        inter-pod terms or host ports."""
        out = []
        for pod, node_name in pairs:
            if pod.uid in self.pod_states:
                raise CacheError(f"pod {pod.key} already assumed/added")
            assumed = object.__new__(type(pod))
            assumed.__dict__.update(pod.__dict__)
            assumed.node_name = node_name
            self._place(assumed)
            self.assumed.add(pod.uid)
            out.append(assumed)
        return out

    def forget_pod(self, pod: Pod) -> None:
        if pod.uid not in self.assumed:
            raise CacheError(f"pod {pod.key} was not assumed; cannot forget")
        self._unplace(self.pod_states[pod.uid])
        self.assumed.discard(pod.uid)
