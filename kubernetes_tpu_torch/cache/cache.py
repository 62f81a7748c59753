"""Host scheduler cache (pkg/scheduler/backend/cache/cache.go): node infos
with their usage accounting, informer adds and deletes of nodes and placed
pods, the assume protocol, and the registry of placed pods that carry (anti-)affinity
terms.

Every mutation bumps the node's ``generation``; a change to the Node object
also bumps its ``static_generation``.  The snapshot mirror repacks only
nodes newer than its own watermark (cache.go:185's incremental
UpdateSnapshot).  ``pod_version`` moves on every placed-pod change and keys
the mirror's placed-pod tensors; ``term_version`` moves when a term-carrying
pod comes or goes and keys the fast gate's probes.
"""

from __future__ import annotations

import itertools
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.resource import Resource
from kubernetes_tpu_torch.api.types import Node, Pod

_generation = itertools.count(1)


def next_generation() -> int:
    return next(_generation)


class CacheError(RuntimeError):
    """Cache invariant violation (the reference fatals on these)."""


@dataclass
class CachedNode:
    """NodeInfo analogue: node + accounting of the pods placed on it."""

    node: Optional[Node]  # None while only pods bound to it are known
    pods: Dict[str, Pod] = field(default_factory=dict)  # uid → pod
    requested: Resource = field(default_factory=Resource)
    non_zero_requested: Resource = field(default_factory=Resource)
    generation: int = 0
    static_generation: int = 0  # bumped only when the Node object changes

    def add_pod(self, pod: Pod) -> None:
        self.requested.add(pod.compute_requests())
        self.non_zero_requested.add(pod.non_zero_requests())
        self.pods[pod.uid] = pod
        self.generation = next_generation()

    def remove_pod(self, pod: Pod) -> bool:
        old = self.pods.pop(pod.uid, None)
        if old is None:
            return False
        self.requested.sub(old.compute_requests())
        self.non_zero_requested.sub(old.non_zero_requests())
        self.generation = next_generation()
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
        self.pod_version = 0
        self.n_term_pods = 0  # placed pods carrying (anti-)affinity terms
        # the term-carrying placed pods themselves: the fast gate asks "could
        # any placed term admit this pod" instead of refusing cluster-wide
        self.term_pods: Dict[str, Pod] = {}
        self.term_version = 0
        self.priorities: Counter = Counter()  # priority → placed pods

    # ----- nodes (informer) -----------------------------------------------

    def add_node(self, node: Node) -> None:
        g = next_generation()
        cn = self.nodes.get(node.name)
        if cn is None:
            self.nodes[node.name] = CachedNode(node=node, generation=g, static_generation=g)
        else:
            cn.node = node
            cn.generation = cn.static_generation = g

    def real_nodes(self) -> List[CachedNode]:
        return [cn for cn in self.nodes.values() if cn.node is not None]

    def placed_pods(self) -> List[Pod]:
        return [p for cn in self.nodes.values() for p in cn.pods.values()]

    # ----- placed pods ----------------------------------------------------

    def _count(self, pod: Pod, sign: int) -> None:
        self.pod_version += 1
        self.priorities[pod.priority] += sign
        if not self.priorities[pod.priority]:
            del self.priorities[pod.priority]
        if has_pod_terms(pod):
            self.n_term_pods += sign
            self.term_version += 1
            if sign > 0:
                self.term_pods[pod.uid] = pod
            else:
                self.term_pods.pop(pod.uid, None)

    def _place(self, pod: Pod) -> None:
        cn = self.nodes.get(pod.node_name)
        if cn is None:
            cn = self.nodes[pod.node_name] = CachedNode(node=None)
        cn.add_pod(pod)
        self.pod_states[pod.uid] = pod
        self._count(pod, +1)

    def _unplace(self, pod: Pod) -> None:
        cn = self.nodes.get(pod.node_name)
        if cn is None or not cn.remove_pod(pod):
            raise CacheError(f"pod {pod.key} not found on node {pod.node_name!r}")
        del self.pod_states[pod.uid]
        self._count(pod, -1)
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
        """Assume one batch's placements in one pass: each pod is charged to
        its node as a COPY bound to that node, so the queued object stays
        pristine."""
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

    def remove_pod(self, pod: Pod) -> None:
        """Informer delete of a placed (or assumed) pod; unknown pods are
        ignored.  The node's usage, the placed-pod population and the term
        registry all move, so the mirror repacks the node's usage row and
        rebuilds its placed-pod tensors."""
        old = self.pod_states.get(pod.uid)
        if old is None:
            return
        self._unplace(old)
        self.assumed.discard(pod.uid)

    def forget_pod(self, pod: Pod) -> None:
        if pod.uid not in self.assumed:
            raise CacheError(f"pod {pod.key} was not assumed; cannot forget")
        self._unplace(self.pod_states[pod.uid])
        self.assumed.discard(pod.uid)
