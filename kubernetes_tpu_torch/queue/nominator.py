"""Nominated-pod tracking (backend/queue/nominator.go), a copy of the JAX
package's queue/nominator.py.

Preemptor pods carry status.nominatedNodeName while their victims exit; the
nominator makes those reservations visible to scheduling cycles so the
capacity they are about to consume is respected
(RunFilterPluginsWithNominatedPods, runtime/framework.go:973).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.types import Pod


class Nominator:
    def __init__(self) -> None:
        self._by_node: Dict[str, Dict[str, Pod]] = {}
        self._node_of: Dict[str, str] = {}

    def add(self, pod: Pod, node_name: Optional[str] = None) -> None:
        node = node_name or pod.nominated_node_name
        if not node:
            return
        self.delete(pod)
        self._by_node.setdefault(node, {})[pod.uid] = pod
        self._node_of[pod.uid] = node
        pod.nominated_node_name = node

    def delete(self, pod: Pod) -> None:
        node = self._node_of.pop(pod.uid, None)
        if node:
            self._by_node.get(node, {}).pop(pod.uid, None)
            if not self._by_node.get(node):
                self._by_node.pop(node, None)

    def update(self, old: Pod, new: Pod) -> None:
        # Keep nomination unless the update carries a new one
        node = new.nominated_node_name or self._node_of.get(old.uid, "")
        self.delete(old)
        if node:
            self.add(new, node)

    def pods_for_node(self, node_name: str) -> List[Pod]:
        return list(self._by_node.get(node_name, {}).values())

    def entries(self) -> List[tuple]:
        """All (node_name, pod) nominations — the gang dispatch charges
        these to their nodes for lower-priority pods."""
        return [
            (node, pod)
            for node, pods in self._by_node.items()
            for pod in pods.values()
        ]

    def __len__(self) -> int:
        return len(self._node_of)

    def nominated_node(self, uid: str) -> Optional[str]:
        return self._node_of.get(uid)
