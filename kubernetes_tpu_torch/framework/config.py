"""SchedulerConfiguration: the knobs the signature fast path reads.

Defaults and meanings are the JAX package's (its framework/config.py).
``resident_drain`` defaults to True there and here; this slice ports the
``residentDrain: false`` route, so a device-sized fast batch under the
default raises NotImplementedError until ``resident_run`` is ported
(ROADMAP B3).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from kubernetes_tpu_torch.ops.scores import DEFAULT_SCORE_WEIGHTS, WEIGHT_ORDER

DEFAULT_SCHEDULER_NAME = "default-scheduler"

# device-backed Filter/Score plugins of the default profile
DEFAULT_ENABLED = frozenset(
    {
        "ImageLocality",
        "InterPodAffinity",
        "NodeAffinity",
        "NodeName",
        "NodePorts",
        "NodeResourcesBalancedAllocation",
        "NodeResourcesFit",
        "NodeUnschedulable",
        "PodTopologySpread",
        "TaintToleration",
    }
)


@dataclass
class Profile:
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    enabled: frozenset = DEFAULT_ENABLED
    score_weights: Dict[str, int] = field(default_factory=lambda: dict(DEFAULT_SCORE_WEIGHTS))

    def weights(self) -> tuple:
        """Score weights in WEIGHT_ORDER: [0] taint, [1] naff, [4] fit,
        [5] bal, [6] img."""
        return tuple(self.score_weights.get(n, 0) for n in WEIGHT_ORDER)


@dataclass
class SchedulerConfiguration:
    profiles: List[Profile] = field(default_factory=lambda: [Profile()])
    batch_size: int = 512  # pods per popped batch
    # fast batches EXTEND up to this many pods while the queue head stays
    # signature-eligible with already-evaluated signatures
    fast_batch_max: int = 4096
    # fast batches smaller than this commit on the host FastCommitter; larger
    # ones take the device sig_scan kernel
    fast_device_min: int = 1024
    # device-resident drain loop (resident_run): not ported yet (ROADMAP B3)
    resident_drain: bool = True
    # every device batch also runs usage_checksum and checks it against the
    # host-tracked sum
    resident_epoch_guard: bool = True

    def validate(self) -> None:
        if self.batch_size < 1 or self.fast_batch_max < self.batch_size:
            raise ValueError("need 1 <= batch_size <= fast_batch_max")
        names = [p.scheduler_name for p in self.profiles]
        if not names or len(set(names)) != len(names):
            raise ValueError("profiles need distinct scheduler names")
        for p in self.profiles:
            if any(w < 0 for w in p.score_weights.values()):
                raise ValueError("score weights must be non-negative")
