"""SchedulerConfiguration: the knobs the signature fast path reads.

Defaults and meanings are the JAX package's (its framework/config.py).
``resident_drain`` defaults to True there and here: device-sized fast
batches extend up to ``resident_run_max`` pods and are placed by
``resident_run`` (kernel K4); ``resident_drain=False`` places them with
``sig_scan`` (K2).  ``wave_dispatch`` defaults to True as there: batches
with their own cross-pod constraints (spread, inter-pod terms, host ports)
take the speculative wave (``wave_run`` / ``chain_dispatch(wave=True)``,
kernels K8 and K9); ``wave_dispatch=False`` sends them to the gang scan
(K5), with the same placements.  ``gang_dispatch`` defaults to True as
there: PodGroup members are admitted all or nothing by ``workloads_run``
(kernels K8 and K11).  ``planner_kernel`` (the reference's
``plannerKernel``) defaults to True as there: the what-if planners run on
``counterfactual_run``.  A profile's ``post_filter`` (on by
default, DefaultPreemption) preempts lower-priority pods for pods that fail
to schedule.  ``feature_gates`` holds the gates this scheduler reads, with
the reference's names and defaults: ``DynamicResourceAllocation`` (off by
default) adds the DynamicResources plugin to every profile, after
VolumeZone, so pods with ResourceClaims take the workloads dispatch; with
it off their claims are ignored.  ``validate`` rejects any other gate name.

The reference's sampling and tie-break knobs: ``percentage_of_nodes_to_score``
(0, the default, is adaptive; a profile's own value, None by default,
overrides it) and ``reference_sampling_compat`` cut each pod's Filter pass
to numFeasibleNodesToFind nodes in nodeTree order from a rotating cursor,
as upstream does; ``tie_break_seed`` breaks max-score ties with seeded bits
(ops/rng.py).  Any of them keeps batches off the fast path and the chained
and workloads dispatches, as in the reference.  A profile's
``plugin_config`` carries NodeResourcesFit's args (its scoring strategy,
framework/plugins.py); ``validate`` rejects args of other plugins.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.framework.plugins import NodeResourcesFit
from kubernetes_tpu_torch.ops.scores import DEFAULT_SCORE_WEIGHTS, WEIGHT_ORDER

DEFAULT_SCHEDULER_NAME = "default-scheduler"

# the feature gates this scheduler reads and their reference defaults
# (pkg/features/kube_features.go @ v1.31)
DEFAULT_FEATURE_GATES: List[Tuple[str, bool]] = [
    ("DynamicResourceAllocation", False),  # alpha
]

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
    # the DefaultPreemption PostFilter (on in the default profile) and its
    # candidate sizing: max(nodes·percentage/100, absolute), capped at nodes
    post_filter: bool = True
    min_candidate_nodes_percentage: int = 10
    min_candidate_nodes_absolute: int = 100
    # plugin name → args (only NodeResourcesFit's are read)
    plugin_config: Dict[str, dict] = field(default_factory=dict)
    # overrides the configuration's own value when set
    percentage_of_nodes_to_score: Optional[int] = None

    def weights(self) -> tuple:
        """Score weights in WEIGHT_ORDER: [0] taint, [1] naff, [4] fit,
        [5] bal, [6] img."""
        return tuple(self.score_weights.get(n, 0) for n in WEIGHT_ORDER)

    def fit_plugin(self) -> NodeResourcesFit:
        """NodeResourcesFit under this profile's args."""
        return NodeResourcesFit(self.plugin_config.get(NodeResourcesFit.name))

    def fit_strategy(self) -> tuple:
        """The kernels' (strategy id, shape, (w_cpu, w_mem))."""
        return self.fit_plugin().fit_strategy()


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
    # device-resident drain loop: large fast batches are placed by
    # resident_run's speculation/admission fixed point; off = sig_scan
    resident_drain: bool = True
    # resident RUN width: fast batches extend up to this many pods when the
    # resident path is engaged (supersedes fast_batch_max there)
    resident_run_max: int = 16384
    # speculation window per fixed-point round (clamped to the node count)
    resident_window: int = 2048
    # finish a run's unresolved tail on the device with the serial sig_scan
    # replay; off = unresolved pods come back UNRESOLVED and the host
    # committer finishes them
    resident_serial_tail: bool = False
    # every device batch also runs usage_checksum and checks it against the
    # host-tracked sum
    resident_epoch_guard: bool = True
    # cross-pod-constraint batches (spread / inter-pod terms / host ports)
    # take the speculative wave (K8 + K9); off = every such batch takes the
    # gang scan (K5), counted in wave_fallback_kill_switch
    wave_dispatch: bool = True
    # the gangDispatch switch: batches with members of registered PodGroups
    # take the workloads dispatch (K8 + K11, all-or-nothing gang admission);
    # off = gang members schedule one by one like any pod
    gang_dispatch: bool = True
    # the plannerKernel switch: the counterfactual planners run their forks
    # through counterfactual_run (K15, the workloads engine per fork, K16);
    # off = the same fork specs replay through the serial forked-snapshot
    # oracle (oracle/planner.py)
    planner_kernel: bool = True
    # component-base/featuregate: only the gates this scheduler reads exist
    feature_gates: Dict[str, bool] = field(default_factory=lambda: dict(DEFAULT_FEATURE_GATES))
    # the reference's percentageOfNodesToScore: 0 = adaptive (50 - nodes /
    # 125, floor 5 %); a profile's own value overrides it
    percentage_of_nodes_to_score: int = 0
    # sample with the adaptive formula even at 0 (upstream always samples;
    # the default here is full width)
    reference_sampling_compat: bool = False
    # seeded uniform tie-break among max-score nodes (the deterministic
    # analogue of selectHost's reservoir sampling); None: first max
    tie_break_seed: Optional[int] = None

    def dra_enabled(self) -> bool:
        """The DynamicResourceAllocation gate: the DynamicResources plugin
        joins every profile and claims are allocated."""
        return bool(self.feature_gates.get("DynamicResourceAllocation"))

    def validate(self) -> None:
        if self.batch_size < 1 or self.fast_batch_max < self.batch_size:
            raise ValueError("need 1 <= batch_size <= fast_batch_max")
        if self.resident_run_max < self.batch_size:
            raise ValueError("need batch_size <= resident_run_max")
        if self.resident_window < 1:
            raise ValueError("resident_window must be >= 1")
        if not 0 <= self.percentage_of_nodes_to_score <= 100:
            raise ValueError("percentageOfNodesToScore must be in [0, 100]")
        names = [p.scheduler_name for p in self.profiles]
        if not names or len(set(names)) != len(names):
            raise ValueError("profiles need distinct scheduler names")
        for p in self.profiles:
            if any(w < 0 for w in p.score_weights.values()):
                raise ValueError("score weights must be non-negative")
            if not 0 <= p.min_candidate_nodes_percentage <= 100 or p.min_candidate_nodes_absolute < 0:
                raise ValueError("min candidate nodes: percentage in [0, 100], absolute >= 0")
            if p.percentage_of_nodes_to_score is not None and not 0 <= p.percentage_of_nodes_to_score <= 100:
                raise ValueError("profile percentageOfNodesToScore must be in [0, 100]")
            other = sorted(set(p.plugin_config) - {NodeResourcesFit.name})
            if other:
                raise ValueError(f"plugin args this scheduler does not read: {', '.join(other)}")
            p.fit_plugin()  # the args' own validation
        unknown = sorted(set(self.feature_gates) - {name for name, _ in DEFAULT_FEATURE_GATES})
        if unknown:
            raise ValueError(f"feature gates this scheduler does not read: {', '.join(unknown)}")
