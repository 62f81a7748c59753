"""Preemption evaluator: the PostFilter dry run.

A copy of the JAX package's framework/preemption.py, the reference's
generic evaluator (preemption.go:148-212 Preempt, :216 findCandidates,
:431 pickOneNodeForPreemption) with DefaultPreemption's victim selection
(default_preemption.go:140-229 SelectVictimsOnNode, :239
PodEligibleToPreemptOthers):

  * eligibility (preemptionPolicy=Never, a terminating victim on the
    nominated node);
  * candidate discovery by dry-running victim removal per node: remove ALL
    lower-priority pods, check fit, then reprieve victims highest priority
    first (PDB-violating victims first);
  * lexicographic candidate selection (fewest PDB violations, lowest
    highest victim priority, lowest priority sum, fewest victims, latest
    earliest start time, first);
  * preparation: evict the victims, then clear lower-priority nominations
    on the chosen node.

The dry run's re-filter runs on the host ``OracleState``; the scheduler's
batched PostFilter narrows the nodes up front with K10
(ops/preemption.narrow_candidates), so only plausible nodes reach the
reprieve loop.  The profile's host Filter plugins (the volume plugins,
framework/runtime.py) judge the dry run too: PreFilter runs once per
preemptor, an UnschedulableAndUnresolvable host verdict removes a node from
the potential nodes, and every fit check runs the host Filters, on a
CycleState cloned per node.

Left out, because the port has no counterpart: PreFilter extensions' AddPod /
RemovePod notifications, extenders' ProcessPreemption, and Permit's waiting
pods (a victim is always deleted).  A pod that would need them is refused
before it reaches the evaluator.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import Pod, PodDisruptionBudget
from kubernetes_tpu_torch.framework.interface import Code, CycleState, Status
from kubernetes_tpu_torch.oracle import filters as OF
from kubernetes_tpu_torch.oracle.state import NodeState, OracleState, bump_pod_set_version


@dataclass
class Victims:
    """extenderv1.Victims analogue: pods ordered most important first."""

    pods: List[Pod] = field(default_factory=list)
    num_pdb_violations: int = 0


@dataclass
class Candidate:
    name: str
    victims: Victims


def more_important(a: Pod, b: Pod) -> bool:
    """util.MoreImportantPod: higher priority first; ties → earlier start
    (a missing start time counts as +inf)."""
    if a.priority != b.priority:
        return a.priority > b.priority
    sa = a.start_time if a.start_time is not None else float("inf")
    sb = b.start_time if b.start_time is not None else float("inf")
    return sa < sb


def _importance_key(p: Pod):
    return (-p.priority, p.start_time if p.start_time is not None else float("inf"))


class Evaluator:
    """framework/preemption.Evaluator.  ``handle`` provides oracle_state(),
    nominator, delete_pod(pod), list_pdbs(), activate(pods),
    note_preemption(n_victims) and, optionally, framework_for(pod) (the
    pod's profile's host plugins, framework/runtime.py, or None)."""

    def __init__(self, plugin_name: str, handle, percentage: int = 10, min_candidates: int = 100):
        self.plugin_name = plugin_name
        self.handle = handle
        self.percentage = percentage
        self.min_candidates = min_candidates
        self._fast_fit = False
        self._hf_fwk = self._hf_state = None

    # ----- entry point ------------------------------------------------------

    def preempt(
        self,
        pod: Pod,
        potential_nodes: Optional[Sequence[str]] = None,
        shortlist: Optional[set] = None,
    ) -> Tuple[Optional[str], Status]:
        """Returns (nominated_node_name, status).  A nominated "" with an
        unschedulable status means "clear any existing nomination".
        ``shortlist`` bounds the potential-node walk (the K10 narrow)."""
        state = self.handle.oracle_state()

        ok, msg = self.pod_eligible(pod, state)
        if not ok:
            return None, Status.unschedulable(msg, plugin=self.plugin_name)

        # Resource-only fast fit: without spread / inter-pod / port
        # constraints on the pod and no placed pod's required anti-affinity
        # anywhere, every _fits re-check inside the reprieve loop reduces to
        # request arithmetic (static filters were checked by
        # potential_nodes or the K10 narrow).
        self._fast_fit = (
            not pod.topology_spread_constraints
            and not (pod.affinity and (pod.affinity.pod_affinity or pod.affinity.pod_anti_affinity))
            and not pod.host_ports()
            and not any(
                p.affinity is not None
                and p.affinity.pod_anti_affinity is not None
                and p.affinity.pod_anti_affinity.required_during_scheduling_ignored_during_execution
                for ns in state.nodes.values()
                for p in ns.pods
            )
        )

        # the host Filter plugins (volume binding class) judge the dry run
        # too, or preemption evicts victims on nodes the pod's volumes can
        # never use (preemption.go:216); PreFilter runs once here
        self._hf_fwk = self._hf_state = None
        fwk = getattr(self.handle, "framework_for", lambda p: None)(pod)
        if fwk is not None and fwk.has_host_filters():
            cs = CycleState()
            if fwk.run_pre_filter(cs, [pod]):
                return "", Status.unschedulable("preemption is not helpful for scheduling", plugin=self.plugin_name)
            if fwk.active_host_filters(cs, [pod]):
                self._hf_fwk, self._hf_state = fwk, cs

        if potential_nodes is None:
            potential_nodes = self.potential_nodes(pod, state, shortlist)
        if not potential_nodes:
            # preemption can't help anywhere: clear a stale nomination
            return "", Status.unschedulable("preemption is not helpful for scheduling", plugin=self.plugin_name)

        offset, num = self.offset_and_num_candidates(len(potential_nodes))
        pdbs = self.handle.list_pdbs()
        candidates = self.dry_run(pod, state, list(potential_nodes)[offset:], num, pdbs)
        if not candidates:
            return "", Status.unschedulable(
                "no preemption victims found for incoming pod", plugin=self.plugin_name
            )

        best = self.select_candidate(candidates)
        self.handle.note_preemption(len(best.victims.pods))
        self.prepare_candidate(pod, best)
        return best.name, Status.success()

    # ----- eligibility (default_preemption.go:239) --------------------------

    def pod_eligible(self, pod: Pod, state: OracleState) -> Tuple[bool, str]:
        if pod.preemption_policy == "Never":
            return False, "not eligible due to preemptionPolicy=Never"
        nom = pod.nominated_node_name
        if nom:
            ns = state.nodes.get(nom)
            if ns is not None:
                for p in ns.pods:
                    if p.priority < pod.priority and p.deletion_timestamp is not None:
                        return False, "not eligible due to a terminating pod on the nominated node"
        return True, ""

    # ----- candidate discovery ---------------------------------------------

    def offset_and_num_candidates(self, n: int) -> Tuple[int, int]:
        """GetOffsetAndNumCandidates: max(n·percentage/100, minCandidates),
        capped at n.  The offset is 0 for deterministic decisions (the
        reference randomizes it to spread load)."""
        num = max(n * self.percentage // 100, self.min_candidates)
        return 0, min(num, n)

    def potential_nodes(self, pod: Pod, state: OracleState, shortlist: Optional[set] = None) -> List[str]:
        """Nodes where removing lower-priority pods COULD make the pod
        schedulable: it has victims and passes every filter no removal can
        fix (NodesForStatusCode(Unschedulable), preemption.go:216-230).
        ``shortlist`` is the K10 narrow's superset; the walk keeps the
        snapshot's node order either way, so truncation is deterministic."""
        out = []
        for name, ns in state.nodes.items():
            if shortlist is not None and name not in shortlist:
                continue
            if not any(p.priority < pod.priority for p in ns.pods):
                continue
            if OF.filter_node_name(pod, ns):
                continue
            if OF.filter_node_unschedulable(pod, ns):
                continue
            if OF.filter_taints(pod, ns):
                continue
            if OF.filter_node_affinity(pod, ns):
                continue
            # only UnschedulableAndUnresolvable removes a node: victim
            # removal may resolve a plain Unschedulable host verdict
            if self._hf_fwk is not None and self._hf_fwk.run_host_filters(
                    self._hf_state, pod, ns).code == Code.UNSCHEDULABLE_AND_UNRESOLVABLE:
                continue
            out.append(name)
        return out

    def dry_run(
        self,
        pod: Pod,
        state: OracleState,
        nodes: Sequence[str],
        num_candidates: int,
        pdbs: Sequence[PodDisruptionBudget],
    ) -> List[Candidate]:
        """DryRunPreemption (preemption.go:548): candidates in node order,
        stopping once ``num_candidates`` are found."""
        candidates: List[Candidate] = []
        for name in nodes:
            victims = self.select_victims_on_node(pod, state, name, pdbs)
            if victims is not None:
                candidates.append(Candidate(name=name, victims=victims))
                if len(candidates) >= num_candidates:
                    break
        return candidates

    def select_victims_on_node(
        self,
        pod: Pod,
        state: OracleState,
        node_name: str,
        pdbs: Sequence[PodDisruptionBudget],
    ) -> Optional[Victims]:
        """SelectVictimsOnNode on a working copy of the node: remove all
        lower-priority pods, check fit, reprieve highest priority first
        (PDB-violating victims first)."""
        orig = state.nodes[node_name]
        work = NodeState(node=orig.node)
        potential: List[Pod] = []
        for p in orig.pods:
            if p.priority < pod.priority:
                potential.append(p)
            else:
                work.add_pod(p)
        if not potential:
            return None
        # a CycleState per node: plugin state written while judging one node
        # must not leak into the next
        prev_hf = self._hf_state
        if prev_hf is not None:
            self._hf_state = prev_hf.clone()
        state.nodes[node_name] = work
        bump_pod_set_version()  # the dict swap bypasses NodeState's mutators
        try:
            if not self._fits(pod, work, state):
                return None
            potential.sort(key=_importance_key)
            violating, non_violating = self._split_pdb_violations(potential, pdbs)
            victims: List[Pod] = []
            num_violating = 0

            def reprieve(v: Pod) -> bool:
                work.add_pod(v)
                if self._fits(pod, work, state):
                    return True
                work.remove_pod(v)
                victims.append(v)
                return False

            for v in violating:
                if not reprieve(v):
                    num_violating += 1
            for v in non_violating:
                reprieve(v)
            if not victims:
                return None  # everyone reprieved: nothing to preempt here
            victims.sort(key=_importance_key)
            return Victims(pods=victims, num_pdb_violations=num_violating)
        finally:
            state.nodes[node_name] = orig
            bump_pod_set_version()
            self._hf_state = prev_hf

    def _fits(self, pod: Pod, ns: NodeState, state: OracleState) -> bool:
        """RunFilterPluginsWithNominatedPods for one node: all default
        filters, with nominated pods of >= priority on the node counted
        (runtime/framework.go:973)."""
        nominated = [
            np_
            for np_ in self.handle.nominator.pods_for_node(ns.node.name)
            if np_.priority >= pod.priority and np_.uid != pod.uid
        ]
        if self._fast_fit and not nominated and self._hf_fwk is None:
            return not OF.filter_node_resources(pod, ns)
        for np_ in nominated:
            ns.add_pod(np_)
        try:
            if OF.filter_node_name(pod, ns):
                return False
            if OF.filter_node_unschedulable(pod, ns):
                return False
            if OF.filter_taints(pod, ns):
                return False
            if OF.filter_node_affinity(pod, ns):
                return False
            if OF.filter_node_ports(pod, ns):
                return False
            if OF.filter_node_resources(pod, ns):
                return False
            if OF.filter_interpod_affinity(pod, ns, state):
                return False
            counts = OF.spread_pair_counts(pod, state)
            if OF.filter_topology_spread(pod, ns, state, counts):
                return False
            return self._hf_fwk is None or self._hf_fwk.run_host_filters(self._hf_state, pod, ns).ok
        finally:
            for np_ in nominated:
                ns.remove_pod(np_)

    @staticmethod
    def _split_pdb_violations(
        victims: Sequence[Pod], pdbs: Sequence[PodDisruptionBudget]
    ) -> Tuple[List[Pod], List[Pod]]:
        """filterPodsWithPDBViolation (default_preemption.go:290): every
        matching PDB's budget is decremented per victim, and a victim
        violates when any matched budget goes negative."""
        allowed = [p.disruptions_allowed for p in pdbs]
        violating: List[Pod] = []
        non_violating: List[Pod] = []
        for v in victims:
            is_violating = False
            if v.labels:
                for i, p in enumerate(pdbs):
                    if not p.matches(v):
                        continue
                    allowed[i] -= 1
                    if allowed[i] < 0:
                        is_violating = True
            (violating if is_violating else non_violating).append(v)
        return violating, non_violating

    # ----- candidate selection (preemption.go:431) --------------------------

    @staticmethod
    def select_candidate(candidates: List[Candidate]) -> Candidate:
        if len(candidates) == 1:
            return candidates[0]

        def highest_priority(c: Candidate) -> int:
            return c.victims.pods[0].priority if c.victims.pods else -(2**31)

        def sum_priorities(c: Candidate) -> int:
            return sum(p.priority + 2**31 + 1 for p in c.victims.pods)

        def earliest_start(c: Candidate) -> float:
            starts = [p.start_time if p.start_time is not None else float("-inf") for p in c.victims.pods]
            return min(starts) if starts else float("-inf")

        pool = candidates
        for key, reverse in (
            (lambda c: c.victims.num_pdb_violations, False),
            (highest_priority, False),
            (sum_priorities, False),
            (lambda c: len(c.victims.pods), False),
            (earliest_start, True),  # the LATEST earliest start wins
        ):
            vals = [key(c) for c in pool]
            best = max(vals) if reverse else min(vals)
            pool = [c for c, v in zip(pool, vals) if v == best]
            if len(pool) == 1:
                return pool[0]
        return pool[0]

    # ----- preparation (preemption.go:349 prepareCandidate) -----------------

    def prepare_candidate(self, pod: Pod, c: Candidate) -> None:
        for victim in c.victims.pods:
            self.handle.delete_pod(victim)
        # lower-priority pods nominated here may no longer fit: clear their
        # nominations and reactivate them
        demoted = [np_ for np_ in self.handle.nominator.pods_for_node(c.name) if np_.priority < pod.priority]
        for np_ in demoted:
            np_.nominated_node_name = ""
            self.handle.nominator.delete(np_)
        if demoted:
            self.handle.activate(demoted)
