"""The sampling window, its rotation cursor and the seeded tie-break end
to end: the port's Scheduler (device="cpu") against the JAX Scheduler
(dispatch ledger off) on every case of tests/test_sampling_compat.py and
the second seed of tests/test_wave.py::test_sampling_compat_rides_wave (the
first is in tests/test_torch_rng.py, whose own work is light, so that
--dist loadfile spreads the JAX Scheduler's compiles over workers): the
placements, both counters (the rotation cursor and the attempt counter)
and the route counts.  Every output is an integer: the tolerance is zero.
"""

import random

import pytest

from kubernetes_tpu.framework.config import SchedulerConfiguration as JConfig
from kubernetes_tpu.observability import kernels as j_kernels
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch.framework.config import SchedulerConfiguration as PConfig
from kubernetes_tpu_torch.scheduler import Scheduler as PScheduler
from tests import test_sampling_compat as tsc
from tests.gen import make_pod
from tests.test_torch_pack import PORT_API
from tests.test_torch_sampling import SEED, _port_pods, _zoned_port_nodes, to_port
from tests.test_wave import _zone_nodes


def _drain(sched, nodes, pods):
    got = {}
    sched.binding_sink = lambda pod, node: got.__setitem__(pod.name, node)
    for n in nodes:
        sched.on_node_add(n)
    for p in pods:
        sched.on_pod_add(p)
    for o in sched.schedule_pending():
        got.setdefault(o.pod.name, o.node)
    return got


ROUTES = ("scan_batches", "wave_batches", "chain_batches", "fast_batches", "resident_batches", "workload_batches")


def _both(jnodes, jpods, pnodes, ppods, **cfg):
    js = JScheduler(JConfig(kernel_ledger=False, **cfg))
    j_kernels.deactivate()
    want = _drain(js, jnodes, jpods)
    ps = PScheduler(PConfig(**cfg), device="cpu")
    got = _drain(ps, pnodes, ppods)
    assert got == want, {k: (got.get(k), want.get(k)) for k in want if got.get(k) != want.get(k)}
    assert ps._next_start_node_index == getattr(js, "_next_start_node_index", 0)
    assert ps._attempt_counter == getattr(js, "_attempt_counter", 0)
    for r in ROUTES:
        assert ps.metrics[r] == js.metrics.get(r, 0), r
    return js, ps


# (nodes, pct, seed, scale): test_batched_compat_matches_serial_reference and
# test_multizone_compat_matches_nodetree_order
SCHED_CASES = [
    ("plain", 0, SEED, 1), ("plain", 80, SEED, 1),
    ("zoned", 0, SEED, 1), ("zoned", 60, SEED, 1), ("zoned", 60, None, 1), ("zoned", 0, None, 2),
]


@pytest.mark.parametrize("kind,pct,seed,scale", SCHED_CASES,
                         ids=[f"{c[0]}-pct{c[1]}-seed{c[2]}-scale{c[3]}" for c in SCHED_CASES])
def test_scheduler_sampling_compat_matches_reference(kind, pct, seed, scale):
    n_pods = 48 if kind == "plain" else 40
    if kind == "plain":
        jnodes = tsc._nodes()
        T, R = PORT_API
        pnodes = [T.Node(name=n.name, labels=dict(n.labels), capacity=R.Resource.from_map({"cpu": "8",
                                                                                             "memory": "16Gi"}))
                  for n in jnodes]
    else:
        jnodes, pnodes = tsc._zoned_nodes(scale), _zoned_port_nodes(scale)
    js, ps = _both(jnodes, tsc._pods(n_pods), pnodes, _port_pods(n_pods), batch_size=16,
                   percentage_of_nodes_to_score=pct, reference_sampling_compat=True, tie_break_seed=seed)
    assert ps.metrics["scan_batches"] >= 1 and ps.metrics["fast_batches"] == 0


def test_scheduler_default_mode_is_full_width_first_max():
    jnodes = tsc._nodes()
    T, R = PORT_API
    pnodes = [T.Node(name=n.name, labels=dict(n.labels), capacity=R.Resource.from_map({"cpu": "8", "memory": "16Gi"}))
              for n in jnodes]
    js, ps = _both(jnodes, tsc._pods(1), pnodes, _port_pods(1))
    assert ps._attempt_counter == 0 and ps._next_start_node_index == 0


def _gen_pods(seed):
    """tests/test_wave.py's compat drain workload (tests/gen.py make_pod)."""
    r = random.Random(seed)
    pods = [make_pod(r, f"sc-{i}") for i in range(72)]
    for p in pods:
        p.node_name = None
    return pods


def rides_wave_check(seed):
    """reference_sampling_compat with a tie seed on spread / affinity /
    port pods (tests/test_wave.py::test_sampling_compat_rides_wave's drain):
    the wave carries the cursor (the gang scan's placements on these seeds
    are the reference test's own check)."""
    jpods = _gen_pods(seed)
    ppods = [to_port(p) for p in jpods]
    jnodes = _zone_nodes(12)
    js, ps = _both(jnodes, jpods, [to_port(n) for n in jnodes], ppods, batch_size=64,
                   reference_sampling_compat=True, tie_break_seed=seed)
    assert ps.metrics["wave_batches"] >= 1


@pytest.mark.parametrize("seed", [19])
def test_scheduler_sampling_compat_rides_wave(seed):
    """The second seed of tests/test_wave.py::test_sampling_compat_rides_wave
    (the first is in tests/test_torch_rng.py)."""
    rides_wave_check(seed)
