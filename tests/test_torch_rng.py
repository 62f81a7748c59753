"""The seeded tie-break bits: the port's threefry (ops/rng.py) against
jax.random, with the JAX package's settings (jax_enable_x64, which the test
configuration turns on, and jax_threefry_partitionable, which importing
kubernetes_tpu turns on).

prng_key, fold_in and bits against jax.random.PRNGKey / fold_in / bits for
seeds below and at or above 2**32, attempts at and above 2**16 and node
counts that are not a multiple of 32; tie_bits' plain version (K19's) and
its CPU dispatch against a loop of jax.random draws; the prefix property
both routes rely on (a draw over the padded node bucket agrees with one
over the real node count).  End to end, the seeds of
tests/test_wave.py::test_sampling_compat_rides_wave (the first; the second is
in tests/test_torch_scheduler_sampling.py): the port's Scheduler
(device="cpu") against the JAX Scheduler under reference_sampling_compat
with the tie seed on spread / affinity / port pods, every wave-shaped batch
on the wave, the placements, both counters and the routes equal.  Every
value is an integer: the tolerance is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu  # noqa: F401  (the reference's PRNG settings)
from kubernetes_tpu_torch.ops import rng
from tests.test_torch_scheduler_sampling import rides_wave_check

SEEDS = [0, 7, 1234, 2**31 + 5, 2**32, 2**40 + 3, 2**63 - 1]
ATTEMPTS = [0, 1, 513, 2**16, 70001, 2**31 - 1]


def _jax_bits(seed, attempt, n):
    k = jax.random.fold_in(jax.random.PRNGKey(seed), attempt)
    return np.asarray(jax.random.bits(k, (n,), dtype=jnp.uint32)).astype(np.int64)


def test_reference_settings_are_on():
    assert jax.config.jax_enable_x64 and jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_bits_match_jax(seed):
    key = rng.prng_key(seed)
    assert key == tuple(np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))).tolist())
    for attempt in ATTEMPTS:
        fk = rng.fold_in(key, attempt)
        want = np.asarray(jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(seed), attempt))).tolist()
        assert list(fk) == want, attempt
        for n in (1, 33, 100, 1000):
            got = rng.bits(fk, n).numpy()
            assert got.dtype == np.int64 and (got >= 0).all() and (got < 2**32).all()
            assert np.array_equal(got, _jax_bits(seed, attempt, n)), (attempt, n)


def test_tie_bits_block_matches_jax():
    key = rng.prng_key(2**40 + 3)
    A, N, base = 9, 77, 2**16 - 3
    want = np.stack([_jax_bits(2**40 + 3, base + a, N) for a in range(A)])
    for fn in (rng.tie_bits_plain, rng.tie_bits):
        got = fn(key, base, A, N, "cpu")
        assert got.shape == (A, N) and got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want), fn.__name__


def test_bits_prefix_over_padding():
    """Node n's bits depend only on (key, attempt, n)."""
    key = rng.fold_in(rng.prng_key(5), 12)
    assert torch.equal(rng.bits(key, 1024)[:1000], rng.bits(key, 1000))
    blk = rng.tie_bits_plain(rng.prng_key(5), 12, 3, 1024)
    assert torch.equal(blk[0, :1000], rng.bits(key, 1000))


def test_tie_bits_raise_without_cuda():
    """The CUDA route never gives way to the plain version: on a machine
    without a card the launch raises instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_kernels_cuda.py holds K19")
    with pytest.raises((RuntimeError, AssertionError, OSError)):
        rng.tie_bits(rng.prng_key(1), 0, 2, 8, "cuda")


@pytest.mark.parametrize("seed", [3])
def test_scheduler_sampling_compat_rides_wave(seed):
    """tests/test_wave.py::test_sampling_compat_rides_wave's first seed
    (tests/test_torch_scheduler_sampling.py has the second: the JAX Scheduler's
    compiles are spread over two workers)."""
    rides_wave_check(seed)
