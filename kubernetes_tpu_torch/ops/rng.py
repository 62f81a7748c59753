"""Seeded tie-break bits: JAX's threefry PRNG in plain PyTorch, and K19.

The reference breaks max-score ties with ``jax.random.bits(fold_in(key,
attempt), (N,), uint32)`` under ``jax_enable_x64`` and
``jax_threefry_partitionable``; with those settings

  prng_key(s)      = (s >> 32, s & 0xFFFFFFFF)
  fold_in(k, d)    = threefry2x32(k, (0, d))
  bits(k, N)[n]    = x0 ^ x1   where (x0, x1) = threefry2x32(k, (0, n))

so node n's bits depend only on (key, attempt, n), and a draw over the
padded node bucket agrees with one over the real node count on the prefix.
Values are uint32 held in int64 (torch's uint32 support on the CPU is
thin): every step is int64 arithmetic masked to 32 bits.

``tie_bits`` draws the [A, N] block of attempts attempt_base .. +A: K19 on
CUDA tensors (csrc/rng.cu, one thread per (attempt, node), the device
function ``ktpu::rng::threefry2x32`` the shared per-pod step uses too), its
plain version on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from kubernetes_tpu_torch.ops import _build

I64 = torch.int64
MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (jax.random's threefry2x32) on int64
    tensors (or ints) holding uint32 values; returns (y0, y1)."""
    ks = (k0 & MASK32, k1 & MASK32, (k0 ^ k1 ^ _PARITY) & MASK32)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int):
    """jax.random.PRNGKey(seed) under x64: (high word, low word)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (s >> 32, s & MASK32)


def fold_in(key, data: int):
    """jax.random.fold_in(key, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK32)


def bits(key, n: int, device="cpu"):
    """jax.random.bits(key, (n,), uint32) as int64 [n]."""
    idx = torch.arange(n, dtype=I64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(idx), idx)
    return y0 ^ y1


def tie_bits_plain(key, attempt_base: int, A: int, N: int, device="cpu"):
    """Plain version of K19: bits(fold_in(key, attempt_base + a), N) for
    a < A, as int64 [A, N]."""
    out = torch.empty((A, N), dtype=I64, device=device)
    for a in range(A):
        out[a] = bits(fold_in(key, attempt_base + a), N, device)
    return out


def tie_bits(key, attempt_base: int, A: int, N: int, device="cpu"):
    """The [A, N] tie-break bits of attempts attempt_base .. attempt_base +
    A - 1: K19 on a CUDA device, its plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return tie_bits_plain(key, attempt_base, A, N, device)
    return _tie_bits_cuda(key, attempt_base, A, N, device)


def _tie_bits_cuda(key, attempt_base: int, A: int, N: int, device):
    """K19 launch: one thread per (attempt, node)."""
    lib = _build.load()
    out = torch.empty((max(A, 1), max(N, 1)), dtype=I64, device=device)
    rc = lib.ktpu_tie_bits(ctypes.c_uint32(key[0]), ctypes.c_uint32(key[1]), ctypes.c_uint32(attempt_base & MASK32),
                           ctypes.c_int(A), ctypes.c_int(N), ctypes.c_void_p(out.data_ptr()),
                           _build.stream_handle(device))
    _build.check_launch(lib, rc, "tie_bits")
    _build.launches["tie_bits"] += 1
    return out[:A, :N]
