"""Device-resident usage state of the fast path: kernel K3, the epoch guard.

The JAX package's module of the same name also holds ``resident_run``, the
speculation/admission fixed point behind the default ``residentDrain: true``;
that kernel is the next slice of the port (ROADMAP B3) and joins
``usage_checksum`` here.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.ops import _build

I32 = torch.int32
I64 = torch.int64


def usage_checksum(used, nz0, nz1, num_pods):
    """Exact int64 sum of every usage row, as a 0-d int64 tensor.  The host
    tracks the same quantity (base sum + per-batch commit deltas), so after
    each device batch the two must agree; a mismatch means the device
    lineage is torn and the scheduler raises."""
    if used.device.type == "cpu":
        return usage_checksum_plain(used, nz0, nz1, num_pods)
    return _usage_checksum_cuda(used, nz0, nz1, num_pods)


def usage_checksum_plain(used, nz0, nz1, num_pods):
    """Plain PyTorch version of K3."""
    return used.sum() + nz0.sum() + nz1.sum() + num_pods.to(I64).sum()


def _usage_checksum_cuda(used, nz0, nz1, num_pods):
    dev = used.device
    lib = _build.load()
    N, R = used.shape
    c = _build.check_cuda
    p_used = c("used", used, dev, I64, (N, R))
    p_nz0 = c("nz0", nz0, dev, I64, (N,))
    p_nz1 = c("nz1", nz1, dev, I64, (N,))
    p_np = c("num_pods", num_pods, dev, I32, (N,))
    out = torch.empty((), dtype=I64, device=dev)
    rc = lib.ktpu_usage_checksum(
        p_used, N * R, p_nz0, p_nz1, p_np, N, out.data_ptr(), _build.stream_handle(dev)
    )
    _build.check_launch(lib, rc, "usage_checksum")
    _build.launches["usage_checksum"] += 1
    return out
