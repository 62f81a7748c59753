"""Single-buffer host→device transport.

Flattens a dataclass tree of numpy arrays into ONE contiguous byte buffer
(pinned when the target is a CUDA device), ships it with one non-blocking
copy, and rebuilds each leaf as a typed ``view`` of a slice at a static,
8-byte-aligned offset — the PyTorch form of the JAX package's ``pack_tree`` /
``_unpacker.run`` pair.  Leaves that are Python ints (scalar ids) pass
through unchanged.
"""

from __future__ import annotations

from dataclasses import fields, is_dataclass, replace
from typing import List, Tuple

import numpy as np
import torch

_ALIGN = 8

_TORCH_DTYPE = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def _leaves(tree, out: List[np.ndarray]) -> None:
    for f in fields(tree):
        v = getattr(tree, f.name)
        if is_dataclass(v):
            _leaves(v, out)
        elif isinstance(v, np.ndarray):
            out.append(v)


def pack_tree(tree) -> Tuple[np.ndarray, list]:
    """(byte_buffer, [(dtype, shape, offset) per array leaf])."""
    arrays: List[np.ndarray] = []
    _leaves(tree, arrays)
    spec = []
    off = 0
    for a in arrays:
        off += (-off) % _ALIGN
        spec.append((a.dtype, a.shape, off))
        off += a.nbytes
    buf = np.zeros(off + (-off) % _ALIGN, np.uint8)
    for a, (_, _, o) in zip(arrays, spec):
        if a.nbytes:
            buf[o : o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return buf, spec


def _rebuild(tree, dev_buf: torch.Tensor, spec_iter):
    vals = {}
    for f in fields(tree):
        v = getattr(tree, f.name)
        if is_dataclass(v):
            vals[f.name] = _rebuild(v, dev_buf, spec_iter)
        elif isinstance(v, np.ndarray):
            dt, shape, off = next(spec_iter)
            nb = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
            raw = dev_buf[off : off + nb]
            vals[f.name] = raw.view(_TORCH_DTYPE[dt]).reshape(shape)
    return replace(tree, **vals)


def device_put_packed(tree, device):
    """Upload a dataclass tree of numpy arrays in ONE host→device copy."""
    buf, spec = pack_tree(tree)
    host = torch.from_numpy(buf)
    device = torch.device(device)
    if device.type == "cuda":
        host = host.pin_memory()
        dev_buf = host.to(device, non_blocking=True)
    else:
        dev_buf = host
    return _rebuild(tree, dev_buf, iter(spec))
