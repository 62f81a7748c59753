"""The ctypes mirrors in ops/_build.py against the argument structs of
csrc/ktpu.cuh: the same fields in the same order, pointers before ints.
A mismatch would hand the kernels shifted pointers; nvcc cannot catch it,
and on the CPU nothing else reads the header."""

import re

import pytest

from kubernetes_tpu_torch.ops import _build

STRUCTS = ["StaticEvalArgs", "SigScanArgs", "ResidentArgs", "GangSpreadArgs", "GangInterpodArgs", "GangScanArgs",
           "WaveArgs", "PreemptArgs", "WorkloadsArgs"]


def header_fields(struct: str):
    """(pointer names, int names) of `struct` in csrc/ktpu.cuh, in order."""
    text = (_build.CSRC / "ktpu.cuh").read_text()
    body = re.search(r"struct " + struct + r" \{(.*?)\n\};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    ptrs, ints = [], []
    for decl in (d.strip() for d in body.split(";")):
        if not decl:
            continue
        if "*" in decl:
            ptrs.append(decl.rsplit("*", 1)[1].strip())
        else:
            assert decl.startswith("int "), decl
            ints.extend(n.strip() for n in decl[4:].split(","))
    return ptrs, ints


@pytest.mark.parametrize("struct", STRUCTS)
def test_ctypes_mirror_matches_header(struct):
    mirror = getattr(_build, struct)
    ptrs, ints = header_fields(struct)
    assert list(mirror._PTRS) == ptrs
    assert list(mirror._INTS) == ints


def test_set_ptrs_keeps_each_operand_alive():
    """A wrapper's operand built inline (a .contiguous() copy, a table made
    for the launch) must outlive the call that takes its pointer: freed
    early, its memory goes to the wrapper's next allocation before the
    kernel reads it (K5 read zeroed slot keys that way once its global
    counters were allocated after the argument block)."""
    import gc
    import weakref

    import torch

    from kubernetes_tpu_torch.ops import gang

    a = _build.GangScanArgs()
    cpu = torch.device("cpu")
    gang._set_ptrs(a, cpu, [("sp_key", torch.arange(6, dtype=torch.int32).reshape(2, 3)[:, :2].contiguous(),
                             torch.int32, (2, 2))])
    ref = weakref.ref(a._tensors["sp_key"])
    gc.collect()
    assert ref() is not None and a.sp_key == ref().data_ptr()
    assert ref().tolist() == [[0, 1], [3, 4]]
    gang._set_ptrs(a, cpu, [("sp_key", torch.zeros((2, 2), dtype=torch.int32), torch.int32, (2, 2))])
    gc.collect()
    assert ref() is None  # replaced under the same name: released
