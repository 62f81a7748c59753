"""The ctypes mirrors in ops/_build.py against the argument structs of
csrc/ktpu.cuh: the same fields in the same order, pointers before ints.
A mismatch would hand the kernels shifted pointers; nvcc cannot catch it,
and on the CPU nothing else reads the header."""

import re

import pytest

from kubernetes_tpu_torch.ops import _build

STRUCTS = ["StaticEvalArgs", "SigScanArgs", "ResidentArgs", "GangSpreadArgs", "GangInterpodArgs", "GangScanArgs"]


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
