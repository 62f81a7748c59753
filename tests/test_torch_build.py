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


@pytest.mark.parametrize("enum,names", [("SpreadSpan", "SPREAD_KERNELS"), ("InterpodSpan", "INTERPOD_KERNELS")])
def test_statics_span_rows_match_the_kernel_ids(enum, names):
    """K6's / K7's span table: the wrapper names its kernels in the order of
    the kernel ids csrc/gang_statics.cu writes them under, with as many rows
    a kernel (SPAN_SMS), and sizes it by their count (the entry point
    rejects another size)."""
    from kubernetes_tpu_torch.ops import gang

    text = (_build.CSRC / "gang_statics.cu").read_text()
    ids = [i.strip() for i in re.search(r"enum " + enum + r" \{(.*?)\};", text, re.S).group(1).split(",")]
    assert ids[-1].endswith("_KERNELS") and len(ids) - 1 == len(getattr(gang, names))
    assert [i.split("_", 1)[1].lower() for i in ids[:-1]] == list(getattr(gang, names))
    assert int(re.search(r"constexpr int SPAN_SMS = (\d+);", text).group(1)) == gang.SPAN_SMS


@pytest.mark.parametrize("case", ["aligned", "odd_bucket", "misaligned_row"])
def test_statics_row_check(case):
    """K6 / K7 read and write four nodes a thread: their wrappers take a
    node bucket that is a multiple of 4 with 16-byte aligned input rows,
    and raise on anything else rather than launch."""
    import torch

    from kubernetes_tpu_torch.ops import gang

    rows = torch.zeros((3, 16), dtype=torch.int32)
    if case == "aligned":
        gang._check_rows(16, rows, rows[1])
        return
    with pytest.raises(ValueError):
        if case == "odd_bucket":
            gang._check_rows(10, rows)
        else:
            gang._check_rows(12, rows.flatten()[1:13])
