"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source is compiled by its own ``nvcc`` process for ``sm_90a``, all
started together, and the objects are linked into one shared library with a
plain C interface that ctypes loads (no PyTorch headers, so a build takes
seconds).  The library lands in ``kubernetes_tpu_torch/_build/<digest>/``,
keyed by the sources and flags, so an edited source never loads a stale
build.  Nothing here runs at import time: the CPU path never builds.

``launches`` counts, per kernel, the launches its wrapper made; the
wrappers add one where they launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("static_eval.cu", "sig_scan.cu", "usage_checksum.cu", "runtime.cu")
HEADERS = ("ktpu.cuh",)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler=-fPIC",
    "-Xptxas=-v",
)

launches: Dict[str, int] = {"static_eval": 0, "sig_scan": 0, "usage_checksum": 0}

_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output (ptxas register / spill report), also in nvcc_build.log


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the port's "
            "CUDA kernels build from csrc/ at first use on a CUDA tensor"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(so_path: Path) -> None:
    global build_log
    nvcc = _nvcc()
    so_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=so_path.parent) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src), "-o", str(obj)]
            procs.append(
                (src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            )
        logs = []
        failed = []
        for src, _, proc in procs:
            out, err = proc.communicate()
            logs.append(f"== {src}\n{out}{err}")
            if proc.returncode != 0:
                failed.append(src)
        build_log = "\n".join(logs)
        (so_path.parent / "nvcc_build.log").write_text(build_log)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
        tmp_so = Path(tmp) / so_path.name
        link = [nvcc, "-shared", "-o", str(tmp_so), *[str(o) for _, o, _ in procs]]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_so, so_path)  # atomic: a concurrent loader sees all or nothing


class StaticEvalArgs(ctypes.Structure):
    """Mirror of csrc/ktpu.cuh StaticEvalArgs (pointers, then ints)."""

    _PTRS = (
        "node_labels val_ints taint_key taint_val taint_eff unsched node_valid img_sizes "
        "valid ns_key ns_op ns_vals ns_rhs ns_tv pf_key pf_op pf_vals pf_rhs pf_tv pf_weight "
        "tol_key tol_op tol_val tol_eff target_name img_ids n_containers spread "
        "mask m_nodename m_unsched m_taints m_nodeaff taint_raw naff_raw img"
    ).split()
    _INTS = (
        "N K NVI T IMG S NT NR NV PT PR PV TL I "
        "name_key unsched_key empty_val n_valid_nodes enabled has_images"
    ).split()
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


class SigScanArgs(ctypes.Structure):
    """Mirror of csrc/ktpu.cuh SigScanArgs (pointers, then ints)."""

    _PTRS = (
        "ids sig_req sig_nz sig_allzero sig_ok sig_img alloc allowed "
        "used nz0 nz1 num_pods choices"
    ).split()
    _INTS = "P N R S w_fit w_bal w_img check_fit".split()
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this process."""
    global _lib
    if _lib is not None:
        return _lib
    so = BUILD_ROOT / _digest() / "libktpu_kernels.so"
    if not so.exists():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.ktpu_static_eval.argtypes = [ctypes.POINTER(StaticEvalArgs), vp]
    lib.ktpu_static_eval.restype = ctypes.c_int
    lib.ktpu_sig_scan.argtypes = [ctypes.POINTER(SigScanArgs), vp]
    lib.ktpu_sig_scan.restype = ctypes.c_int
    lib.ktpu_usage_checksum.argtypes = [
        vp, ctypes.c_longlong, vp, vp, vp, ctypes.c_longlong, vp, vp
    ]
    lib.ktpu_usage_checksum.restype = ctypes.c_int
    lib.ktpu_error_string.argtypes = [ctypes.c_int]
    lib.ktpu_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise on a refused launch (the C entry points return cudaGetLastError)."""
    if rc != 0:
        msg = lib.ktpu_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({rc})")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(name: str, t: torch.Tensor, device: torch.device, dtype, shape=None) -> int:
    """Validate one kernel operand and return its device pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()
