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
SOURCES = (
    "static_eval.cu",
    "sig_scan.cu",
    "usage_checksum.cu",
    "resident_run.cu",
    "gang_statics.cu",
    "gang_scan.cu",
    "wave.cu",
    "workloads.cu",
    "preemption.cu",
    "volume.cu",
    "dra.cu",
    "counterfactual.cu",
    "explain.cu",
    "pipeline.cu",
    "rng.cu",
    "runtime.cu",
)
HEADERS = ("ktpu.cuh",)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler=-fPIC",
    "-Xptxas=-v",
)

launches: Dict[str, int] = {
    "static_eval": 0,
    "sig_scan": 0,
    "usage_checksum": 0,
    "resident_run": 0,
    "gang_spread_statics": 0,
    "gang_interpod_statics": 0,
    "gang_scan": 0,
    "wave_speculate": 0,
    "wave_admit": 0,
    "workloads_admit": 0,
    "narrow_candidates": 0,
    "volume_topology_mask": 0,
    "dra_selector_match": 0,
    "dra_spec_mask": 0,
    "fork_view": 0,
    "fork_summary": 0,
    "explain_stack": 0,
    "pipeline_score": 0,
    "tie_bits": 0,
}

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
        "mask m_nodename m_unsched m_taints m_nodeaff taint_raw naff_raw img extra"
    ).split()
    _INTS = (
        "N K NVI T IMG S NT NR NV PT PR PV TL I "
        "name_key unsched_key empty_val n_valid_nodes enabled has_images mask_enabled"
    ).split()
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


class SigScanArgs(ctypes.Structure):
    """Mirror of csrc/ktpu.cuh SigScanArgs (pointers, then ints)."""

    _PTRS = (
        "ids sig_req sig_nz sig_allzero sig_ok sig_img alloc allowed "
        "used nz0 nz1 num_pods choices present sig_rows tree_sig leaves lv_val lv_idx info"
    ).split()
    _INTS = "P N R S w_fit w_bal w_img check_fit tree_smem launches".split()
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


class ResidentArgs(ctypes.Structure):
    """Mirror of csrc/ktpu.cuh ResidentArgs (pointers, then ints)."""

    _PTRS = (
        "ids sig_req sig_nz sig_allzero sig_ok sig_img alloc allowed "
        "used nz0 nz1 num_pods choices ctl keys rank order sufmax "
        "slot_sig slot_node slot_flags slot_ckey slot_csuf slot_thr"
    ).split()
    _INTS = "P N R S W w_fit w_bal w_img check_fit r_cap min_yield stop_grace".split()
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


class GangSpreadArgs(ctypes.Structure):
    """Mirror of csrc/ktpu.cuh GangSpreadArgs (pointers, then ints)."""

    _PTRS = (
        "node_labels val_ints dom_ids dom_size dom_off dom_vals epod_node epod_ns epod_labels epod_valid epod_deleting "
        "valid ns_id labels tsc_key tsc_op tsc_vals tsc_rhs tsc_tv tsc_topo tsc_hard honor_aff honor_taints "
        "naff taints sp_dv sp_te sp_dom_cnt sp_dom_pres sp_ndom sp_self sp_bmatch sp_counting sp_node_cnt "
        "sp_sc_dom sp_all_keys sp_cdv rep match span"
    ).split()
    _INTS = "N K NVI E P C R V EW D hostname_key smem_cap class_ratio span_rows".split()
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


class GangInterpodArgs(ctypes.Structure):
    """Mirror of csrc/ktpu.cuh GangInterpodArgs (pointers, then ints)."""

    _PTRS = (
        "node_labels val_ints dom_ids dom_size dom_off dom_vals epod_node epod_ns epod_labels epod_valid "
        "term_pod term_kind term_topo term_weight tt_key tt_op tt_vals tt_rhs tt_tv term_ns_all term_ns_ids "
        "used_ppk used_ip used_wild valid ns_id labels aff_key aff_op aff_vals aff_rhs aff_tv aff_kind "
        "aff_topo aff_ns_all aff_ns_ids want_ppk want_ip want_wild ip_dv ip_dom_cnt ip_viol_existing ip_sym "
        "inc_any self_ok ip_bmatch d_ports port_b ext_term key_used inc_rep inc_match span"
    ).split()
    _INTS = (
        "N K NVI E M TR TV TNS U P AT AR AV NS W EW DSUM D hard_weight do_interpod do_ports smem_cap class_ratio "
        "span_rows"
    ).split()
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


class GangScanArgs(ctypes.Structure):
    """Mirror of csrc/ktpu.cuh GangScanArgs (pointers, then ints)."""

    _PTRS = (
        "allocatable allowed_pods node_valid log_tab requested nonzero num_pods requests nonzero_req valid "
        "max_skew min_domains static_mask sp_hard sp_soft sp_te sp_dom_cnt sp_dom_pres sp_ndom sp_self "
        "sp_bmatch sp_is_host sp_counting sp_node_cnt sp_sc_dom sp_all_keys ip_dom_cnt "
        "ip_viol_existing ip_sym ip_any_static ip_self_all ip_bmatch ip_is_aff ip_is_anti ip_pref_w ip_sym_w "
        "ip_key_idx sc_taint sc_nodeaff sc_image port_b d_nodename d_unsched d_taints d_nodeaff "
        "d_ports d_extra chosen n_feas reason_counts dom_ids sp_key ip_key kd2_key cnt_h port_stamp "
        "feas ip_raw sp_raw sp_cnt priority nom_off nom_prio nom_req extra_score fit_shape visit_rank "
        "visit_order sample_start"
    ).split()
    _INTS = (
        "N K Rn Rp L P C AT KD2 D JP w_taint w_naff w_spread w_ip w_fit w_bal w_img check_fit "
        "strat_id n_shape w_cpu w_mem sample_k n_valid tie_on tie_k0 tie_k1 attempt_base"
    ).split()
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


class WaveArgs(ctypes.Structure):
    """Mirror of csrc/ktpu.cuh WaveArgs (pointers, then ints)."""

    _PTRS = (
        "tid_sp rep_sp_p rep_sp_c tid_ip rep_ip_p rep_ip_u tid_pt port_conf c0 kinds cterms sums carries lane "
        "admit_info spec_info"
    ).split()
    _INTS = "Tsp Tip Tpt W Dsp D2 hostname_key has_ports sums_smem carry_smem cluster slice rows_smem xch_cells stage".split()
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


class WorkloadsArgs(ctypes.Structure):
    """Mirror of csrc/ktpu.cuh WorkloadsArgs (pointers, then ints)."""

    _PTRS = (
        "gang_id gang_first gang_last gang_need assigned gang_admit gang_landed choice_log undone "
        "dra_match req_count req_all req_cl q_valid req_bad ref_cl free claim_node dra_row dra_scratch take_log claims"
    ).split()
    _INTS = "g_cap DQ DD CQ CL claims_smem".split()
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


class PreemptArgs(ctypes.Structure):
    """Mirror of csrc/ktpu.cuh PreemptArgs (pointers, then ints)."""

    _PTRS = (
        "victim_node victim_prio victim_req groups pod_group batch_node batch_prio batch_req allocatable "
        "allowed_pods requests kept_req kept_cnt victims mask"
    ).split()
    _INTS = "N R Rp E B2 G P".split()
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


class ExplainArgs(ctypes.Structure):
    """Mirror of csrc/explain.cu ExplainArgs (pointers, then ints)."""

    _PTRS = (
        "node_valid num_pods allowed_pods allocatable requested valid requests d_unsched d_nodename d_taints "
        "d_nodeaff d_ports d_extra sp_hard sp_dv sp_te sp_dom_cnt sp_dom_pres sp_ndom sp_self min_domains max_skew "
        "ip_viol_existing ip_dv ip_dom_cnt ip_is_aff ip_is_anti ip_any_static ip_self_all out"
    ).split()
    _INTS = "N P Rn Rp C AT check_fit".split()
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + [(n, ctypes.c_int) for n in _INTS]


class PipelineArgs(ctypes.Structure):
    """Mirror of csrc/pipeline.cu PipelineArgs (pointers, then ints)."""

    _PTRS = (
        "feasible allocatable requested nonzero log_tab requests nonzero_req max_skew sc_taint sc_nodeaff sc_image "
        "sp_soft sp_is_host sp_all_keys sp_cdv sp_node_cnt sp_sc_dom ip_sym ip_dv ip_dom_cnt ip_pref_w seen totals "
        "n_feasible chosen"
    ).split()
    _INTS = "N P Rn Rp C AT L D w_taint w_naff w_spread w_ip w_fit w_bal w_img".split()
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
    lib.ktpu_sig_scan.argtypes = [ctypes.POINTER(SigScanArgs), ctypes.c_int, vp]
    lib.ktpu_sig_scan.restype = ctypes.c_int
    lib.ktpu_usage_checksum.argtypes = [
        vp, ctypes.c_longlong, vp, vp, vp, ctypes.c_longlong, vp, vp
    ]
    lib.ktpu_usage_checksum.restype = ctypes.c_int
    res = ctypes.POINTER(ResidentArgs)
    for fn, extra in (
        ("ktpu_resident_init", []),
        ("ktpu_resident_rounds", [ctypes.c_int]),
        ("ktpu_resident_tail_ids", [vp]),
        ("ktpu_resident_tail_merge", [vp]),
    ):
        getattr(lib, fn).argtypes = [res, *extra, vp]
        getattr(lib, fn).restype = ctypes.c_int
    for fn, st in (
        ("ktpu_gang_spread_statics", GangSpreadArgs),
        ("ktpu_gang_interpod_statics", GangInterpodArgs),
    ):
        getattr(lib, fn).argtypes = [ctypes.POINTER(st), vp]
        getattr(lib, fn).restype = ctypes.c_int
    lib.ktpu_gang_scan_plan.argtypes = [ctypes.POINTER(GangScanArgs), ctypes.POINTER(WaveArgs), ctypes.c_int,
                                        ctypes.c_int]
    lib.ktpu_gang_scan_plan.restype = ctypes.c_int
    for fn in ("ktpu_gang_scan", "ktpu_wave_speculate", "ktpu_wave_admit"):
        getattr(lib, fn).argtypes = [ctypes.POINTER(GangScanArgs), ctypes.POINTER(WaveArgs), vp]
        getattr(lib, fn).restype = ctypes.c_int
    lib.ktpu_wave_admit_plan.argtypes = [ctypes.POINTER(GangScanArgs), ctypes.POINTER(WaveArgs), ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]
    lib.ktpu_wave_admit_plan.restype = ctypes.c_int
    lib.ktpu_workloads_admit_plan.argtypes = [ctypes.POINTER(GangScanArgs), ctypes.POINTER(WaveArgs),
                                              ctypes.POINTER(WorkloadsArgs), ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ktpu_workloads_admit_plan.restype = ctypes.c_int
    lib.ktpu_workloads_admit.argtypes = [ctypes.POINTER(GangScanArgs), ctypes.POINTER(WaveArgs),
                                         ctypes.POINTER(WorkloadsArgs), vp]
    lib.ktpu_workloads_admit.restype = ctypes.c_int
    lib.ktpu_preempt_narrow.argtypes = [ctypes.POINTER(StaticEvalArgs), ctypes.POINTER(PreemptArgs), vp]
    lib.ktpu_preempt_narrow.restype = ctypes.c_int
    lib.ktpu_volume_topology_mask.argtypes = [vp] * 10 + [ctypes.c_int] * 8 + [vp]
    lib.ktpu_volume_topology_mask.restype = ctypes.c_int
    lib.ktpu_dra_selector_match.argtypes = [vp] * 7 + [ctypes.c_int] * 7 + [vp]
    lib.ktpu_dra_selector_match.restype = ctypes.c_int
    lib.ktpu_dra_spec_mask.argtypes = [vp] * 11 + [ctypes.c_int] * 7 + [vp]
    lib.ktpu_dra_spec_mask.restype = ctypes.c_int
    lib.ktpu_fork_view.argtypes = [vp] * 13 + [ctypes.c_int] * 4 + [vp]
    lib.ktpu_fork_view.restype = ctypes.c_int
    lib.ktpu_fork_summary.argtypes = [vp] * 11 + [ctypes.c_int] * 5 + [vp]
    lib.ktpu_fork_summary.restype = ctypes.c_int
    lib.ktpu_explain_stack.argtypes = [ctypes.POINTER(ExplainArgs), vp]
    lib.ktpu_explain_stack.restype = ctypes.c_int
    lib.ktpu_pipeline_score.argtypes = [ctypes.POINTER(PipelineArgs), vp]
    lib.ktpu_pipeline_score.restype = ctypes.c_int
    u32 = ctypes.c_uint32
    lib.ktpu_tie_bits.argtypes = [u32, u32, u32, ctypes.c_int, ctypes.c_int, vp, vp]
    lib.ktpu_tie_bits.restype = ctypes.c_int
    lib.ktpu_cluster_threads.argtypes = []
    lib.ktpu_cluster_threads.restype = ctypes.c_int
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
