"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU
mode) and skips without one.  Outputs are integer or bool, so the tolerance
is zero.  The file imports no JAX, because the machine with the card has
none; run it there without the JAX suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The plain versions are held against the JAX package on the CPU by
tests/test_torch_static_eval.py, test_torch_sig_scan.py and
test_torch_scheduler.py.
"""

import pytest
import torch

import chip_smoke
from kubernetes_tpu_torch.ops import _build
from kubernetes_tpu_torch.ops import fastpath as ops_fp
from kubernetes_tpu_torch.ops import resident as ops_res

pytestmark = pytest.mark.cuda

ALL = frozenset({"NodeName", "NodeUnschedulable", "TaintToleration", "NodeAffinity"})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU mode)")
    return torch.device("cuda")


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


@pytest.mark.parametrize("has_images", [True, False])
def test_static_eval_kernel_matches_plain(cuda, has_images):
    _, dc, db = chip_smoke.k1_inputs(cuda, n_nodes=700)
    n0 = _build.launches["static_eval"]
    got = ops_fp.static_eval(dc, db, ALL, has_images)
    assert _build.launches["static_eval"] == n0 + 1
    want = ops_fp.static_eval_plain(dc, db, ALL, has_images)
    for k in ops_fp.STATIC_KEYS:
        _equal(got[k], want[k])


@pytest.mark.parametrize("check_fit,w_img", [(True, 1), (False, 0)])
def test_sig_scan_and_checksum_kernels_match_plain(cuda, check_fit, w_img):
    nt, dc, db = chip_smoke.k1_inputs(cuda, n_nodes=700)
    mask = ops_fp.static_eval_plain(dc, db, ALL, True)["mask"]
    fixed, state = chip_smoke.k2_inputs(torch, cuda, nt, mask, P=1024)
    w = dict(w_fit=1, w_bal=1, w_img=w_img, check_fit=check_fit)
    outs = []
    for fn in (ops_fp.sig_scan, ops_fp.sig_scan_plain):
        st = {k: v.clone() for k, v in state.items()}
        ch, _ = fn(fixed["sig_ids"], fixed["sig_req"], fixed["sig_nz"], fixed["sig_allzero"],
                   fixed["sig_ok"], fixed["sig_img"], fixed["alloc"], fixed["allowed"],
                   st["used"], st["nz0"], st["nz1"], st["num_pods"], **w)
        outs.append((ch, st))
    (ch_k, st_k), (ch_p, st_p) = outs
    _equal(ch_k, ch_p)
    for k in st_k:
        _equal(st_k[k], st_p[k])
    args = (st_k["used"], st_k["nz0"], st_k["nz1"], st_k["num_pods"])
    _equal(ops_res.usage_checksum(*args), ops_res.usage_checksum_plain(*args))


def test_scheduler_on_cuda_matches_the_host_committer(cuda):
    nodes = lambda: chip_smoke.mixed_nodes(150)  # noqa: E731
    pods = lambda: chip_smoke.mixed_pods(3000)  # noqa: E731
    _build.reset_launches()
    got, _, sched = chip_smoke.drain(cuda, nodes(), pods())
    assert min(_build.launches.values()) > 0
    want, _, _ = chip_smoke.drain(torch.device("cpu"), nodes(), pods(), host_only=True)
    assert got == want
    chip_smoke.check_capacity(sched)
