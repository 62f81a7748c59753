"""The port stands alone: no module of kubernetes_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package kubernetes_tpu."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "kubernetes_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# runs on the card's machine, which has no JAX
CARD_TESTS = [ROOT / "tests" / "test_torch_kernels_cuda.py"]
FORBIDDEN = ("jax", "jaxlib", "kubernetes_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_has_modules():
    assert len(PORT_FILES) > 15


@pytest.mark.parametrize("path", PORT_FILES + CARD_TESTS, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    """Import every port module in a fresh interpreter in which importing
    jax or the JAX package fails."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES
        if p.name != "chip_smoke.py"
    )
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'kubernetes_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib') and v is not None for k, v in sys.modules.items())\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_without_a_card_prints_no_result():
    res = subprocess.run(
        [sys.executable, "-c", "import torch, runpy, sys; torch.cuda.is_available = lambda: False; "
         "sys.argv = ['chip_smoke.py']; runpy.run_path('chip_smoke.py', run_name='__main__')"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert res.stdout == ""
