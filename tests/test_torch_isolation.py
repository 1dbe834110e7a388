"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro")


def _forbidden(module: str) -> bool:
    """True for ``jax``/``repro`` and their submodules — not for
    ``repro_torch``, which merely shares the prefix."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_matches_whole_names_only():
    assert _forbidden("jax.numpy") and _forbidden("repro")
    assert _forbidden("repro.core.fabric")
    assert not _forbidden("repro_torch.core") and not _forbidden("jaxlib2")


def test_importing_the_port_loads_neither_jax_nor_repro():
    """Every module imports with no ``nvcc`` to be found (an empty PATH
    and a CUDA_HOME that does not exist) and loads no ``triton``: the
    kernels are built at first launch, never at import."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "PATH": "",
           "CUDA_HOME": str(ROOT / "no-cuda-here")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split()
    for module in ("repro_torch.core.vector_throughput",
                   "repro_torch.core.strategies",
                   "repro_torch.core.tracer", "repro_torch.core.placement",
                   "repro_torch.core.fim", "repro_torch.core.report",
                   "repro_torch.kernels.flowhash.build",
                   "repro_torch.kernels.loads.build",
                   "repro_torch.kernels.loads.ops",
                   "repro_torch.kernels.placement.build",
                   "repro_torch.kernels.placement.ops",
                   "repro_torch.kernels.flash_attention.build",
                   "repro_torch.kernels.flash_attention.ops",
                   "repro_torch.kernels.ssd.build",
                   "repro_torch.kernels.ssd.ops", "repro_torch.models.ssm",
                   "repro_torch.models.model", "repro_torch.serve.engine",
                   "repro_torch.interop"):
        assert module in out
    assert [m for m in out if _forbidden(m)] == []
    assert [m for m in out if m == "triton" or m.startswith("triton.")] == []


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_no_source_of_the_port_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): m for f in files for m in _imports(f)
           if _forbidden(m)}
    assert bad == {}
