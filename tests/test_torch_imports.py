"""Import hygiene of the port: ``src/repro_torch/`` and ``chip_smoke.py``
import neither ``jax`` nor the JAX package ``repro``.

An AST scan reads every import statement (including ones inside
functions); a subprocess then imports every ``repro_torch`` module with
``jax`` and ``repro`` blocked in ``sys.modules``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name in _imported(tree) if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_without_jax():
    mods = list(_modules())
    assert {"repro_torch.kernels.ops", "repro_torch.kernels.ssd_kernel",
            "repro_torch.configs.base", "repro_torch.configs.mamba2_2p7b",
            "repro_torch.models.blocks", "repro_torch.models.ssm",
            "repro_torch.models.transformer", "repro_torch.models.zoo",
            "repro_torch.serve.engine", "repro_torch.serve.batcher",
            "repro_torch.core.matrixize",
            "repro_torch.core.tessellate", "repro_torch.core.unroll_jam",
            "repro_torch.core.autotune", "repro_torch.core.locked_json",
            "repro_torch.roofline", "repro_torch.roofline.calibrate",
            "repro_torch.roofline.stencil"} <= set(mods)
    assert len(mods) >= 32
    code = ("import importlib, sys\n"
            "for name in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[name] = None\n"
            f"for mod in {mods!r}:\n"
            "    importlib.import_module(mod)\n"
            "loaded = [k for k, v in sys.modules.items() if v is not None and\n"
            "          k.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not loaded, loaded\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
