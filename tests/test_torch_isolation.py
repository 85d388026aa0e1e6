"""The port stands alone: no module of ``repro_torch`` (nor chip_smoke.py)
imports jax, ml_dtypes or the JAX package, and without CUDA its entry
points raise instead of falling back to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serving.executor import TorchExecutor  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")

IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
training = {"repro_torch.training.optimizer", "repro_torch.training.train_lib",
            "repro_torch.training.compression", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.manager",
            "repro_torch.launch.fault_tolerance",
            "repro_torch.launch.train"} <= set(names)
print(len(names), training, bad)
"""


def test_importing_every_module_loads_no_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=240,
                         check=True).stdout.split(maxsplit=2)
    assert int(out[0]) >= 20          # every module was imported
    assert out[1] == "True"           # the training path's among them
    assert out[2].strip() == "[]"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_entry_points_raise_without_cuda(monkeypatch):
    cfg = get_reduced("phi4-mini-3.8b")
    model = Model(cfg, device="cpu")
    lora = model.init_lora(2, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchExecutor(model, lora)
