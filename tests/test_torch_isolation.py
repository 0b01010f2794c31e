"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the reference package ``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro)(?:\.|\s|$)", re.M)

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now fails
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
leaked = sorted(
    m for m in sys.modules
    if m == "repro" or m.startswith(("repro.", "jax.", "jaxlib"))
)
assert not leaked, leaked
assert sys.modules["jax"] is None
for name in ("repro_torch.launch.calibrate", "repro_torch.core.scheduler",
             "repro_torch.models.model", "repro_torch.configs",
             "repro_torch.launch.train", "repro_torch.train.trainer",
             "repro_torch.data.tokens", "repro_torch.checkpoint.store"):
    assert name in sys.modules, name
print("ok", len([m for m in sys.modules if m.startswith("repro_torch")]))
"""


def test_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_sources_import_no_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        found = IMPORT.findall(path.read_text())
        assert not found, f"{path.relative_to(ROOT)} imports {found}"
