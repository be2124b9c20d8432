"""The port stands alone: it imports neither jax nor the JAX package.

One check imports every module of ``repro_torch`` in a fresh interpreter
where ``import jax`` fails; the other searches the port's sources and
chip_smoke.py for an import of jax or of ``repro`` (``repro_torch`` is not
``repro``).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro.")
             or (m.startswith("jax") and sys.modules[m] is not None))
print(len(names), bad)
assert not bad, bad
"""


def test_every_port_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=env, capture_output=True,
                         text=True, timeout=120, check=False)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15, out.stdout


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)"
                        r"|from\s+repro(\.|\s+import))", re.MULTILINE)


def test_no_source_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 15
    hits = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
            for p in files for m in _FORBIDDEN.finditer(p.read_text())]
    assert not hits, hits
    assert not _FORBIDDEN.search("from repro_torch.core import tasks\nimport repro_torch\n")
    assert _FORBIDDEN.search("from repro.core import tasks")
    assert _FORBIDDEN.search("  import jax.numpy as jnp")
