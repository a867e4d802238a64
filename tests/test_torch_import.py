"""`genjax_tpu_torch` stands without JAX: every module imports with `jax`
blocked, and no source file of the package imports it."""

import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

PACKAGE = Path(__file__).resolve().parent.parent / "genjax_tpu_torch"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import genjax_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(genjax_tpu_torch.__path__, 'genjax_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        cwd=PACKAGE.parent,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.MULTILINE)
    sources = sorted(PACKAGE.rglob("*.py"))
    assert sources
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders
