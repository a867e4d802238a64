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


# The names the combinator path exports, each under the JAX package's name.
COMBINATOR_NAMES = [
    "Dimap", "DiscreteHMM", "DiscreteHMMConfiguration", "IndexRequest", "RepeatCombinator", "Scan",
    "VectorRequest", "Vmap", "accumulate", "categorical", "contramap", "dimap",
    "forward_filtering_backward_sampling", "iterate", "iterate_final", "map", "reduce", "repeat", "scan", "vmap",
]


def test_combinator_names_are_exported_under_the_jax_names():
    import genjax_tpu
    import genjax_tpu_torch

    for name in COMBINATOR_NAMES:
        assert hasattr(genjax_tpu, name), f"genjax_tpu has no {name}"
        assert hasattr(genjax_tpu_torch, name) and name in genjax_tpu_torch.__all__, name
    for method in ("vmap", "repeat", "scan", "accumulate", "reduce", "iterate", "iterate_final", "map", "contramap", "dimap"):
        assert callable(getattr(genjax_tpu_torch.GenerativeFunction, method))
        assert callable(getattr(genjax_tpu.GenerativeFunction, method))
    for method in ("get_subtrace", "get_inner_trace"):
        assert callable(getattr(genjax_tpu_torch.Trace, method)) and callable(getattr(genjax_tpu.Trace, method))
