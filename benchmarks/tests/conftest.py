"""Shared set-up of the benchmark's tests: the harness on the path, the
repository's root, and the one fixture that decides whether a card is
there (never while a module is imported)."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
for path in (str(ROOT), str(BENCH_DIR)):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
