"""Every docstring example in `genjax_tpu_torch` runs under stdlib doctest,
on the CPU (the counterpart of `tests/test_doctests.py`)."""

import doctest
import importlib
import pkgutil

import pytest
import torch

import genjax_tpu_torch

torch.set_num_threads(1)


def _module_names():
    prefix = "genjax_tpu_torch."
    return sorted(["genjax_tpu_torch"] + [m.name for m in pkgutil.walk_packages(genjax_tpu_torch.__path__, prefix)])


@pytest.mark.parametrize("modname", _module_names())
def test_module_doctests(modname):
    mod = importlib.import_module(modname)
    result = doctest.testmod(mod, optionflags=doctest.ELLIPSIS | doctest.NORMALIZE_WHITESPACE, verbose=False)
    assert result.failed == 0, f"{result.failed} doctest failure(s) in {modname}"
