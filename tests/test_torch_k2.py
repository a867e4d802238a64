"""K2's wrapper off the card (`ops/resample.py`): what it refuses, its
launch geometry, and that importing the package builds and loads no
kernel. The kernel itself runs on the card only (`tests/test_torch_cuda.py`);
on the CPU, `systematic_resample` takes the plain twin
(`tests/test_torch_smc.py`)."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from genjax_tpu_torch.ops import fused_systematic_ancestors
from genjax_tpu_torch.ops.resample import tiles


@pytest.mark.parametrize(
    "lw, n, match",
    [
        (torch.zeros(8), 8, "CUDA device"),
        (torch.zeros(2, 4), 8, "1-D"),
        (torch.zeros(8, dtype=torch.float64), 8, "float32"),
    ],
    ids=["cpu_tensor", "rows", "float64"],
)
def test_the_kernel_wrapper_refuses_what_it_does_not_take(lw, n, match):
    # No plain fallback behind the kernel's wrapper: a CPU tensor raises.
    before = fused_systematic_ancestors.launches
    with pytest.raises(ValueError, match=match):
        fused_systematic_ancestors(torch.tensor(0.5), lw, n)
    assert fused_systematic_ancestors.launches == before


@pytest.mark.parametrize("k", [1, 4095, 4096, 4097, 1_000_000, 4_194_304, 2**31 - 1])
def test_each_tile_of_4096_particles_has_one_block(k):
    assert (tiles(k) - 1) * 4096 < k <= tiles(k) * 4096


def test_importing_the_package_builds_and_loads_no_kernel():
    code = (
        "import torch\n"
        "import genjax_tpu_torch as gx\n"
        "from genjax_tpu_torch.ops import _build, resample\n"
        "from genjax_tpu_torch.inference.smc import systematic_resample\n"
        "anc = systematic_resample(torch.Generator().manual_seed(0), torch.zeros(64), 64)\n"
        "print(_build.load_library.cache_info().currsize, resample._library.cache_info().currsize, "
        "resample.fused_systematic_ancestors.launches, int(anc.sum()))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        env={"PATH": "", "CUDA_VISIBLE_DEVICES": ""},
        cwd=Path(__file__).resolve().parent.parent,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "0", "0", str(sum(range(64)))]
