"""Build the package's CUDA kernels with `nvcc` at first use; load them
with `ctypes`.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers),
so one build takes seconds. The shared library goes into `_build/` beside
the sources, named by a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing here
runs at import time.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


class KernelBuildError(RuntimeError):
    """A CUDA kernel of the package could not be built or loaded."""


def find_nvcc() -> str:
    """The `nvcc` to build with: `$CUDA_HOME/bin/nvcc`, else the one on
    `PATH`, else the toolkit's default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels of genjax_tpu_torch are built from csrc/ at first "
        "use on a machine with the CUDA toolkit. On the CPU, call the "
        "public functions (e.g. ops.logsumexp) with CPU tensors instead."
    )


def library_path(name: str) -> Path:
    """Where the build of `csrc/<name>.cu` lives (it may not exist yet)."""
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if no build of this source exists, and load it."""
    out = library_path(name)
    if not out.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build into a temporary name, then rename: a concurrent process
        # never loads a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(out))
