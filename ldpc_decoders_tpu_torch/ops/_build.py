"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
``ldpc_decoders_tpu_torch/build/`` and loaded with ``ctypes``. The library
file name carries a hash of the source, so an edited kernel is rebuilt and
a stale build is never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels are built from source at first use")
    return path


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to (hash of its source in the name)."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as fp:
        digest = hashlib.sha256(fp.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, then load it.
    ptxas's register and shared-memory report goes to ``<lib>.log``."""
    out = library_path(name)
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}.cu:\n{proc.stdout}{proc.stderr}")
        with open(out + ".log", "w") as fp:
            fp.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        os.replace(tmp, out)    # atomic: no reader sees half a file
    return ctypes.CDLL(out)
