"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
``ldpc_decoders_tpu_torch/build/`` and loaded with ``ctypes``. A source may
include headers of ``csrc/`` (``#include "<header>.cuh"``). The library
file name carries a hash of the source and of the headers it includes, so
an edited kernel or header is rebuilt and a stale build is never loaded.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", CSRC_DIR)
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


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


def source_files(name: str) -> list:
    """``<name>.cu`` and the ``csrc/`` headers it includes, directly or
    through another header, in the order they are first met."""
    files, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f not in files:
            files.append(f)
            with open(os.path.join(CSRC_DIR, f), "rb") as fp:
                todo += [m.decode() for m in _INCLUDE.findall(fp.read())]
    return files


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to (a hash of its source and of the
    headers it includes in the name)."""
    digest = hashlib.sha256()
    for f in source_files(name):
        with open(os.path.join(CSRC_DIR, f), "rb") as fp:
            digest.update(f.encode() + b"\0" + fp.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


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
