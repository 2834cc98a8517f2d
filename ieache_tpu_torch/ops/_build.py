"""Build and load the CUDA kernels of ``ieache_tpu_torch/csrc``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface,
``ieache_tpu_torch/build/libieache_kernels.so``, loaded with
``ctypes``.  The library is built on first use and rebuilt when a
source is newer than it; ``nvcc``'s resource report (``-Xptxas -v``:
registers, shared memory, spills per kernel) is kept beside it in
``build/ptxas.log``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libieache_kernels.so")
PTXAS_LOG = os.path.join(BUILD_DIR, "ptxas.log")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built"
        )
    return path


def build() -> str:
    """Compile the kernels unless the library is newer than every
    source; returns the library's path."""
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    newest = max(os.path.getmtime(s) for s in srcs)
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= newest:
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name and rename: another process never
    # loads a half-written library
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    with open(PTXAS_LOG, "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(build())
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ieache_rot_diff_decompose.argtypes = [
        vp, vp, vp, i32, i32, i32, i32, i32, ctypes.c_uint32, vp,
    ]
    lib.ieache_rot_diff_decompose.restype = i32
    lib.ieache_external_product.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, i32, vp,
    ]
    lib.ieache_external_product.restype = i32
    lib.ieache_error_string.argtypes = [i32]
    lib.ieache_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.ieache_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
