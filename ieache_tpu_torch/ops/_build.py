"""Build and load the CUDA kernels of ``ieache_tpu_torch/csrc``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process for
Hopper (``sm_90a``), all started together, and the objects are linked
into one shared library with a plain C interface,
``ieache_tpu_torch/build/libieache_kernels.so``, loaded with
``ctypes``.  The library is built on first use and rebuilt when a
source or a shared header (``csrc/*.cuh``) is newer than it; ``nvcc``'s
resource report (``-Xptxas -v``: registers, shared memory, spills per
kernel) is kept beside it in ``build/ptxas.log``, after a line naming
the sources and headers it was built from.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libieache_kernels.so")
PTXAS_LOG = os.path.join(BUILD_DIR, "ptxas.log")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def _run(procs: list) -> str:
    """Wait for every ``(name, Popen)``; raise on the first failure;
    return their joined output."""
    logs, failed = [], []
    for name, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode})")
    if failed:
        raise RuntimeError("nvcc failed: " + ", ".join(failed) + "\n"
                           + "\n".join(logs))
    return "\n".join(logs)


def build() -> str:
    """Compile the kernels unless the library is newer than every
    source and header; returns the library's path."""
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    newest = max(os.path.getmtime(f) for f in srcs + headers)
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= newest:
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under private names and rename: another process never
    # loads a half-written library
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [os.path.join(BUILD_DIR, os.path.basename(s)[:-3] + f".{tag}.o")
            for s in srcs]
    log = _run([
        (os.path.basename(src), subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, obj in zip(srcs, objs)
    ])
    tmp = f"{LIB_PATH}.{tag}"
    _run([("link", subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", tmp, *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
    for obj in objs:
        os.remove(obj)
    names = [os.path.basename(f) for f in srcs + headers]
    with open(PTXAS_LOG, "w") as f:
        f.write(f"built from: {' '.join(names)}\n{log}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed: one build,
    whichever thread asks first (the Cloud role launches from its
    listener threads)."""
    with _lock:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    # the rotations' launch shapes come last but for the stream: split's
    # run, the tr rotation's and the sublane kernel's splits
    lib.ieache_rot_diff_decompose.argtypes = [
        vp, vp, vp, i32, i32, i32, i32, i32, ctypes.c_uint32, i32, vp]
    lib.ieache_rot_diff_decompose_tr.argtypes = [
        vp, vp, vp, i32, i32, i32, i32, i32, ctypes.c_uint32, i32, vp]
    lib.ieache_rot_diff_decompose.restype = i32
    lib.ieache_rot_diff_decompose_tr.restype = i32
    # the product's launch (ops/kernels.py:product_launch) comes last but
    # for the stream: form, batch tile, coefficients, split
    lib.ieache_external_product.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.ieache_external_product_tr.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, i32, vp]
    for fn in (lib.ieache_external_product, lib.ieache_external_product_tr):
        fn.restype = i32
    lib.ieache_rotate_lane.argtypes = [vp, vp, vp, i32, i32, i32, vp]
    lib.ieache_rotate_sublane.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.ieache_rotate_lane.restype = i32
    lib.ieache_rotate_sublane.restype = i32
    # the fused step's launch (ops/kernels.py:step_launch) comes last but
    # for the stream: form (which implies the batch tile and coefficients),
    # split, per_item, cluster; the overlap entry's small-batch route:
    # split, per_item, cluster (split 0: its own kernel)
    lib.ieache_cmux_step.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, ctypes.c_uint32,
        i32, i32, i32, i32, vp]
    lib.ieache_cmux_step_overlap.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, ctypes.c_uint32,
        i32, i32, i32, vp]
    # the scan's launch (ops/kernels.py:scan_launch) comes last but for
    # the stream: split, per_item, grid, cluster, form
    lib.ieache_blind_rotate_scan.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_uint32, i32, i32, i32, i32, i32, vp,
    ]
    lib.ieache_blind_rotate_scan_per_sm.argtypes = [
        i32, i32, ctypes.POINTER(i32)]
    lib.ieache_cmux_step_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32)]
    for fn in (lib.ieache_blind_rotate_scan_clusters,
               lib.ieache_cmux_step_clusters):
        fn.argtypes = [i32, i32, i32, i32, ctypes.POINTER(i32)]
    for fn in (lib.ieache_cmux_step, lib.ieache_cmux_step_overlap,
               lib.ieache_blind_rotate_scan,
               lib.ieache_blind_rotate_scan_per_sm,
               lib.ieache_cmux_step_per_sm,
               lib.ieache_blind_rotate_scan_clusters,
               lib.ieache_cmux_step_clusters):
        fn.restype = i32
    # the keyswitch's launch (ops/kernels.py:keyswitch_launch) comes last
    # but for the stream: lanes a tile, K-slices
    lib.ieache_keyswitch.argtypes = [
        vp, vp, vp, i32, i32, i32, i32, ctypes.c_uint32, i32, i32, i32, i32,
        vp]
    lib.ieache_keyswitch.restype = i32
    for fn in (lib.ieache_mm_s8, lib.ieache_mm_bf16):
        fn.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp]
        fn.restype = i32
    lib.ieache_error_string.argtypes = [i32]
    lib.ieache_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.ieache_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
