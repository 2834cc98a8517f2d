"""ctypes bindings for the native oracle (``libieache_oracle.so``).

The port's own binding of the C++ oracle of the JAX package
(:mod:`ieache_tpu.native.lib`): the same functions and arguments, the
same library built from the same sources, ``ieache_tpu/native/src/
{oracle,ec}.cc``, which it reads and never copies or writes beside.
``g++`` compiles them on first use into the port's own build directory,
``ieache_tpu_torch/build/native/``, and again when a source is newer
than the library.  :func:`params_array` takes the port's ``TFHEParams``
(or any object with its fields).  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import threading

import numpy as np

from ieache_tpu_torch.params import TFHEParams

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(os.path.dirname(_PKG), "ieache_tpu", "native", "src")
BUILD_DIR = os.path.join(_PKG, "build", "native")
LIB_PATH = os.path.join(BUILD_DIR, "libieache_oracle.so")

#: the flags of ``ieache_tpu/native/Makefile``
CXXFLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lib = None
_lock = threading.Lock()


def build() -> str:
    """Compile the oracle unless the library is newer than every source;
    returns the library's path."""
    srcs = sorted(glob.glob(os.path.join(SRC_DIR, "*.cc")))
    if not srcs:
        raise RuntimeError(f"no oracle sources in {SRC_DIR}")
    newest = max(os.path.getmtime(s) for s in srcs)
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= newest:
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name and rename: the protocol's role
    # processes may build at once, and none loads a half-written library
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, *srcs],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def get_lib():
    global _lib
    with _lock:  # one build, whichever thread asks first
        if _lib is None:
            _lib = _load(build())
    return _lib


def _load(path: str):
    lib = ctypes.CDLL(path)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.tf_threefry.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, u32p,
    ]
    lib.tf_random_bits.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, u32p, ctypes.c_int64,
    ]
    lib.tf_keygen.argtypes = [
        i32p, u32p, ctypes.c_int, i32p, i32p, i32p, i32p,
    ]
    lib.tf_encrypt.argtypes = [
        i32p, i32p, i32p, ctypes.c_int64, ctypes.c_uint32,
        ctypes.c_uint32, i32p,
    ]
    lib.tf_decrypt.argtypes = [i32p, i32p, i32p, ctypes.c_int64, i32p]
    lib.tf_bootstrap.argtypes = [
        i32p, i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int32, i32p,
    ]
    for fn in (lib.tf_threefry, lib.tf_random_bits, lib.tf_keygen,
               lib.tf_encrypt, lib.tf_decrypt, lib.tf_bootstrap):
        fn.restype = None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ec_mul.argtypes = [u8p, u8p, u8p, u8p, u8p]
    lib.ec_mul.restype = ctypes.c_int
    return lib


def ec_mul(scalar: int, x: int, y: int):
    """Native brainpool scalar multiplication (releases the GIL).

    Returns (x, y) ints, or None for the point at infinity."""
    lib = get_lib()
    buf = (ctypes.c_uint8 * 160)()
    buf[0:32] = scalar.to_bytes(32, "big")
    buf[32:64] = x.to_bytes(32, "big")
    buf[64:96] = y.to_bytes(32, "big")

    def at(off):
        return ctypes.cast(ctypes.byref(buf, off),
                           ctypes.POINTER(ctypes.c_uint8))

    if lib.ec_mul(at(0), at(32), at(64), at(96), at(128)):
        return None
    return (
        int.from_bytes(bytes(buf[96:128]), "big"),
        int.from_bytes(bytes(buf[128:160]), "big"),
    )


def params_array(p: TFHEParams) -> np.ndarray:
    return np.array(
        [p.n, p.N, p.k, p.bg_bit, p.l, p.ks_basebit, p.ks_t,
         p.lwe_noise_scale, p.tlwe_noise_scale, p.noise_bits],
        dtype=np.int32,
    )


# -- high-level wrappers ----------------------------------------------------

def oracle_keygen(p: TFHEParams, seed_words):
    lib = get_lib()
    pr = params_array(p)
    seeds = np.asarray(seed_words, np.uint32)
    lwe_s = np.zeros(p.n, np.int32)
    trlwe_k = np.zeros(p.k * p.N, np.int32)
    bk = np.zeros(p.n * p.trgsw_rows * (p.k + 1) * p.N, np.int32)
    ks = np.zeros(p.kN * p.ks_t * (p.n + 1), np.int32)
    lib.tf_keygen(pr, seeds, len(seeds), lwe_s, trlwe_k, bk, ks)
    return (
        lwe_s,
        trlwe_k.reshape(p.k, p.N),
        bk.reshape(p.n, p.trgsw_rows, p.k + 1, p.N),
        ks.reshape(p.kN * p.ks_t, p.n + 1),
    )


def oracle_encrypt(p: TFHEParams, lwe_s, bits, stream_key):
    lib = get_lib()
    bits = np.ascontiguousarray(bits, np.int32).reshape(-1)
    out = np.zeros(len(bits) * (p.n + 1), np.int32)
    lib.tf_encrypt(
        params_array(p), np.ascontiguousarray(lwe_s, np.int32), bits,
        len(bits), int(stream_key[0]), int(stream_key[1]), out,
    )
    return out.reshape(len(bits), p.n + 1)


def oracle_decrypt(p: TFHEParams, lwe_s, lwe):
    lib = get_lib()
    lwe = np.ascontiguousarray(lwe, np.int32)
    nrows = lwe.shape[0]
    bits = np.zeros(nrows, np.int32)
    lib.tf_decrypt(
        params_array(p), np.ascontiguousarray(lwe_s, np.int32),
        lwe.reshape(-1), nrows, bits,
    )
    return bits


def oracle_bootstrap(p: TFHEParams, bk, ks, lwe_in, mu=1 << 29):
    lib = get_lib()
    lwe_in = np.ascontiguousarray(lwe_in, np.int32)
    nrows = lwe_in.shape[0]
    out = np.zeros(nrows * (p.n + 1), np.int32)
    lib.tf_bootstrap(
        params_array(p),
        np.ascontiguousarray(bk, np.int32).reshape(-1),
        np.ascontiguousarray(ks, np.int32).reshape(-1),
        lwe_in.reshape(-1), nrows, np.int32(mu), out,
    )
    return out.reshape(nrows, p.n + 1)
