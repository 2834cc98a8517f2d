"""On-disk formats: key files and ciphertext files.

The port's own copy of :mod:`ieache_tpu.codec.files`: the IEK1
container is byte for byte the same, so a key file written by either
package loads in the other.

Counterparts of the reference's durable artifacts
(``secret.key`` / ``cloud.key`` / ``nbit.key`` written by
the reference's ``Keygen/keygen.c:39-51``, ``cloud.data`` /
``answer.data`` written by ``Client1/alice.c:166-191`` and
``Cloud/cloud.c:899-916``).  tfhe-lib's text-ish export format is
replaced by a single self-describing container:

    magic "IEK1" | uint32 header_len | header JSON | raw arrays

The header carries the parameter set and an array manifest
(name, dtype, shape, byte offset), so files are readable from C++
(the oracle in ieache_tpu/native) without a Python dependency.
"""

from __future__ import annotations

import dataclasses
import json
import struct

import numpy as np

from ieache_tpu_torch.lwe.types import CloudKeySet, LweKey, SecretKeySet, TrlweKey
from ieache_tpu_torch.params import TFHEParams

MAGIC = b"IEK1"


def _params_to_dict(p: TFHEParams) -> dict:
    return dataclasses.asdict(p)


def _params_from_dict(d: dict) -> TFHEParams:
    return TFHEParams(**d)


def dumps_container(params: TFHEParams, arrays: dict, kind: str,
                    extra: dict | None = None) -> bytes:
    manifest = []
    blobs = []
    offset = 0
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        manifest.append(
            {
                "name": name,
                "dtype": arr.dtype.name,
                "shape": list(arr.shape),
                "offset": offset,
            }
        )
        raw = arr.tobytes()
        blobs.append(raw)
        offset += len(raw)
    hdr = {
        "kind": kind,
        "params": _params_to_dict(params),
        "arrays": manifest,
    }
    if extra:
        hdr["extra"] = extra
    header = json.dumps(hdr).encode()
    return b"".join(
        [MAGIC, struct.pack("<I", len(header)), header] + blobs
    )


def loads_container(blob: bytes, expect_kind: str | None = None):
    if blob[:4] != MAGIC:
        raise ValueError(f"bad magic {blob[:4]!r}")
    (hlen,) = struct.unpack("<I", blob[4:8])
    header = json.loads(blob[8:8 + hlen].decode())
    if expect_kind and header["kind"] != expect_kind:
        raise ValueError(
            f"kind {header['kind']!r}, wanted {expect_kind!r}"
        )
    payload = blob[8 + hlen:]
    params = _params_from_dict(header["params"])
    arrays = {}
    for m in header["arrays"]:
        dt = np.dtype(m["dtype"])
        count = int(np.prod(m["shape"])) if m["shape"] else 1
        arr = np.frombuffer(
            payload, dtype=dt, count=count, offset=m["offset"]
        ).reshape(m["shape"])
        arrays[m["name"]] = arr
    return params, arrays, header


def save_container(path: str, params: TFHEParams, arrays: dict,
                   kind: str) -> None:
    with open(path, "wb") as f:
        f.write(dumps_container(params, arrays, kind))


def load_container(path: str, expect_kind: str | None = None):
    with open(path, "rb") as f:
        blob = f.read()
    try:
        return loads_container(blob, expect_kind)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


# -- key files (secret.key / cloud.key equivalents) -------------------------

def save_secret_keyset(path: str, ks: SecretKeySet) -> None:
    save_container(
        path,
        ks.params,
        {
            "lwe_s": ks.lwe_key.s,
            "trlwe_k": ks.trlwe_key.coefs,
            "bk": ks.cloud.bk,
            "ks": ks.cloud.ks,
        },
        kind="secret_keyset",
    )


def load_secret_keyset(path: str) -> SecretKeySet:
    params, a, _ = load_container(path, "secret_keyset")
    return SecretKeySet(
        params,
        LweKey(params, a["lwe_s"].astype(np.int32)),
        TrlweKey(params, a["trlwe_k"].astype(np.int32)),
        CloudKeySet(params, a["bk"].astype(np.int32),
                    a["ks"].astype(np.int32)),
    )


def save_cloud_keyset(path: str, cloud: CloudKeySet) -> None:
    save_container(
        path, cloud.params, {"bk": cloud.bk, "ks": cloud.ks},
        kind="cloud_keyset",
    )


def load_cloud_keyset(path: str) -> CloudKeySet:
    params, a, _ = load_container(path, "cloud_keyset")
    return CloudKeySet(params, a["bk"].astype(np.int32),
                       a["ks"].astype(np.int32))


# -- ciphertext files (cloud.data / answer.data equivalents) ----------------

def save_lwe_array(path: str, params: TFHEParams, lwe: np.ndarray,
                   meta: dict | None = None) -> None:
    """LWE batch (..., n+1) int32 -> file; `meta` rides in the header."""
    arrays = {"lwe": np.asarray(lwe, np.int32)}
    if meta:
        arrays["_meta_json"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
    save_container(path, params, arrays, kind="lwe_array")


def load_lwe_array(path: str):
    params, a, _ = load_container(path, "lwe_array")
    meta = None
    if "_meta_json" in a:
        meta = json.loads(a["_meta_json"].tobytes().decode())
    return params, a["lwe"].astype(np.int32), meta
