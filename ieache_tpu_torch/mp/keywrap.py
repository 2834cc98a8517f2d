"""AES-256-CBC file wrapping for key material ("*.hacklab" files).

The port's own copy of :mod:`ieache_tpu.mp.keywrap`, pinned to it by
``tests/test_torch_mp.py``.

Byte-compatible re-implementation of the reference's
``encrypting()``/``decrypting()`` helpers
(``/root/reference/Keygen/dragonfly_private_keygen.py:527-546`` /
``Client1/dragonfly_private_client.py:529-546``): the PMK from the
Dragonfly handshake keys an AES-256-CBC stream with a 16-char ASCII
file-size header, a 16-byte IV prefix, 64 KiB chunking and space
padding; wrapped files carry the ``.hacklab`` suffix.

Uses the `cryptography` package (in-image) instead of pycryptodomex.
"""

from __future__ import annotations

import secrets

from cryptography.hazmat.primitives.ciphers import (
    Cipher, algorithms, modes,
)

SUFFIX = ".hacklab"
CHUNK = 64 * 1024


def encrypt_bytes(key: bytes, data: bytes, iv: bytes | None = None) -> bytes:
    """-> 16-char size header + IV + CBC ciphertext (space padded)."""
    if len(key) != 32:
        raise ValueError("AES-256 key must be 32 bytes")
    iv = iv or secrets.token_bytes(16)
    header = "{:016d}".format(len(data)).encode()
    enc = Cipher(algorithms.AES(key), modes.CBC(iv)).encryptor()
    out = [header, iv]
    for off in range(0, len(data), CHUNK):
        chunk = data[off:off + CHUNK]
        if len(chunk) % 16:
            chunk += b" " * (16 - len(chunk) % 16)
        out.append(enc.update(chunk))
    out.append(enc.finalize())
    return b"".join(out)


def decrypt_bytes(key: bytes, blob: bytes) -> bytes:
    size = int(blob[:16].decode())
    iv = blob[16:32]
    dec = Cipher(algorithms.AES(key), modes.CBC(iv)).decryptor()
    plain = dec.update(blob[32:]) + dec.finalize()
    return plain[:size]


def encrypt_file(key: bytes, filename: str, out: str | None = None) -> str:
    """filename -> filename + '.hacklab' (reference convention)."""
    out = out or filename + SUFFIX
    with open(filename, "rb") as f:
        data = f.read()
    with open(out, "wb") as f:
        f.write(encrypt_bytes(key, data))
    return out


def decrypt_file(key: bytes, filename: str, out: str | None = None) -> str:
    if out is None:
        out = filename[: -len(SUFFIX)] if filename.endswith(SUFFIX) \
            else filename + ".plain"
    with open(filename, "rb") as f:
        blob = f.read()
    with open(out, "wb") as f:
        f.write(decrypt_bytes(key, blob))
    return out


def new_iv() -> bytes:
    return secrets.token_bytes(16)


def file_md5(path: str) -> str:
    """md5 digest hex — the reference's manual transfer cross-check
    (`dragonfly_private_keygen.py:676-680`)."""
    import hashlib

    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
