"""Deployment/network configuration.

The port's own copy of :mod:`ieache_tpu.mp.config`, pinned to it by
``tests/test_torch_mp.py``.

The reference hardcodes its topology: six fixed IPs
(``README.md:63-71``), key-plane port 4380 and data-plane port 4381
(``Client1/dragonfly_cipher_client.py:33-39``,
``Output/output_dynamic.py:1054-1055``), and the network password
``'abc1238'`` (``Client1/dragonfly_private_client.py:555``).  SURVEY
§5.6 flags the absence of a config layer; this dataclass is its
first-class replacement.  Defaults mirror the reference topology;
`localhost_config()` builds the loopback topology used by the
in-process multi-party simulation (the test harness the reference
lacks, SURVEY §4).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Endpoint:
    host: str
    key_port: int = 4380   # key plane (Dragonfly + DataKey)
    data_port: int = 4381  # data plane (ciphertext/job/answer)


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    keygen: Endpoint = Endpoint("192.168.0.3")
    cloud: Endpoint = Endpoint("192.168.0.1")
    output: Endpoint = Endpoint("192.168.0.4")
    clients: tuple = (
        Endpoint("192.168.0.21"),
        Endpoint("192.168.0.22"),
        Endpoint("192.168.0.23"),
    )
    password: str = "abc1238"
    #: BER DataContent payload chunk.  The reference streams 1024-byte
    #: chunks (dragonfly_cipher_client.py:86) — a buffer-size choice,
    #: not a schema constraint (DataContent is an arbitrary-length
    #: OCTET STRING).  At lambda=110 ciphertext sizes (tens of MB per
    #: operand) 1 KiB stop-and-wait costs ~30k Python-framed ack
    #: round-trips per pull; 256 KiB keeps the ack/rewind protocol and
    #: the wire schema while making framing negligible.  Reference-
    #: sized chunks stay pinned by tests/test_transport.py.
    chunk_size: int = 256 * 1024
    #: DataKey chunk.  Reference value: 8192
    #: (dragonfly_private_keygen.py:658-672); at 33 MB key blobs the
    #: 4000 ack round-trips per peer (~0.6 s of GIL-bound framing)
    #: were what serialized the threaded key fan-out (r5 keyplane
    #: profile) — 1 MiB leaves AES/md5 (GIL-releasing) as the only
    #: per-peer cost, so concurrent exchanges actually overlap.
    key_chunk_size: int = 1024 * 1024
    connect_retry_s: float = 0.2
    connect_retries: int = 50


def localhost_config(base_port: int = 0) -> NetworkConfig:
    """Loopback topology with distinct ports per role (for the sim).

    base_port=0 lets the OS pick free ports lazily per listener; when
    nonzero, roles get consecutive port pairs from base_port.
    """
    def ep(i):
        if base_port == 0:
            return Endpoint("127.0.0.1", 0, 0)
        return Endpoint("127.0.0.1", base_port + 2 * i,
                        base_port + 2 * i + 1)

    return NetworkConfig(
        keygen=ep(0),
        cloud=ep(1),
        output=ep(2),
        clients=(ep(3), ep(4), ep(5)),
    )
