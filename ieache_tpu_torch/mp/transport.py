"""TCP transport: BER message framing, SAE-over-socket, chunked files.

The port's own copy of :mod:`ieache_tpu.mp.transport`, on the port's
``codec`` and ``dragonfly``.

Counterpart of the reference's socket plumbing (components C15-C21):
BER TLVs over SOCK_STREAM, a hand-rolled stop-and-wait reliability
protocol (`"success"`/`"fail"` acks with sender-side rewind —
``Client1/dragonfly_cipher_client.py:82-118``,
``Cloud/dragonfly_cipher_cloud.py:821-875``,
``Output/output_dynamic.py:952-1004``), and the Dragonfly handshake
messages (`DataScalarElement`/`DataMac`/`DataStaAp`).

Unlike the reference, received EC points are parsed from a CSV
IA5String rather than ``eval()``'d (SURVEY Appendix A).
"""

from __future__ import annotations

import socket
import time

from ieache_tpu_torch.codec import ber, schema
from ieache_tpu_torch.mp import dragonfly

ACK_OK = b"success"
ACK_FAIL = b"fail"


# -- low-level framing ------------------------------------------------------

def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("socket closed mid-message")
        buf += part
    return buf


def recv_tlv(sock: socket.socket) -> bytes:
    """Read one complete BER TLV off the stream."""
    head = recv_exact(sock, 2)
    first_len = head[1]
    if first_len < 0x80:
        body_len = first_len
        rest = b""
    else:
        nbytes = first_len & 0x7F
        rest = recv_exact(sock, nbytes)
        body_len = int.from_bytes(rest, "big")
    return head + rest + recv_exact(sock, body_len)


def send_msg(sock: socket.socket, sch: dict, values: dict) -> None:
    sock.sendall(ber.encode_message(sch, values))


def recv_msg(sock: socket.socket, sch: dict) -> dict:
    buf = recv_tlv(sock)
    values, _ = ber.decode_message(sch, buf)
    return values


def send_ack(sock: socket.socket, ok: bool = True) -> None:
    """Length-framed stop-and-wait ack.

    The reference sends a bare unframed ``b"success"`` and reads it
    with a fixed-size ``recv`` (`dragonfly_cipher_client.py:100-117`)
    — if TCP coalesces the ack with the peer's next TLV the extra
    bytes are swallowed and the stream desyncs.  We frame the ack as a
    BER ``DataIndicator`` TLV instead, so `recv_ack` consumes exactly
    one message no matter how segments coalesce.
    """
    send_msg(
        sock, schema.DataIndicator,
        {"data": (ACK_OK if ok else ACK_FAIL).decode()},
    )


def recv_ack(sock: socket.socket) -> bool:
    data = recv_msg(sock, schema.DataIndicator)["data"]
    return data == ACK_OK.decode()


def connect_retry(host: str, port: int, retries: int = 50,
                  delay: float = 0.2) -> socket.socket:
    """The reference's infinite reconnect loop, bounded
    (`dragonfly_private_client.py:48-61`)."""
    last = None
    for _ in range(retries):
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.connect((host, port))
            return s
        except OSError as e:
            last = e
            time.sleep(delay)
    raise ConnectionError(f"cannot connect to {host}:{port}: {last}")


# -- stop-and-wait chunked transfer ----------------------------------------

def send_blob(sock: socket.socket, data: bytes, chunk: int = 1024,
              size_schema=None, content_schema=None) -> None:
    """DataFsize + acked DataContent chunks with rewind on nack."""
    size_schema = size_schema or schema.DataFsize
    content_schema = content_schema or schema.DataContent
    send_msg(sock, size_schema, {"data": len(data)})
    if not recv_ack(sock):
        raise ConnectionError("size rejected")
    off = 0
    while off < len(data):
        part = data[off:off + chunk]
        send_msg(sock, content_schema, {"data": part})
        if recv_ack(sock):
            off += len(part)
        # on nack: offset unchanged -> resend (sender-side rewind,
        # dragonfly_cipher_client.py:100-117)


def recv_blob(sock: socket.socket, size_schema=None,
              content_schema=None) -> bytes:
    size_schema = size_schema or schema.DataFsize
    content_schema = content_schema or schema.DataContent
    size = recv_msg(sock, size_schema)["data"]
    send_ack(sock, True)
    parts, got = [], 0  # list+join: quadratic += cost seconds on
    while got < size:   # multi-MB ciphertext/key blobs (r4 keyplane)
        try:
            values = recv_msg(sock, content_schema)
        except ValueError:
            send_ack(sock, False)  # decode failure -> nack, peer rewinds
            continue
        parts.append(values["data"])
        got += len(values["data"])
        send_ack(sock, True)
    return b"".join(parts)


# -- Dragonfly SAE over a socket -------------------------------------------

def sae_handshake(sock: socket.socket, password: str, my_mac: str,
                  peer_mac: str | None = None):
    """Run SAE with the peer on `sock`; returns (PMK, peer_mac).

    Wire format (both directions, symmetric):
      DataStaAp{data: mac}  then  DataScalarElement{data:
      "scalar,elem_x,elem_y"}  then  DataMac{data: token}.
    """
    send_msg(sock, schema.DataStaAp, {"data": my_mac})
    peer_mac_rx = recv_msg(sock, schema.DataStaAp)["data"]
    peer_mac = peer_mac or peer_mac_rx

    peer = dragonfly.Peer(password, my_mac, name=my_mac)
    peer.initiate(peer_mac)
    scalar, element = peer.commit_exchange()
    send_msg(
        sock, schema.DataScalarElement,
        {"data": f"{scalar},{element.x},{element.y}"},
    )
    parts = recv_msg(sock, schema.DataScalarElement)["data"].split(",")
    peer_scalar = int(parts[0])
    peer_element = dragonfly.Point(int(parts[1]), int(parts[2]))

    token = peer.compute_shared_secret(peer_element, peer_scalar, peer_mac)
    send_msg(sock, schema.DataMac, {"data": token})
    peer_token = recv_msg(sock, schema.DataMac)["data"]
    return peer.confirm_exchange(peer_token), peer_mac_rx
