"""ASN.1 BER (ITU-T X.690) encoder/decoder — self-contained.

The port's own copy of :mod:`ieache_tpu.codec.ber` (the same bytes for
every message; ``tests/test_torch_codec.py`` pins it to the original).

The reference encodes every wire message as BER via the external
`asn1tools` package compiled from per-node ``declaration.asn`` schemas
(e.g. ``/root/reference/Output/declaration.asn:1-72``; import sites like
``Client1/dragonfly_private_client.py:33``).  This module implements
the needed X.690 subset natively: definite-length TLV with universal
tags SEQUENCE / INTEGER / OCTET STRING / IA5String / UTF8String.

Schemas are Python descriptions (see codec/schema.py);
OPTIONAL fields are matched positionally by tag, which is exactly how
the reference's schemas behave (identical-tag OPTIONALs are only ever
omitted from the tail).
"""

from __future__ import annotations

TAG_INTEGER = 0x02
TAG_OCTET_STRING = 0x04
TAG_UTF8STRING = 0x0C
TAG_IA5STRING = 0x16
TAG_SEQUENCE = 0x30


def encode_length(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def decode_length(buf: bytes, off: int):
    first = buf[off]
    off += 1
    if first < 0x80:
        return first, off
    nbytes = first & 0x7F
    if nbytes == 0:
        raise ValueError("indefinite length not supported")
    n = int.from_bytes(buf[off:off + nbytes], "big")
    return n, off + nbytes


def encode_tlv(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + encode_length(len(content)) + content


def decode_tlv(buf: bytes, off: int = 0):
    """-> (tag, content, next_offset)."""
    if off >= len(buf):
        raise ValueError("truncated TLV")
    tag = buf[off]
    length, body_off = decode_length(buf, off + 1)
    end = body_off + length
    if end > len(buf):
        raise ValueError("TLV length exceeds buffer")
    return tag, buf[body_off:end], end


def encode_integer(v: int) -> bytes:
    if v == 0:
        body = b"\x00"
    else:
        nbytes = (v.bit_length() + 8) // 8  # +1 bit for sign
        body = v.to_bytes(nbytes, "big", signed=True)
        # minimal encoding
        while (
            len(body) > 1
            and (
                (body[0] == 0x00 and body[1] < 0x80)
                or (body[0] == 0xFF and body[1] >= 0x80)
            )
        ):
            body = body[1:]
    return encode_tlv(TAG_INTEGER, body)


def decode_integer(content: bytes) -> int:
    return int.from_bytes(content, "big", signed=True)


_FIELD_TAGS = {
    "INTEGER": TAG_INTEGER,
    "OCTET STRING": TAG_OCTET_STRING,
    "IA5String": TAG_IA5STRING,
    "UTF8String": TAG_UTF8STRING,
}


def _encode_field(ftype, value) -> bytes:
    if isinstance(ftype, dict):  # nested SEQUENCE schema
        return encode_message(ftype, value)
    if ftype == "INTEGER":
        return encode_integer(int(value))
    if ftype == "OCTET STRING":
        if isinstance(value, str):
            value = value.encode()
        return encode_tlv(TAG_OCTET_STRING, bytes(value))
    if ftype in ("IA5String", "UTF8String"):
        if isinstance(value, bytes):
            value = value.decode()
        return encode_tlv(_FIELD_TAGS[ftype], value.encode("ascii" if
                          ftype == "IA5String" else "utf-8"))
    raise ValueError(f"unknown field type {ftype!r}")


def _decode_field(ftype, tag, content):
    if isinstance(ftype, dict):
        if tag != TAG_SEQUENCE:
            raise ValueError("expected SEQUENCE")
        return _decode_sequence_fields(ftype, content)
    want = _FIELD_TAGS[ftype]
    if tag != want:
        raise ValueError(f"tag {tag:#x} != expected {want:#x}")
    if ftype == "INTEGER":
        return decode_integer(content)
    if ftype == "OCTET STRING":
        return content
    return content.decode("ascii" if ftype == "IA5String" else "utf-8")


def encode_message(schema: dict, values: dict) -> bytes:
    """schema = {"fields": [(name, type, optional?), ...]}."""
    out = b""
    for field in schema["fields"]:
        name, ftype = field[0], field[1]
        optional = len(field) > 2 and field[2]
        if name not in values or values[name] is None:
            if optional:
                continue
            raise ValueError(f"missing required field {name!r}")
        out += _encode_field(ftype, values[name])
    return encode_tlv(TAG_SEQUENCE, out)


def _decode_sequence_fields(schema: dict, content: bytes) -> dict:
    values = {}
    off = 0
    for field in schema["fields"]:
        name, ftype = field[0], field[1]
        optional = len(field) > 2 and field[2]
        if off >= len(content):
            if optional:
                continue
            raise ValueError(f"missing required field {name!r}")
        tag, body, off2 = decode_tlv(content, off)
        try:
            values[name] = _decode_field(ftype, tag, body)
            off = off2
        except ValueError:
            if optional:
                continue
            raise
    if off != len(content):
        raise ValueError("trailing bytes in SEQUENCE")
    return values


def decode_message(schema: dict, buf: bytes, off: int = 0):
    """-> (values dict, next_offset)."""
    tag, content, end = decode_tlv(buf, off)
    if tag != TAG_SEQUENCE:
        raise ValueError(f"top-level tag {tag:#x} is not SEQUENCE")
    return _decode_sequence_fields(schema, content), end
