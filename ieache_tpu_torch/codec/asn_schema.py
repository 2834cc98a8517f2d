"""Minimal ASN.1 (X.680) module parser — ``declaration.asn`` is the
wire format's source of truth, the same artifact kind the reference
deploys per node (``/root/reference/Output/declaration.asn:1-72``,
compiled there with asn1tools at each import site,
``Client1/dragonfly_private_client.py:33``).

Supports exactly the subset the reference's schemas use: a single
``<Module> DEFINITIONS ::= BEGIN ... END`` block of ``SEQUENCE`` type
assignments whose fields are ``INTEGER``, ``IA5String``,
``OCTET STRING``, or a reference to another SEQUENCE type, each
optionally marked ``OPTIONAL``.  Output is the dict format of
:mod:`ieache_tpu_torch.codec.schema`, which tests/test_torch_codec.py
verifies is identical to the hand-maintained transcription.  The port's
own copy of :mod:`ieache_tpu.codec.asn_schema`: it parses the port's
copy of ``declaration.asn``, which lies beside it.
"""

from __future__ import annotations

import os
import re

_PRIMITIVES = ("OCTET STRING", "IA5String", "INTEGER")

#: which declared types each node role carries — the schemas have
#: drifted per node in the reference (SURVEY C14): clients hold only
#: the 10 common transfer types (`Client1/declaration.asn:2-39`),
#: Cloud adds the job-descriptor group (`Cloud/declaration.asn:1-65`),
#: Keygen adds the two unused handshake codes (spelling its
#: DataInitate "DataIntiate", `Keygen/declaration.asn:11`), and Output
#: carries everything (`Output/declaration.asn:1-72`).
_COMMON = [
    "DataMd5", "DataMac", "DataKey", "DataScalarElement", "DataStaAp",
    "DataFsize", "DataContent", "DataIndicator", "DataAnsSize",
    "DataAnswer",
]
_JOB = ["DataUserInput", "IPADDRESSES", "OPERATIONS", "POSTFIX"]
_UNUSED = ["DataDragonflyVerif", "DataInitate"]
#: Keygen's schema copy misspells DataInitate as "DataIntiate"
#: (`Keygen/declaration.asn:11`) — preserved verbatim per role
_UNUSED_KEYGEN = ["DataDragonflyVerif", "DataIntiate"]
NODE_TYPES = {
    "client": list(_COMMON),
    "cloud": _JOB + _COMMON,
    "keygen": _UNUSED_KEYGEN + _COMMON,
    "output": _JOB + _UNUSED + _COMMON,
}


def _strip_comments(text: str) -> str:
    return re.sub(r"--[^\n]*", "", text)


def parse_module(text: str) -> dict:
    """Parse a DEFINITIONS module -> {name: schema-dict}.

    Schema dicts use the :mod:`schema` shapes: ``{"name": ...,
    "fields": [(field, type[, True]) ...]}`` where ``type`` is a
    primitive name or the referenced type's schema dict, and the
    optional third element marks ``OPTIONAL``.
    """
    text = _strip_comments(text)
    m = re.search(
        r"\bDEFINITIONS\s*::=\s*BEGIN\b(.*)\bEND\b", text, re.S
    )
    if not m:
        raise ValueError("no DEFINITIONS ::= BEGIN ... END block")
    body = m.group(1)

    raw = {}
    for tm in re.finditer(
        r"([A-Za-z][\w-]*)\s*::=\s*SEQUENCE\s*\{(.*?)\}", body, re.S
    ):
        name, fields_src = tm.group(1), tm.group(2)
        fields = []
        for part in fields_src.split(","):
            part = " ".join(part.split())
            if not part:
                continue
            optional = False
            if part.endswith(" OPTIONAL"):
                optional = True
                part = part[: -len(" OPTIONAL")]
            fm = re.fullmatch(r"([\w-]+)\s+(.+)", part)
            if not fm:
                raise ValueError(f"bad field {part!r} in {name}")
            fname, ftype = fm.group(1), fm.group(2).strip()
            if ftype not in _PRIMITIVES and not re.fullmatch(
                r"[A-Za-z][\w-]*", ftype
            ):
                raise ValueError(f"bad type {ftype!r} in {name}")
            fields.append((fname, ftype, optional))
        raw[name] = fields

    # resolve type references into nested schema dicts
    out: dict = {}

    def build(name: str, seen=()):  # noqa: D401
        if name in out:
            return out[name]
        if name in seen:
            raise ValueError(f"recursive type {name}")
        fields = []
        for fname, ftype, optional in raw[name]:
            if ftype in _PRIMITIVES:
                t = ftype
            elif ftype in raw:
                t = build(ftype, seen + (name,))
            else:
                raise ValueError(
                    f"unknown type {ftype!r} in {name}"
                )
            fields.append(
                (fname, t, True) if optional else (fname, t)
            )
        out[name] = {"name": name, "fields": fields}
        return out[name]

    for name in raw:
        build(name)
    return out


def module_path() -> str:
    return os.path.join(os.path.dirname(__file__), "declaration.asn")


def load_module() -> dict:
    """Parse the packaged ``declaration.asn``."""
    with open(module_path()) as f:
        return parse_module(f.read())


def emit_module(schemas: dict, module: str = "TEST") -> str:
    """Schema dicts -> ASN.1 module text (the inverse of
    :func:`parse_module`; used to emit per-node ``declaration.asn``
    files from :data:`NODE_TYPES` subsets)."""
    lines = [f"{module} DEFINITIONS ::= BEGIN", ""]
    for name, sch in schemas.items():
        lines.append(f"    {name} ::= SEQUENCE {{")
        fl = []
        for f in sch["fields"]:
            fname, ftype = f[0], f[1]
            tname = ftype if isinstance(ftype, str) else ftype["name"]
            opt = " OPTIONAL" if len(f) > 2 and f[2] else ""
            fl.append(f"        {fname} {tname}{opt}")
        lines.append(",\n".join(fl))
        lines.append("    }")
        lines.append("")
    lines.append("END")
    return "\n".join(lines) + "\n"


def node_module(role: str) -> str:
    """The ``declaration.asn`` text for one node role."""
    full = load_module()
    return emit_module({n: full[n] for n in NODE_TYPES[role]})
