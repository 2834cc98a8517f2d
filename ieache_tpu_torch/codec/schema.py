"""Wire message schemas — the reference's ``declaration.asn`` types.

The port's own copy of :mod:`ieache_tpu.codec.schema` (equal dicts,
pinned by ``tests/test_torch_codec.py``).

Transcribed from ``/root/reference/Output/declaration.asn:1-72`` (the
fullest of the six per-node copies; clients carry the 10 common types,
``Client1/declaration.asn:2-39``).  Notable reference facts preserved:

* ``DataUserInput`` caps a job at 3 client IPs + 2 operators
  (``Cloud/declaration.asn:8-18``) even though the CLI collects up to
  4/3 — the effective capability is <=3 operands (SURVEY Appendix A);
* ``DataDragonflyVerif`` / ``DataInitate`` are declared but unused
  (kept for schema parity);
* all handshake payloads ride IA5String fields, key/ciphertext chunks
  ride OCTET STRINGs.
"""

IPADDRESSES = {
    "name": "IPADDRESSES",
    "fields": [
        ("ipaddress1", "OCTET STRING", True),
        ("ipaddress2", "OCTET STRING", True),
        ("ipaddress3", "OCTET STRING", True),
    ],
}

OPERATIONS = {
    "name": "OPERATIONS",
    "fields": [
        ("operation1", "OCTET STRING", True),
        ("operation2", "OCTET STRING", True),
    ],
}

POSTFIX = {
    "name": "POSTFIX",
    "fields": [("postfix", "OCTET STRING", True)],
}

DataUserInput = {
    "name": "DataUserInput",
    "fields": [
        ("ipaddress", IPADDRESSES),
        ("operation", OPERATIONS),
        ("postfix", POSTFIX),
    ],
}

DataMd5 = {"name": "DataMd5", "fields": [("data", "IA5String")]}
DataDragonflyVerif = {
    "name": "DataDragonflyVerif", "fields": [("code", "INTEGER")]
}
DataInitate = {"name": "DataInitate", "fields": [("code", "INTEGER")]}
#: Keygen's copy of the schema misspells DataInitate — preserved
#: verbatim for wire parity (`/root/reference/Keygen/declaration.asn:11`)
DataIntiate = {"name": "DataIntiate", "fields": [("code", "INTEGER")]}
DataMac = {"name": "DataMac", "fields": [("data", "IA5String")]}
DataKey = {
    "name": "DataKey",
    "fields": [("key", "OCTET STRING"), ("nbit", "OCTET STRING")],
}
DataScalarElement = {
    "name": "DataScalarElement", "fields": [("data", "IA5String")]
}
DataStaAp = {"name": "DataStaAp", "fields": [("data", "IA5String")]}
DataFsize = {"name": "DataFsize", "fields": [("data", "INTEGER")]}
DataContent = {"name": "DataContent", "fields": [("data", "OCTET STRING")]}
DataIndicator = {"name": "DataIndicator", "fields": [("data", "IA5String")]}
DataAnsSize = {"name": "DataAnsSize", "fields": [("data", "INTEGER")]}
DataAnswer = {"name": "DataAnswer", "fields": [("data", "OCTET STRING")]}

ALL = {
    s["name"]: s
    for s in [
        DataUserInput, IPADDRESSES, OPERATIONS, POSTFIX, DataMd5,
        DataDragonflyVerif, DataInitate, DataIntiate, DataMac,
        DataKey,
        DataScalarElement, DataStaAp, DataFsize, DataContent,
        DataIndicator, DataAnsSize, DataAnswer,
    ]
}
