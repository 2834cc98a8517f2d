"""The port's wire codec against the JAX package's.

``ieache_tpu_torch.codec.{ber,schema,asn_schema}`` and its copy of
``declaration.asn`` are host copies of the JAX package's modules.  Each
test of ``tests/test_codec.py``, ``tests/test_ber_interop.py`` and
``tests/test_reference_schema_pin.py`` has its counterpart here through
the port, and the copies are pinned to their originals: equal bytes for
every message type, each package decoding the other's bytes, equal
parsed modules.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ieache_tpu.codec import asn_schema as jasn
from ieache_tpu.codec import ber as jber
from ieache_tpu.codec import schema as jschema
from ieache_tpu_torch import params as P
from ieache_tpu_torch.codec import asn_schema, ber, files, schema
from ieache_tpu_torch.lwe import keygen

REF = "/root/reference"

#: reference directory -> NODE_TYPES role
ROLES = {"Client1": "client", "Client2": "client", "Client3": "client",
         "Cloud": "cloud", "Keygen": "keygen", "Output": "output"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def H(s):  # compact hex literal helper
    return bytes.fromhex(s.replace(" ", ""))


# -- tests/test_codec.py, through the port -------------------------------

def test_ber_integer_roundtrip():
    for v in [0, 1, -1, 127, 128, -128, -129, 255, 256, 2**31 - 1,
              -(2**31), 16384, 1024 * 1024]:
        buf = ber.encode_integer(v)
        tag, content, end = ber.decode_tlv(buf)
        assert tag == ber.TAG_INTEGER
        assert end == len(buf)
        assert ber.decode_integer(content) == v
        assert buf == jber.encode_integer(v)


def test_ber_known_der_encodings():
    assert ber.encode_integer(0) == b"\x02\x01\x00"
    assert ber.encode_integer(127) == b"\x02\x01\x7f"
    assert ber.encode_integer(128) == b"\x02\x02\x00\x80"
    assert ber.encode_integer(-128) == b"\x02\x01\x80"
    long = ber.encode_tlv(ber.TAG_OCTET_STRING, b"x" * 300)
    assert long[:4] == b"\x04\x82\x01\x2c"


def test_message_roundtrips():
    msgs = [
        (schema.DataFsize, {"data": 123456}),
        (schema.DataContent, {"data": bytes(range(256)) * 4}),
        (schema.DataMd5, {"data": "d41d8cd98f00b204e9800998ecf8427e"}),
        (schema.DataKey, {"key": b"\x00" * 100, "nbit": b"\xff" * 50}),
        (schema.DataIndicator, {"data": "finished"}),
        (schema.DataAnsSize, {"data": 162304}),
    ]
    for sch, values in msgs:
        buf = ber.encode_message(sch, values)
        got, end = ber.decode_message(sch, buf)
        assert end == len(buf)
        assert got == values


def test_user_input_nested_with_optionals():
    values = {
        "ipaddress": {"ipaddress1": b"192.168.0.21",
                      "ipaddress2": b"192.168.0.22"},
        "operation": {"operation1": b"1"},
        "postfix": {"postfix": b"AB+"},
    }
    buf = ber.encode_message(schema.DataUserInput, values)
    got, _ = ber.decode_message(schema.DataUserInput, buf)
    assert got["ipaddress"] == values["ipaddress"]
    assert got["operation"] == {"operation1": b"1"}
    assert got["postfix"] == {"postfix": b"AB+"}


def test_key_file_roundtrip(tmp_path):
    p = P.TEST_TINY
    ks = keygen.generate_secret_keyset(p)
    path = str(tmp_path / "secret.key")
    files.save_secret_keyset(path, ks)
    ks2 = files.load_secret_keyset(path)
    assert ks2.params == p
    np.testing.assert_array_equal(ks2.lwe_key.s, ks.lwe_key.s)
    np.testing.assert_array_equal(ks2.cloud.bk, ks.cloud.bk)
    np.testing.assert_array_equal(ks2.cloud.ks, ks.cloud.ks)
    cpath = str(tmp_path / "cloud.key")
    files.save_cloud_keyset(cpath, ks.cloud)
    np.testing.assert_array_equal(files.load_cloud_keyset(cpath).bk,
                                  ks.cloud.bk)


def test_lwe_array_file_roundtrip(tmp_path):
    p = P.TEST_TINY
    arr = np.arange(3 * 5 * (p.n + 1), dtype=np.int32).reshape(3, 5, -1)
    path = str(tmp_path / "cloud.data")
    files.save_lwe_array(path, p, arr, meta={"kind": "operand"})
    p2, arr2, meta = files.load_lwe_array(path)
    assert p2 == p
    assert meta == {"kind": "operand"}
    np.testing.assert_array_equal(arr2, arr)


def test_schema_matches_declaration_asn():
    assert asn_schema.load_module() == schema.ALL


def test_asn_emit_parse_roundtrip_per_node():
    full = asn_schema.load_module()
    for role, names in asn_schema.NODE_TYPES.items():
        parsed = asn_schema.parse_module(asn_schema.node_module(role))
        assert parsed == {n: full[n] for n in names}, role
    assert len(asn_schema.NODE_TYPES["client"]) == 10
    assert len(asn_schema.NODE_TYPES["output"]) == 16
    assert "DataUserInput" not in asn_schema.NODE_TYPES["keygen"]


def test_asn1tools_crosscheck():
    """If asn1tools is available, the port's module must compile and
    BER-encode DataFsize identically to the port's codec."""
    asn1tools = pytest.importorskip("asn1tools")
    spec = asn1tools.compile_files([asn_schema.module_path()], "ber")
    for value in [0, 1, 127, 128, 162304, 2**31 - 1]:
        theirs = spec.encode("DataFsize", {"data": value})
        assert theirs == ber.encode_message(schema.DataFsize,
                                            {"data": value}), value


# -- tests/test_ber_interop.py, through the port --------------------------

GOLDEN = [
    (schema.DataFsize, {"data": 0}, H("30 03 02 01 00")),
    (schema.DataFsize, {"data": 127}, H("30 03 02 01 7f")),
    (schema.DataFsize, {"data": 128}, H("30 04 02 02 00 80")),
    (schema.DataFsize, {"data": 987654}, H("30 05 02 03 0f 12 06")),
    (schema.DataFsize, {"data": -1}, H("30 03 02 01 ff")),
    (schema.DataFsize, {"data": 65536}, H("30 05 02 03 01 00 00")),
    (schema.DataMac, {"data": "abc"}, H("30 05 16 03 61 62 63")),
    (schema.DataIndicator, {"data": "success"},
     H("30 09 16 07") + b"success"),
    (schema.DataStaAp, {"data": "02:aa"}, H("30 07 16 05") + b"02:aa"),
    (schema.DataKey, {"key": b"KK", "nbit": b"N"},
     H("30 07 04 02 4b 4b 04 01 4e")),
    (schema.DataDragonflyVerif, {"code": 1}, H("30 03 02 01 01")),
    (schema.DataInitate, {"code": 300}, H("30 04 02 02 01 2c")),
]


@pytest.mark.parametrize("sch,values,golden", GOLDEN,
                         ids=[f"{g[0]['name']}-{i}" for i, g in
                              enumerate(GOLDEN)])
def test_golden_encodings(sch, values, golden):
    assert ber.encode_message(sch, values) == golden
    decoded, end = ber.decode_message(sch, golden)
    assert end == len(golden)
    assert decoded == values


def test_golden_long_form_length():
    payload = bytes((i * 3) % 256 for i in range(200))
    golden = H("30 81 cb") + H("04 81 c8") + payload
    assert ber.encode_message(schema.DataContent, {"data": payload}) == golden
    decoded, _ = ber.decode_message(schema.DataContent, golden)
    assert decoded["data"] == payload


def test_golden_nested_datauserinput_with_tail_optionals():
    values = {
        "ipaddress": {"ipaddress1": b"10.0.0.1"},
        "operation": {"operation1": b"1"},
        "postfix": {"postfix": b"AB+"},
    }
    golden = (H("30 18") + H("30 0a 04 08") + b"10.0.0.1"
              + H("30 03 04 01 31") + H("30 05 04 03") + b"AB+")
    assert ber.encode_message(schema.DataUserInput, values) == golden
    decoded, _ = ber.decode_message(schema.DataUserInput, golden)
    assert decoded == values
    assert "ipaddress2" not in decoded["ipaddress"]


def test_golden_full_three_ip_job():
    values = {
        "ipaddress": {f"ipaddress{i}": f"192.168.0.2{i}".encode()
                      for i in (1, 2, 3)},
        "operation": {"operation1": b"1", "operation2": b"2"},
        "postfix": {"postfix": b"AB+C-"},
    }
    ip = H("30 2a") + b"".join(
        H("04 0c") + values["ipaddress"][f"ipaddress{i}"] for i in (1, 2, 3))
    golden = (H("30 3d") + ip + H("30 06 04 01 31 04 01 32")
              + H("30 07 04 05") + b"AB+C-")
    assert ber.encode_message(schema.DataUserInput, values) == golden
    decoded, _ = ber.decode_message(schema.DataUserInput, golden)
    assert decoded == values


def _sample_values(sch, variant):
    """A value dict for a schema (tests/test_ber_interop.py's sweep):
    variant 0 full, 1 drops the OPTIONAL tail, others vary magnitudes."""
    ints = [0, 1, 127, 128, 255, 256, -1, -128, 162304, 2**31 - 1,
            -2**31][variant % 11]
    out = {}
    for i, field in enumerate(sch["fields"]):
        fname, ftype = field[0], field[1]
        optional = len(field) > 2 and field[2]
        if optional and variant == 1 and i >= len(sch["fields"]) - 1:
            continue
        if isinstance(ftype, dict):
            out[fname] = _sample_values(ftype, variant)
        elif ftype == "INTEGER":
            out[fname] = ints
        elif ftype == "OCTET STRING":
            out[fname] = bytes((i * 7 + j) % 256
                               for j in range(variant * 37 % 300))
        else:
            out[fname] = "msg-%d-%d" % (i, variant) + "x" * (variant * 29)
    return out


def test_second_source_encoder_agrees_on_all_types():
    import ber2

    for name, sch in schema.ALL.items():
        for variant in range(11):
            values = _sample_values(sch, variant)
            ours = ber.encode_message(sch, values)
            assert ours == ber2.encode(sch, values), (name, variant)
            _, end = ber.decode_message(sch, ours)
            assert end == len(ours), (name, variant)


def test_second_source_matches_golden_fixtures():
    import ber2

    for sch, values, golden in GOLDEN:
        assert ber2.encode(sch, values) == golden


# -- tests/test_reference_schema_pin.py, through the port ------------------

def _ref_module(node):
    if not os.path.isdir(REF):
        pytest.skip("reference tree not mounted")
    with open(os.path.join(REF, node, "declaration.asn")) as f:
        return asn_schema.parse_module(f.read())


@pytest.mark.parametrize("node", sorted(ROLES))
def test_node_type_set_matches_reference(node):
    assert set(_ref_module(node)) == set(asn_schema.NODE_TYPES[ROLES[node]])


@pytest.mark.parametrize("node", sorted(ROLES))
def test_field_layouts_match_transcription(node):
    for name, sch in _ref_module(node).items():
        assert sch == schema.ALL[name], f"{node}/{name}"


def test_keygen_datainitiate_misspelling_preserved():
    parsed = _ref_module("Keygen")
    assert "DataIntiate" in parsed and "DataInitate" not in parsed
    emitted = asn_schema.parse_module(asn_schema.node_module("keygen"))
    assert "DataIntiate" in emitted and "DataInitate" not in emitted


def test_output_module_is_the_full_superset():
    union = set()
    for node in ROLES:
        union |= set(_ref_module(node))
    assert union == set(schema.ALL)
    assert union - set(_ref_module("Output")) == {"DataIntiate"}


# -- the copies pinned to their originals ----------------------------------

@pytest.mark.parametrize("name", sorted(jschema.ALL))
def test_every_schema_type_encodes_to_the_same_bytes(name):
    """Equal schema dicts, equal BER bytes for every sample value of the
    type, and each package decodes the other's bytes to the values."""
    sch, jsch = schema.ALL[name], jschema.ALL[name]
    assert sch == jsch
    for variant in range(11):
        values = _sample_values(sch, variant)
        ours = ber.encode_message(sch, values)
        theirs = jber.encode_message(jsch, values)
        assert ours == theirs, variant
        assert ber.decode_message(sch, theirs) == \
            jber.decode_message(jsch, ours)
        got, end = ber.decode_message(sch, theirs)
        assert end == len(theirs)


def test_module_level_names_match():
    """The port's schema module defines the JAX package's types, the
    same tags and the same node roles."""
    for name in jschema.ALL:
        assert getattr(schema, name) == getattr(jschema, name)
    for tag in ("TAG_INTEGER", "TAG_OCTET_STRING", "TAG_UTF8STRING",
                "TAG_IA5STRING", "TAG_SEQUENCE"):
        assert getattr(ber, tag) == getattr(jber, tag)
    assert asn_schema.NODE_TYPES == jasn.NODE_TYPES


def test_declaration_asn_copies_parse_equal():
    """The port's declaration.asn lies beside its parser, and parses to
    the JAX package's module; every node's emitted module is the same
    text in both packages."""
    assert asn_schema.module_path() != jasn.module_path()
    assert os.path.dirname(asn_schema.module_path()) == os.path.dirname(
        asn_schema.__file__)
    assert asn_schema.load_module() == jasn.load_module()
    for role in asn_schema.NODE_TYPES:
        assert asn_schema.node_module(role) == jasn.node_module(role)
    with open(jasn.module_path()) as f:
        text = f.read()
    assert asn_schema.parse_module(text) == jasn.parse_module(text)


@pytest.mark.parametrize("bad", [
    "no module here",
    "T DEFINITIONS ::= BEGIN X ::= SEQUENCE { a Unknown } END",
    "T DEFINITIONS ::= BEGIN X ::= SEQUENCE { a X } END",
])
def test_parser_refuses_what_the_original_refuses(bad):
    with pytest.raises(ValueError):
        jasn.parse_module(bad)
    with pytest.raises(ValueError):
        asn_schema.parse_module(bad)


@pytest.mark.parametrize("buf", [b"", b"\x30\x05\x02\x01", b"\x02\x01\x00",
                                 b"\x30\x80\x00\x00"])
def test_decoder_refuses_what_the_original_refuses(buf):
    for mod, sch in ((ber, schema.DataFsize), (jber, jschema.DataFsize)):
        with pytest.raises((ValueError, IndexError)):
            mod.decode_message(sch, buf)


def test_key_files_of_one_package_load_in_the_other(tmp_path):
    """A key file the port writes loads in the JAX package, and back;
    the containers are byte for byte the same."""
    from ieache_tpu import params as JP
    from ieache_tpu.codec import files as jfiles
    from ieache_tpu.lwe import keygen as jkeygen

    ks = keygen.generate_secret_keyset(P.TEST_TINY)
    jks = jkeygen.generate_secret_keyset(JP.TEST_TINY)
    ours, theirs = str(tmp_path / "port.key"), str(tmp_path / "jax.key")
    files.save_secret_keyset(ours, ks)
    jfiles.save_secret_keyset(theirs, jks)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    back = jfiles.load_secret_keyset(ours)
    assert dataclasses.asdict(back.params) == dataclasses.asdict(ks.params)
    np.testing.assert_array_equal(back.cloud.bk, ks.cloud.bk)
