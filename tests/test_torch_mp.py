"""The port's protocol (``ieache_tpu_torch.mp``) against the JAX package's.

Each test of ``tests/test_mp.py``, ``tests/test_transport.py`` and
``tests/test_error_paths.py`` has its counterpart here through the port,
with the clients and the Cloud on the CPU (``device="cpu"``, the
kernels' plain twins).  The host copies are pinned to their originals
(equal configs, key wraps, SAE across packages, both native libraries,
the scheduler's plans, operand bytes), and the roles of the two
packages serve each other: a JAX Keygen and Output with the port's
clients and Cloud, and the reverse, both decrypting to the Python
result; under ``IEACHE_DETERMINISTIC=1`` one ``expr`` flow in each
package writes byte-equal operand and answer blobs.
"""

import dataclasses
import os
import random
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ieache_tpu import params as JP
from ieache_tpu.circuits import evaluator as jev
from ieache_tpu.lwe import keygen as jkeygen
from ieache_tpu.mp import config as jconfig
from ieache_tpu.mp import dragonfly as jdragonfly
from ieache_tpu.mp import keywrap as jkeywrap
from ieache_tpu.mp import nodes as jnodes
from ieache_tpu.mp import scheduler as jscheduler
from ieache_tpu.mp import sim as jsim
from ieache_tpu.mp import transport as jtransport
from ieache_tpu.mp import wire as jwire
from ieache_tpu.native import lib as jlib
from ieache_tpu_torch import params as P
from ieache_tpu_torch.circuits import evaluator as ev
from ieache_tpu_torch.codec import ber, files, schema
from ieache_tpu_torch.lwe import keygen
from ieache_tpu_torch.mp import (
    config,
    dragonfly,
    keywrap,
    liveness,
    nodes,
    scheduler,
    sim,
    supervisor,
    transport,
    wire,
)
from ieache_tpu_torch.native import lib
from ieache_tpu_torch.utils import prng
from ieache_tpu_torch.utils.trace import Timings, bootstraps_per_sec

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers, and a flow's node threads share this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def deterministic(monkeypatch):
    monkeypatch.setenv("IEACHE_DETERMINISTIC", "1")


# -- tests/test_mp.py, through the port -----------------------------------

def test_dragonfly_handshake_derives_same_pmk():
    a, b = dragonfly.handshake_pair()
    assert a.pmk == b.pmk
    assert len(a.pmk) == 32
    assert a.pe == dragonfly.Peer(
        dragonfly.DEFAULT_PASSWORD, a.mac_address).initiate(b.mac_address)


def test_dragonfly_wrong_password_fails():
    mac_a, mac_b = "02:aa", "02:bb"
    a = dragonfly.Peer("abc1238", mac_a)
    b = dragonfly.Peer("wrong", mac_b)
    a.initiate(mac_b)
    b.initiate(mac_a)
    sa, ea = a.commit_exchange()
    sb, eb = b.commit_exchange()
    ta = a.compute_shared_secret(eb, sb, mac_b)
    b.compute_shared_secret(ea, sa, mac_a)
    with pytest.raises(ValueError):
        b.confirm_exchange(ta)


def test_curve_group_law():
    c = dragonfly.Curve()
    pe = dragonfly.Peer("x", "m1").initiate("m2")
    assert c.add(c.add(pe, pe), pe) == c.mul(3, pe)
    assert c.valid(c.mul(12345, pe))


def test_keywrap_roundtrip():
    key = bytes(range(32))
    for n in [0, 1, 15, 16, 17, 1000, 70000]:
        data = bytes((i * 7) % 256 for i in range(n))
        assert keywrap.decrypt_bytes(key, keywrap.encrypt_bytes(key, data)) \
            == data


def test_scheduler_caps_and_parse():
    assert scheduler.parse_postfix("AB+C-") == (["A", "B", "C"], ["+", "-"])
    with pytest.raises(scheduler.JobError):
        scheduler.parse_postfix("AB+CD+E+")
    with pytest.raises(scheduler.JobError):
        scheduler.parse_postfix("AB+C-D*")


def test_full_flow_two_operand():
    res = sim.run_full_flow("AB+", {"A": [3, 100], "B": [5, 27]}, width=8,
                            params=P.TEST_TINY, device=CPU)
    assert res.values == [8, 127]
    assert sorted(res.served_roles) == ["client-1", "client-2", "cloud",
                                        "output"]
    assert res.gate_count > 0


def test_full_flow_three_operand_chain():
    res = sim.run_full_flow("AB+C-", {"A": [30, 1], "B": [12, 2],
                                      "C": [50, 3]},
                            width=8, params=P.TEST_TINY, device=CPU)
    assert res.values == [-8, 0]
    assert len(res.timings) == 1 and res.timings[0]["op"] == "+-"
    names = [s["name"] for s in res.cloud_spans]
    assert names == ["job_receive", "data_request", "data_request",
                     "data_request", "compute_chain", "answer_ship"]
    assert [s["name"] for s in res.output_spans] == [
        "user_input_processing", "answer_wait", "verify"]
    assert res.key_exchange_s > 0


def test_full_flow_three_operand_unchained(monkeypatch):
    monkeypatch.setenv("IEACHE_CHAIN", "0")
    res = sim.run_full_flow("AB+C-", {"A": [30], "B": [12], "C": [50]},
                            width=8, params=P.TEST_TINY, device=CPU)
    assert res.values == [-8]
    assert len(res.timings) == 2


def test_plan_postfix_shapes():
    letters, op_chars, steps = scheduler.plan_postfix("AB+C-")
    assert letters == ["A", "B", "C"] and op_chars == ["+", "-"]
    assert steps == [("+", ("opnd", 0), ("opnd", 1)),
                     ("-", ("step", 0), ("opnd", 2))]
    _, _, steps = scheduler.plan_postfix("ABC*-")
    assert steps == [("*", ("opnd", 1), ("opnd", 2)),
                     ("-", ("opnd", 0), ("step", 0))]
    with pytest.raises(scheduler.JobError):
        scheduler.plan_postfix("AB+-")


def test_full_flow_mul_first_tree():
    res = sim.run_full_flow("ABC*-", {"A": [100], "B": [5], "C": [9]},
                            width=8, params=P.TEST_TINY, device=CPU)
    assert res.values == [100 - 5 * 9]
    assert res.timings[0]["op"] == "*-"


def test_key_transfer_digest_mismatch_detected():
    a, b = socket.socketpair()
    pmk = bytes(range(32))
    errors = []

    def sender():
        wrapped_k = keywrap.encrypt_bytes(pmk, b"K" * 1000)
        wrapped_n = keywrap.encrypt_bytes(pmk, b"N" * 500)
        transport.send_msg(a, schema.DataFsize, {"data": len(wrapped_k)})
        transport.recv_ack(a)
        transport.send_msg(a, schema.DataFsize, {"data": len(wrapped_n)})
        transport.recv_ack(a)
        transport.send_msg(a, schema.DataKey,
                           {"key": wrapped_k, "nbit": wrapped_n})
        transport.recv_ack(a)
        transport.send_msg(a, schema.DataMd5, {"data": "deadbeef,deadbeef"})
        if not transport.recv_ack(a):
            errors.append("sender saw mismatch")

    t = threading.Thread(target=sender)
    t.start()
    with pytest.raises(ConnectionError, match="digest mismatch"):
        nodes._recv_keypair(b, pmk)
    t.join(10)
    assert not t.is_alive()
    assert errors == ["sender saw mismatch"]
    a.close()
    b.close()


def test_key_transfer_digest_ok_roundtrip():
    a, b = socket.socketpair()
    pmk = bytes(range(32))
    blob_k, blob_n = b"K" * 9000, b"N" * 500
    t = threading.Thread(target=nodes._send_keypair,
                         args=(a, pmk, blob_k, blob_n), kwargs={"chunk": 4096})
    t.start()
    assert nodes._recv_keypair(b, pmk) == (blob_k, blob_n)
    t.join(10)
    assert not t.is_alive()
    a.close()
    b.close()


def test_submit_job_validates_liveness_and_ip():
    out = nodes.OutputNode("pw")
    with pytest.raises(ValueError, match="Invalid IP"):
        out.submit_job(("127.0.0.1", 1), "AB+",
                       {"A": ("not-an-ip", 5), "B": ("127.0.0.1", 5)})
    with pytest.raises(ValueError, match="not alive"):
        out.submit_job(("127.0.0.1", 1), "AB+",
                       {"A": ("127.0.0.1", 1), "B": ("127.0.0.1", 1)})


def test_keygen_discover_tcp_probe():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    node = nodes.KeygenNode.__new__(nodes.KeygenNode)  # skip keygen
    assert node.discover(["127.0.0.1"], port=srv.getsockname()[1]) == [
        "127.0.0.1"]
    srv.close()


def test_supervisor_bounded_restarts():
    code = supervisor.supervise(
        [sys.executable, "-c", "import sys; sys.exit(3)"],
        max_restarts=2, delay=0.05, backoff=1.0, max_delay=0.1,
    )
    assert code == 3


def test_node_stop_before_start_is_safe():
    nodes.OutputNode("pw").stop()
    nodes.CloudNode("pw", device=CPU).stop()
    nodes.ClientNode(1, "pw", device=CPU).stop()


@pytest.fixture(scope="module")
def tiny_pair():
    return keygen.generate_gate_keypair(P.TEST_TINY)


def _mini_keygen(pair, clients=None):
    node = nodes.KeygenNode(P.TEST_TINY, "pw", pair=pair)
    return node, node.start("127.0.0.1", 0, clients=clients,
                            admit_timeout=5.0)


def _pull_keys(addr, role, password="pw", mod=transport, nodes_mod=nodes):
    s = mod.connect_retry(*addr, retries=20, delay=0.05)
    try:
        pmk, _ = mod.sae_handshake(s, password, role)
        return nodes_mod._recv_keypair(s, pmk)
    finally:
        s.close()


def test_keygen_admission_unknown_role_refused(tiny_pair):
    node, addr = _mini_keygen(tiny_pair, clients=["client-1"])
    _pull_keys(addr, "output")
    with pytest.raises((ConnectionError, OSError)):
        _pull_keys(addr, "client-9")
    assert "client-9" in node.refused and "client-9" not in node.served
    node.stop()


def test_keygen_admission_cloud_never_gets_secret(tiny_pair):
    node, addr = _mini_keygen(tiny_pair, clients=[])
    _pull_keys(addr, "output")
    blob_k, _ = _pull_keys(addr, "cloud")
    _, arrays, _ = files.loads_container(blob_k, expect_kind="cloud_keyset")
    assert "lwe_s" not in arrays and "trlwe_k" not in arrays
    with pytest.raises((ConnectionError, OSError)):
        _pull_keys(addr, "cloud-2")
    node.stop()


def test_keygen_admission_order_output_first(tiny_pair):
    node, addr = _mini_keygen(tiny_pair, clients=["client-1"])
    order = []

    def pull(role):
        _pull_keys(addr, role)
        order.append(role)

    tc = threading.Thread(target=pull, args=("client-1",))
    tcl = threading.Thread(target=pull, args=("cloud",))
    tc.start()
    tcl.start()
    time.sleep(0.5)
    assert order == []
    pull("output")
    tc.join(10)
    tcl.join(10)
    assert not tc.is_alive() and not tcl.is_alive()
    assert set(order) == {"output", "client-1", "cloud"}
    # the order Keygen served them in: a waiting client may finish
    # unpacking its keys before Output's thread records its own return
    # (Keygen records a peer once its digest ack is in: wait for it)
    deadline = time.time() + 10
    while len(node.served) < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert node.served == ["output", "client-1", "cloud"]
    node.stop()


def _py_mul(c, scalar, pt):
    result, addend = dragonfly.O, pt
    while scalar:
        if scalar & 1:
            result = c.add(result, addend)
        addend = c.add(addend, addend)
        scalar >>= 1
    return result


def test_native_ec_matches_python():
    """The port's build of native/src/ec.cc equals the pure-Python
    double-and-add at the scalar edges and at random scalars."""
    c = dragonfly.Curve()
    pe = dragonfly.Peer(mac_address="02:00:00:00:00:01").initiate(
        "02:00:00:00:00:02")
    rng = random.Random(7)
    scalars = [1, 2, 3, dragonfly.Q - 1, dragonfly.Q, dragonfly.Q + 1,
               dragonfly.P - 1] + [rng.randrange(1, dragonfly.P)
                                   for _ in range(10)]
    for pt in (pe, _py_mul(c, 12345, pe)):
        for s in scalars:
            got, want = lib.ec_mul(s, pt.x, pt.y), _py_mul(c, s, pt)
            assert got is None if want is dragonfly.O else \
                got == (want.x, want.y), s
    assert lib.ec_mul(0, pe.x, pe.y) is None


def test_keypair_transfer_at_reference_chunk_size():
    pmk = b"\x07" * 32
    blob_k, blob_n = bytes(range(256)) * 300, b"\xA5" * 10_000
    a, b = socket.socketpair()
    err = []

    def sender():
        try:
            nodes._send_keypair(a, pmk, blob_k, blob_n, chunk=8192)
        except Exception as e:  # pragma: no cover
            err.append(e)

    t = threading.Thread(target=sender)
    t.start()
    got = nodes._recv_keypair(b, pmk)
    t.join(10)
    assert not err and got == (blob_k, blob_n)
    a.close()
    b.close()


def test_sae_handshake_pure_python_fallback(monkeypatch):
    monkeypatch.setenv("IEACHE_NATIVE_EC", "0")
    assert dragonfly._native_ec_mul() is None
    a, b = dragonfly.handshake_pair()
    assert a.pmk == b.pmk and len(a.pmk) == 32


# -- tests/test_transport.py, through the port -----------------------------

def test_send_recv_msg_roundtrip():
    a, b = socket.socketpair()
    transport.send_msg(a, schema.DataFsize, {"data": 987654})
    assert transport.recv_msg(b, schema.DataFsize) == {"data": 987654}
    big = bytes(range(256)) * 40
    transport.send_msg(a, schema.DataContent, {"data": big})
    assert transport.recv_msg(b, schema.DataContent)["data"] == big
    a.close()
    b.close()


def test_blob_transfer_with_nacks():
    a, b = socket.socketpair()
    data = bytes((i * 13) % 256 for i in range(10_000))
    result = {}

    def evil_receiver():
        size = transport.recv_msg(b, schema.DataFsize)["data"]
        transport.send_ack(b, True)
        buf, flip = b"", True
        while len(buf) < size:
            values = transport.recv_msg(b, schema.DataContent)
            if flip:
                transport.send_ack(b, False)
            else:
                buf += values["data"]
                transport.send_ack(b, True)
            flip = not flip
        result["data"] = buf

    t = threading.Thread(target=evil_receiver)
    t.start()
    transport.send_blob(a, data, chunk=1024)
    t.join(10)
    assert result["data"] == data
    a.close()
    b.close()


def _handshake_pair(mod_a, mod_b, pw_a="pw123", pw_b="pw123"):
    """SAE over a socket pair, side a through ``mod_a``, side b through
    ``mod_b``: {side: (PMK, peer mac) or the exception}."""
    a, b = socket.socketpair()
    out = {}

    def side(mod, sock, mac, pw, key):
        try:
            out[key] = mod.sae_handshake(sock, pw, mac)
        except Exception as e:  # noqa: BLE001 - the test reads it
            out[key] = e

    threads = [threading.Thread(target=side, args=(mod_a, a, "02:aa", pw_a,
                                                   "a")),
               threading.Thread(target=side, args=(mod_b, b, "02:bb", pw_b,
                                                   "b"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    a.close()
    b.close()
    return out


def test_sae_over_socket_pair():
    out = _handshake_pair(transport, transport)
    (pmk_a, peer_a), (pmk_b, peer_b) = out["a"], out["b"]
    assert pmk_a == pmk_b
    assert peer_a == "02:bb" and peer_b == "02:aa"


def test_sae_wrong_password_fails():
    out = _handshake_pair(transport, transport, "right", "wrong")
    assert any(isinstance(v, Exception) for v in out.values())


def test_ack_coalesced_with_next_tlv():
    a, b = socket.socketpair()
    ack = ber.encode_message(schema.DataIndicator, {"data": "success"})
    nxt = ber.encode_message(schema.DataFsize, {"data": 4242})
    a.sendall(ack + nxt)
    assert transport.recv_ack(b) is True
    assert transport.recv_msg(b, schema.DataFsize)["data"] == 4242
    nack = ber.encode_message(schema.DataIndicator, {"data": "fail"})
    a.sendall(nack + ack)
    assert transport.recv_ack(b) is False
    assert transport.recv_ack(b) is True
    a.close()
    b.close()


def test_recv_tlv_long_form():
    a, b = socket.socketpair()
    payload = b"z" * 70000
    a.sendall(ber.encode_tlv(ber.TAG_OCTET_STRING, payload))
    tag, content, _ = ber.decode_tlv(transport.recv_tlv(b))
    assert tag == ber.TAG_OCTET_STRING and content == payload
    a.close()
    b.close()


# -- tests/test_error_paths.py, through the port ---------------------------

def test_mul_width_guard_over_sockets():
    with pytest.raises(RuntimeError, match="Cannot multiply 256 bit"):
        sim.run_full_flow("AB*", {"A": [3], "B": [5]}, width=256,
                          params=P.TEST_TINY, device=CPU)


def test_malformed_postfix_over_sockets():
    with pytest.raises(RuntimeError, match="error"):
        sim.run_full_flow("AB++", {"A": [3], "B": [5]}, width=8,
                          params=P.TEST_TINY, device=CPU)


def test_timings_recorder(tmp_path):
    import json

    t = Timings()
    with t.span("compute", op="+"):
        pass
    t.count("bootstraps", 160)
    t.count("bootstraps", 160)
    assert t.counters["bootstraps"] == 320
    assert t.total("compute") >= 0
    path = str(tmp_path / "timings.txt")
    t.dump(path)
    assert json.loads(open(path).read())["counters"]["bootstraps"] == 320
    assert bootstraps_per_sec(100, 2.0) == 50.0


# -- the failure of a job on the Cloud reaches Output and the node ---------

def test_a_fault_of_the_evaluation_fails_the_job_and_is_kept(monkeypatch):
    """A fault inside the Cloud's evaluation (here: IEACHE_PALLAS=1 on
    CPU tensors, where no kernel runs) is not swallowed: Output's
    ``submit_job`` raises with it, and ``CloudNode.failures`` holds it
    for the serve process to exit on."""
    monkeypatch.setenv("IEACHE_PALLAS", "1")
    made = []
    real = nodes.CloudNode

    def keep(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(sim, "CloudNode", keep)
    with pytest.raises(RuntimeError, match="IEACHE_PALLAS=1"):
        sim.run_full_flow("AB+", {"A": [3], "B": [5]}, width=4,
                          params=P.TEST_TINY, device=CPU)
    (cloud,) = made
    assert len(cloud.failures) == 1
    assert "IEACHE_PALLAS=1" in str(cloud.failures[0])


def test_a_job_the_cloud_rejects_is_no_failure_of_the_node(monkeypatch):
    made = []
    real = nodes.CloudNode

    def keep(*args, **kwargs):
        made.append(real(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(sim, "CloudNode", keep)
    with pytest.raises(RuntimeError, match="Cannot multiply 256 bit"):
        sim.run_full_flow("AB*", {"A": [3], "B": [5]}, width=256,
                          params=P.TEST_TINY, device=CPU)
    assert made[0].failures == []


def test_nodes_take_an_explicit_device():
    for make in (lambda **kw: nodes.ClientNode(1, "pw", **kw),
                 lambda **kw: nodes.CloudNode("pw", **kw)):
        with pytest.raises(TypeError):
            make()
        assert make(device="cpu").device == CPU


# -- the host copies pinned to their originals -----------------------------

def test_config_matches_the_original():
    assert dataclasses.asdict(config.NetworkConfig()) == \
        dataclasses.asdict(jconfig.NetworkConfig())
    for base in (0, 5000):
        assert dataclasses.asdict(config.localhost_config(base)) == \
            dataclasses.asdict(jconfig.localhost_config(base))


@pytest.mark.parametrize("n", [0, 1, 16, 17, 70000])
def test_keywrap_bytes_match_the_original(n):
    """Same key, IV and data: the same wrapped bytes; each package
    unwraps the other's."""
    key, iv = bytes(range(32)), bytes(range(16, 32))
    data = bytes((i * 11) % 256 for i in range(n))
    ours = keywrap.encrypt_bytes(key, data, iv)
    assert ours == jkeywrap.encrypt_bytes(key, data, iv)
    assert jkeywrap.decrypt_bytes(key, keywrap.encrypt_bytes(key, data)) \
        == data
    assert keywrap.decrypt_bytes(key, jkeywrap.encrypt_bytes(key, data)) \
        == data


def test_keywrap_files_and_digest_match(tmp_path):
    src = tmp_path / "k.bin"
    src.write_bytes(bytes(range(256)) * 100)
    key = b"\x01" * 32
    wrapped = keywrap.encrypt_file(key, str(src))
    assert wrapped.endswith(keywrap.SUFFIX)
    out = jkeywrap.decrypt_file(key, wrapped, str(tmp_path / "back"))
    assert open(out, "rb").read() == src.read_bytes()
    assert keywrap.file_md5(str(src)) == jkeywrap.file_md5(str(src))


@pytest.mark.parametrize("macs", [("02:aa", "02:bb"), ("cloud", "keygen"),
                                  ("output", "client-3")])
def test_password_element_matches_the_original(macs):
    a, b = macs
    ours = dragonfly.Peer("abc1238", a).initiate(b)
    theirs = jdragonfly.Peer("abc1238", a).initiate(b)
    assert (ours.x, ours.y) == (theirs.x, theirs.y)


@pytest.mark.parametrize("sides", [(transport, jtransport),
                                   (jtransport, transport)],
                         ids=["port-jax", "jax-port"])
def test_sae_across_packages_derives_the_same_pmk(sides):
    """A port peer and a JAX-package peer on one socket pair derive the
    same PMK; a wrong password fails across packages too."""
    out = _handshake_pair(*sides)
    (pmk_a, peer_a), (pmk_b, peer_b) = out["a"], out["b"]
    assert pmk_a == pmk_b and len(pmk_a) == 32
    assert (peer_a, peer_b) == ("02:bb", "02:aa")
    bad = _handshake_pair(*sides, pw_a="right", pw_b="wrong")
    assert any(isinstance(v, Exception) for v in bad.values())


def test_port_builds_its_own_native_library():
    """The port's oracle library is built from the JAX package's sources
    into the port's build directory, never beside those sources."""
    lib.get_lib()
    assert os.path.exists(lib.LIB_PATH)
    assert os.path.commonpath([lib.LIB_PATH, lib.BUILD_DIR]) == lib.BUILD_DIR
    assert os.path.realpath(lib.SRC_DIR) == os.path.realpath(
        os.path.join(os.path.dirname(jlib.__file__), "src"))
    assert "ieache_tpu_torch" in lib.BUILD_DIR.split(os.sep)


def test_native_ec_mul_of_both_libraries_equal():
    pe = dragonfly.Peer(mac_address="m1").initiate("m2")
    rng = random.Random(11)
    for s in [0, 1, 2, dragonfly.Q - 1, dragonfly.Q] + [
            rng.randrange(1, dragonfly.P) for _ in range(8)]:
        assert lib.ec_mul(s, pe.x, pe.y) == jlib.ec_mul(s, pe.x, pe.y), s


def test_oracles_of_both_libraries_equal():
    """oracle_keygen, _encrypt, _decrypt and _bootstrap of the port's
    binding equal the JAX package's, array for array, at TEST_TINY."""
    p, jp = P.TEST_TINY, JP.TEST_TINY
    np.testing.assert_array_equal(lib.params_array(p), jlib.params_array(jp))
    ours = lib.oracle_keygen(p, [1, 2, 3])
    theirs = jlib.oracle_keygen(jp, [1, 2, 3])
    for x, y in zip(ours, theirs):
        np.testing.assert_array_equal(x, y)
    lwe_s, _, bk, ks = ours
    bits = np.array([0, 1, 1, 0, 1], np.int32)
    ct = lib.oracle_encrypt(p, lwe_s, bits, (5, 6))
    np.testing.assert_array_equal(ct, jlib.oracle_encrypt(jp, lwe_s, bits,
                                                          (5, 6)))
    np.testing.assert_array_equal(lib.oracle_decrypt(p, lwe_s, ct), bits)
    np.testing.assert_array_equal(lib.oracle_decrypt(p, lwe_s, ct),
                                  jlib.oracle_decrypt(jp, lwe_s, ct))
    np.testing.assert_array_equal(lib.oracle_bootstrap(p, bk, ks, ct),
                                  jlib.oracle_bootstrap(jp, bk, ks, ct))


@pytest.mark.parametrize("postfix", ["AB+", "AB+C-", "ABC*-", "AB*C-",
                                     "AB-C+", "AB/", "AB+-", "A", "AB+C-D*",
                                     "AB%"])
def test_scheduler_plans_match_the_original(postfix):
    def plan(mod):
        try:
            return mod.plan_postfix(postfix), mod.parse_postfix(postfix)
        except mod.JobError as e:
            return type(e).__name__, str(e)

    assert plan(scheduler) == plan(jscheduler)
    assert scheduler.OPCODES == jscheduler.OPCODES


def test_liveness_probe():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    assert liveness.probe_tcp("127.0.0.1", port)
    assert liveness.host_alive("127.0.0.1", port)
    srv.close()
    assert not liveness.probe_tcp("127.0.0.1", port)


# -- wire: the same operand gives the same bytes in both packages ----------

def _operands(values, width, seed):
    """One operand encrypted by each package on the same stream:
    (port Operand on the CPU, JAX Operand); their words are equal."""
    pair = keygen.generate_gate_keypair(P.TEST_TINY)
    jpair = jkeygen.generate_gate_keypair(JP.TEST_TINY)
    s = prng.key_from_seed_words([seed])
    return (ev.encrypt_operand(pair.main, pair.nbit, values, width, s, CPU),
            jev.encrypt_operand(jpair.main, jpair.nbit, values, width, s))


@pytest.mark.parametrize("value_width", [256, 64, 8])
def test_operand_bytes_match_the_original(value_width):
    """Equal operands give equal bytes, also where the value word is
    narrower than the wire's 8 slots (an answer: padded with copies of
    the carry word); the port reads the JAX package's bytes back to the
    same words."""
    ours, theirs = _operands([5, -3, 7], 8, 0x51)
    if value_width < 256:
        ours = dataclasses.replace(ours, value=ours.value[:, :value_width])
        theirs = dataclasses.replace(theirs,
                                     value=theirs.value[:, :value_width])
    p, jp = P.TEST_TINY, JP.TEST_TINY
    blob = wire.operand_to_bytes(ours, p, p)
    jblob = jwire.operand_to_bytes(theirs, jp, jp)
    assert blob == jblob
    back = wire.operand_from_bytes(jblob, CPU)
    jback = jwire.operand_from_bytes(blob)
    for field in ("neg_word", "bit_word", "value", "carry_word"):
        got = getattr(back, field)
        assert got.device == CPU and got.dtype == torch.int32
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jback, field)))
    np.testing.assert_array_equal(back.value[:, :value_width].numpy(),
                                  np.asarray(theirs.value))


# -- the roles of one package serve the other's ----------------------------

PKG = {"jax": (jnodes, jkeygen, JP), "port": (nodes, keygen, P)}


def _node(pkg, cls, *args, **kwargs):
    mod = PKG[pkg][0]
    if pkg == "port" and cls in ("ClientNode", "CloudNode"):
        kwargs["device"] = CPU
    return getattr(mod, cls)(*args, **kwargs)


def _mixed_flow(keygen_pkg, output_pkg, client_pkg, cloud_pkg, postfix,
                values, width):
    """The sim's six-role flow with each role from the package named:
    Keygen, Output, the clients, the Cloud.  Returns Output's lanes."""
    cfg = config.localhost_config()
    kmod, kkeygen, kparams = PKG[keygen_pkg]
    kg = _node(keygen_pkg, "KeygenNode", kparams.TEST_TINY, "pw",
               pair=kkeygen.generate_gate_keypair(kparams.TEST_TINY),
               cfg=cfg)
    kaddr = kg.start("127.0.0.1", 0)
    out = _node(output_pkg, "OutputNode", "pw", cfg=cfg)
    oaddr = out.start_indicator_server("127.0.0.1", 0)
    letters = sorted(values)
    clients = {}
    for i, letter in enumerate(letters):
        clients[letter] = _node(client_pkg, "ClientNode", i + 1, "pw",
                                cfg=cfg)
        clients[letter].set_value(values[letter], width)
    cloud = _node(cloud_pkg, "CloudNode", "pw", cfg=cfg)
    try:
        out.receive_keys(kaddr)
        for letter in letters:
            clients[letter].receive_keys(kaddr)
        cloud.receive_keys(kaddr)
        kg.notify_finished(oaddr)
        out.wait_finished()
        addrs = {letter: clients[letter].start_data_server("127.0.0.1", 0)
                 for letter in letters}
        return out.submit_job(cloud.start_job_server("127.0.0.1", 0),
                              postfix, addrs)
    finally:
        for node in (*clients.values(), cloud, kg, out):
            node.stop()


@pytest.mark.parametrize("roles", [("jax", "jax", "port", "port"),
                                   ("port", "port", "jax", "jax")],
                         ids=["jax-keygen-output", "port-keygen-output"])
def test_roles_of_one_package_serve_the_other(roles):
    """A JAX Keygen fans keys out to the port's clients and Cloud and a
    JAX Output submits A + B - C to them; and the reverse.  Both decrypt
    to the Python result."""
    values = {"A": [30, -7, 1], "B": [12, 20, 2], "C": [50, 3, -4]}
    got = _mixed_flow(*roles, "AB+C-", values, 8)
    assert got == [a + b - c for a, b, c in
                   zip(values["A"], values["B"], values["C"])]


def _recorded_flow(sim_mod, wire_mod, monkeypatch, **kwargs):
    blobs = []
    real = wire_mod.operand_to_bytes

    def recording(*args):
        blobs.append(real(*args))
        return blobs[-1]

    monkeypatch.setattr(wire_mod, "operand_to_bytes", recording)
    res = sim_mod.run_full_flow(**kwargs)
    monkeypatch.setattr(wire_mod, "operand_to_bytes", real)
    return res.values, blobs


def test_expr_flow_writes_the_same_blobs_in_both_packages(deterministic,
                                                          monkeypatch):
    """Under IEACHE_DETERMINISTIC=1 the same ``A + B - C`` flow in each
    package writes byte-equal operand blobs and a byte-equal answer blob
    (the socket bytes differ by design: SAE secrets and AES IVs)."""
    values = {"A": [30, -7], "B": [12, 20], "C": [50, 3]}
    common = dict(postfix="AB+C-", client_values=values, width=8)
    ours, blobs = _recorded_flow(
        sim, wire, monkeypatch, params=P.TEST_TINY, device=CPU,
        pair=keygen.generate_gate_keypair(P.TEST_TINY), **common)
    theirs, jblobs = _recorded_flow(
        jsim, jwire, monkeypatch, params=JP.TEST_TINY,
        pair=jkeygen.generate_gate_keypair(JP.TEST_TINY), **common)
    assert ours == theirs == [-8, 10]
    assert len(blobs) == len(jblobs) == 4  # three operands, the answer
    assert blobs == jblobs


# -- device work on one lasting thread a node -------------------------------

def test_device_thread_runs_calls_in_turn_on_one_thread():
    worker = nodes._DeviceThread(CPU)
    idents = {worker.run(threading.get_ident) for _ in range(5)}
    assert len(idents) == 1 and threading.get_ident() not in idents
    with pytest.raises(ZeroDivisionError):
        worker.run(lambda: 1 / 0)
    assert worker.run(lambda a, b: a + b, 2, 3) == 5
    (ident,) = idents
    assert ident in {t.ident for t in threading.enumerate()}


def test_flow_runs_device_work_on_the_nodes_lasting_threads(monkeypatch):
    """Every client's encryption and the Cloud's job run on the node's
    device thread, which outlives the flow (a listener thread that ran
    torch code and ended as the process exits could abort the exit)."""
    where = {"encrypt": [], "job": []}
    encrypt, run_job = nodes.ClientNode.encrypt_operand, \
        nodes.CloudNode.run_job

    def encrypt_here(self):
        where["encrypt"].append(threading.get_ident())
        return encrypt(self)

    def job_here(self, postfix):
        where["job"].append(threading.get_ident())
        return run_job(self, postfix)

    monkeypatch.setattr(nodes.ClientNode, "encrypt_operand", encrypt_here)
    monkeypatch.setattr(nodes.CloudNode, "run_job", job_here)
    res = sim.run_full_flow("AB+C-", {"A": [3], "B": [4], "C": [5]}, width=4,
                            params=P.TEST_TINY, device=CPU)
    assert res.values == [2]
    alive = {t.ident for t in threading.enumerate()}
    assert len(set(where["encrypt"])) == 3 and len(where["job"]) == 1
    assert set(where["encrypt"]) | set(where["job"]) <= alive
    assert threading.get_ident() not in set(where["encrypt"] + where["job"])
