"""The port's CLI (``python -m ieache_tpu_torch.cli.main``) against the
JAX package's.

Each test of ``tests/test_cli.py`` has its counterpart here through the
port's CLI with ``--device cpu``; ``cli/convert.py`` and
``cli/fixtures.py`` are pinned to their originals; files written by one
CLI are read by the other (keys by the JAX CLI, operands, answers and
their decryption by the port's, and the reverse); and without a CUDA
device the subcommands that do ciphertext work exit nonzero unless
``--device cpu`` is given.
"""

import os
import subprocess
import sys

import pytest
import torch

from ieache_tpu.cli import convert as jconvert
from ieache_tpu.cli import fixtures as jfixtures
from ieache_tpu.cli import main as jmain
from ieache_tpu_torch.cli import convert, fixtures
from ieache_tpu_torch.cli import main as tmain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the tier-1 run shares the CPU between several
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                **extra)


def _port_cli(*args, cwd, input=None, timeout=300, **env):
    return subprocess.run(
        [sys.executable, "-m", "ieache_tpu_torch.cli.main", *args],
        cwd=cwd, env=_env(**env), input=input, capture_output=True, text=True,
        timeout=timeout,
    )


# -- tests/test_cli.py, through the port -----------------------------------

def test_infix_to_postfix():
    assert convert.to_postfix("A + B") == "AB+"
    assert convert.to_postfix("A + B - C") == "AB+C-"
    assert convert.to_postfix("A * B * C") == "AB*C*"
    assert convert.to_postfix("A + B * C") == "ABC*+"
    assert convert.to_postfix("(A + B) * C") == "AB+C*"
    assert convert.to_postfix("A - B - C") == "AB-C-"


def test_validation_filters():
    with pytest.raises(convert.ExpressionError):
        convert.validate(convert.to_postfix("A + B * C"))
    with pytest.raises(convert.ExpressionError):
        convert.validate(convert.to_postfix("A * B * C"))
    with pytest.raises(convert.ExpressionError):
        convert.validate("A")
    with pytest.raises(convert.ExpressionError):
        convert.validate("AB+CD+E+"[:-1] + "+")
    assert convert.validate("AB+C-") == (["A", "B", "C"], ["+", "-"])


def test_validate_ipv4():
    assert convert.validate_ipv4("192.168.0.21")
    assert not convert.validate_ipv4("192.168.0")
    assert not convert.validate_ipv4("192.168.0.256")
    assert not convert.validate_ipv4("a.b.c.d")
    assert not convert.validate_ipv4("01.2.3.4")


def test_values_txt_roundtrip(tmp_path):
    path = str(tmp_path / "values.txt")
    for width in (32, 64, 128, 256):
        for v in (fixtures.canned_value(width),
                  fixtures.canned_value(width, True), 7, -12345):
            fixtures.write_values_txt(path, v, width)
            assert fixtures.read_values_txt(path) == (v, width)
    fixtures.write_values_txt(path, fixtures.canned_value(32), 32)
    lines = open(path).read().splitlines()
    assert lines[0] == "0" * 32
    assert lines[1] == "00000000000000000000000000100000"
    assert lines[2] == "01000000000000000000000000000000"
    assert lines[3] == "0" * 32


def test_cli_end_to_end(tmp_path):
    """keygen -> fixtures -> encrypt x2 -> cloud -> verify -> reset,
    tiny params, the ciphertext work on the CPU."""
    d = str(tmp_path)

    def run(*args):
        r = _port_cli(*args, cwd=d)
        assert r.returncode == 0, r.stdout + r.stderr
        return r.stdout

    run("keygen", "--params", "test_tiny", "--out", d)
    run("fixtures", "--width", "32", "--value", "1000",
        "--out", os.path.join(d, "a.txt"))
    run("fixtures", "--width", "32", "--value", "-234",
        "--out", os.path.join(d, "b.txt"))
    for name in ("a", "b"):
        run("encrypt", "--keys", d, "--values", os.path.join(d, f"{name}.txt"),
            "--out", os.path.join(d, f"{name}.data"), "--device", "cpu")
    run("cloud", os.path.join(d, "a.data"), os.path.join(d, "b.data"),
        "--keys", d, "--op", "1", "--out", os.path.join(d, "answer.data"),
        "--device", "cpu")
    assert "Answer: 766" in run("verify", "--keys", d, "--answer",
                                os.path.join(d, "answer.data"), "--op", "1")
    run("reset", "--dir", d)
    assert not os.path.exists(os.path.join(d, "answer.data"))


def test_cli_interactive_sim(tmp_path):
    r = _port_cli("interactive", "--params", "test_tiny", "--width", "8",
                  "--device", "cpu", cwd=str(tmp_path),
                  input="A\nA + B - C\n30\n12\n50\n")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Hello!" in r.stdout
    assert "at least 2 letters" in r.stdout
    assert "Postfix Expression: AB+C-" in r.stdout
    assert "Answer: -8" in r.stdout


def test_cli_interactive_rejects_mixed_ops(tmp_path):
    r = _port_cli("interactive", "--params", "test_tiny", "--device", "cpu",
                  cwd=str(tmp_path), input="A + B * C\n", timeout=120)
    assert r.returncode == 1
    assert ("addition and multiplication operation cannot be "
            "processed") in r.stdout


# -- the copies pinned to their originals ----------------------------------

@pytest.mark.parametrize("expr", ["A + B", "A + B - C", "A * B * C",
                                  "(A + B) * C", "A - B * C", "A / B",
                                  "A ^ B", "(A + B", "A + B)", "A $ B"])
def test_convert_matches_the_original(expr):
    def outcome(mod):
        try:
            postfix = mod.to_postfix(expr)
        except mod.ExpressionError as e:
            return "to_postfix", str(e)
        try:
            return postfix, mod.validate(postfix)
        except mod.ExpressionError as e:
            return postfix, str(e)

    assert outcome(convert) == outcome(jconvert)


@pytest.mark.parametrize("width", [32, 64, 128, 256])
def test_values_txt_bytes_match_the_original(tmp_path, width):
    for i, v in enumerate((fixtures.canned_value(width),
                           fixtures.canned_value(width, True), 0, -77)):
        ours, theirs = tmp_path / f"o{i}.txt", tmp_path / f"j{i}.txt"
        fixtures.write_values_txt(str(ours), v, width)
        jfixtures.write_values_txt(str(theirs), v, width)
        assert ours.read_bytes() == theirs.read_bytes()
        assert jfixtures.read_values_txt(str(ours)) == (v, width)


def test_parsers_have_the_original_subcommands_and_flags():
    """The port's parser has every subcommand and flag of the JAX CLI,
    and adds --device to those with ciphertext work."""
    def flags(parser):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {name: {opt for a in p._actions for opt in a.option_strings}
                for name, p in sub.choices.items()}

    ours, theirs = flags(tmain.build_parser()), flags(jmain.build_parser())
    assert set(ours) == set(theirs)
    for cmd in theirs:
        added = ours[cmd] - theirs[cmd]
        assert theirs[cmd] <= ours[cmd], cmd
        with_device = cmd in ("encrypt", "cloud", "expr", "interactive",
                              "serve")
        assert added == ({"--device"} if with_device else set()), cmd


# -- files written by one CLI, read by the other ---------------------------

def _in_process(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cli_files_cross_packages(tmp_path, monkeypatch, capsys, writer):
    """writer "jax": the JAX CLI writes the keys; the port's CLI
    encrypts, evaluates and verifies.  writer "port": the port's CLI
    writes the keys; the JAX CLI does the rest.  A - B reads 1234."""
    monkeypatch.chdir(tmp_path)
    d = str(tmp_path)
    first, second = (jmain.main, tmain.main) if writer == "jax" else \
        (tmain.main, jmain.main)
    dev = ["--device", "cpu"] if second is tmain.main else []
    _in_process(first, ["keygen", "--params", "test_tiny", "--out", d],
                capsys)
    for name, value in (("a", 1000), ("b", -234)):
        txt = os.path.join(d, f"{name}.txt")
        _in_process(second, ["fixtures", "--width", "32", "--value",
                             str(value), "--out", txt], capsys)
        _in_process(second, ["encrypt", "--keys", d, "--values", txt,
                             "--out", os.path.join(d, f"{name}.data"),
                             *dev], capsys)
    answer = os.path.join(d, "answer.data")
    _in_process(second, ["cloud", os.path.join(d, "a.data"),
                         os.path.join(d, "b.data"), "--keys", d, "--op", "2",
                         "--out", answer, *dev], capsys)
    # and the first package's verify reads the second's answer
    for main in (second, first):
        out = _in_process(main, ["verify", "--keys", d, "--answer", answer,
                                 "--op", "2"], capsys)
        assert "Answer: 1234" in out


def test_cli_operand_and_answer_files_byte_equal(tmp_path, monkeypatch,
                                                 capsys):
    """Under IEACHE_DETERMINISTIC=1 with one --seed, the two CLIs write
    byte-equal operand files and byte-equal answer files."""
    monkeypatch.setenv("IEACHE_DETERMINISTIC", "1")
    monkeypatch.chdir(tmp_path)
    d = str(tmp_path)
    _in_process(jmain.main, ["keygen", "--params", "test_tiny", "--out", d],
                capsys)
    txt = os.path.join(d, "v.txt")
    fixtures.write_values_txt(txt, -99, 32)
    written = {}
    for tag, main, dev in (("jax", jmain.main, []),
                           ("port", tmain.main, ["--device", "cpu"])):
        op = os.path.join(d, f"{tag}.data")
        ans = os.path.join(d, f"{tag}_answer.data")
        _in_process(main, ["encrypt", "--keys", d, "--values", txt,
                           "--out", op, "--seed", "5", *dev], capsys)
        _in_process(main, ["cloud", op, op, "--keys", d, "--op", "4",
                           "--out", ans, *dev], capsys)
        written[tag] = [open(op, "rb").read(), open(ans, "rb").read()]
    assert written["port"] == written["jax"]


# -- no card: the ciphertext work refuses to fall back ---------------------

@pytest.mark.parametrize("argv", [
    ["expr", "A + B", "1", "2", "--params", "test_tiny", "--width", "8"],
    ["encrypt"], ["cloud", "a.data", "b.data"], ["interactive"],
    ["serve", "--role", "cloud"], ["serve", "--role", "client"],
])
def test_cuda_device_without_a_card_exits_nonzero(argv, monkeypatch,
                                                  tmp_path):
    """--device cuda (the default) with no CUDA device: SystemExit with
    a message naming --device cpu, before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit) as e:
            tmain.main(argv + extra)
        assert "--device cpu" in str(e.value.code)
    assert os.listdir(tmp_path) == []


def test_cuda_device_without_a_card_exits_nonzero_as_a_process(tmp_path):
    r = _port_cli("expr", "A + B - C", "30", "12", "50", "--params",
                  "test_tiny", "--width", "8", "--device", "cuda",
                  cwd=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "Answer" not in r.stdout
    r = _port_cli("expr", "A + B - C", "30", "12", "50", "--params",
                  "test_tiny", "--width", "8", "--device", "cpu",
                  cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "Answer: -8" in r.stdout
