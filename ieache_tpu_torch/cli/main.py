"""`ieache` command-line interface of the port.

The port's counterpart of :mod:`ieache_tpu.cli.main`, with the same
subcommands and flags.  One CLI replacing the reference's per-node
binaries and scripts:

    keygen    — generate + export keysets      (C1, Keygen/keygen.c)
    fixtures  — write values.txt               (C2, Client*/process.c)
    encrypt   — values.txt -> cloud.data       (C3, Client*/alice.c)
    cloud     — evaluate one op on 2 operands  (C10, Cloud/cloud.c)
    verify    — decrypt answer.data            (C11, Output/verif.c)
    expr      — full in-process expression run (C22, output_dynamic.py)
    reset     — delete run artifacts           (C25, */reset.py)

Run `python -m ieache_tpu_torch.cli.main <command> --help` for options.

The subcommands that do ciphertext work (``encrypt``, ``cloud``,
``expr``, ``interactive``, and ``serve`` for the client and cloud
roles) take ``--device`` (default ``cuda``): with no CUDA device they
exit nonzero unless ``--device cpu`` is given, and never fall back to
the CPU.  Key generation (``keygen``, the keygen role, from
``--keycache`` where given) and Output's decryption (``verify``) are
host work.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: artifacts deleted by `reset` (the union of the three reset.py lists:
#: Keygen/reset.py, Cloud/reset.py, Output/reset.py)
RESET_PATTERNS = [
    "secret.key", "cloud.key", "nbit.key", "values.txt", "cloud.data",
    "answer.data", "operator.txt", "timings.txt", "averagestandard.txt",
    "dragonfly.log",
]


def _device(name: str):
    """The torch device ``--device`` names; exits when it is a CUDA
    device and there is none."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: no CUDA device; the ciphertext work runs "
            f"on the card and does not fall back to the CPU (pass "
            f"--device cpu to run it there)"
        )
    return device


def _params(name: str):
    from ieache_tpu_torch import params as P

    table = {
        "ieache_110": P.IEACHE_110,
        "ieache_110_l2": P.IEACHE_110_FAST,  # the bench gadget (l=2)
        "tfhe_compat": P.IEACHE_110_TFHE_COMPAT,
        "test_tiny": P.TEST_TINY,
        "test_small_noisy": P.TEST_SMALL_NOISY,
    }
    if name not in table:
        raise SystemExit(
            f"unknown --params {name!r}; one of {sorted(table)}"
        )
    return table[name]


def cmd_keygen(args):
    from ieache_tpu_torch.codec import files
    from ieache_tpu_torch.lwe import keygen

    p = _params(args.params)
    t0 = time.time()
    pair = keygen.generate_gate_keypair(p)
    dt = time.time() - t0
    os.makedirs(args.out, exist_ok=True)
    files.save_secret_keyset(os.path.join(args.out, "secret.key"),
                             pair.main)
    files.save_cloud_keyset(os.path.join(args.out, "cloud.key"),
                            pair.main.cloud)
    files.save_secret_keyset(os.path.join(args.out, "nbit.key"),
                             pair.nbit)
    # keygen.c:53-56 prints its wall clock
    print(f"Computation Time: {dt:f}[sec]")
    print(f"wrote secret.key, cloud.key, nbit.key to {args.out}")


def cmd_fixtures(args):
    from ieache_tpu_torch.cli import fixtures

    value = args.value
    if value is None:
        value = fixtures.canned_value(args.width, args.negative)
    fixtures.write_values_txt(args.out, value, args.width)
    print(f"Wrote a binary value of {value} to {args.out}")


def cmd_encrypt(args):
    from ieache_tpu_torch.circuits import evaluator as ev
    from ieache_tpu_torch.cli import fixtures
    from ieache_tpu_torch.codec import files
    from ieache_tpu_torch.mp import wire
    from ieache_tpu_torch.utils import prng

    device = _device(args.device)
    t0 = time.time()
    main_ks = files.load_secret_keyset(
        os.path.join(args.keys, "secret.key")
    )
    nbit_ks = files.load_secret_keyset(
        os.path.join(args.keys, "nbit.key")
    )
    value, width = fixtures.read_values_txt(args.values)
    if getattr(args, "seed", None) is not None:
        stream = prng.key_from_seed_words([0xA11CE, args.seed])
    else:
        stream = prng.fresh_stream(0xA11CE)
    operand = ev.encrypt_operand(
        main_ks, nbit_ks, [value], width, stream, device
    )
    blob = wire.operand_to_bytes(operand, main_ks.params, nbit_ks.params)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"Computation Time: {time.time() - t0:f}[sec]")
    print(f"wrote {args.out} ({len(blob)} bytes)")


def cmd_cloud(args):
    from ieache_tpu_torch.boot.bootstrap import pack_cloud_key
    from ieache_tpu_torch.circuits import evaluator as ev
    from ieache_tpu_torch.codec import files
    from ieache_tpu_torch.mp import wire
    from ieache_tpu_torch.utils.trace import sync

    device = _device(args.device)
    cloud_ks = files.load_cloud_keyset(
        os.path.join(args.keys, "cloud.key")
    )
    nbit_ks = files.load_secret_keyset(
        os.path.join(args.keys, "nbit.key")
    )
    with open(args.operand_a, "rb") as f:
        a = wire.operand_from_bytes(f.read(), device)
    with open(args.operand_b, "rb") as f:
        b = wire.operand_from_bytes(f.read(), device)

    # operator.txt carries the opcode (cloud.c:770-773)
    if args.operator_file:
        with open(args.operator_file) as f:
            op = int(f.read().strip())
    else:
        op = args.op

    evaluator = ev.CloudEvaluator(
        pack_cloud_key(cloud_ks, device), nbit_ks, adder=args.adder
    )
    t0 = time.time()
    try:
        answer, info = evaluator.compute(op, a, b)
    except ev.MulWidthError as e:
        print(str(e))
        sys.exit(126)  # cloud.c:860-864
    sync(device)
    dt = time.time() - t0
    print(f"Computation Time: {dt:f}[sec]")
    with open("averagestandard.txt", "a") as f:  # cloud.c:17,2467-2471
        f.write(f"{dt:f}\n")
    blob = wire.operand_to_bytes(answer, cloud_ks.params, nbit_ks.params)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out}: {json.dumps(info)}")


def cmd_verify(args):
    from ieache_tpu_torch.circuits import evaluator as ev
    from ieache_tpu_torch.codec import files
    from ieache_tpu_torch.mp import wire

    t0 = time.time()
    main_ks = files.load_secret_keyset(
        os.path.join(args.keys, "secret.key")
    )
    nbit_ks = files.load_secret_keyset(
        os.path.join(args.keys, "nbit.key")
    )
    with open(args.answer, "rb") as f:
        answer = wire.operand_from_bytes(f.read(), "cpu")
    if args.operator_file and os.path.exists(args.operator_file):
        with open(args.operator_file) as f:
            op = int(f.read().strip())
    else:
        op = args.op
    values = ev.decrypt_answer(main_ks, nbit_ks, answer, op)
    print(f"Computation Time: {time.time() - t0:f}[sec]")
    for v in values:
        print(f"Answer: {v}")


def cmd_interactive(args):
    """The reference Output CLI's interactive prompt loop
    (`output_dynamic.py:1055-1245`): expression prompt, postfix echo,
    the two fatal expression filters, per-operand IPv4+liveness entry
    with re-prompt, and the "Answer Bit Size is too large" answer-size
    message.  With --sim (default) the six-role topology runs
    in-process and per-operand VALUES are prompted instead of IPs;
    --live submits to running `serve` roles at the prompted addresses.
    """
    from ieache_tpu_torch.cli import convert
    from ieache_tpu_torch.mp import liveness

    # --live submits to running roles: this process only decrypts
    device = None if args.live else _device(args.device)
    print("Hello!")
    while True:
        expr = input(
            "Enter an expression using letters (A, B, C) for clients "
            "and symbols ( +, -, *) for operators. [E.g. A + B - C]: "
        )
        try:
            postfix = convert.to_postfix(expr)
        except convert.ExpressionError as e:
            print(e)
            continue
        print("Postfix Expression:", postfix)
        try:
            letters, ops = convert.validate(postfix)
        except convert.ExpressionError as e:
            print(e)
            # the reference EXITS on the two operator filters
            # (output_dynamic.py:1080-1085) and re-prompts otherwise
            msg = str(e)
            if "cannot be processed" in msg:
                sys.exit(1)
            continue
        break
    if "/" in ops:
        print("note: '/' maps to multiplication (division is "
              "unimplemented, as in the reference)")

    if args.live:
        from ieache_tpu_torch.mp import nodes

        client_addrs = {}
        for letter in letters:
            while True:
                raw = input(
                    f"Enter the IPv4 Address for {letter}: "
                ).strip()
                host, _, port = raw.partition(":")
                if (convert.validate_ipv4(host)
                        and liveness.host_alive(
                            host, int(port) if port else None)):
                    client_addrs[letter] = (
                        host, int(port or 4381)
                    )
                    break
                print("\nPlease enter a valid and working IPv4 "
                      "Address")
        cloud_raw = input("Enter the Cloud address [host:port]: ")
        chost, _, cport = cloud_raw.partition(":")
        out = nodes.OutputNode(args.password)
        out.receive_keys(_addr_arg(args.keygen_addr, 4380))
        try:
            values = out.submit_job(
                (chost, int(cport or 4381)), postfix, client_addrs
            )
        except (ConnectionError, RuntimeError, ValueError) as e:
            # undersized answer == computation failure
            # (output_dynamic.py:1018-1019)
            print("Answer Bit Size is too large" if "answer" in
                  str(e).lower() else f"job failed: {e}")
            sys.exit(1)
        for v in values:
            print("Answer:", v)
        return

    from ieache_tpu_torch.mp import sim

    values = {}
    for letter in letters:
        while True:
            raw = input(f"Enter the integer value for {letter}: ")
            try:
                values[letter] = [int(raw)]
                break
            except ValueError:
                print("Please enter an integer")
    res = sim.run_full_flow(
        postfix, values, width=args.width,
        params=_params(args.params), device=device,
    )
    for v in res.values:
        print("Answer:", v)


def _addr_arg(s: str, default_port: int):
    host, _, port = s.partition(":")
    return (host, int(port or default_port))


def cmd_expr(args):
    from ieache_tpu_torch.cli import convert
    from ieache_tpu_torch.mp import sim

    device = _device(args.device)
    postfix = convert.to_postfix(args.expression)
    letters, ops = convert.validate(postfix)
    if "/" in ops:
        print("note: '/' maps to multiplication (division is "
              "unimplemented, as in the reference)")
    values = {}
    for letter, v in zip(letters, args.values):
        # comma-separated lists evaluate a whole batch of expressions
        # in one run (e.g. `expr "A + B" 1,2,3 10,20,30`)
        values[letter] = [int(x) for x in str(v).split(",")]
    if len(values) != len(letters):
        print(f"need {len(letters)} values for {letters}")
        sys.exit(1)
    lens = {len(v) for v in values.values()}
    if len(lens) != 1:
        print("all operands need the same number of batch values")
        sys.exit(1)
    from ieache_tpu_torch.utils import trace

    tim = trace.Timings()
    with tim.span("expr", expression=args.expression):
        res = sim.run_full_flow(
            postfix, values, width=args.width,
            params=_params(args.params), adder=args.adder,
            device=device,
        )
    tim.count("bootstraps", res.gate_count)
    tim.spans.extend(
        {"name": f"compute:{t['op']}", **t} for t in res.timings
    )
    print(f"Postfix Expression: {postfix}")
    for v in res.values:
        print(f"Answer: {v}")
    print(f"Total Time: {tim.total('expr'):.3f}s  "
          f"(bootstrapped gates: {res.gate_count})")
    tim.dump("timings.txt")  # output_dynamic.py:736-743


def cmd_reset(args):
    removed = []
    for name in RESET_PATTERNS:
        path = os.path.join(args.dir, name)
        if os.path.exists(path):
            os.remove(path)
            removed.append(name)
    for name in os.listdir(args.dir):
        if name.endswith(".hacklab"):
            os.remove(os.path.join(args.dir, name))
            removed.append(name)
    print(f"removed: {removed or 'nothing'}")


def cmd_serve(args):
    """Long-lived role server for multi-host deployments (the
    systemd/MP.service path; loopback testing uses mp.sim)."""
    import time as _t

    from ieache_tpu_torch.cli import fixtures
    from ieache_tpu_torch.mp import nodes
    from ieache_tpu_torch.mp.config import NetworkConfig
    from ieache_tpu_torch.utils import log as ulog

    # the roles with ciphertext work check their device before anything
    device = None if args.role == "keygen" else _device(args.device)
    ulog.setup("ieache", logfile=args.logfile)
    # long-lived servers retry connects for ~60 s: peer processes may
    # still be importing torch / generating keys when this role starts
    cfg = NetworkConfig(password=args.password, connect_retries=300)

    def addr(s, default_port):
        host, _, port = s.partition(":")
        return (host, int(port or default_port))

    port = args.port or (4380 if args.plane == "key" else 4381)
    if args.role == "keygen":
        pair = None
        if args.keycache:
            from ieache_tpu_torch.codec import files

            pair = files.cached_gate_keypair(args.keycache,
                                             _params(args.params))
        node = nodes.KeygenNode(_params(args.params), cfg=cfg,
                                pair=pair)
        # bind first (generous admission wait: peer processes may
        # still be importing torch when the first connections land),
        # THEN discover — the liveness probes may target services
        # that only answer once this server is up
        node.start(args.bind, port, admit_timeout=300.0,
                   defer_clients=bool(args.clients))
        if args.clients:
            # ping-discovery gates admission: exactly the discovered
            # clients get the secret keyset
            # (dragonfly_private_keygen.py:685-689,704-728)
            hosts = args.clients.split(",")
            up = node.discover(hosts, port=args.discover_port or None)
            print(f"hostup: {len(up)}/{len(hosts)}", flush=True)
            node.set_admitted_clients(
                [f"client-{i + 1}" for i in range(len(up))]
            )
        print(f"keygen serving on {args.bind}:{port}", flush=True)
        while len(node.served) < args.expect_peers:
            _t.sleep(0.5)
        node.notify_finished(addr(args.output_addr, 4380))
        print("finished signal sent; continuing to serve", flush=True)
        while True:
            _t.sleep(3600)
    elif args.role == "client":
        node = nodes.ClientNode(args.index, cfg=cfg, device=device)
        node.receive_keys(addr(args.keygen_addr, 4380))
        if args.values:
            values = [int(v) for v in args.values.split(",")]
        else:
            values = [args.value if args.value is not None
                      else fixtures.canned_value(args.width)]
        node.set_value(values, args.width)
        node.start_data_server(args.bind, port)
        print(f"client-{args.index} serving on {args.bind}:{port}",
              flush=True)
        while True:
            _t.sleep(3600)
    else:  # cloud
        node = nodes.CloudNode(cfg=cfg, adder=args.adder, device=device)
        node.receive_keys(addr(args.keygen_addr, 4380))
        node.start_job_server(args.bind, port)
        print(f"cloud serving on {args.bind}:{port} ({device})", flush=True)
        seen = 0
        while not node.failures:
            _t.sleep(0.5)
            if args.print_spans:
                spans = node.trace.spans
                while seen < len(spans):
                    print("SPAN " + json.dumps(spans[seen]), flush=True)
                    seen += 1
        # a job failed on the device (Output got its error): the role
        # stops rather than serve from a device in an unknown state
        raise SystemExit(f"cloud: a job failed on {device}: "
                         f"{node.failures[0]!r}")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="ieache",
        description="IE-ACHE on PyTorch + CUDA: homomorphic integer "
                    "expressions over TFHE gate bootstrapping",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("keygen", help="generate + export keysets (C1)")
    p.add_argument("--params", default="ieache_110")
    p.add_argument("--out", default=".")
    p.set_defaults(fn=cmd_keygen)

    p = sub.add_parser("fixtures", help="write values.txt (C2)")
    p.add_argument("--width", type=int, default=32,
                   choices=[32, 64, 128, 256])
    p.add_argument("--negative", action="store_true")
    p.add_argument("--value", type=int, default=None,
                   help="override the canned 2^(width-2) fixture")
    p.add_argument("--out", default="values.txt")
    p.set_defaults(fn=cmd_fixtures)

    p = sub.add_parser("encrypt", help="values.txt -> cloud.data (C3)")
    p.add_argument("--keys", default=".")
    p.add_argument("--values", default="values.txt")
    p.add_argument("--out", default="cloud.data")
    p.add_argument("--seed", type=int, default=None,
                   help="deterministic encryption stream (repro only; "
                        "default draws from os.urandom)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the ciphertext work (cuda, cpu); no fallback")
    p.set_defaults(fn=cmd_encrypt)

    p = sub.add_parser("cloud", help="evaluate one op (C10)")
    p.add_argument("operand_a")
    p.add_argument("operand_b")
    p.add_argument("--keys", default=".")
    p.add_argument("--op", type=int, default=1,
                   help="1=add 2=sub 4=mul, 3 accepted as mul (operator.txt codes)")
    p.add_argument("--operator-file", default=None)
    p.add_argument("--adder", default="ripple",
                   choices=["ripple", "kogge_stone"])
    p.add_argument("--out", default="answer.data")
    p.add_argument("--device", default="cuda",
                   help="torch device of the ciphertext work (cuda, cpu); no fallback")
    p.set_defaults(fn=cmd_cloud)

    p = sub.add_parser("verify", help="decrypt answer.data (C11)")
    p.add_argument("--keys", default=".")
    p.add_argument("--answer", default="answer.data")
    p.add_argument("--op", type=int, default=1)
    p.add_argument("--operator-file", default="operator.txt")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser(
        "expr", help="full in-process expression run (C22)"
    )
    p.add_argument("expression", help='e.g. "A + B - C"')
    p.add_argument("values", nargs="+", help="one integer per operand")
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--params", default="ieache_110")
    p.add_argument("--adder", default="ripple",
                   choices=["ripple", "kogge_stone"])
    p.add_argument("--device", default="cuda",
                   help="torch device of the ciphertext work (cuda, cpu); no fallback")
    p.set_defaults(fn=cmd_expr)

    p = sub.add_parser(
        "interactive",
        help="reference-style interactive prompt loop "
             "(output_dynamic.py:1055-1245)",
    )
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--params", default="ieache_110")
    p.add_argument("--live", action="store_true",
                   help="submit to running `serve` roles (prompts for "
                        "per-operand addresses) instead of the "
                        "in-process sim")
    p.add_argument("--password", default="abc1238")
    p.add_argument("--keygen-addr", default="192.168.0.3:4380")
    p.add_argument("--device", default="cuda",
                   help="torch device of the ciphertext work (cuda, cpu); no fallback")
    p.set_defaults(fn=cmd_interactive)

    p = sub.add_parser("reset", help="delete run artifacts (C25)")
    p.add_argument("--dir", default=".")
    p.set_defaults(fn=cmd_reset)

    p = sub.add_parser(
        "serve",
        help="run one protocol role as a long-lived server (C15-C21)",
    )
    p.add_argument("--role", required=True,
                   choices=["keygen", "client", "cloud"])
    p.add_argument("--plane", default="data", choices=["key", "data"])
    p.add_argument("--params", default="ieache_110")
    p.add_argument("--password", default="abc1238")
    p.add_argument("--bind", default="0.0.0.0")
    p.add_argument("--port", type=int, default=0,
                   help="0 = role default (4380 key / 4381 data)")
    p.add_argument("--keygen-addr", default="192.168.0.3:4380")
    p.add_argument("--output-addr", default="192.168.0.4:4380")
    p.add_argument("--index", type=int, default=1,
                   help="client index (1-3)")
    p.add_argument("--value", type=int, default=None)
    p.add_argument("--values", default="",
                   help="client: comma-separated batch of values "
                        "(one expression lane each; overrides --value)")
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--keycache", default="",
                   help="keygen: directory of cached .iek keysets — "
                        "the reference's keygen-once optimized mode "
                        "(AC058.pdf Fig.9, keygen_dynamic.py:695); "
                        "generated + saved there when absent")
    p.add_argument("--print-spans", action="store_true",
                   help="cloud: emit 'SPAN {json}' lines for each "
                        "trace span (the timings.txt hook for "
                        "harness-side collection)")
    p.add_argument("--adder", default="ripple",
                   choices=["ripple", "kogge_stone"],
                   help="cloud: adder circuit — kogge_stone halves "
                        "small-batch expression latency (r5), ripple "
                        "minimizes bootstraps for batched throughput")
    p.add_argument("--expect-peers", type=int, default=4,
                   help="keygen: peers to serve before 'finished'")
    p.add_argument("--clients", default="",
                   help="keygen: comma-separated client hosts to "
                        "ping-discover before admission")
    p.add_argument("--discover-port", type=int, default=0,
                   help="TCP port probed during discovery (0 = ICMP)")
    p.add_argument("--logfile", default="dragonfly.log",
                   help="log file (console is always on)")
    p.add_argument("--device", default="cuda",
                   help="client and cloud roles: torch device of their "
                        "ciphertext work (cuda, cpu); no fallback; the "
                        "keygen role works on the host")
    p.set_defaults(fn=cmd_serve)

    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
