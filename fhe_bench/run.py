"""Run one cell of the benchmark on the card and print its result line.

    python3 -m fhe_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the CUDA devices the
cell asks for; without them it exits nonzero and prints no result.  Once
the window has closed, the card's name, power limit and SM clock, the
seconds of set-up's parts and each job's seconds go to standard error;
the numbers the check compared, each beside its limit, are its last
lines, and the last key of the result, which is the last line of
standard output.  The run exits nonzero, with no result, if it
holds JAX or the JAX package once the window has closed.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def card_line() -> str:
    """The card's name, power limit and SM clock (now and its maximum),
    as nvidia-smi reads them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not readable: {e}"
    return proc.stdout.strip().splitlines()[0]


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m fhe_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from fhe_bench import harness

    bench = harness.Bench(harness.ROOT)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fhe_bench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f"; the benchmark does not fall back to the CPU",
              file=sys.stderr)
        return 2
    line, record = harness.run(bench, args.workload, args.seed,
                               args.seconds, bool(args.trace),
                               torch.device("cuda", 0), _STARTED)
    print(f"card: {card_line()}", file=sys.stderr)
    print("phases (s): " + " ".join(
        f"{k} {v:.3f}" for k, v in record["phases"].items()), file=sys.stderr)
    print("job seconds: " + " ".join(
        f"{j['seconds']:.4f}" if "seconds" in j else "failed"
        for j in record["jobs"]), file=sys.stderr)
    held = harness.forbidden_modules(sys.modules)
    if held:
        print(f"fhe_bench: the run holds {', '.join(held)}", file=sys.stderr)
        return 3
    for key, check in line["checks"].items():
        print(f"check {key} {check['value']} limit {check['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
