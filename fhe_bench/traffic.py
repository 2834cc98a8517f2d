"""The one generator of the benchmark's traffic.

A mix is a JSON file of parameters in ``traffic/``:

* ``entry``: what a job drives: ``evaluator`` (the Cloud's evaluator on
  operands resident on the card, ``CloudEvaluator.compute_steps``) or
  ``protocol`` (the in-process roles on loopback sockets, a job through
  ``OutputNode.submit_job``);
* ``postfix``: the expression; ``lanes``: lanes per job; ``width``: the
  operands' bits;
* ``magnitude_bits``, ``negative_share``: each operand lane's magnitude
  is drawn uniformly below ``2**magnitude_bits`` and is negative with
  that probability;
* ``loop``: ``closed`` (the next job is sent when the last one is
  answered);
* ``operand_pool`` (evaluator entry): operands made in set-up per
  letter; job j takes the combination of pool entries numbered by j's
  digits in that base, so no two of the first ``pool ** letters`` jobs
  evaluate the same set (the protocol entry draws fresh values for
  every job);
* ``warm_batches``: the bootstrap wave batches one job uses, warmed up
  in set-up;
* ``why``: one line.

Every seed gives the same sizes and the same work: only the values
differ.
"""

from __future__ import annotations

import json

import numpy as np

ENTRIES = ("evaluator", "protocol")
KEYS = ("entry", "postfix", "lanes", "width", "magnitude_bits",
        "negative_share", "loop", "warm_batches", "why")


def load(path) -> dict:
    """A mix from its file, checked."""
    with open(path) as f:
        mix = json.load(f)
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"{path}: missing {missing}")
    if mix["entry"] not in ENTRIES:
        raise ValueError(f"{path}: entry must be one of {ENTRIES}")
    if mix["loop"] != "closed":
        raise ValueError(f"{path}: only the closed loop is generated")
    if not 0 < mix["magnitude_bits"] <= mix["width"]:
        raise ValueError(f"{path}: magnitude_bits outside (0, width]")
    if mix["entry"] == "evaluator" and mix.get("operand_pool", 0) < 1:
        raise ValueError(f"{path}: the evaluator entry needs operand_pool")
    return mix


def operand_values(mix: dict, seed: int, index: int, letter: str) -> list:
    """Lane values of operand ``index`` of ``letter`` (a job's number
    under the protocol entry, a pool entry's under the evaluator's):
    signed Python ints, the same for the same seed."""
    rng = np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        [seed & 0xFFFFFFFF, seed >> 32, index, ord(letter)])))
    lanes = mix["lanes"]
    mags = rng.integers(0, 1 << mix["magnitude_bits"], lanes, dtype=np.int64)
    neg = rng.random(lanes) < mix["negative_share"]
    return [-int(m) if s else int(m) for m, s in zip(mags, neg)]


def pool_picks(job: int, names: list, pool: int) -> dict:
    """Which pool entry of each letter job ``job`` takes: the digits of
    ``job`` in base ``pool``."""
    return {name: (job // pool ** i) % pool for i, name in enumerate(names)}
