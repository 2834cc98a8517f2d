"""The check that decides ``correct`` fails what it has to fail.

A whole run (set-up, window, check) at TEST_TINY on the CPU, without the
harness's look for a card: sound, it is correct; with the control in the
evaluator's place, or with the timed path broken underneath in each way
these cells can break, it is not.  (The cells run on one card: there is
no exchange between chips to leave out.)"""

import pytest
import torch

from fhe_bench import control
from fhe_bench.tests import tiny
from ieache_tpu_torch.boot import bootstrap
from ieache_tpu_torch.circuits import evaluator as ev

SEED = 2**31 + 404


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"))


CELLS = [tiny.BATCH, tiny.INTERACTIVE]


def checks(line):
    return {k: c["value"] for k, c in line["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    line, _ = tiny.run(root, cell, SEED, seconds=0.5)
    assert line["correct"] and line["failed"] == 0
    assert checks(line) == {"wrong_lanes": 0, "failed_jobs": 0}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    """The reference on half-width integers in the evaluator's place."""
    bench = tiny.harness.Bench(root)
    line = control.run(bench, cell, SEED, 0.0, "cpu")
    assert not line["correct"]
    assert checks(line)["wrong_lanes"] == line["attempted"] * \
        bench.mix(bench.workload(cell)["traffic"])["lanes"]


def wrap_steps(change):
    """A tamper wrapping the evaluator's ``compute_steps``: ``change(j,
    answer)`` returns the answer of the j-th call the Cloud ships."""
    def tamper(cell):
        real = cell.evaluator.compute_steps
        calls = []

        def compute_steps(steps, operands):
            answer, info = real(steps, operands)
            calls.append(answer)
            return change(calls, answer), info
        cell.evaluator.compute_steps = compute_steps
    return tamper


def altered_bit(calls, answer):
    value = answer.value.clone()
    value[0, 3] = -value[0, 3]          # one bit of one lane flipped
    return ev.Operand(answer.neg_word, answer.bit_word, value,
                      answer.carry_word)


def half_left_out(calls, answer):
    """Half the lanes answered with the other half's answers; with one
    lane a job, every other job with the job's before."""
    b = answer.value.shape[0]
    if b > 1:
        keep = torch.arange(b) % (b // 2)
        return ev.Operand(*(w[keep] for w in (
            answer.neg_word, answer.bit_word, answer.value,
            answer.carry_word)))
    return calls[-2] if len(calls) % 2 == 0 else answer


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    seconds, tamper = 0.0, None
    if fault == "state_unchanged":
        # every blind rotation returns its accumulator as it came in
        monkeypatch.setattr(bootstrap, "blind_rotate",
                            lambda acc0, *a, **k: acc0)
    elif fault == "half_left_out":
        tamper = wrap_steps(half_left_out)
        seconds = 4.0 if cell == tiny.INTERACTIVE else 0.0
    else:
        tamper = wrap_steps(altered_bit)
    line, _ = tiny.run(root, cell, SEED, tamper=tamper, seconds=seconds)
    assert not line["correct"]
    assert checks(line)["wrong_lanes"] > 0
