"""The comparison that decides ``correct`` has to refuse what is wrong.

Each test drives a whole run of a cell at a small size on the CPU, past
the harness's look for a card, with the committed limits, and sees
``correct`` come out false: the control (the plain reference in the
program's place, in float8, the precision below the configuration's
bf16), and each fault the cell can have, planted under the timed path.
On the card the same readings were taken at each cell's own size
(``calibrate.py``; ``PERF.md`` gives them).
"""

import copy

import pytest
import torch

from portbench.lib import cells, serve_cell
from portbench.tests import tiny

TRAIN = "train-mistral7b-l12-s1k"
SERVE = ["serve-mistral7b-decode", "serve-mistral7b-chat"]


def _sound(c):
    rec = cells.drive(c)
    assert rec["correct"], rec["checks"]
    return rec


def _numbers(rec):
    return {k: v["value"] for k, v in rec["checks"].items()}


def test_train_control_in_fp8_is_refused_and_reads_above_the_program():
    # the limits are the cell's, set at its own size; at this size the
    # bf16 program itself reads above some of them, so the program and
    # the control are also held against each other
    sound = _numbers(cells.drive(tiny.cell(TRAIN, dtype="bfloat16")))
    c = tiny.cell(TRAIN, dtype="bfloat16")
    c.control = "fp8"
    rec = cells.drive(c)
    assert not rec["correct"]
    control = _numbers(rec)
    assert all(control[k] > 3 * sound[k] for k in sound), (sound, control)


def _unchanged(step_fn):
    # computes the step's loss on a copy and returns the state unchanged
    def step(p, o, tokens):
        q, r = copy.deepcopy((p, o))
        return p, o, step_fn(q, r, tokens)[2]
    return step


def _half_batch(step_fn):
    # half of the batch left out: the mean is over the rest
    def step(p, o, tokens):
        return step_fn(p, o, tokens[:tokens.shape[0] // 2])
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_train_fault_is_refused(fault):
    c = tiny.cell(TRAIN, dtype="bfloat16", fault=fault)
    assert not cells.drive(c)["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_serve_sound_run_is_correct(name):
    _sound(tiny.cell(name, dtype="bfloat16"))


@pytest.mark.parametrize("name", SERVE)
def test_serve_control_in_fp8_is_refused(name):
    c = tiny.cell(name, dtype="bfloat16")
    c.control = "fp8"
    rec = cells.drive(c)
    limit = c.limits["max_logit_gap"]
    assert rec["control_max_logit_gap"] > limit


def _token_altered(eng):
    inner = eng._forward
    vocab = eng.cfg.vocab_size

    def forward(*a, **kw):
        out = inner(*a, **kw)
        out[0] = (out[0] + 1) % vocab     # lane 0's token, as produced
        return out
    eng._forward = forward


def _cache_unchanged(eng):
    inner = eng._forward

    def forward(*a, **kw):
        kept = {s: [p.clone() for p in eng._pools[s]] for s in ("k", "v")}
        out = inner(*a, **kw)
        for s in ("k", "v"):
            for p, q in zip(eng._pools[s], kept[s]):
                p.copy_(q)
        return out
    eng._forward = forward


@pytest.mark.parametrize("fault", [_token_altered, _cache_unchanged])
@pytest.mark.parametrize("name", SERVE)
def test_serve_fault_is_refused(name, fault):
    c = tiny.cell(name, dtype="bfloat16", fault=fault)
    assert not cells.drive(c)["correct"]


def test_the_sample_holds_the_longest_finished_request():
    recs = [{"prompt": [1] * n, "tokens": [2] * m, "max_new": m,
             "failed": False} for n, m in ((5, 3), (40, 9), (7, 2))]
    recs.append({"prompt": [1] * 90, "tokens": [2], "max_new": 4,
                 "failed": False})           # cancelled: not finished
    pick = serve_cell._sample(recs, 2 ** 31 + 1)
    assert pick[0] is recs[1]
    assert recs[3] not in pick


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs the port's kernels")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", [TRAIN] + SERVE)
def test_a_short_run_on_the_card_is_correct(cuda, name):
    import time

    # long enough for the decode cell's shortest requests (128 tokens
    # after 8 s of warm traffic) to finish into the check's sample
    c = cells.cell(cells.benchmark(), name, seed=2 ** 31 + 21, seconds=15,
                   device=cuda, t_start=time.monotonic())
    rec = cells.drive(c)
    assert rec["correct"], rec["checks"]
    assert rec["device"]["platform"] == "gpu"
