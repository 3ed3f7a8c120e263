"""The harness on the CPU: traffic, statistics, work counts, discovery by
name, the import guard, and the reference against the port at a tiny
size.

    python -m pytest portbench/tests -q
"""

import json
import math
import os
import shutil
import subprocess
import sys
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.lib import cells, stats, traffic
from portbench.metrics import _work
from portbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
MISTRAL = cells.load_json(REPO / "portbench/configs/mistral-7b.json")


# ------------------------------------------------------------- traffic

@pytest.mark.parametrize("mix", ["decode-closed64", "chat-poisson"])
def test_requests_repeat_per_seed_and_differ_across(mix):
    m = cells.load_json(REPO / f"portbench/traffic/{mix}.json")
    a = traffic.requests(m, 2 ** 31 + 3, 32768, 2)
    b = traffic.requests(m, 2 ** 31 + 3, 32768, 2)
    c = traffic.requests(m, 7, 32768, 2)
    assert a == b
    assert [r["tokens"] for r in a] != [r["tokens"] for r in c]
    # every block holds the same sizes, whatever the seed
    for blk in range(2):
        lo, hi = blk * m["block"], (blk + 1) * m["block"]
        for key in ("max_new_tokens",):
            assert sorted(r[key] for r in a[lo:hi]) == \
                sorted(r[key] for r in c[lo:hi])
        assert sorted(len(r["tokens"]) for r in a[lo:hi]) == \
            sorted(len(r["tokens"]) for r in c[lo:hi])


def test_sizes_follow_their_distributions():
    n = 4096
    u = traffic.quantiles({"dist": "uniform", "lo": 128, "hi": 512}, n)
    assert u.min() == 128 and u.max() == 512
    assert abs(u.mean() - 320.5) < 1.0
    lg = traffic.quantiles({"dist": "loguniform", "lo": 64, "hi": 1024}, n)
    assert lg.min() == 64 and lg.max() == 1024
    # log-uniform: each octave holds the same share
    for lo in (64, 128, 256, 512):
        share = np.mean((lg >= lo) & (lg < 2 * lo))
        assert abs(share - 0.25) < 0.01
    e = traffic.quantiles({"dist": "exponential", "mean": 0.25}, n)
    assert abs(e.mean() - 0.25) < 0.01
    assert abs(np.median(e) - 0.25 * math.log(2)) < 0.005


def test_open_loop_arrives_at_its_rate_and_shares_its_prefix():
    m = cells.load_json(REPO / "portbench/traffic/chat-poisson.json")
    reqs = traffic.requests(m, 5, 32768, 8)
    span = reqs[-1]["due_s"]
    assert abs(len(reqs) / span - m["rate_per_s"]) / m["rate_per_s"] < 0.05
    prefix = reqs[0]["tokens"][:m["shared_prefix"]]
    assert all(r["tokens"][:m["shared_prefix"]] == prefix for r in reqs)
    assert all(32 <= r["max_new_tokens"] <= 256 for r in reqs)


def test_batches_are_fresh_each_step_and_repeat_per_seed():
    m = {"batch": 8, "seq_len": 64}
    a0 = traffic.batch_tokens(m, 2 ** 31 + 9, 0, 32768, "cpu")
    a1 = traffic.batch_tokens(m, 2 ** 31 + 9, 1, 32768, "cpu")
    assert torch.equal(a0, traffic.batch_tokens(m, 2 ** 31 + 9, 0, 32768,
                                                "cpu"))
    assert not torch.equal(a0, a1)
    assert len({tuple(r.tolist()) for r in a0}) == 8


# ---------------------------------------------------------- statistics

def test_percentile_is_over_every_sample_and_counts_missing_as_slowest():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert stats.percentile(v, 50) == pytest.approx(50.5)
    with_missing = list(range(1, 20)) + [math.inf]
    assert math.isinf(stats.percentile(with_missing, 96))


def _serve_record(times_by_request, dues, t0=10.0, t_end=20.0):
    return {"kind": "serve", "t0": t0, "t_end": t_end,
            "requests": [{"due": d, "times": t, "failed": False}
                         for d, t in zip(dues, times_by_request)]}


def test_rates_and_tails_are_over_the_whole_window():
    # two requests: one streams 100 tokens evenly over the window, the
    # other a token at 19.5 s; tokens outside [10, 20) do not count
    steady = [10.0 + 0.1 * i for i in range(100)]
    rec = _serve_record([steady + [20.5], [19.5]], dues=[9.0, 15.0])
    tps = cells.reader("output_tokens_per_s")(rec)
    assert tps == pytest.approx(101 / 10.0)
    # ttft over requests due in the window only: 19.5 - 15
    assert cells.reader("ttft_p95_s")(rec) == pytest.approx(4.5)
    itl = cells.reader("itl_p95_ms")(rec)
    assert itl == pytest.approx(100.0)
    rec["requests"][1]["failed"] = True
    assert math.isinf(cells.reader("ttft_p95_s")(rec))


def test_train_rate_is_tokens_over_the_window():
    rec = {"kind": "train", "steps": 10, "tokens": 10 * 8192,
           "window_s": 8.0, "cfg": MISTRAL, "chips": 1,
           "mix": {"batch": 8, "seq_len": 1024}}
    assert cells.reader("train_tokens_per_s")(rec) == 10240.0


# --------------------------------------------------------- work counts

def test_mistral_operation_counts_match_hand_worked_values():
    p = 7_248_023_552 - 32768 * 4096
    assert _work.params_without_embedding(MISTRAL) == p
    l12 = cells.load_json(REPO / "portbench/configs/mistral-7b-l12.json")
    assert _work.params_without_embedding(l12) == \
        2_885_783_552 - 32768 * 4096
    # 6 x 2,751,565,824 + 6 x 12 x 1024 x 4096 a token
    assert _work.train_flops_per_token(l12, 1024) == \
        6 * 2_751_565_824 + 6 * 12 * 1024 * 4096
    # flash forward at [8, 1024, 32/8, 128]: 2 B H S^2 D operations;
    # q and the output 8 x 1024 x 32 x 128, k and v 8 x 1024 x 8 x 128
    flops, nbytes = _work.flash_fwd(8, 1024, 32, 8, 128)
    assert flops == 2 * 8 * 32 * 1024 * 1024 * 128 == 68_719_476_736
    assert nbytes == (2 * 33_554_432 + 2 * 8_388_608) * 2 == 167_772_160
    # memory bound? 68.7e9 / 989e12 = 69.5 us against 50.1 us of bytes
    assert _work.roofline_s(flops, nbytes) == pytest.approx(
        68_719_476_736 / 989e12)
    # paged decode, one layer: 64 lanes of 1000 positions read K and V
    # (8 heads x 128 x 2 B each) and q and the output (32 x 128 x 2 B)
    flops, nbytes = _work.paged_decode(MISTRAL, 64, 64_000)
    assert nbytes == 64_000 * 2 * 8 * 128 * 2 + 64 * 2 * 32 * 128 * 2
    assert flops == 4 * 64_000 * 32 * 128
    assert _work.roofline_s(flops, nbytes) == pytest.approx(
        nbytes / 3.35e12)
    assert _work.causal_context_sum(0, 4) == 1 + 2 + 3 + 4
    assert _work.causal_context_sum(1024, 1026) == 1025 + 1026
    assert _work.forward_flops(MISTRAL, 1, 10) == 2 * p + 4 * 32 * 4096 * 10


# ---------------------------------------------------- found by its name

def test_a_new_config_mix_metric_and_cell_are_found_without_an_edit(
        tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", base,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = cells.benchmark(REPO)
    cfg = dict(MISTRAL, name="mistral-7b-b32")
    cfg["engine"] = dict(cfg["engine"], max_batch=32)
    (base / "configs/mistral-7b-b32.json").write_text(json.dumps(cfg))
    mix = cells.load_json(base / "traffic/decode-closed64.json")
    (base / "traffic/decode-closed32.json").write_text(
        json.dumps(dict(mix, clients=32)))
    (base / "metrics/requests_done.py").write_text(
        "def read(record):\n    return float(len(record['requests']))\n")
    bench["configs"].append({"name": "mistral-7b-b32", "source": "x",
                             "file": "portbench/configs/mistral-7b-b32.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "serve-b32", "config": "mistral-7b-b32",
                               "traffic": "decode-closed32", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "requests_done", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "output_tokens_per_s",
                               "workloads": ["serve-b32"]})
    c = cells.cell(bench, "serve-b32", base=base, trace=True)
    assert c.cfg["engine"]["max_batch"] == 32 and c.mix["clients"] == 32
    assert [m["name"] for m in cells.metrics_for(bench, "serve-b32", True)] \
        == ["requests_done"]
    rec = {"correct": True, "attempted": 3, "failed": 0, "checks": {},
           "device": {}, "requests": [1, 2, 3]}
    out = cells.result(bench, c, rec, base=base)
    assert out["metrics"] == {"requests_done": {"value": 3.0, "unit": "1"}}
    assert list(out)[-1] == "checks"


def test_every_metric_of_the_benchmark_has_its_reader():
    bench = cells.benchmark(REPO)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(cells.reader(m["name"]))
    for w in bench["workloads"]:
        c = cells.cell(bench, w["name"])
        assert c.cfg["kind"] in ("train", "serve")


# ------------------------------------------------------ the import guard

def test_the_guard_compares_whole_top_level_names():
    sys.path.insert(0, str(REPO / "portbench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    saved = dict(sys.modules)
    try:
        for name in [m for m in sys.modules
                     if m.split(".")[0] in run.FORBIDDEN]:
            del sys.modules[name]
        sys.modules["ray_tpu_torch_fake"] = sys
        sys.modules["jaxtyping_fake"] = sys
        assert run.forbidden_modules() == []
        sys.modules["ray_tpu.api"] = sys
        assert run.forbidden_modules() == ["ray_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_tiny_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests import tiny\n"
        "from portbench.lib import cells\n"
        "for n in ('train-mistral7b-l12-s1k', 'serve-mistral7b-chat'):\n"
        "    cells.drive(tiny.cell(n, seconds=0.5))\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules\n"
        "              if m.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'ray_tpu')})\n"
        "print('BAD', bad)\n" % str(REPO))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "serve-mistral7b-decode", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 2
    assert out.stdout == ""


def test_run_refuses_in_a_folder_without_the_program(tmp_path):
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "serve-mistral7b-decode", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert out.stdout == ""


# ------------------------------------------- the reference against the port

@pytest.mark.parametrize("name", ["train-mistral7b-l12-s1k",
                                  "serve-mistral7b-decode",
                                  "serve-mistral7b-chat"])
def test_the_reference_agrees_with_the_port_in_fp32(name):
    c = tiny.cell(name, seconds=1.0)
    rec = cells.drive(c)
    numbers = {k: v["value"] for k, v in rec["checks"].items()}
    if c.cfg["kind"] == "train":
        assert numbers["loss_rel_gap"] < 1e-5
        assert numbers["grad_norm_gap"] < 1e-4
        assert statistics.median(rec["losses"]["program"]) > 0
    else:
        assert rec["tokens_compared"] > 0
        assert numbers["max_logit_gap"] < 1e-4
