"""The port's continuous-batching engine (ray_tpu_torch/serve/llm.py)
held against ray_tpu's LLMEngine on the same converted weights.

Both engines run the tiny fp32 config of tests/test_serve_llm.py (fp32
keeps greedy argmax bit-stable across frameworks), on the CPU, where the
port's paged decode takes its kernel's plain version.  Greedy streams
must be token-identical; sampled streams cannot match jax.random bit for
bit, so they are held to same-seed replay and top-k membership.
"""

import threading
import time

import pytest
import torch

import jax.numpy as jnp

from tests.conftest import force_cpu_jax

from ray_tpu.models.llama import LlamaConfig as JaxConfig
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch._private import deadlines
from ray_tpu_torch._private.errors import DeadlineExceededError
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.serve.llm import LLMEngine, LLMOverloadedError

force_cpu_jax()
torch.set_num_threads(2)   # six xdist workers share the test machine

MODEL = {"vocab_size": 64, "dim": 32, "n_layers": 2, "n_heads": 4,
         "n_kv_heads": 2, "hidden_dim": 64, "max_seq_len": 64}
KW = dict(page_size=8, num_pages=33, max_batch=4, prefill_chunk=8,
          max_queue=8, detach_grace_s=60.0)

_jax_params = {}


def _flax_params():
    """ray_tpu's seed-0 flax params for the tiny config, made once."""
    if "p" not in _jax_params:
        probe = JaxEngine(JaxConfig(dtype=jnp.float32, **MODEL), **KW)
        _jax_params["p"] = probe._params
    return _jax_params["p"]


def _port(**kw):
    kw = {**KW, **kw}
    kw.setdefault("params", _flax_params())
    return LLMEngine(LlamaConfig(dtype=torch.float32, **MODEL),
                     device="cpu", **kw)


def _jax(**kw):
    return JaxEngine(JaxConfig(dtype=jnp.float32, **MODEL),
                     params=_flax_params(), **{**KW, **kw})


def _drain(engine, rounds=200):
    for _ in range(rounds):
        if not engine.step():
            break


def _assert_greedy(engine, prompt, generated, n=None):
    """Teacher forcing through the port's no-cache forward: each
    generated token is the argmax at its prefix position."""
    if n is not None:
        assert len(generated) == n, (len(generated), n)
    full = torch.tensor([list(prompt) + list(generated)], dtype=torch.int32)
    with torch.no_grad():
        lg = engine._model(full)[0]
    for j, tok in enumerate(generated):
        assert int(lg[len(prompt) + j - 1].argmax()) == int(tok), (j, tok)


PROMPTS = [[5, 9, 3], [7, 11, 2, 4, 8, 1, 9, 10, 3, 2], [1, 2],
           [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3]]


def _staggered(engine):
    """test_serve_llm.py's admission pattern: three sequences, three
    steps, then a fourth joins mid-flight."""
    seqs = [engine.submit({"tokens": p, "max_new_tokens": 6})
            for p in PROMPTS[:3]]
    for _ in range(3):
        engine.step()
    seqs.append(engine.submit({"tokens": PROMPTS[3], "max_new_tokens": 5}))
    _drain(engine)
    return [list(s.generated) for s in seqs]


# ------------------------------------------------------ cross-framework


def test_greedy_streams_match_jax_engine():
    port, ref = _port(), _jax()
    before = tpa.LAUNCHES
    got = _staggered(port)
    assert got == _staggered(ref)
    assert tpa.LAUNCHES == before, "CPU decode must not launch the kernel"
    for p, g, n in zip(PROMPTS, got, (6, 6, 6, 5)):
        _assert_greedy(port, p, g, n=n)
    st = port.stats()
    assert st["used_pages"] == 0 and st["free_pages"] == 32, st
    assert st["decode_steps"] > 0 and st["attention_impl"] == "paged"
    assert st["kv_page_bytes"] == ref.stats()["kv_page_bytes"]


def _prefix_run(engine):
    base = list(range(1, 25))  # 3 full pages at page_size=8
    s1 = engine.submit({"tokens": base, "max_new_tokens": 6,
                        "request_id": "p1"})
    for _ in range(4):
        engine.step()
    assert len(engine._prefix_index) == 3
    s2 = engine.submit({"tokens": base, "max_new_tokens": 6,
                        "request_id": "p2"})
    engine.step()
    div = base[:20] + [60, 61, 62, 63]
    s3 = engine.submit({"tokens": div, "max_new_tokens": 6,
                        "request_id": "p3"})
    _drain(engine)
    return [list(s.generated) for s in (s1, s2, s3)], engine.stats()


def test_prefix_sharing_and_cow_match_jax_engine():
    (t1, t2, t3), st = _prefix_run(_port())
    (j1, j2, j3), jst = _prefix_run(_jax())
    assert [t1, t2, t3] == [j1, j2, j3]
    assert t1 == t2
    for key in ("prefix_hits", "cow_splits", "prefix_tokens_shared",
                "used_pages", "free_pages", "pages_allocated_total"):
        assert st[key] == jst[key], key
    assert st["prefix_hits"] == 2 and st["cow_splits"] == 2
    assert st["prefix_tokens_shared"] == 23 + 20


def test_kv_pack_exported_by_jax_engine_decodes_on_port():
    """A prefill_request payload from the JAX engine (host numpy rows of
    the same [T, Hkv, D] pool layout) attaches to the port engine by
    request and decodes the JAX decode engine's tokens."""
    prompt = list(range(2, 21))   # 19 tokens -> 3 pages shipped
    payload = _jax().prefill_request({"tokens": prompt, "max_new_tokens": 6,
                                      "request_id": "ship1"})
    pack = (payload["meta"], payload["rows"])
    port, ref = _port(), _jax()
    s = port.submit({"tokens": prompt, "max_new_tokens": 6,
                     "request_id": "ship1"}, kv_pack=pack)
    r = ref.submit({"tokens": prompt, "max_new_tokens": 6,
                    "request_id": "ship1"}, kv_pack=pack)
    _drain(port)
    _drain(ref)
    assert s.done and len(s.generated) == 6
    assert s.generated[0] == payload["meta"]["first_token"]
    assert list(s.generated) == list(r.generated)
    _assert_greedy(port, prompt, s.generated, n=6)
    st = port.stats()
    assert st["kv_pages_shipped_in"] == 3 and st["used_pages"] == 0


# ------------------------------------------------------------ port only


def test_port_prefill_request_round_trip():
    P, D = _port(), _port()
    prompt = list(range(2, 21))
    payload = P.prefill_request({"tokens": prompt, "max_new_tokens": 6,
                                 "request_id": "r"})
    meta, rows = payload["meta"], payload["rows"]
    assert meta["n"] == len(prompt) and meta["pages"] == 3
    assert all(isinstance(r, torch.Tensor) and r.device.type == "cpu"
               for r in rows["k"] + rows["v"])
    assert P.stats()["kv_pages_shipped_out"] == 3
    assert P.stats()["used_pages"] == 0
    s = D.submit({"tokens": prompt, "max_new_tokens": 6,
                  "request_id": "r"}, kv_pack=(meta, rows))
    _drain(D)
    _assert_greedy(D, prompt, s.generated, n=6)


def test_mismatched_kv_pack_falls_back_to_local_prefill():
    P, D = _port(), _port()
    payload = P.prefill_request({"tokens": [5, 9, 3, 7],
                                 "max_new_tokens": 2})
    other = [1, 2, 3, 4, 5, 6]
    s = D.submit({"tokens": other, "max_new_tokens": 4},
                 kv_pack=(payload["meta"], payload["rows"]))
    _drain(D)
    _assert_greedy(D, other, s.generated, n=4)
    assert D.stats()["kv_pages_shipped_in"] == 0


def test_sampling_is_seeded_and_top_k():
    prompt, n = [5, 9, 3], 6

    def sampled(seed):
        eng = _port(seed=seed, temperature=0.8, top_k=5)
        s = eng.submit({"tokens": prompt, "max_new_tokens": n})
        _drain(eng)
        assert eng.stats()["used_pages"] == 0
        return eng, list(s.generated)

    eng, a = sampled(7)
    _eng, b = sampled(7)
    assert a == b, "same seed must replay the same tokens"
    assert len(a) == n
    full = torch.tensor([prompt + a], dtype=torch.int32)
    with torch.no_grad():
        lg = eng._model(full)[0]
    for j, tok in enumerate(a):
        top5 = set(lg[len(prompt) + j - 1].topk(5).indices.tolist())
        assert tok in top5, (j, tok, top5)


def test_paged_vs_dense_identical_tokens():
    reqs = [{"tokens": [5, 9, 3], "max_new_tokens": 6},
            {"tokens": [7, 11, 2, 4, 8, 1, 9, 10, 3, 2],
             "max_new_tokens": 6},
            {"tokens": [3] * 13, "max_new_tokens": 6}]
    paged, dense = _port(), _port(attention_impl="dense")
    assert dense.stats()["attention_impl"] == "dense"
    assert paged.generate_batch([dict(r) for r in reqs]) == \
        dense.generate_batch([dict(r) for r in reqs])


def test_attention_impl_validation():
    with pytest.raises(ValueError, match="auto\\|paged\\|dense"):
        _port(attention_impl="flashier")


# ------------------------------------------- routing on the kernels' shapes


@pytest.mark.parametrize("name,flash,paged", [("tiny", False, False),
                                              ("small", True, True),
                                              ("llama3_8b", True, True)])
def test_kernel_predicates_and_auto_resolution(name, flash, paged):
    """Each kernel module states the shapes its CUDA kernel takes; the
    engine's ``auto`` resolves to ``paged`` on a CUDA device only where
    the paged kernel takes the model's shape (tiny: head_dim 16), on
    the CPU always (the plain version takes every shape), and an
    explicit choice is kept."""
    from ray_tpu_torch.ops import flash_attention as tfa
    from ray_tpu_torch.serve.llm import resolve_attention_impl

    cfg = getattr(LlamaConfig, name)()
    group = cfg.n_heads // cfg.n_kv_heads
    assert tfa.kernel_takes(cfg.head_dim, 512, 512, cfg.dtype) is flash
    assert tpa.kernel_takes(cfg.head_dim, group, cfg.dtype) is paged
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert resolve_attention_impl("auto", cfg, cuda) == \
        ("paged" if paged else "dense")
    assert resolve_attention_impl("auto", cfg, cpu) == "paged"
    assert resolve_attention_impl("paged", cfg, cuda) == "paged"
    assert resolve_attention_impl("dense", cfg, cuda) == "dense"


def test_kernel_predicates_refuse_what_the_kernels_refuse():
    from ray_tpu_torch.ops import flash_attention as tfa

    assert not tpa.kernel_takes(80, 4, torch.bfloat16)     # head_dim
    assert not tpa.kernel_takes(128, 16, torch.bfloat16)   # group > 8
    assert not tpa.kernel_takes(128, 4, torch.float16)     # dtype
    assert tpa.kernel_takes(64, 8, torch.float32)
    assert not tfa.kernel_takes(128, 520, 520, torch.bfloat16)  # tile
    assert not tfa.kernel_takes(32, 512, 512, torch.bfloat16)
    assert tfa.kernel_takes(64, 512, 512, torch.float32)


def test_default_attention_takes_flash_only_where_the_kernel_takes_it(
        monkeypatch):
    """On a device that is not the CPU (``meta`` here: shapes only, no
    card), a long causal prefill goes to flash at head_dim 64/128 and to
    dense attention at 16 or 80, decided before any launch."""
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.ops import flash_attention as tfa

    calls = []
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda q, k, v, causal: calls.append(q.shape[-1])
                        or torch.empty_like(q))
    for d in (16, 64, 80, 128):
        q = torch.empty(1, 512, 4, d, device="meta")
        kv = torch.empty(1, 512, 2, d, device="meta")
        assert tl.default_attention(q, kv, kv, True).shape == q.shape
    assert calls == [64, 128]


def test_state_dict_params_and_seeded_init():
    """params may be the port's own state_dict; params=None initializes
    from the seed (same seed, same weights)."""
    src = _port()
    copy = _port(params=src._model.state_dict())
    assert _staggered(copy) == _staggered(_port())
    a, b = _port(params=None, seed=3), _port(params=None, seed=3)
    assert torch.equal(a._model.lm_head.weight, b._model.lm_head.weight)


def test_bf16_engine_runs():
    eng = _port(dtype=torch.bfloat16)
    assert eng._model.lm_head.weight.dtype == torch.bfloat16
    assert eng._pools["k"][0].dtype == torch.bfloat16
    out = eng.generate_batch([{"tokens": [5, 9, 3], "max_new_tokens": 4},
                              {"tokens": list(range(1, 20)),
                               "max_new_tokens": 4}])
    assert [len(o) for o in out] == [4, 4]
    assert all(0 <= t < MODEL["vocab_size"] for o in out for t in o)


def test_eos_stops_and_recycles():
    eng = _port()
    probe = eng.submit({"tokens": [5, 9, 3], "max_new_tokens": 6})
    _drain(eng)
    ref = list(probe.generated)
    s = eng.submit({"tokens": [5, 9, 3], "max_new_tokens": 6,
                    "eos": ref[2]})
    _drain(eng)
    assert s.generated == ref[:3]
    assert eng.stats()["used_pages"] == 0


def test_chunked_prefill_does_not_stall_decodes():
    eng = _port()
    short = eng.submit({"tokens": [1, 2], "max_new_tokens": 3})
    eng.step()
    long_prompt = [7] * 40  # 5 prefill chunks
    long = eng.submit({"tokens": long_prompt, "max_new_tokens": 3})
    _drain(eng)
    _assert_greedy(eng, [1, 2], short.generated, n=3)
    _assert_greedy(eng, long_prompt, long.generated, n=3)
    assert short.first_token_at < long.first_token_at


def test_admission_shed_and_page_bounds():
    eng = _port(num_pages=9, max_batch=1, max_queue=1)
    a = eng.submit({"tokens": [1, 2, 3], "max_new_tokens": 20})
    eng.step()
    b = eng.submit({"tokens": [4, 5], "max_new_tokens": 4})
    with pytest.raises(LLMOverloadedError):
        eng.submit({"tokens": [6], "max_new_tokens": 2})
    with pytest.raises(ValueError):
        eng.submit({"tokens": [1] * 40, "max_new_tokens": 40})
    _drain(eng)
    assert a.done and b.done and eng.stats()["used_pages"] == 0


def test_cancel_and_detach_grace_recycle_pages():
    eng = _port(detach_grace_s=0.05)
    s = eng.submit({"tokens": [5, 9, 3], "max_new_tokens": 30,
                    "request_id": "c1"})
    for _ in range(4):
        eng.step()
    assert eng.cancel("c1") and eng.stats()["used_pages"] == 0
    assert list(eng.iter_tokens(s, len(s.generated))) == []
    t = eng.submit({"tokens": [5, 9, 3], "max_new_tokens": 40})
    eng.step()
    eng.release(t)
    time.sleep(0.08)
    _drain(eng, rounds=5)
    assert t.done and t.cancelled and eng.stats()["used_pages"] == 0
    assert eng.stats()["cancelled"] == 2


def test_save_restore_resumes_generation():
    eng = _port()
    s = eng.submit({"tokens": [5, 9, 3], "max_new_tokens": 6,
                    "request_id": "r1"})
    for _ in range(3):
        eng.step()
    k = len(s.generated)
    assert 0 < k < 6
    eng2 = _port(params=eng._model.state_dict())
    eng2.restore_state(eng.save_state())
    s2 = eng2.submit({"tokens": [5, 9, 3], "max_new_tokens": 6,
                      "request_id": "r1", "emit_from": k})
    out = []
    t = threading.Thread(
        target=lambda: out.extend(eng2.iter_tokens(s2, max(0, k - 1))))
    t.start()
    _drain(eng2)
    t.join(10)
    assert not t.is_alive()
    _assert_greedy(eng, [5, 9, 3], s2.generated, n=6)
    flat = [(o["i"] + j, tok) for o in out
            for j, tok in enumerate(o["tokens"])]
    assert [i for i, _ in flat] == list(range(k - 1, 6))


def _exceeded(where):
    """ray_tpu_deadline_exceeded_total{where=...} as the metrics registry
    renders it."""
    from ray_tpu_torch._private.metrics import deadline_metrics

    prefix = f'ray_tpu_deadline_exceeded_total{{where="{where}"}} '
    return next((float(line[len(prefix):]) for line in
                 deadline_metrics().render() if line.startswith(prefix)),
                0.0)


def test_deadline_admission_and_expiry():
    eng = _port()
    before = {w: _exceeded(w) for w in ("admission", "running")}
    token = deadlines.activate(time.time() - 0.5)
    try:
        with pytest.raises(DeadlineExceededError) as ei:
            eng.submit({"tokens": [1, 2], "max_new_tokens": 4})
    finally:
        deadlines.restore(token)
    assert ei.value.where == "admission"
    eng._step_ewma = 0.2  # 2 chunks + 1 decode = 0.6s needed
    with pytest.raises(DeadlineExceededError):
        eng.submit({"tokens": [1] * 16, "max_new_tokens": 4,
                    "deadline_ms": (time.time() + 0.2) * 1000.0})
    eng._step_ewma = 0.0
    s = eng.submit({"tokens": [5, 9, 3], "max_new_tokens": 60,
                    "deadline_ms": (time.time() + 0.15) * 1000.0})
    for _ in range(3):
        eng.step()
    time.sleep(0.2)
    eng.step()  # the sweep runs at step start
    assert s.done and s.cancelled and s.error.where == "running"
    with pytest.raises(DeadlineExceededError):
        list(eng.iter_tokens(s, len(s.generated)))
    assert eng.stats()["used_pages"] == 0
    assert _exceeded("admission") == before["admission"] + 2
    assert _exceeded("running") == before["running"] + 1


def test_loop_single_flight_and_stop():
    eng = _port()
    t = threading.Thread(target=eng.run_loop, daemon=True)
    t.start()
    deadline = time.time() + 5
    while not eng.stats()["loop_running"] and time.time() < deadline:
        time.sleep(0.01)
    assert eng.run_loop() == {"already_running": True}
    s = eng.submit({"tokens": [5, 9, 3], "max_new_tokens": 4})
    toks = [tok for o in eng.iter_tokens(s) for tok in o["tokens"]]
    _assert_greedy(eng, [5, 9, 3], toks, n=4)
    eng.stop()
    t.join(5)
    assert not t.is_alive()
