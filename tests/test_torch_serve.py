"""Serving through the port's runtime (ray_tpu_torch/serve), on the CPU.

One port cluster for the module (``resources={"GPU": 1}`` claims one
card, so fractional leases can be checked without one), with the HTTP
proxy.  Replicas run the tiny fp32 config of tests/test_serve_llm.py
with ``device="cpu"``, where paged decode takes its kernel's plain
version.  The parity oracle is ray_tpu's LLMEngine, run in this process
with ``generate_batch`` on seed-0 flax params; the replicas get the same
tree as numpy (carried across by ``models/convert.params_from_flax``).
fp32 keeps greedy argmax bit-stable across the two frameworks, so tokens
must be equal.  The replica targets live in tests/torch_serve_targets.py,
which imports no JAX: a replica process imports it.
"""

import http.client
import json
import os
import socket
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import force_cpu_jax

import ray_tpu_torch as rt
from ray_tpu.models.llama import LlamaConfig as JaxConfig
from ray_tpu.serve.llm import LLMEngine as JaxEngine
from ray_tpu_torch import serve
from ray_tpu_torch.models.llama import LlamaConfig
from tests.torch_waits import bounded

force_cpu_jax()
torch.set_num_threads(2)   # six xdist workers share the test machine

MODEL = {"vocab_size": 64, "dim": 32, "n_layers": 2, "n_heads": 4,
         "n_kv_heads": 2, "hidden_dim": 64, "max_seq_len": 256}
KW = dict(page_size=8, num_pages=33, max_batch=4, prefill_chunk=8)
SERVE_RUN_S = 240   # a deploy that has not finished by then has stalled
DISAGG_PROMPT = list(range(3, 22))   # 19 tokens -> 3 shipped pages


METRICS_REQUESTS = [{"tokens": [5, 9, 3], "max_new_tokens": 6},
                    {"tokens": list(range(1, 21)), "max_new_tokens": 4},
                    {"tokens": [7, 7], "max_new_tokens": 5}]


def _token_counts(family, run):
    """``run()``'s output and the ``ray_tpu_llm_tokens_total`` it added,
    by phase, in ``family``'s process-wide counter."""
    tokens = family()[0]

    def now():
        return {p: sum(v for k, v in tokens._values.items()
                       if ("phase", p) in k) for p in ("prefill", "decode")}

    before = now()
    out = run()
    after = now()
    return out, {p: after[p] - before[p] for p in after}


class _Oracle:
    """ray_tpu's engine on its seed-0 flax params, built and run on a
    background thread while the cluster and the replicas start (its jit
    compiles would otherwise add ~12 s to the module): the tree as numpy
    for the port's replicas, then every reference output the module
    compares with."""

    def __init__(self):
        import concurrent.futures
        import threading

        self._params = concurrent.futures.Future()
        self._results = concurrent.futures.Future()
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        from ray_tpu._private.metrics import llm_metrics

        try:
            eng = JaxEngine(JaxConfig(dtype=jnp.float32, **MODEL), **KW)
            self._params.set_result(
                jax.tree_util.tree_map(np.asarray, eng._params))

            def greedy(prompt):
                return eng.generate_batch([{"tokens": list(prompt),
                                            "max_new_tokens": 6}])[0]

            self._results.set_result({
                "sse": greedy([5, 9, 3]), "disagg": greedy(DISAGG_PROMPT),
                "metrics": _token_counts(llm_metrics, lambda: eng.
                                         generate_batch([dict(r) for r in
                                                         METRICS_REQUESTS]))})
        except BaseException as exc:
            for fut in (self._params, self._results):
                if not fut.done():
                    fut.set_exception(exc)

    def params(self):
        return self._params.result(timeout=300)

    def __getitem__(self, key):
        return self._results.result(timeout=300)[key]


@pytest.fixture(scope="module")
def oracle():
    return _Oracle()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory, oracle):
    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    bounded(lambda: rt.init(num_cpus=4, resources={"GPU": 1},
                            object_store_memory=96 << 20),
            120, "rt.init")
    host, port = bounded(serve.start_http, 120, "serve.start_http")
    try:
        yield {"host": host, "port": port, "oracle": oracle}
    finally:
        for stop in (serve.shutdown_http, serve.shutdown):
            try:
                stop()
            except Exception:
                pass
        bounded(rt.shutdown, 60, "rt.shutdown")
        os.environ.pop("RT_TMPDIR", None)


def _engine_kwargs(cluster, **over):
    return {"model": dict(MODEL), "dtype": torch.float32, "device": "cpu",
            "params": cluster["oracle"].params(), **KW, **over}


def _sse(cluster, name, payload, timeout=60):
    conn = http.client.HTTPConnection(cluster["host"], cluster["port"],
                                      timeout=timeout)
    conn.request("POST", f"/{name}", body=json.dumps(payload),
                 headers={"Content-Type": "application/json",
                          "Accept": "text/event-stream"})
    return conn, conn.getresponse()


def _read_items(resp):
    return [json.loads(ln) for ln in resp.read().decode().splitlines()
            if ln.strip()]


def _flat(items):
    return [(it["i"] + j, t) for it in items
            for j, t in enumerate(it["tokens"])]


# ------------------------------------------------ the fractional GPU lease


def test_half_gpu_leases_share_card_zero_and_a_third_queues(cluster):
    """Two ``num_gpus=0.5`` actors live at once both see card "0" (a
    fractional demand takes a share of one card, not none); a third
    waits for a share until one of them dies, then sees "0" too."""
    class ShareHolder:
        def cards(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES", "<unset>")

    holder = rt.remote(num_gpus=0.5)(ShareHolder)
    a, b = holder.remote(), holder.remote()
    assert rt.get([a.cards.remote(), b.cards.remote()], timeout=60) == \
        ["0", "0"]
    c = holder.remote()
    pending = c.cards.remote()
    ready, _ = rt.wait([pending], timeout=1.5)
    assert not ready, "a third half-card lease was granted on one card"
    rt.kill(a)
    assert rt.get(pending, timeout=60) == "0"
    for h in (b, c):
        rt.kill(h)


def test_gpu_shares_take_whole_cards_and_remainders():
    """A demand takes whole free cards, lowest index first, and its
    remainder as a share of the lowest card with that much left; shares
    come back with the lease."""
    from ray_tpu_torch._private.node_agent import GpuShares

    full = GpuShares.UNITS
    cards = GpuShares(["0", "1", "2"])
    half = cards.take(0.5)
    assert half == {"0": full // 2}
    assert cards.take(1.5) == {"1": full, "0": full // 2}
    assert cards.take(0.25) == {"2": full // 4}
    cards.give_back(half)
    assert cards.take(0.5) == {"0": full // 2}


# --------------------------------------------------------- copied serve


def test_function_deployment_and_http_json(cluster):
    """Ports of test_serve.py:24 and :200: a function deployment through
    a handle, and a JSON request through the HTTP proxy."""
    @serve.deployment(name="doubler")
    def doubler(x):
        return {"doubled": int(x["n"]) * 2} if isinstance(x, dict) else x * 2

    handle = bounded(lambda: serve.run(doubler.bind()), SERVE_RUN_S,
                     "serve.run")
    assert rt.get(handle.remote(4), timeout=60) == 8
    conn = http.client.HTTPConnection(cluster["host"], cluster["port"],
                                      timeout=60)
    conn.request("POST", "/doubler", body=json.dumps({"n": 21}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200 and json.loads(resp.read()) == \
        {"doubled": 42}
    conn.request("POST", "/nosuch", body="1",
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 404
    resp.read()
    conn.close()

    # the pinned decode loop refuses a replica that hosts no engine
    from ray_tpu_torch import api
    from ray_tpu_torch._private.worker import LLM_EXEC_METHOD

    replica = handle._replicas[0]
    ref = api._worker().submit_actor_task(
        replica._actor_id, LLM_EXEC_METHOD, (), {})[0]
    with pytest.raises(rt.RayTaskError, match="TypeError.*llm_deployment"):
        rt.get(ref, timeout=60)
    serve.delete("doubler")


# ------------------------------------------------------------- LLM serve


@pytest.fixture(scope="module")
def llm(cluster):
    """One continuous-batching replica (tests/torch_serve_targets.py's
    ProbedLLM, an _LLMCallable) shared by the SSE, disconnect and
    process tests."""
    from ray_tpu_torch.serve.api import Deployment
    from tests.torch_serve_targets import ProbedLLM

    app = Deployment(ProbedLLM, "llm", llm=True).bind(
        **_engine_kwargs(cluster, detach_grace_s=0.3))
    return bounded(lambda: serve.run(app), SERVE_RUN_S, "serve.run")


def test_llm_sse_end_to_end_matches_the_jax_engine(cluster, llm, oracle):
    """Port of test_serve_llm.py:657: tokens stream over SSE through the
    proxy, the handle and the pinned decode loop, equal to ray_tpu's
    engine on the same flax params."""
    conn, resp = _sse(cluster, "llm", {"tokens": [5, 9, 3],
                                       "max_new_tokens": 6})
    assert resp.status == 200
    items = _read_items(resp)
    conn.close()
    flat = _flat(items)
    assert [i for i, _ in flat] == list(range(6))
    assert items[-1]["done"] is True
    assert [t for _, t in flat] == oracle["sse"]
    st = rt.get(llm.method("stats")(), timeout=30)
    assert st["loop_running"] and st["used_pages"] == 0
    assert st["attention_impl"] == "paged"


def test_llm_disconnect_frees_kv_pages(cluster, llm):
    """Port of test_serve_llm.py:750: the client vanishes mid-stream;
    the proxy's failed write cancels the replica-side generator, and the
    engine recycles the sequence's pages after the grace window instead
    of decoding another ~200 tokens for nobody."""
    before = rt.get(llm.method("stats")(), timeout=30)
    conn, resp = _sse(cluster, "llm", {"tokens": [5, 9, 3],
                                       "max_new_tokens": 240})
    assert resp.status == 200
    resp.read(1)   # at least one token delivered
    conn.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         b"\x01\x00\x00\x00\x00\x00\x00\x00")  # RST
    conn.close()
    deadline = time.time() + 60
    st = {}
    while time.time() < deadline:
        st = rt.get(llm.method("stats")(), timeout=30)
        if st["cancelled"] > before["cancelled"] and st["used_pages"] == 0:
            break
        time.sleep(0.1)
    assert st.get("cancelled", 0) > before["cancelled"] \
        and st.get("used_pages") == 0, (before, st)


def test_replica_process_holds_nothing_of_jax_or_ray_tpu(cluster, llm):
    info = rt.get(llm.method("process")(), timeout=30)
    assert info["reference_roots"] == [], info
    assert info["pid"] != os.getpid()
    # a replica with no GPU demand is shown no card
    assert info["cuda_visible_devices"] == ""


def test_disaggregated_prefill_matches_the_jax_engine(cluster, oracle):
    """Port of test_serve_llm.py:975: ``llm_deployment(
    prefill_replicas=1)`` with both pools on half a card each; an SSE
    request's prefill runs on the prefill replica, its KV pack goes
    through the object store, and the decode replica attaches it.
    Tokens equal ray_tpu's engine's; the shipped-page counters move on
    both sides and both end with no page in use."""
    h = bounded(lambda: serve.run(serve.llm_deployment(
        "llm_disagg", prefill_replicas=1,
        ray_actor_options={"num_gpus": 0.5},
        **_engine_kwargs(cluster, detach_grace_s=5.0))), SERVE_RUN_S,
        "serve.run")
    pf = serve.get_handle("llm_disagg-prefill")
    conn, resp = _sse(cluster, "llm_disagg",
                      {"tokens": DISAGG_PROMPT, "max_new_tokens": 6})
    assert resp.status == 200
    items = _read_items(resp)
    conn.close()
    flat = _flat(items)
    assert [i for i, _ in flat] == list(range(6))
    assert [t for _, t in flat] == oracle["disagg"]
    std = rt.get(h.method("stats")(), timeout=30)
    stp = rt.get(pf.method("stats")(), timeout=30)
    assert std["kv_pages_shipped_in"] >= 3, std
    assert stp["kv_pages_shipped_out"] >= 3, stp
    assert std["used_pages"] == 0 and stp["used_pages"] == 0
    serve.delete("llm_disagg")
    serve.delete("llm_disagg-prefill")


# --------------------------------------------------------------- metrics


def test_llm_metrics_token_counters_match_the_jax_engine(oracle):
    """The port's engine records ``ray_tpu_llm_tokens_total`` by phase
    as ray_tpu's does: the same requests count the same tokens."""
    from ray_tpu_torch._private.metrics import llm_metrics
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(LlamaConfig(dtype=torch.float32, **MODEL),
                    device="cpu", params=oracle.params(), **KW)
    out, counts = _token_counts(llm_metrics, lambda: eng.generate_batch(
        [dict(r) for r in METRICS_REQUESTS]))
    jax_out, jax_counts = oracle["metrics"]
    assert out == jax_out
    assert counts == jax_counts, (counts, jax_counts)
    assert counts["prefill"] == sum(len(r["tokens"])
                                    for r in METRICS_REQUESTS)
    assert counts["decode"] > 0 and eng.stats()["used_pages"] == 0
