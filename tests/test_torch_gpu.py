"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

A CUDA kernel has no CPU mode, so every test here needs a CUDA device
and skips without one.  The file imports nothing of JAX, so it runs on a
machine with torch and a card alone:

    python -m pytest tests/test_torch_gpu.py -q

Tolerances, per element, |kernel - plain| <= atol + rtol * |plain|: the
kernels and the plain versions compute in fp32 from the same inputs and
round the output once to the input type.  fp32 outputs differ by
summation order (atol 1e-4); a bf16 output may land one rounding step,
at most 2^-7 of its value, away (atol 1e-3, rtol 2^-6 allows two).  The
bf16 flash kernel also rounds P to bf16 before P.V, so its check adds
``p_rounding_allowance`` (2^-8 * softmax(S) . |V|) per element.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.gpu
torch.set_num_threads(2)   # six xdist workers share the test machine

TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-3, 2 ** -6)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_close(out, ref, extra=None):
    atol, rtol = TOL[ref.dtype]
    diff = (out.float() - ref.float()).abs()
    allowed = atol + rtol * ref.float().abs()
    if extra is not None:
        allowed = allowed + extra
    assert bool((diff <= allowed).all()), \
        f"max err {float(diff.max())}, {float((diff / allowed).max())}x tol"


def _paged_case(dev, dtype, lens, heads, kv_heads, d, page_size, seed=0,
                width=None):
    """Random pools and shuffled pages; lanes 0 and 1 alias one set of
    pages when their lengths agree (a shared prefix).  The table is
    ``width`` wide (default: two past the longest lane)."""
    rng = np.random.default_rng(seed)
    used = [-(-n // page_size) for n in lens]
    num_pages = sum(used) + 4
    t = num_pages * page_size

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(dev, dtype)

    pages = list(rng.permutation(np.arange(1, num_pages)))
    table = np.zeros((len(lens), width or max(max(used), 1) + 2), np.int32)
    for b, u in enumerate(used):
        table[b, :u] = [pages.pop() for _ in range(u)]
    if len(lens) > 1 and lens[0] == lens[1]:
        table[1] = table[0]
    return (rand(len(lens), 1, heads, d), rand(t, kv_heads, d),
            rand(t, kv_heads, d), torch.from_numpy(table).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lens,heads,kv_heads,d,page_size,width", [
    ([300, 300, 0, 17, 1032], 32, 8, 128, 16, None),   # 8B decode shape
    ([13, 1, 0], 8, 8, 64, 4, None),                   # MHA, small pages
    ([700, 5], 16, 2, 128, 64, None),                  # G = 8
    ([300, 129], 32, 4, 128, 128, None),               # big pages
    # many splits; 256 ends on a split edge
    ([4000, 3000, 0, 3500, 256, 3999], 32, 8, 128, 16, 256),
    ([0, 0, 0], 8, 2, 64, 16, 64),                     # all lanes inactive
    ([2048, 512, 1], 64, 8, 128, 16, 256),             # G = 8, long
    ([1000, 77], 8, 8, 64, 128, 32),                   # pages of 128, wide
])
def test_paged_kernel_matches_plain(cuda, dtype, lens, heads, kv_heads, d,
                                    page_size, width):
    q, pk, pv, bt, cl = _paged_case(cuda, dtype, lens, heads, kv_heads, d,
                                    page_size, width=width)
    before = pa.LAUNCHES
    out = pa.paged_attention(q, pk, pv, bt, cl, page_size=page_size)
    ref = pa.paged_attention_ref(q, pk, pv, bt, cl, page_size=page_size)
    torch.cuda.synchronize()
    assert pa.LAUNCHES == before + 1
    assert bool(torch.isfinite(out).all())
    for lane, n in enumerate(lens):
        if n == 0:
            assert bool((out[lane] == 0).all())
    _assert_close(out, ref)


def test_paged_wrapper_raises_instead_of_falling_back(cuda):
    q, pk, pv, bt, cl = _paged_case(cuda, torch.float32, [5], 4, 2, 16, 4)
    before = pa.LAUNCHES
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q, pk, pv, bt, cl, page_size=4)
    assert pa.LAUNCHES == before


def _flash_check(dev, dtype, causal, b, s, t, h, hkv, d, seed=1):
    gen = torch.Generator(dev).manual_seed(seed)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(dtype)
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v, causal)
    ref = fa.flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert bool(torch.isfinite(out).all())
    extra = (fa.p_rounding_allowance(q, k, v, causal)
             if dtype == torch.bfloat16 else None)
    _assert_close(out, ref, extra)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,t,h,hkv,d", [
    (1, 256, 256, 8, 2, 64),
    (2, 512, 512, 4, 4, 128),
    (1, 192, 192, 8, 8, 64),      # S = T = 192: a half q tile, G = 1
    (2, 192, 192, 8, 2, 128),     # ... G = 4
    (1, 192, 320, 8, 1, 128),     # S != T, G = 8
    (1, 320, 192, 16, 2, 64),     # S > T, G = 8
])
def test_flash_kernel_matches_plain(cuda, dtype, causal, b, s, t, h, hkv,
                                    d):
    _flash_check(cuda, dtype, causal, b, s, t, h, hkv, d)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_at_8b_prefill_shape(cuda, dtype):
    _flash_check(cuda, dtype, True, 2, 2048, 2048, 32, 8, 128, seed=3)


def test_flash_wrapper_refuses_misaligned_pointer(cuda):
    shape = (1, 128, 4, 64)
    n = 128 * 4 * 64
    q = torch.zeros(n + 8, dtype=torch.bfloat16, device=cuda)[1:n + 1] \
        .view(shape)
    kv = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    assert q.is_contiguous() and q.data_ptr() % 16
    before = fa.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(q, kv, kv, True)
    assert fa.LAUNCHES == before


def test_flash_backward_on_gpu_matches_dense(cuda):
    from ray_tpu_torch.models.llama import dense_attention

    gen = torch.Generator(cuda).manual_seed(2)
    q, k, v = (torch.randn(1, 128, n, 64, generator=gen, device=cuda)
               for n in (4, 2, 2))
    grads = []
    for fn in (lambda *a: fa.flash_attention(*a, True),
               lambda *a: dense_attention(*a, causal=True)):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        fn(*xs).square().sum().backward()
        grads.append([x.grad for x in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _paged_split_kernels(prof) -> int:
    """The paged split kernels a profiler trace saw run, eager or
    replayed from a CUDA graph: one a paged_attention call."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and "paged_decode_split" in e.name)


def test_engine_paged_and_dense_agree_on_gpu(cuda):
    """fp32 greedy decode through the paged kernel equals the dense
    path; the kernel runs once per layer per decode step, by the
    profiler's count, and the wrapper counts the steps it launched
    eagerly (none: every decode step replays a graph)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = LlamaConfig(vocab_size=64, dim=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, hidden_dim=128, max_seq_len=64,
                      dtype=torch.float32)
    kw = dict(device=cuda, page_size=8, num_pages=33, max_batch=4,
              prefill_chunk=8)
    reqs = [{"tokens": [5, 9, 3], "max_new_tokens": 6},
            {"tokens": list(range(1, 21)), "max_new_tokens": 6}]
    paged = LLMEngine(cfg, **kw)
    before = pa.LAUNCHES
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = paged.generate_batch([dict(r) for r in reqs])
        torch.cuda.synchronize()
    st = paged.stats()
    assert _paged_split_kernels(prof) == cfg.n_layers * st["decode_steps"]
    assert pa.LAUNCHES - before == \
        cfg.n_layers * (st["decode_steps"] - st["decode_graph_replays"])
    dense = LLMEngine(cfg, params=paged._model.state_dict(),
                      attention_impl="dense", **kw)
    assert dense.generate_batch([dict(r) for r in reqs]) == out


def test_engine_prefills_together_what_it_prefills_alone_on_gpu(cuda):
    """fp32 prompts of four lengths prefilled in one step (four lanes,
    rows and context to the longest) give the first tokens each gives
    prefilled by an engine of its own."""
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = LlamaConfig(vocab_size=64, dim=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, hidden_dim=128, max_seq_len=64,
                      dtype=torch.float32)
    kw = dict(device=cuda, page_size=8, num_pages=33, max_batch=4,
              prefill_chunk=32)
    prompts = [[5, 9, 3], list(range(1, 21)), [3] * 13,
               list(range(30, 56))]
    together = LLMEngine(cfg, **kw)
    seqs = [together.submit({"tokens": p, "max_new_tokens": 1})
            for p in prompts]
    together.step()
    st = together.stats()
    assert st["prefill_steps"] == 1 and all(s.done for s in seqs)
    assert st["prefill_cells"] == 4 * 32 * 32   # rows 26 -> 32, hi 26 -> 32
    params = together._model.state_dict()
    for p, s in zip(prompts, seqs):
        alone = LLMEngine(cfg, params=params, **kw)
        assert alone.generate_batch([{"tokens": p, "max_new_tokens": 1}]) \
            == [list(s.generated)], p


@pytest.mark.parametrize("head_dim", [32, 16])
def test_engine_at_a_head_dim_the_kernel_refuses_serves_dense(cuda,
                                                              head_dim):
    """``auto`` resolves to dense decode where the paged kernel does not
    take the shape (head_dim 32 or 16), and the engine serves the same
    greedy tokens as an explicitly dense one, launching no kernel; an
    explicit ``paged`` engine at that shape still raises at its first
    decode step."""
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = LlamaConfig(vocab_size=64, dim=4 * head_dim, n_layers=2,
                      n_heads=4, n_kv_heads=2, hidden_dim=128,
                      max_seq_len=64, dtype=torch.float32)
    kw = dict(device=cuda, page_size=8, num_pages=33, max_batch=4,
              prefill_chunk=8)
    reqs = [{"tokens": [5, 9, 3], "max_new_tokens": 6},
            {"tokens": list(range(1, 21)), "max_new_tokens": 6}]
    auto = LLMEngine(cfg, **kw)
    assert auto.stats()["attention_impl"] == "dense"
    before = pa.LAUNCHES
    out = auto.generate_batch([dict(r) for r in reqs])
    assert pa.LAUNCHES == before
    assert all(len(o) == 6 for o in out)
    dense = LLMEngine(cfg, params=auto._model.state_dict(),
                      attention_impl="dense", **kw)
    assert dense.generate_batch([dict(r) for r in reqs]) == out
    paged = LLMEngine(cfg, params=auto._model.state_dict(),
                      attention_impl="paged", **kw)
    with pytest.raises(ValueError, match="head_dim"):
        paged.generate_batch([dict(reqs[0])])


GRAPH_CFG = dict(vocab_size=64, dim=256, n_layers=2, n_heads=4,
                 n_kv_heads=2, hidden_dim=128, max_seq_len=64)
# 16 pages of 4 a sequence: the width buckets are 4 and 16
GRAPH_KW = dict(page_size=4, num_pages=65, max_batch=4, prefill_chunk=8)


def _graphed_and_dense(dev, dtype=torch.float32, **kw):
    """A paged engine on the card, which replays its decode graphs, and
    an eager dense engine with the same weights."""
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = LlamaConfig(dtype=dtype, **GRAPH_CFG)
    kw = {**GRAPH_KW, **kw}
    graphed = LLMEngine(cfg, device=dev, **kw)
    assert graphed.stats()["decode_graph_captures"] == 2
    dense = LLMEngine(cfg, params=graphed._model.state_dict(), device=dev,
                      attention_impl="dense", **kw)
    assert dense.stats()["decode_graph_captures"] == 0
    return graphed, dense


def _drain(engine, rounds=300):
    for _ in range(rounds):
        if not engine.step():
            return


def _all_replayed(engine):
    st = engine.stats()
    assert st["decode_steps"] > 0
    assert st["decode_graph_replays"] == st["decode_steps"], st


def _greedy_within(engine, prompt, generated):
    """Each generated token's logit under the no-cache forward over the
    prompt and the tokens before it is within the file's tolerance for
    the dtype of the best logit at its position."""
    atol, rtol = TOL[engine.cfg.dtype]
    full = torch.tensor([list(prompt) + list(generated)], dtype=torch.int32,
                        device=engine.device)
    with torch.no_grad():
        lg = engine._model(full)[0].float()
    for j, tok in enumerate(generated):
        row = lg[len(prompt) + j - 1]
        best = float(row.max())
        assert best - float(row[tok]) <= atol + rtol * abs(best), (j, tok)


@pytest.mark.parametrize("dtype", DTYPES)
def test_graphed_decode_crosses_a_width_bucket_on_gpu(cuda, dtype):
    """Contexts that grow from 4 pages past 4 mid-stream move the step
    from the width-4 graph to the width-16 one; every decode step is a
    replay.  fp32 gives exactly the dense engine's greedy tokens; bf16
    gives a token within the bf16 tolerance of the best at each
    position."""
    graphed, dense = _graphed_and_dense(cuda, dtype)
    reqs = [{"tokens": list(range(3, 17)), "max_new_tokens": 12},
            {"tokens": [5, 9, 3], "max_new_tokens": 20},
            {"tokens": [7] * 10, "max_new_tokens": 9}]
    out = graphed.generate_batch([dict(r) for r in reqs])
    _all_replayed(graphed)
    assert graphed.stats()["used_pages"] == 0
    if dtype == torch.float32:
        assert dense.generate_batch([dict(r) for r in reqs]) == out
    else:
        for r, o in zip(reqs, out):
            assert len(o) == r["max_new_tokens"]
            _greedy_within(graphed, r["tokens"], o)


def _cow_pair(engine):
    """A prompt of three pages, then one that shares its first two and
    diverges inside the third (a copy-on-write split), decoding
    together."""
    base = list(range(1, 13))
    s1 = engine.submit({"tokens": base, "max_new_tokens": 10})
    for _ in range(3):
        engine.step()
    s2 = engine.submit({"tokens": base[:10] + [40, 41, 42],
                        "max_new_tokens": 10})
    _drain(engine)
    assert engine.stats()["cow_splits"] == 1
    return [list(s1.generated), list(s2.generated)]


def test_graphed_decode_after_a_copy_on_write_split_on_gpu(cuda):
    graphed, dense = _graphed_and_dense(cuda)
    assert _cow_pair(graphed) == _cow_pair(dense)
    _all_replayed(graphed)


def _cancel_one(engine):
    """Three sequences decode; the second is cancelled after four decode
    steps and the others go on."""
    seqs = [engine.submit({"tokens": p, "max_new_tokens": 12})
            for p in ([5, 9, 3], list(range(20, 31)), [2] * 6)]
    while engine.stats()["decode_steps"] < 4:
        engine.step()
    assert engine.cancel(seqs[1].request_id)
    _drain(engine)
    assert engine.stats()["used_pages"] == 0
    return [list(s.generated) for s in seqs]


def test_graphed_decode_goes_on_after_a_cancel_on_gpu(cuda):
    graphed, dense = _graphed_and_dense(cuda)
    got = _cancel_one(graphed)
    assert got == _cancel_one(dense)
    assert len(got[0]) == len(got[2]) == 12 and len(got[1]) < 12
    _all_replayed(graphed)


def test_graphed_decode_of_an_imported_kv_pack_on_gpu(cuda):
    """A KV pack exported by ``prefill_request`` is scattered eagerly
    before the replay that reads it: the decode engine gives the tokens
    a dense engine gives after its own prefill."""
    graphed, dense = _graphed_and_dense(cuda)
    from ray_tpu_torch.serve.llm import LLMEngine

    prefill = LLMEngine(graphed.cfg, params=graphed._model.state_dict(),
                        device=cuda, **GRAPH_KW)
    prompt = list(range(2, 21))
    req = {"tokens": prompt, "max_new_tokens": 8, "request_id": "ship"}
    payload = prefill.prefill_request(dict(req))
    s = graphed.submit(dict(req), kv_pack=(payload["meta"],
                                            payload["rows"]))
    _drain(graphed)
    assert graphed.stats()["kv_pages_shipped_in"] == 5
    assert dense.generate_batch([dict(req)]) == [list(s.generated)]
    _all_replayed(graphed)


def test_graphed_sampling_replays_its_seeded_stream_on_gpu(cuda):
    """A sampling engine's graph ends at the picked logits and draws
    eagerly from the engine's generator: one seed gives one stream,
    each token among the five best at its position."""
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = LlamaConfig(dtype=torch.float32, **GRAPH_CFG)
    req = {"tokens": [5, 9, 3], "max_new_tokens": 16}
    streams = []
    for _ in range(2):
        eng = LLMEngine(cfg, device=cuda, seed=7, temperature=0.8, top_k=5,
                        **GRAPH_KW)
        streams.append(eng.generate_batch([dict(req)])[0])
        _all_replayed(eng)
    assert streams[0] == streams[1] and len(streams[0]) == 16
    full = torch.tensor([req["tokens"] + streams[0]], dtype=torch.int32,
                        device=cuda)
    with torch.no_grad():
        lg = eng._model(full)[0]
    for j, tok in enumerate(streams[0]):
        top5 = set(lg[len(req["tokens"]) + j - 1].topk(5).indices.tolist())
        assert tok in top5, (j, tok, top5)


def test_train_step_on_gpu_loss_falls(cuda):
    """A tiny bf16 train step with fp32 master weights on the card: the
    loss of one batch falls, and with remat each step launches the flash
    kernel twice per layer (the forward, then its recompute)."""
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.train.gspmd import build_llama_train_state

    cfg = LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, hidden_dim=512, max_seq_len=512,
                      remat=True)
    params, opt, step, _ = build_llama_train_state(
        cfg, make_mesh(MeshSpec(dp=-1)), learning_rate=1e-3)
    assert params.lm_head.weight.dtype == torch.float32
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 512)).astype(np.int32)
    before = fa.LAUNCHES
    losses = []
    for _ in range(5):
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))
    assert fa.LAUNCHES - before == 5 * 2 * cfg.n_layers
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_one_rank_nccl_step_matches_the_one_device_step(cuda, tmp_path):
    """The multi-process path at one rank over nccl (a DeviceMesh, FSDP2's
    hooks, the global loss) against the one-device step from the same
    seed: losses within 1e-5 relative (the two sum the loss in other
    orders)."""
    from ray_tpu_torch.parallel import (MeshSpec, init_distributed,
                                        make_mesh, shutdown_distributed)
    from ray_tpu_torch.train.gspmd import build_llama_train_state

    cfg = LlamaConfig(vocab_size=256, dim=256, n_layers=2, n_heads=4,
                      n_kv_heads=2, hidden_dim=512, max_seq_len=512,
                      remat=True)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 512)).astype(np.int32)

    def losses(mesh):
        params, opt, step, _ = build_llama_train_state(cfg, mesh,
                                                       learning_rate=1e-3)
        return [float(step(params, opt, tokens)[2]) for _ in range(3)]

    one_device = losses(make_mesh(MeshSpec(dp=-1)))
    init_distributed("file://" + str(tmp_path / "rendezvous"), 1, 0)
    try:
        mesh = make_mesh(MeshSpec(fsdp=-1))
        assert mesh.device_mesh is not None
        one_rank = losses(mesh)
    finally:
        shutdown_distributed()
    for a, b in zip(one_rank, one_device):
        assert abs(a - b) <= 1e-5 * abs(b), (one_rank, one_device)


# ---------------------------------------------------------- the runtime


@pytest.fixture
def port_cluster(cuda, tmp_path, monkeypatch):
    import ray_tpu_torch as rt

    monkeypatch.setenv("RT_TMPDIR", str(tmp_path))
    rt.init(num_cpus=2, object_store_memory=256 << 20)
    try:
        yield rt
    finally:
        rt.shutdown()


def test_cuda_tensor_through_the_store_lands_on_the_receivers_card(
        port_cluster):
    """A CUDA tensor put by the driver comes back bit for bit on the
    current CUDA device of a GPU-pinned actor, and one returned by the
    actor lands on the driver's."""
    rt = port_cluster

    @rt.remote(num_gpus=1)
    class Receiver:
        def take(self, boxed):
            import os

            got = rt.get(boxed[0])
            return (str(got.device), torch.cuda.current_device(),
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                    got.cpu(), got * 2)

    x = torch.randn(1 << 20, device="cuda").to(torch.bfloat16)
    r = Receiver.remote()
    device, current, visible, host, doubled = rt.get(
        r.take.remote([rt.put(x)]), timeout=180)
    assert device == f"cuda:{current}" and len(visible.split(",")) == 1
    assert torch.equal(host, x.cpu())
    assert doubled.is_cuda and torch.equal(doubled, x * 2)


def test_train_loop_thread_drives_the_workers_card(port_cluster):
    """The worker joins its process group on the actor's exec thread and
    the loop runs in a thread of its own: with the lease's one card
    visible, both drive cuda:0, and a collective from the loop's thread
    runs over nccl on it."""
    import socket
    import time

    import cloudpickle

    from ray_tpu_torch.train import WorkerGroup

    def loop():
        import os

        import torch.distributed as dist

        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        return {"current": torch.cuda.current_device(),
                "count": torch.cuda.device_count(),
                "backend": dist.get_backend(), "sum": float(x.sum()),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    group = WorkerGroup(1, {"GPU": 1})
    try:
        assert group.execute("init_distributed", f"localhost:{port}", 1,
                             0, timeout=180) == [1]
        group.execute("run_async", cloudpickle.dumps(loop), None)
        for _ in range(1200):
            (p,) = group.execute("poll")
            if p["done"]:
                break
            time.sleep(0.05)
        assert p["error"] is None and p["done"]
        assert p["final"] == {"current": 0, "count": 1, "backend": "nccl",
                              "sum": 4.0, "visible": p["final"]["visible"]}
        assert len(p["final"]["visible"].split(",")) == 1
    finally:
        group.shutdown()


def test_llama_stages_on_gpu_equal_the_model_and_launch_flash(cuda):
    """Two LlamaStages drawn from the model's seed hold its weights on
    the card, and chained they give its logits, each block's attention
    through the flash kernel (S = 512, bf16)."""
    from ray_tpu_torch.models.llama import LlamaModel, LlamaStage

    cfg = LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=2,
                      n_kv_heads=1, hidden_dim=512, max_seq_len=512)
    model = LlamaModel(cfg, device=cuda, seed=3)
    first = LlamaStage(cfg, 0, 1, first=True, device=cuda, seed=3)
    last = LlamaStage(cfg, 1, 2, last=True, device=cuda, seed=3)
    sd = model.state_dict()
    for stage in (first, last):
        for k, v in stage.state_dict().items():
            assert torch.equal(v, sd[k]), k
    tokens = torch.randint(0, cfg.vocab_size, (2, 512), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(0))
    before = fa.LAUNCHES
    with torch.no_grad():
        got = last(first(tokens))
        want = model(tokens)
    torch.cuda.synchronize()
    assert fa.LAUNCHES - before == 2 * cfg.n_layers
    assert torch.equal(got, want)
