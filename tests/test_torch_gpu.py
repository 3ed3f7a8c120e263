"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

A CUDA kernel has no CPU mode, so every test here needs a CUDA device
and skips without one.  The file imports nothing of JAX, so it runs on a
machine with torch and a card alone:

    python -m pytest tests/test_torch_gpu.py -q

Tolerances, per element, |kernel - plain| <= atol + rtol * |plain|: the
kernels and the plain versions compute in fp32 from the same inputs and
round the output once to the input type.  fp32 outputs differ by
summation order (atol 1e-4); a bf16 output may land one rounding step,
at most 2^-7 of its value, away (atol 1e-3, rtol 2^-6 allows two).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-3, 2 ** -6)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_close(out, ref):
    atol, rtol = TOL[ref.dtype]
    diff = (out.float() - ref.float()).abs()
    allowed = atol + rtol * ref.float().abs()
    assert bool((diff <= allowed).all()), \
        f"max err {float(diff.max())}, {float((diff / allowed).max())}x tol"


def _paged_case(dev, dtype, lens, heads, kv_heads, d, page_size, seed=0):
    """Random pools and shuffled pages; lanes 0 and 1 alias one set of
    pages when their lengths agree (a shared prefix)."""
    rng = np.random.default_rng(seed)
    used = [-(-n // page_size) for n in lens]
    num_pages = sum(used) + 4
    t = num_pages * page_size

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(dev, dtype)

    pages = list(rng.permutation(np.arange(1, num_pages)))
    table = np.zeros((len(lens), max(max(used), 1) + 2), np.int32)
    for b, u in enumerate(used):
        table[b, :u] = [pages.pop() for _ in range(u)]
    if len(lens) > 1 and lens[0] == lens[1]:
        table[1] = table[0]
    return (rand(len(lens), 1, heads, d), rand(t, kv_heads, d),
            rand(t, kv_heads, d), torch.from_numpy(table).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lens,heads,kv_heads,d,page_size", [
    ([300, 300, 0, 17, 1032], 32, 8, 128, 16),   # 8B decode shape
    ([13, 1, 0], 8, 8, 64, 4),                   # MHA, small pages
    ([700, 5], 16, 2, 128, 64),                  # G = 8, two tiles a page
    ([300, 129], 32, 4, 128, 128),               # big pages, fp32 ring fit
])
def test_paged_kernel_matches_plain(cuda, dtype, lens, heads, kv_heads, d,
                                    page_size):
    q, pk, pv, bt, cl = _paged_case(cuda, dtype, lens, heads, kv_heads, d,
                                    page_size)
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,hkv,d", [(1, 256, 8, 2, 64),
                                         (2, 512, 4, 4, 128)])
def test_flash_kernel_matches_plain(cuda, dtype, causal, b, s, h, hkv, d):
    gen = torch.Generator(cuda).manual_seed(1)
    q = torch.randn(b, s, h, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, s, hkv, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, s, hkv, d, generator=gen, device=cuda).to(dtype)
    before = fa.LAUNCHES
    out = fa.flash_attention(q, k, v, causal)
    ref = fa.flash_attention_ref(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    _assert_close(out, ref)


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


def test_engine_paged_and_dense_agree_on_gpu(cuda):
    """fp32 greedy decode through the paged kernel equals the dense
    path; the kernel runs once per layer per decode step."""
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
    out = paged.generate_batch([dict(r) for r in reqs])
    assert pa.LAUNCHES - before == \
        cfg.n_layers * paged.stats()["decode_steps"]
    dense = LLMEngine(cfg, params=paged._model.state_dict(),
                      attention_impl="dense", **kw)
    assert dense.generate_batch([dict(r) for r in reqs]) == out
