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
