"""Plain PyTorch Mistral 7B: the forward pass, the loss, and AdamW.

Written from the published description of Mistral-7B-v0.3
(huggingface.co/mistralai/Mistral-7B-v0.3, ``MistralForCausalLM``): a
pre-norm decoder with RMSNorm (eps from the config), grouped-query
attention with rotary embeddings that rotate halves (inverse frequencies
theta^(-2i/d)), causal, no sliding window in v0.3, a SwiGLU MLP
``w2(silu(w1 x) * w3 x)``, a final RMSNorm and an untied output head.
The configuration is the harness's JSON of the published keys.

It computes in float32 with TF32 off, imports nothing of the program,
and takes its weights as a mapping of plain tensors (the harness draws
them from the seed).  ``quant="fp8"`` rounds both operands of every
weight product to float8 e4m3 (weights with one scale a tensor,
activations with one a row) and so stands for the step below the
program's bf16: the control that the comparison must refuse.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0    # largest float8 e4m3 value


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale that maps its largest
    magnitude (over ``dim``, or the whole tensor) to 448, back in fp32."""
    amax = (x.abs().amax(dim=dim, keepdim=True) if dim is not None
            else x.abs().max())
    scale = FP8_MAX / amax.clamp_min(1e-12)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
           ) -> torch.Tensor:
    w = w.float()
    if quant == "fp8":
        # straight through: the rounding is a constant offset, so the
        # backward pass sees the rounded operands' products
        xq = x + (_fp8(x.detach(), -1) - x.detach())
        wq = w + (_fp8(w.detach(), None) - w.detach())
        return F.linear(xq, wq)
    return F.linear(x, w)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [S, H, D] at ``positions`` [S]; halves rotate."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = (positions.double()[:, None] * inv).float()
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal GQA over one sequence: q [S, H, D], k/v [S, Hkv, D]."""
    s, h, d = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("shd,thd->hst", q, k) / math.sqrt(d)
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    return torch.einsum("hst,thd->shd", scores.softmax(-1), v)


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], i: int, cfg: dict,
          quant: Optional[str] = None) -> torch.Tensor:
    """Decoder block ``i`` over one sequence's hidden states [S, hidden]."""
    s = x.shape[0]
    p = f"layers.{i}."
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    pos = torch.arange(s, device=x.device)
    h = rms_norm(x, w[p + "attn_norm.scale"], cfg["rms_norm_eps"])
    q = linear(h, w[p + "attn.wq.weight"], quant).view(s, -1, hd)
    k = linear(h, w[p + "attn.wk.weight"], quant).view(s, -1, hd)
    v = linear(h, w[p + "attn.wv.weight"], quant).view(s, -1, hd)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    x = x + linear(attention(q, k, v).reshape(s, -1),
                   w[p + "attn.wo.weight"], quant)
    h = rms_norm(x, w[p + "mlp_norm.scale"], cfg["rms_norm_eps"])
    return x + linear(F.silu(linear(h, w[p + "mlp.w1.weight"], quant))
                      * linear(h, w[p + "mlp.w3.weight"], quant),
                      w[p + "mlp.w2.weight"], quant)


def logits(tokens: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict,
           quant: Optional[str] = None) -> torch.Tensor:
    """One sequence [S] -> logits [S, vocab], all weights in ``w``."""
    x = w["embed.weight"][tokens.long()].float()
    for i in range(cfg["num_hidden_layers"]):
        x = block(x, w, i, cfg, quant)
    x = rms_norm(x, w["final_norm.scale"], cfg["rms_norm_eps"])
    return linear(x, w["lm_head.weight"], quant)


@torch.no_grad()
def logits_layerwise(seqs: List[torch.Tensor], cfg: dict,
                     layer_weights: Callable[[int], Dict[str, torch.Tensor]],
                     embed: torch.Tensor, final: Dict[str, torch.Tensor],
                     quant: Optional[str] = None):
    """The logits of several sequences [S_i] -> [S_i, vocab], one layer
    at a time over all of them, so only one layer's weights are held
    (``layer_weights(i)`` draws block i's); yields each sequence's
    logits in turn, so only one is held."""
    xs = [embed[t.long()].float() for t in seqs]
    for i in range(cfg["num_hidden_layers"]):
        w = layer_weights(i)
        xs = [block(x, w, i, cfg, quant) for x in xs]
        del w
    for n in range(len(xs)):
        x, xs[n] = xs[n], None
        yield linear(rms_norm(x, final["final_norm.scale"],
                              cfg["rms_norm_eps"]),
                     final["lm_head.weight"], quant)


def next_token_loss_sum(tokens: torch.Tensor, w: Dict[str, torch.Tensor],
                        cfg: dict, quant: Optional[str] = None
                        ) -> torch.Tensor:
    """Summed cross entropy of each position's next token, one sequence."""
    out = logits(tokens[:-1], w, cfg, quant)
    return F.cross_entropy(out, tokens[1:].long(), reduction="sum")


class AdamW:
    """Decoupled AdamW: p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas, eps: float, weight_decay: float):
        self.params = params
        self.lr, self.eps, self.wd = lr, eps, weight_decay
        self.b1, self.b2 = betas
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps)
            p.sub_(self.lr * (upd + self.wd * p))


def train_steps(w: Dict[str, torch.Tensor], batches: List[torch.Tensor],
                cfg: dict, opt_cfg: dict, quant: Optional[str] = None
                ) -> dict:
    """AdamW steps on the mean next-token loss of each batch [B, S], in
    place on ``w`` (fp32 leaves).  Rows go through one at a time and
    their gradients add up, so one row's activations are held.  Returns
    each step's loss, the first step's gradient norm of every leaf, and
    the leaves themselves after the steps."""
    opt = AdamW(w, opt_cfg["learning_rate"], opt_cfg["betas"],
                opt_cfg["eps"], opt_cfg["weight_decay"])
    losses, first_grad_norms = [], None
    for p in w.values():
        p.requires_grad_(True)
    for batch in batches:
        n_targets = batch.shape[0] * (batch.shape[1] - 1)
        total = 0.0
        for row in batch:
            loss = next_token_loss_sum(row, w, cfg, quant) / n_targets
            loss.backward()
            total += float(loss.detach())
        grads = {k: p.grad for k, p in w.items()}
        if first_grad_norms is None:
            first_grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        opt.step(grads)
        for p in w.values():
            p.grad = None
        losses.append(total)
    for p in w.values():
        p.requires_grad_(False)
    return {"losses": losses, "grad_norms": first_grad_norms}
