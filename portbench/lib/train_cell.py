"""A training cell: the program's train step fed fresh batches.

Set-up builds the step (model, AdamW, ``step_fn``) with the seed's
weights and drives it through its first three steps with the window's
own call and feed, reading what the comparison needs on the way: each
step's loss, every leaf's first gradient as AdamW got it (its first
moment after one step over 1 - beta1) and every leaf's change after the
three steps.  The window then runs whole steps, each ended by reading
its loss, until ``seconds`` have passed.  After it the program's state
is freed and the plain reference runs the same three steps from the same
weights and batches.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict

import torch

from portbench.lib import cells, device, program, traffic, trace
from portbench.reference import mistral as ref

N_CHECKED = 3       # steps the reference follows
TRACE_STEPS = 3


def _leaf_change(cfg: dict, seed: int, params: Dict[str, torch.Tensor],
                 dtype, dev) -> Dict[str, float]:
    """Every leaf's ||now - initial||, the initial leaves drawn again
    from the seed one group at a time."""
    out, group, held = {}, None, {}
    for name, p in params.items():
        g = name.split(".")[1] if name.startswith("layers.") \
            else name.split(".")[0]
        if g != group:
            held, group = program.draw_group(cfg, seed, g, dtype, dev), g
        out[name] = float((p.detach().float() - held[name].float()).norm())
    return out


def compare(prog: dict, want: dict) -> Dict[str, float]:
    """The numbers held against their limits.  Norms are compared leaf
    by leaf as the gap between the two norms over the larger of the
    reference's norm of that leaf and of the median leaf; the worst leaf
    counts.  Leaves whose reference gradient is under a thousandth of
    the median leaf's move by round-off alone and are left out of the
    change."""
    loss = max(abs(a - b) / abs(b) for a, b in
               zip(prog["losses"], want["losses"]))
    g_ref = want["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad = max(abs(prog["grad_norms"][k] - g_ref[k]) / max(g_ref[k], g_med)
               for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    u_ref = want["changes"]
    u_med = statistics.median(u_ref[k] for k in moved)
    upd = max(abs(prog["changes"][k] - u_ref[k]) / max(u_ref[k], u_med)
              for k in moved)
    return {"loss_rel_gap": loss, "grad_norm_gap": grad,
            "change_norm_gap": upd}


def reference_run(cfg: dict, seed: int, mix: dict, dev, quant=None,
                  rows=None) -> dict:
    """The plain reference's three steps from the seed's weights and
    batches (``rows``: only the first rows of each batch, a fault)."""
    ref.no_tf32()
    leaves = {}
    for g in ["embed"] + [str(i) for i in range(cfg["num_hidden_layers"])] \
            + ["final_norm", "lm_head"]:
        for k, v in program.draw_group(cfg, seed, g, torch.float32,
                                       dev).items():
            leaves[k] = v
    batches = [traffic.batch_tokens(mix, seed, i, cfg["vocab_size"], dev)
               for i in range(N_CHECKED)]
    if rows is not None:
        batches = [b[:rows] for b in batches]
    out = ref.train_steps(leaves, batches, cfg, cfg["train"], quant)
    out["changes"] = _leaf_change(cfg, seed, leaves, torch.float32, dev)
    del leaves
    return out


def run(c: cells.Cell) -> dict:
    dev = torch.device(c.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg, mix = c.cfg, c.mix
    vocab = cfg["vocab_size"]
    b1 = cfg["train"]["betas"][0]

    if c.control:
        params = opt = named = step_fn = None
        prog = reference_run(cfg, c.seed, mix, dev, quant=c.control)
        steps, window_s, failed = 0, 0.0, 0
        t_window = time.monotonic()
    else:
        params, opt, step_fn = program.train_state(cfg, c.seed, c.device)
        if c.fault is not None:
            step_fn = c.fault(step_fn)
        named = dict(params.named_parameters())
        losses = []
        for i in range(N_CHECKED):
            tokens = traffic.batch_tokens(mix, c.seed, i, vocab, dev)
            params, opt, loss = step_fn(params, opt, tokens)
            losses.append(float(loss))
            if i == 0:
                grad_norms = {
                    k: float(opt.state[p]["exp_avg"].norm()) / (1 - b1)
                    if p in opt.state else 0.0 for k, p in named.items()}
        prog = {"losses": losses, "grad_norms": grad_norms,
                "changes": _leaf_change(cfg, c.seed, named,
                                        getattr(torch, cfg["train"]["param_dtype"]),
                                        dev)}

        # ---- the window: whole steps, each ended by its loss's read
        t_window = time.monotonic()
        step, steps, failed = N_CHECKED, 0, 0
        t0 = time.perf_counter()
        while True:
            tokens = traffic.batch_tokens(mix, c.seed, step, vocab, dev)
            params, opt, loss = step_fn(params, opt, tokens)
            value = float(loss)
            step += 1
            steps += 1
            failed += not math.isfinite(value)
            window_s = time.perf_counter() - t0
            if window_s >= c.seconds:
                break

    record = {"kind": "train", "cfg": cfg, "mix": mix, "chips": c.chips,
              "setup_s": t_window - c.t_start, "window_s": window_s,
              "steps": steps,
              "tokens": steps * int(mix["batch"]) * int(mix["seq_len"]),
              "attempted": steps, "failed": failed}

    if c.trace and params is not None:
        if cuda:
            torch.cuda.synchronize()
        with trace.profile() as prof:
            t0 = time.perf_counter()
            for _ in range(TRACE_STEPS):
                tokens = traffic.batch_tokens(mix, c.seed, step, vocab, dev)
                params, opt, loss = step_fn(params, opt, tokens)
                step += 1
            float(loss)
            wall = time.perf_counter() - t0
        record["trace"] = trace.reduce(prof, wall)
        record["trace_steps"] = TRACE_STEPS

    record["device"] = device.info(c, cuda)
    if cuda:
        record["power_limit"] = device.power_limit()
    if "trace" in record:
        record["device"]["busy_s"] = record["trace"]["busy_s"]
        record["device"]["window_s"] = record["trace"]["window_s"]

    # ---- the check, once the program's state is gone
    del params, opt, named, step_fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = reference_run(cfg, c.seed, mix, dev)
    numbers = compare(prog, want)
    record["correct"], record["checks"] = cells.judge(numbers, c.limits)
    record["reference_s"] = time.perf_counter() - t_ref
    record["losses"] = {"program": prog["losses"], "reference": want["losses"]}
    return record
