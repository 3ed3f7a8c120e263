"""A serving cell: ``LLMEngine`` under ``run_loop``, fed by the mix.

Set-up draws the weights, builds the engine and starts its loop; the
mix's traffic then runs ``warmup_s`` before the window opens, so every
shape the window uses (the prefill chunk, the decode batch) has run and
the batch is full.  Each request is a thread that ``submit``s it and
reads ``iter_tokens`` to its end, stamping every token as it arrives.  A
closed loop keeps ``clients`` such threads, each sending its next
request when the last has finished; an open loop starts one at each
request's due time.

A wrapper around the engine's ``step`` (the harness's span around the
call into the engine) sums the wall of the steps that did work and
snapshots the engine's ``stats()`` and every sequence's progress at the
window's ends, and with ``--trace 1`` profiles ``TRACE_STEPS`` working
steps after the window.  When the window has closed, new requests stop,
every request due in the window is awaited to its first token (at most
``FIRST_TOKEN_WAIT_S``), and the rest are cancelled.

The check: a sample drawn from the seed of the finished requests, the
longest among them, of at least ``SAMPLE_TOKENS`` served tokens; the
plain reference runs once over each prompt and its served tokens, and
the number compared is the widest gap by which a served token's logit
lies below the reference's best at its position.
"""

from __future__ import annotations

import gc
import math
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import cells, device, program, traffic, trace, weights
from portbench.metrics import _work
from portbench.reference import mistral as ref

TRACE_STEPS = 24
FIRST_TOKEN_WAIT_S = 60.0
SAMPLE_TOKENS = 640
SAMPLE_MAX = 12


def _progress(sq) -> tuple:
    return (sq.pos, sq.state, len(sq.generated), len(sq.prompt))


class _Run:
    """The traffic and the engine's loop for one run."""

    def __init__(self, c: cells.Cell, eng):
        self.c, self.eng = c, eng
        self.lock = threading.Lock()
        self.records: List[dict] = []
        self.stop = threading.Event()
        self.traced = threading.Event()
        self.threads: List[threading.Thread] = []
        self.next_idx = 0
        self.exhausted = False
        self.max_lag_s = 0.0
        self.snaps: Dict[str, dict] = {}
        self.step_wall_s = 0.0
        self.prof = None
        self.trace_left = TRACE_STEPS if c.trace else 0
        self.trace_wall = 0.0

    # ------------------------------------------------ the engine's steps

    def snapshot(self) -> dict:
        with self.lock:
            seqs = {id(r["seq"]): _progress(r["seq"]) for r in self.records
                    if r["seq"] is not None}
        return {"t": time.perf_counter(), "stats": self.eng.stats(),
                "seqs": seqs}

    def wrap_step(self, t0: float, t_end: float) -> None:
        inner = self.eng.step
        cuda = self.c.device.startswith("cuda")

        def step() -> bool:
            now = time.perf_counter()
            if "t0" not in self.snaps and now >= t0:
                self.snaps["t0"] = self.snapshot()
            elif "t0" in self.snaps and "end" not in self.snaps \
                    and now >= t_end:
                self.snaps["end"] = self.snapshot()
            tracing = "end" in self.snaps and self.trace_left > 0
            if tracing and self.prof is None:
                if cuda:
                    torch.cuda.synchronize()
                self.snaps["trace0"] = self.snapshot()
                self.prof = trace.profile()
                self.prof.__enter__()
                self.trace_t0 = time.perf_counter()
            did = inner()
            if "t0" in self.snaps and "end" not in self.snaps and did:
                self.step_wall_s += time.perf_counter() - now
            if tracing and did:
                self.trace_left -= 1
                if self.trace_left == 0:
                    if cuda:
                        torch.cuda.synchronize()
                    self.trace_wall = time.perf_counter() - self.trace_t0
                    self.prof.__exit__(None, None, None)
                    self.snaps["trace1"] = self.snapshot()
                    self.traced.set()
            return did

        self.eng.step = step

    # ---------------------------------------------------------- traffic

    def consume(self, req: dict, due: float) -> None:
        rec = {"due": due, "prompt": req["tokens"],
               "max_new": req["max_new_tokens"], "times": [], "tokens": [],
               "failed": False, "seq": None}
        try:
            sq = self.eng.submit({"tokens": req["tokens"],
                                  "max_new_tokens": req["max_new_tokens"]})
            with self.lock:
                rec["seq"] = sq
                self.records.append(rec)
            for item in self.eng.iter_tokens(sq):
                t = time.perf_counter()
                rec["times"].extend([t] * len(item["tokens"]))
                rec["tokens"].extend(item["tokens"])
            self.eng.release(sq)
        except Exception as e:   # a failed request is counted, not raised
            rec["failed"], rec["error"] = True, repr(e)
            with self.lock:
                if rec["seq"] is None:
                    self.records.append(rec)

    def closed_client(self, reqs: List[dict]) -> None:
        while not self.stop.is_set():
            with self.lock:
                i = self.next_idx
                self.next_idx += 1
            if i >= len(reqs):
                self.exhausted = True
                return
            self.consume(reqs[i], time.perf_counter())

    def open_dispatch(self, reqs: List[dict], t_traffic: float) -> None:
        for req in reqs:
            due = t_traffic + req["due_s"]
            wait = due - time.perf_counter()
            if wait > 0 and self.stop.wait(wait):
                return
            if self.stop.is_set():
                return
            self.max_lag_s = max(self.max_lag_s, time.perf_counter() - due)
            th = threading.Thread(target=self.consume, args=(req, due),
                                  daemon=True)
            th.start()
            with self.lock:
                self.threads.append(th)
        self.exhausted = True


def _n_blocks(mix: dict, span_s: float) -> int:
    if mix["kind"] == "open_poisson":
        n = float(mix["rate_per_s"]) * span_s * 1.5 + mix["block"]
    else:
        n = float(mix["max_requests_per_s"]) * span_s
    return max(2, math.ceil(n / int(mix["block"])))


def _work_between(cfg: dict, a: dict, b: dict) -> dict:
    """Tokens the engine computed between two snapshots and the sum of
    their contexts; shared-prefix tokens were not computed and are taken
    out, each hit's as the leading positions of its prompt."""
    tokens = ctx = admitted = 0
    for key, (pos1, state1, _g1, plen) in b["seqs"].items():
        pos0, state0, _g0, _p = a["seqs"].get(key, (0, "queued", 0, plen))
        tokens += pos1 - pos0
        ctx += _work.causal_context_sum(pos0, pos1)
        if state0 == "queued" and state1 != "queued":
            admitted += plen
    shared = b["stats"]["prefix_tokens_shared"] \
        - a["stats"]["prefix_tokens_shared"]
    hits = b["stats"]["prefix_hits"] - a["stats"]["prefix_hits"]
    if hits:
        mean = shared // hits
        ctx -= hits * _work.causal_context_sum(0, mean)
    return {"tokens": tokens - shared, "context_sum": ctx,
            "shared_tokens": shared, "hits": hits,
            "admitted_prompt_tokens": admitted,
            "decode_steps": b["stats"]["decode_steps"]
            - a["stats"]["decode_steps"],
            "decode_secs": b["stats"]["decode_secs"]
            - a["stats"]["decode_secs"],
            "seconds": b["t"] - a["t"]}


def _decode_rows(a: dict, b: dict) -> tuple:
    """(lane-steps, context rows) of the decode steps between two
    snapshots: a sequence's j-th token (j >= 1) came from a decode step
    over prompt + j positions."""
    lanes = rows = 0
    for key, (_p1, _s1, g1, plen) in b["seqs"].items():
        g0 = max(a["seqs"].get(key, (0, "queued", 0, plen))[2], 1)
        for j in range(g0, g1):
            lanes += 1
            rows += plen + j
    return lanes, rows


def _sample(records: List[dict], seed: int) -> List[dict]:
    done = [r for r in records if not r["failed"]
            and len(r["tokens"]) == r["max_new"]]
    if not done:
        return []
    done.sort(key=lambda r: -(len(r["prompt"]) + r["max_new"]))
    rest = done[1:]
    order = np.random.default_rng([int(seed), 7]).permutation(len(rest))
    pick, n = [done[0]], len(done[0]["tokens"])
    for i in order:
        if n >= SAMPLE_TOKENS or len(pick) >= SAMPLE_MAX:
            break
        pick.append(rest[i])
        n += len(rest[i]["tokens"])
    return pick


def check(cfg: dict, seed: int, sample: List[dict], dev, control=None
          ) -> Dict[str, float]:
    """The widest gap below the reference's best logit of a served token
    (and, with ``control``, of the token that the control's logits put
    first at the same positions)."""
    ref.no_tf32()
    dt = getattr(torch, cfg["torch_dtype"])
    seqs = [torch.tensor(r["prompt"] + r["tokens"][:-1], device=dev)
            for r in sample]
    layer = lambda i: weights.layer(cfg, seed, i, dt, dev)  # noqa: E731
    embed = weights.embed(cfg, seed, dt, dev)
    final = {"final_norm.scale": torch.ones(cfg["hidden_size"], device=dev),
             "lm_head.weight": weights.head(cfg, seed, dt, dev)}
    served, gap = [], 0.0
    for r, lg in zip(sample, ref.logits_layerwise(seqs, cfg, layer, embed,
                                                  final)):
        rows = lg[len(r["prompt"]) - 1:]
        tok = torch.tensor(r["tokens"], device=dev)[:, None]
        gap = max(gap, float((rows.max(-1).values
                              - rows.gather(-1, tok)[:, 0]).max()))
        served.append(rows)
    out = {"max_logit_gap": gap if sample else math.inf}
    if control:
        cgap = 0.0
        for rows, lg in zip(served, ref.logits_layerwise(
                seqs, cfg, layer, embed, final, quant=control)):
            first = lg[-rows.shape[0]:].argmax(-1)[:, None]
            cgap = max(cgap, float((rows.max(-1).values
                                    - rows.gather(-1, first)[:, 0]).max()))
        out["control_max_logit_gap"] = cgap
    return out


def run(c: cells.Cell) -> dict:
    dev = torch.device(c.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg, mix = c.cfg, c.mix
    eng = program.engine(cfg, c.seed, c.device)
    if c.fault is not None:
        c.fault(eng)
    warm = float(mix["warmup_s"])
    reqs = traffic.requests(mix, c.seed, cfg["vocab_size"],
                            _n_blocks(mix, warm + c.seconds + 30))
    r = _Run(c, eng)
    loop = threading.Thread(target=eng.run_loop, daemon=True)
    loop.start()
    t_traffic = time.perf_counter()
    setup_s = time.monotonic() + warm - c.t_start
    t0, t_end = t_traffic + warm, t_traffic + warm + c.seconds
    r.wrap_step(t0, t_end)
    if mix["kind"] == "closed_loop":
        for _ in range(int(mix["clients"])):
            th = threading.Thread(target=r.closed_client, args=(reqs,),
                                  daemon=True)
            th.start()
            r.threads.append(th)
    else:
        disp = threading.Thread(target=r.open_dispatch,
                                args=(reqs, t_traffic), daemon=True)
        disp.start()
    time.sleep(max(0.0, t_end - time.perf_counter()))
    if c.trace:
        r.traced.wait(120.0)
    r.stop.set()
    # every request due in the window gets its first token, or a minute
    deadline = time.perf_counter() + FIRST_TOKEN_WAIT_S
    while time.perf_counter() < deadline:
        with r.lock:
            waiting = [x for x in r.records if t0 <= x["due"] < t_end
                       and not x["times"] and not x["failed"]]
        if not waiting:
            break
        time.sleep(0.05)
    with r.lock:
        live = [x["seq"] for x in r.records if x["seq"] is not None]
    for sq in live:
        if not sq.done:
            eng.cancel(sq.request_id)
    for th in list(r.threads):
        th.join(30.0)
    eng.stop()
    loop.join(30.0)

    in_window = [x for x in r.records if t0 <= x["due"] < t_end]
    record = {
        "kind": "serve", "cfg": cfg, "mix": mix, "chips": c.chips,
        "setup_s": setup_s, "t0": t0, "t_end": t_end,
        "window_s": c.seconds,
        "requests": [{"due": x["due"], "times": x["times"],
                      "failed": x["failed"] or (t0 <= x["due"] < t_end
                                                and not x["times"])}
                     for x in r.records],
        "attempted": len(in_window),
        "failed": sum(1 for x in in_window if x["failed"] or not x["times"]),
        "traffic_exhausted": r.exhausted, "max_lag_s": r.max_lag_s,
        "step_wall_s": r.step_wall_s,
    }
    if "t0" in r.snaps and "end" in r.snaps:
        record["work"] = _work_between(cfg, r.snaps["t0"], r.snaps["end"])
    if c.trace and r.prof is not None and "trace1" in r.snaps:
        record["trace"] = trace.reduce(r.prof, r.trace_wall)
        record["trace_decode"] = _decode_rows(r.snaps["trace0"],
                                              r.snaps["trace1"])
    record["device"] = device.info(c, cuda)
    if cuda:
        record["power_limit"] = device.power_limit()
    if "trace" in record:
        record["device"]["busy_s"] = record["trace"]["busy_s"]
        record["device"]["window_s"] = record["trace"]["window_s"]

    # ---- the check, once the engine is gone
    sample = _sample(r.records, c.seed)
    for x in r.records:
        x["seq"] = None
    del eng, r, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check(cfg, c.seed, sample, dev, c.control)
    record["tokens_compared"] = sum(len(x["tokens"]) for x in sample)
    control = numbers.pop("control_max_logit_gap", None)
    if control is not None:
        record["control_max_logit_gap"] = control
    record["correct"], record["checks"] = cells.judge(numbers, c.limits)
    record["reference_s"] = time.perf_counter() - t_ref
    return record
