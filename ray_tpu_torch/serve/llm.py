"""LLM serving tier: continuous batching over a paged KV cache.

The port of ray_tpu/serve/llm.py's :class:`LLMEngine`.  Admission,
paging, the copy-on-write prefix index, deadlines, disaggregated-prefill
export/import, save/restore and the stepping loop are the same; only the
framework seams differ:

  - one eager :meth:`LLMEngine._forward` over device tensors replaces the
    jitted stepper.  Greedy decoding is ``argmax``; sampling is
    temperature + static top-k + ``torch.multinomial`` drawing from an
    engine-owned ``torch.Generator`` seeded from ``seed``;
  - the KV pools are updated in place (``index_copy_``) where the JAX
    engine donated them to jit;
  - paged decode runs the paged-attention CUDA kernel
    (ops/paged_attention.py) over block tables whose width snaps to the
    same power-of-four buckets.

Request contract (token-level; tokenization is the client's concern):
  {"tokens": [int, ...],        # prompt token ids
   "max_new_tokens": int,       # decode budget (>= 1)
   "eos": int | None,           # optional stop token
   "request_id": str | None,    # idempotency key: a retried request
                                # re-attaches to the live sequence
   "deadline_ms": float | None} # absolute epoch-ms deadline; combined
                                # (tighter wins) with the ambient one
Each streamed item is {"i": <first generation index>, "tokens":
[<id>, ...], "done": <bool>}; items coalesce every token generated since
the consumer last drained.

Admission is a bounded head-of-line queue: a full queue (or a prompt
that can never fit the page budget) raises :class:`LLMOverloadedError`.
Sequences whose consumer vanished keep their pages only for
``llm_detach_grace_s``, then are cancelled and recycled.

Copy-on-write prefix sharing (``llm_prefix_sharing``): page-aligned
token-prefix blocks are hashed into a refcounted prefix index as prefill
completes them; a new sequence whose prompt prefix matches attaches to
the SAME physical pages and prefills from the first unshared token.  A
divergence mid-page copies the shared head of that page into a private
page before the diverging tokens are written.

Disaggregated prefill: ``prefill_request`` runs only the chunked
prefill and exports the finished KV rows to host memory; another engine
attaches them by request (``submit(kv_pack=(meta, rows))``) and starts
at its first decode step.  The pool layout [T, Hkv, D] per layer is the
JAX engine's, so a pack exported by either engine attaches to the other.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ray_tpu_torch._private import deadlines
from ray_tpu_torch._private.config import config
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.errors import DeadlineExceededError
from ray_tpu_torch.models.llama import (LlamaConfig, LlamaModel,
                                        copy_kv_slots, gather_kv_slots,
                                        make_kv_pools, scatter_kv_slots)

__all__ = ["LLMEngine", "LLMOverloadedError"]


class LLMOverloadedError(RuntimeError):
    """Admission shed: queue full or the prompt cannot be paged in."""


# sequence states
_QUEUED = "queued"
_PREFILL = "prefill"
_DECODE = "decode"
_SHIP = "ship"  # prefill-only sequence whose pages were just exported

# prefix-index chain seed: block k's key hashes (parent key || block
# tokens), so one digest equality implies the WHOLE prefix matches
_PREFIX_SEED = b"rtpu-prefix-v1"


def _chain_hash(parent: bytes, block) -> bytes:
    import hashlib

    h = hashlib.blake2b(parent, digest_size=16)
    for t in block:
        h.update(int(t).to_bytes(4, "little", signed=True))
    return h.digest()


class _Seq:
    __slots__ = ("request_id", "prompt", "prefill_tokens", "generated",
                 "max_new", "eos", "block_table", "pos", "state", "done",
                 "error", "attach_count", "detached_at", "done_at",
                 "submitted_at", "first_token_at", "cancelled",
                 "slot_cache", "cond", "deadline", "kv_import",
                 "prefill_export", "export_payload")

    def __init__(self, request_id: str, prompt: List[int], max_new: int,
                 eos: Optional[int], preknown: Optional[List[int]] = None):
        self.request_id = request_id
        # physical slot per position, vectorized at admission; cond is
        # per-sequence so a token emit wakes THIS stream's consumer
        self.slot_cache = None
        self.cond: Optional[threading.Condition] = None
        self.prompt = list(prompt)
        self.generated: List[int] = list(preknown or [])
        # restored sequences re-prefill prompt + already-known tokens in
        # one pass; fresh sequences prefill just the prompt
        self.prefill_tokens = self.prompt + self.generated
        self.max_new = int(max_new)
        self.eos = eos
        self.block_table: List[int] = []
        self.pos = 0                  # tokens whose KV is in the cache
        self.state = _QUEUED
        self.done = False
        self.error: Optional[BaseException] = None
        self.attach_count = 0
        self.detached_at: Optional[float] = None
        self.done_at: Optional[float] = None
        self.submitted_at = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.cancelled = False
        # absolute wall-clock deadline (epoch seconds; 0 = unbounded)
        self.deadline = 0.0
        # disaggregated prefill: shipped KV rows waiting to be scattered
        # into this engine's pools (decode side), or the flag/result of
        # a prefill-only pass (prefill side)
        self.kv_import: Optional[Dict[str, Any]] = None
        self.prefill_export = False
        self.export_payload: Optional[Dict[str, Any]] = None

    @property
    def total_len(self) -> int:
        return len(self.prompt) + self.max_new


class LLMEngine:
    """Continuous-batching decode engine over a paged KV cache.

    One engine per replica.  ``step()`` is called only by ``run_loop``
    or by an inline loop such as ``generate_batch``; request threads
    touch the engine only through ``submit``/``iter_tokens``/
    ``release`` under the engine lock.

    Paging: the cache is ``num_pages`` pages of ``page_size`` slots per
    layer; page 0 is the garbage page for inactive batch lanes and
    prefill padding.  A sequence's pages are allocated UP FRONT for
    prompt + max_new at admission and recycled the moment it finishes,
    errors, or is cancelled.

    ``params`` is None (initialize from ``seed`` with flax's scales), a
    flax-layout tree of ray_tpu's LlamaModel (carried across by
    models.convert.params_from_flax), or a state_dict of the port's
    LlamaModel.  ``device`` defaults to ``cuda``.
    """

    def __init__(self, cfg=None, *, model: Any = "tiny",
                 params: Any = None, seed: int = 0,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 detach_grace_s: Optional[float] = None,
                 prefill_lanes: Optional[int] = None,
                 stream_flush_tokens: Optional[int] = None,
                 dtype: Any = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 prefix_sharing: Optional[bool] = None,
                 attention_impl: Optional[str] = None,
                 device: Any = None):
        if cfg is None:
            if isinstance(model, LlamaConfig):
                cfg = model
            elif isinstance(model, dict):
                cfg = LlamaConfig(**model)
            else:
                cfg = getattr(LlamaConfig, str(model))()
        if dtype is not None:
            import dataclasses

            cfg = dataclasses.replace(cfg, dtype=dtype)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.page_size = int(page_size or config.llm_page_size)
        self.max_batch = int(max_batch or config.llm_max_batch_size)
        self.prefill_chunk = int(prefill_chunk or config.llm_prefill_chunk)
        self.max_queue = int(max_queue or config.llm_admission_queue)
        self.detach_grace_s = float(
            detach_grace_s if detach_grace_s is not None
            else config.llm_detach_grace_s)
        self.prefill_lanes = max(1, min(
            int(prefill_lanes or config.llm_prefill_lanes),
            self.max_batch))
        self.stream_flush_tokens = max(1, int(
            stream_flush_tokens or config.llm_stream_flush_tokens))
        self.pages_per_seq = -(-cfg.max_seq_len // self.page_size)
        if num_pages is None:
            num_pages = int(config.llm_kv_pages) or (
                1 + self.max_batch * self.pages_per_seq)
        # +1: page 0 is the garbage page, never allocated
        self.num_pages = max(int(num_pages), 2)
        self.ctx_len = self.pages_per_seq * self.page_size

        # decode attention implementation: "paged" routes decode steps
        # through the paged-attention kernel (block tables + context
        # lengths, cost tracks used context); "dense" keeps the
        # gather-then-dense reference (cost tracks max context).
        impl = str(attention_impl or config.llm_attention_impl).lower()
        if impl == "auto":
            impl = "paged"
        if impl not in ("paged", "dense"):
            raise ValueError(
                f"llm_attention_impl must be auto|paged|dense, got {impl!r}")
        self.attention_impl = impl
        self._model = LlamaModel(
            cfg, page_size=self.page_size if impl == "paged" else 0,
            device=self.device, seed=int(seed) if params is None else None)
        if params is not None:
            if isinstance(params.get("embed"), Mapping):
                from ray_tpu_torch.models.convert import params_from_flax

                params = params_from_flax(params, cfg)
            self._model.load_state_dict(params)
        self._model.eval()
        self._pools = make_kv_pools(cfg, self.num_pages * self.page_size,
                                    device=self.device)
        # temperature == 0 (the default) is exact greedy argmax; > 0
        # adds temperature scaling + optional static top-k + sampling
        # from this engine's generator, so a fixed seed replays the
        # same stream
        self.temperature = float(
            temperature if temperature is not None
            else config.llm_temperature)
        self.top_k = int(top_k if top_k is not None else config.llm_top_k)
        self._sample_gen = (
            torch.Generator(self.device).manual_seed(int(seed))
            if self.temperature > 0 else None)

        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._free_pages: List[int] = list(range(1, self.num_pages))
        # ---- copy-on-write prefix sharing ----
        # page_refs[p]: sequences whose block table includes page p —
        # pages recycle to _free_pages only at refcount 0.  The prefix
        # index maps a chain hash over page-aligned token blocks to ONE
        # immutable page holding that block's KV; _children groups
        # registered pages under their parent-chain hash so a mid-page
        # divergence can find its copy-on-write source.
        self.prefix_sharing = bool(
            prefix_sharing if prefix_sharing is not None
            else config.llm_prefix_sharing)
        self._page_refs = [0] * self.num_pages
        self._prefix_index: Dict[bytes, int] = {}
        self._children: Dict[bytes, set] = {}
        self._page_tokens: Dict[int, tuple] = {}
        self._page_keys: Dict[int, tuple] = {}
        self._prefix_hits = 0
        self._prefix_tokens_shared = 0
        self._cow_splits = 0
        self._pages_alloc_total = 0
        self._kv_pages_shipped_out = 0
        self._kv_pages_shipped_in = 0
        self._queued: deque = deque()
        self._active: List[_Seq] = []
        self._by_rid: Dict[str, _Seq] = {}
        self._stopped = threading.Event()
        self._loop_running = False
        self._arange = np.arange(self.ctx_len, dtype=np.int32)
        self._steps = 0
        self._cancelled_total = 0
        self._last_batch = 0
        self._last_step_tokens = 0
        # decode-step accumulators (mean step cost is a delta between
        # two stats() snapshots)
        self._decode_steps = 0
        self._decode_secs = 0.0
        # EWMA of one engine step's wall time — the deadline-admission
        # estimate of "prefill + one decode step" cost (0 until the
        # first measured step)
        self._step_ewma = 0.0
        self._deadline_expired_total = 0
        if self.attention_impl == "paged":
            self._warm_paged_buckets()

    # ------------------------------------------------------------ admission

    def submit(self, request: Dict[str, Any],
               kv_pack: Optional[tuple] = None) -> _Seq:
        """Admit (or re-attach to) one sequence.  Raises
        LLMOverloadedError when the admission queue is full, ValueError
        on requests that can never fit.

        ``kv_pack`` is a (meta, rows) KV shipment from a prefill engine
        (``prefill_request``): the sequence skips prefill — the step
        loop scatters the rows into this engine's pools and the sequence
        enters decode at the shipped position.  A pack that does not
        match the request's prompt is discarded (local prefill is always
        correct, just slower).  A request carrying ``_phase ==
        "prefill"`` is prefill-ONLY (see prefill_request)."""
        import uuid

        if not isinstance(request, dict) or not request.get("tokens"):
            raise ValueError("llm request must be a dict with 'tokens'")
        prompt = [int(t) for t in request["tokens"]]
        max_new = int(request.get("max_new_tokens", 16))
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        eos = request.get("eos")
        eos = int(eos) if eos is not None else None
        rid = str(request.get("request_id") or uuid.uuid4().hex[:16])
        prefill_only = request.get("_phase") == "prefill"
        if kv_pack is not None:
            meta = kv_pack[0]
            # the shipment must describe exactly this prompt: the rows
            # are attached positionally
            if (list(meta.get("tokens") or []) != prompt
                    or int(meta.get("n", -1)) != len(prompt)):
                kv_pack = None
        # end-to-end deadline: the ambient context combined with an
        # explicit request-dict "deadline_ms" — tighter wins
        dl = deadlines.effective_deadline() or 0.0
        req_dl = deadlines.from_header(request.get("deadline_ms"))
        if req_dl:
            dl = min(dl, req_dl) if dl else req_dl
        if dl:
            rem = dl - time.time()
            # admission refusal: a sequence whose remaining budget
            # cannot cover its prefill + ONE decode step would only burn
            # pages and lanes.  Cost model: measured step EWMA x
            # (prefill chunks + 1); a cold engine only refuses
            # already-expired budgets.  Prefill-only passes need no
            # decode step; shipped-KV sequences need no prefill chunks.
            need = 0.0
            if self._step_ewma > 0.0:
                chunks = -(-len(prompt) // self.prefill_chunk)
                if kv_pack is not None:
                    need = self._step_ewma
                elif prefill_only:
                    need = self._step_ewma * chunks
                else:
                    need = self._step_ewma * (chunks + 1)
            if rem <= need:
                self._deadline_expired_total += 1
                deadlines.count_exceeded("admission")
                raise DeadlineExceededError(
                    f"remaining budget {max(rem, 0.0) * 1000:.0f}ms cannot "
                    f"cover prefill + one decode step "
                    f"(~{need * 1000:.0f}ms)", where="admission")
        with self._lock:
            seq = self._by_rid.get(rid)
            if seq is not None and seq.cancelled:
                # a cancelled sequence is TRUNCATED — a retry must
                # re-generate, not replay a partial result
                del self._by_rid[rid]
                seq = None
            if seq is not None:
                # idempotent re-attach: a retry resumes the SAME sequence
                seq.attach_count += 1
                seq.detached_at = None
                return seq
            if len(prompt) + max_new > min(self.cfg.max_seq_len,
                                           self.ctx_len):
                raise ValueError(
                    f"prompt+max_new_tokens = {len(prompt) + max_new} "
                    f"exceeds max_seq_len {self.cfg.max_seq_len}")
            pages_needed = -(-(len(prompt) + max_new) // self.page_size)
            if pages_needed > self.num_pages - 1:
                raise LLMOverloadedError(
                    f"request needs {pages_needed} KV pages; replica "
                    f"has {self.num_pages - 1}")
            if len(self._queued) >= self.max_queue:
                raise LLMOverloadedError(
                    f"admission queue full ({self.max_queue})")
            seq = _Seq(rid, prompt, max_new, eos)
            seq.deadline = dl
            seq.cond = threading.Condition(self._lock)
            seq.attach_count = 1
            seq.prefill_export = prefill_only
            if kv_pack is not None:
                seq.kv_import = {"meta": kv_pack[0], "rows": kv_pack[1]}
            self._by_rid[rid] = seq
            self._queued.append(seq)
            self._cond.notify_all()  # wake the parked decode loop
        return seq

    def iter_tokens(self, seq: _Seq, emit_from: int = 0):
        """Blocking generator of token items for one consumer.

        Items are COALESCED: each carries every token generated since
        the consumer last drained (``{"i": <first index>, "tokens":
        [...], "done": bool}``).  The first item leaves the moment the
        first token exists (TTFT); later ones wait for
        ``stream_flush_tokens`` tokens or the end.  Parked waits rely on
        per-sequence notifies and re-check every 2s."""
        i = max(0, int(emit_from))
        first = True
        while True:
            with self._cond:
                while True:
                    if seq.error is not None:
                        raise seq.error
                    n = len(seq.generated)
                    if seq.done and i >= n:
                        return
                    flush = 1 if first else self.stream_flush_tokens
                    if n - i >= flush or (seq.done and n > i):
                        item = {"i": i, "tokens": list(seq.generated[i:n]),
                                "done": bool(seq.done)}
                        break
                    (seq.cond or self._cond).wait(2.0)
            yield item
            first = False
            if item["done"]:
                return
            i = n

    def release(self, seq: _Seq) -> None:
        """One consumer detached (finished, disconnected, cancelled).
        The last detach of an unfinished sequence starts the grace
        clock; past it the loop cancels the sequence and recycles its
        pages."""
        with self._lock:
            seq.attach_count = max(0, seq.attach_count - 1)
            if seq.attach_count == 0 and not seq.done:
                seq.detached_at = time.monotonic()

    def cancel(self, request_id: str) -> bool:
        with self._lock:
            seq = self._by_rid.get(request_id)
            if seq is None or seq.done:
                return False
            self._finish_seq(seq, cancelled=True)
            self._cond.notify_all()
            return True

    # ------------------------------------------------------------- stepping

    def _to_device(self, a: Optional[np.ndarray],
                   dtype: Optional[torch.dtype] = None
                   ) -> Optional[torch.Tensor]:
        if a is None:
            return None
        t = torch.from_numpy(a)
        if dtype is not None:
            t = t.to(dtype)
        return t.to(self.device, non_blocking=True)

    @torch.no_grad()
    def _forward(self, tokens, slot_arr, ctx, ctx_pos, ctx_mask, q_pos,
                 last_idx, block_tables=None, context_lens=None
                 ) -> torch.Tensor:
        """One eager forward over the paged cache -> next tokens at
        ``last_idx`` (a device tensor; the pools update in place).  The
        host arrays move to the engine's device here, every step; slot
        and context indices become int64, which torch indexing needs.

        Context comes in one of two forms: dense ``ctx``/``ctx_pos``/
        ``ctx_mask`` gather arrays (chunked prefill, dense decode), or
        page-granular ``block_tables`` + ``context_lens`` routing decode
        through the paged-attention kernel."""
        cache = {"k": self._pools["k"], "v": self._pools["v"],
                 "slots": self._to_device(slot_arr, torch.int64),
                 "q_pos": self._to_device(q_pos)}
        if block_tables is not None:
            cache["block_tables"] = self._to_device(block_tables)
            cache["context_lens"] = self._to_device(context_lens)
        else:
            cache.update(ctx=self._to_device(ctx, torch.int64),
                         ctx_pos=self._to_device(ctx_pos),
                         ctx_mask=self._to_device(ctx_mask))
        logits, _pools = self._model(self._to_device(tokens), cache)
        lanes = torch.arange(logits.shape[0], device=self.device)
        picked = logits[lanes, self._to_device(last_idx, torch.int64)]
        if self.temperature <= 0.0:
            return torch.argmax(picked, dim=-1)
        scaled = picked.float() / self.temperature
        if self.top_k > 0:
            kth = torch.topk(scaled, self.top_k, dim=-1).values[:, -1:]
            scaled = scaled.masked_fill(scaled < kth, float("-inf"))
        probs = torch.softmax(scaled, dim=-1)
        return torch.multinomial(probs, 1,
                                 generator=self._sample_gen)[:, 0]

    def _paged_width_buckets(self) -> List[int]:
        """Block-table width buckets the paged decode path can emit:
        powers of four from 4 up to (and capped at) pages_per_seq."""
        widths, w = [], 4
        while True:
            widths.append(min(w, self.pages_per_seq))
            if w >= self.pages_per_seq:
                return widths
            w *= 4

    def _warm_paged_buckets(self) -> None:
        """Build and load the paged-attention kernel library before any
        request arrives: a first-use ``nvcc`` run would otherwise stall
        the first decode step of a deadlined request.  The kernel takes
        the table width as a run-time argument, so unlike the jitted
        reference no per-bucket compile remains to warm."""
        if self.device.type == "cuda":
            from ray_tpu_torch.ops import paged_attention

            paged_attention.load_kernel()

    def _alloc_pages(self, n: int) -> List[int]:
        pages = self._free_pages[:n]
        del self._free_pages[:n]
        for p in pages:
            self._page_refs[p] = 1
        self._pages_alloc_total += len(pages)
        return pages

    def _release_pages(self, pages: List[int]) -> None:
        """Lock held.  Drop one reference per page; pages reaching
        refcount 0 return to the free list and leave the prefix index
        (a later lookup must never attach to a recycled page)."""
        freed = []
        for p in pages:
            self._page_refs[p] -= 1
            if self._page_refs[p] <= 0:
                self._page_refs[p] = 0
                freed.append(p)
                keys = self._page_keys.pop(p, None)
                if keys is not None:
                    parent, own = keys
                    if self._prefix_index.get(own) == p:
                        del self._prefix_index[own]
                    kids = self._children.get(parent)
                    if kids is not None:
                        kids.discard(p)
                        if not kids:
                            del self._children[parent]
                self._page_tokens.pop(p, None)
        self._free_pages.extend(freed)

    def _finish_seq(self, seq: _Seq, cancelled: bool = False) -> None:
        """Lock held.  Mark done and release page references
        immediately — physical pages recycle only at refcount 0."""
        seq.done = True
        seq.cancelled = cancelled
        if cancelled:
            self._cancelled_total += 1
        seq.done_at = time.monotonic()
        if seq.cond is not None:
            seq.cond.notify_all()
        self._release_pages(seq.block_table)
        seq.block_table = []
        seq.kv_import = None
        if seq in self._active:
            self._active.remove(seq)
        try:
            self._queued.remove(seq)
        except ValueError:
            pass

    def _sweep(self, now: float) -> None:
        """Lock held: expire sequences past their deadline (pages
        recycle NOW; the consumer sees the typed error), cancel
        sequences abandoned past the grace window, and forget finished
        ones past the replay TTL."""
        wall = time.time()
        for seq in list(self._active) + list(self._queued):
            if seq.deadline and wall >= seq.deadline and not seq.done:
                self._deadline_expired_total += 1
                where = "queued" if seq.state == _QUEUED else "running"
                deadlines.count_exceeded(where)
                seq.error = DeadlineExceededError(
                    f"sequence {seq.request_id} exceeded its deadline "
                    f"while {where} ({len(seq.generated)}/{seq.max_new} "
                    f"tokens generated)", where=where)
                self._finish_seq(seq, cancelled=True)
                continue
            if (seq.attach_count == 0 and seq.detached_at is not None
                    and now - seq.detached_at > self.detach_grace_s):
                self._finish_seq(seq, cancelled=True)
        ttl = float(config.llm_done_seq_ttl_s)
        for rid, seq in list(self._by_rid.items()):
            if seq.done and seq.done_at is not None \
                    and now - seq.done_at > ttl:
                del self._by_rid[rid]

    def _match_prefix(self, seq: _Seq):
        """Lock held.  Longest shared-prefix match for ``seq`` against
        the refcounted index: returns (shared_pages, cow) where
        ``shared_pages`` are live physical pages whose KV covers the
        first ``len(shared_pages) * page_size`` prefill tokens, and
        ``cow`` is an optional (source_page, n_tokens) mid-page
        extension to copy into a private page.  At least ONE token is
        always left for prefill — the final prompt position's logits
        produce the first generated token."""
        toks = seq.prefill_tokens
        ps = self.page_size
        limit = len(toks) - 1
        shared: List[int] = []
        if limit < 1 or not self._children:
            return shared, None
        h = _PREFIX_SEED
        p = 0
        while (p + 1) * ps <= limit:
            block = tuple(toks[p * ps:(p + 1) * ps])
            child = _chain_hash(h, block)
            page = self._prefix_index.get(child)
            # the token compare turns a hash collision into a miss
            if page is None or self._page_refs[page] <= 0 \
                    or self._page_tokens.get(page) != block:
                break
            shared.append(page)
            h = child
            p += 1
        cow = None
        rem = min(limit - p * ps, ps)
        if rem > 0:
            best, best_page = 0, None
            want = toks[p * ps:p * ps + rem]
            for cand in self._children.get(h, ()):
                ct = self._page_tokens.get(cand)
                if not ct or self._page_refs[cand] <= 0:
                    continue
                m = 0
                for a, b in zip(ct, want):
                    if a != b:
                        break
                    m += 1
                if m > best:
                    best, best_page = m, cand
            if best > 0:
                cow = (best_page, best)
        return shared, cow

    def _register_prefix_pages(self, seq: _Seq) -> None:
        """Lock held.  Enter ``seq``'s fully-written prefill pages into
        the prefix index (only once ``pos`` passed a page's end, and
        only within the prefill region).  Idempotent."""
        if not self.prefix_sharing:
            return
        ps = self.page_size
        toks = seq.prefill_tokens
        max_page = min(seq.pos, len(toks)) // ps
        h = _PREFIX_SEED
        for p in range(max_page):
            block = tuple(toks[p * ps:(p + 1) * ps])
            child = _chain_hash(h, block)
            page = seq.block_table[p]
            if page not in self._page_keys and self._page_refs[page] > 0:
                # first registration wins
                self._prefix_index.setdefault(child, page)
                self._children.setdefault(h, set()).add(page)
                self._page_tokens[page] = block
                self._page_keys[page] = (h, child)
            h = child

    def _cow_copy(self, src_page: int, dst_page: int, n_tok: int) -> None:
        """Lock held, loop-synchronized (only ever called from within a
        step, never concurrent with a forward): copy the first
        ``n_tok`` KV rows of ``src_page`` into ``dst_page``."""
        ps = self.page_size
        src = np.arange(n_tok, dtype=np.int64) + src_page * ps
        dst = np.arange(n_tok, dtype=np.int64) + dst_page * ps
        copy_kv_slots(self._pools, src, dst)

    def _admit_locked(self) -> None:
        while self._queued and len(self._active) < self.max_batch:
            seq = self._queued[0]
            pages = -(-seq.total_len // self.page_size)
            shared: List[int] = []
            cow = None
            if self.prefix_sharing and seq.kv_import is None \
                    and not seq.block_table:
                shared, cow = self._match_prefix(seq)
            if pages - len(shared) > len(self._free_pages):
                break  # head-of-line waits for pages to recycle
            self._queued.popleft()
            for p in shared:
                self._page_refs[p] += 1
            seq.block_table = shared + self._alloc_pages(
                pages - len(shared))
            bt = np.asarray(seq.block_table, np.int64)
            seq.slot_cache = (np.repeat(bt * self.page_size,
                                        self.page_size)
                              + np.tile(np.arange(self.page_size),
                                        len(bt))).astype(np.int32)
            shared_tok = len(shared) * self.page_size
            if cow is not None:
                src_page, n_tok = cow
                self._cow_copy(src_page, seq.block_table[len(shared)],
                               n_tok)
                self._cow_splits += 1
                shared_tok += n_tok
            if shared_tok:
                # prefill starts at the first unshared token
                seq.pos = shared_tok
                self._prefix_hits += 1
                self._prefix_tokens_shared += shared_tok
            seq.state = _PREFILL
            self._active.append(seq)

    def _emit_token(self, seq: _Seq, token: int) -> None:
        """Lock held: append one generated token, finish on EOS/budget,
        and wake THIS sequence's consumer at flush boundaries only —
        an engine-wide notify_all per step would wake every parked
        stream thread per token."""
        seq.generated.append(int(token))
        n = len(seq.generated)
        if seq.first_token_at is None:
            seq.first_token_at = time.monotonic()
        if (seq.eos is not None and int(token) == seq.eos) \
                or n >= seq.max_new:
            self._finish_seq(seq)
        elif seq.cond is not None \
                and (n - 1) % self.stream_flush_tokens == 0:
            # aligned with the consumer cursor after the n=1 TTFT item:
            # wakes land when a full flush quota exists past it
            # (n = 1, F+1, 2F+1, ...), not one window late
            seq.cond.notify_all()

    # ------------------------------------------- disaggregated prefill
    # Export and import both touch the KV pools, so they only ever run
    # INSIDE a step, under the engine lock, never concurrent with a
    # forward (which updates the pools in place).

    def _attach_imports_locked(self) -> bool:
        """Scatter shipped KV rows for freshly-admitted sequences into
        this engine's pools; the sequence enters decode at the shipped
        position with the prefill engine's first generated token already
        emitted.  Returns True when any import happened."""
        imports = [s for s in self._active
                   if s.kv_import is not None and s.state == _PREFILL]
        for seq in imports:
            pack, seq.kv_import = seq.kv_import, None
            n = int(pack["meta"]["n"])
            first_tok = int(pack["meta"]["first_token"])
            scatter_kv_slots(self._pools, seq.slot_cache[:n], pack["rows"])
            seq.pos = n
            self._kv_pages_shipped_in += -(-n // self.page_size)
            # imported pages carry a complete prompt prefix: register
            # them so later same-prefix admissions share them
            self._register_prefix_pages(seq)
            seq.state = _DECODE
            self._emit_token(seq, first_tok)
        return bool(imports)

    def _export_seq_locked(self, seq: _Seq, first_token: int) -> None:
        """Prefill-only sequence finished its last chunk: gather its KV
        rows to host memory, stash them as the export payload, and
        finish the sequence (pages recycle NOW — the payload is a host
        copy)."""
        if seq.first_token_at is None:
            seq.first_token_at = time.monotonic()
        seq.generated.append(int(first_token))
        n = seq.pos
        n_pages = -(-n // self.page_size)
        seq.export_payload = {
            "meta": {"request_id": seq.request_id,
                     "tokens": list(seq.prompt),
                     "first_token": int(first_token),
                     "n": n, "pages": n_pages,
                     "page_size": self.page_size},
            "rows": gather_kv_slots(self._pools, seq.slot_cache[:n]),
        }
        self._kv_pages_shipped_out += n_pages
        seq.state = _SHIP
        self._finish_seq(seq)

    def prefill_request(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """Run ONLY the prefill phase for ``request`` and return the
        export payload ({"meta", "rows"}) for another engine's
        ``submit(kv_pack=...)``.  Drives the engine inline when no loop
        is running; under a loop it parks on the sequence condition.
        Idempotent by request_id within the done-seq TTL."""
        req = dict(request)
        req["_phase"] = "prefill"
        seq = self.submit(req)
        try:
            while True:
                with self._lock:
                    if seq.export_payload is not None:
                        return seq.export_payload
                    if seq.error is not None:
                        raise seq.error
                    if seq.done:
                        raise LLMOverloadedError(
                            f"prefill for {seq.request_id} was cancelled "
                            f"before its pages could be exported")
                    inline = not self._loop_running
                    if not inline:
                        (seq.cond or self._cond).wait(0.1)
                if inline:
                    if not self.step():
                        time.sleep(0.001)
        finally:
            self.release(seq)

    def step(self) -> bool:
        """One engine iteration: admit, one prefill chunk, one decode
        pass over every decoding sequence.  Returns False when there was
        nothing to do (the loop then parks on the condition)."""
        now = time.monotonic()
        t_step = time.perf_counter()
        with self._lock:
            self._sweep(now)
            self._admit_locked()
            imported = self._attach_imports_locked()
            prefills = [s for s in self._active
                        if s.state == _PREFILL][:self.prefill_lanes]
            decode = [s for s in self._active if s.state == _DECODE]
            if not prefills and not decode:
                self._last_batch = 0
                self._last_step_tokens = 0
                return imported  # an import that finished immediately
                # (max_new=1 / eos) still counts as work done
            prefill_args = []
            for seq in prefills:
                lo = seq.pos
                hi = min(lo + self.prefill_chunk, len(seq.prefill_tokens))
                prefill_args.append(
                    (seq, lo, hi, seq.prefill_tokens[lo:hi],
                     seq.slot_cache[lo:hi], seq.slot_cache[:hi]))
            decode_args = []
            for seq in decode[:self.max_batch]:
                last = (seq.generated[-1] if seq.generated
                        else seq.prefill_tokens[-1])
                # snapshot the block table under the lock: a concurrent
                # CoW split may rewrite entries after we release it
                decode_args.append(
                    (seq, last, seq.slot_cache[seq.pos],
                     seq.slot_cache[:seq.pos + 1],
                     list(seq.block_table), seq.pos + 1))
        step_tokens = 0
        # ---- chunked prefill, batched across lanes: up to
        # prefill_lanes sequences advance one chunk each per step, so a
        # LONG prompt shares the loop with in-flight decodes instead of
        # monopolizing it
        if prefill_args:
            lanes = self.prefill_lanes
            c = self.prefill_chunk
            tokens = np.zeros((lanes, c), np.int32)
            slot_arr = np.zeros((lanes, c), np.int32)
            ctx = np.zeros((lanes, self.ctx_len), np.int32)
            ctx_pos = np.zeros((lanes, self.ctx_len), np.int32)
            ctx_mask = np.zeros((lanes, self.ctx_len), bool)
            q_pos = np.zeros((lanes, c), np.int32)
            last_idx = np.zeros((lanes,), np.int32)
            for lane, (seq, lo, hi, toks, slots, ctx_slots) \
                    in enumerate(prefill_args):
                tokens[lane, :hi - lo] = toks
                slot_arr[lane, :hi - lo] = slots
                ctx[lane, :hi] = ctx_slots
                ctx_pos[lane, :hi] = self._arange[:hi]
                ctx_mask[lane, :hi] = True
                q_pos[lane, :hi - lo] = self._arange[lo:hi]
                last_idx[lane] = hi - lo - 1
            next_tok = self._forward(
                tokens, slot_arr, ctx, ctx_pos, ctx_mask, q_pos,
                last_idx).cpu().numpy()
            step_tokens += sum(hi - lo for _s, lo, hi, *_r in prefill_args)
            with self._lock:
                for lane, (seq, lo, hi, *_rest) in enumerate(prefill_args):
                    if seq.done:
                        continue  # cancelled mid-chunk: pages already back
                    seq.pos = hi
                    # pages this chunk completed are immutable now
                    self._register_prefix_pages(seq)
                    if hi == len(seq.prefill_tokens):
                        if seq.prefill_export:
                            self._export_seq_locked(
                                seq, int(next_tok[lane]))
                        else:
                            seq.state = _DECODE
                            self._emit_token(seq, int(next_tok[lane]))
        # ---- token-level decode batch
        if decode_args:
            b = self.max_batch
            tokens = np.zeros((b, 1), np.int32)
            slot_arr = np.zeros((b, 1), np.int32)
            q_pos = np.zeros((b, 1), np.int32)
            last_idx = np.zeros((b,), np.int32)
            t_dec = time.perf_counter()
            if self.attention_impl == "paged":
                # page-granular context: block tables + context lengths.
                # The table width snaps to the smallest bucket covering
                # the max used pages across lanes.
                max_used = max(-(-n // self.page_size)
                               for *_a, n in decode_args)
                width = next(w for w in self._paged_width_buckets()
                             if w >= max_used)
                block_tables = np.zeros((b, width), np.int32)
                context_lens = np.zeros((b,), np.int32)
                for lane, (seq, last, slot, _ctx, table, n) \
                        in enumerate(decode_args):
                    tokens[lane, 0] = last
                    slot_arr[lane, 0] = slot
                    used = -(-n // self.page_size)
                    block_tables[lane, :used] = table[:used]
                    context_lens[lane] = n
                    q_pos[lane, 0] = seq.pos
                next_tok = self._forward(
                    tokens, slot_arr, None, None, None, q_pos, last_idx,
                    block_tables=block_tables, context_lens=context_lens)
            else:
                ctx = np.zeros((b, self.ctx_len), np.int32)
                ctx_pos = np.zeros((b, self.ctx_len), np.int32)
                ctx_mask = np.zeros((b, self.ctx_len), bool)
                for lane, (seq, last, slot, ctx_slots, _table, n) \
                        in enumerate(decode_args):
                    tokens[lane, 0] = last
                    slot_arr[lane, 0] = slot
                    ctx[lane, :n] = ctx_slots
                    ctx_pos[lane, :n] = self._arange[:n]
                    ctx_mask[lane, :n] = True
                    q_pos[lane, 0] = seq.pos
                next_tok = self._forward(
                    tokens, slot_arr, ctx, ctx_pos, ctx_mask, q_pos,
                    last_idx)
            next_tok = next_tok.cpu().numpy()  # the one device sync
            decode_dt = time.perf_counter() - t_dec
            self._decode_steps += 1
            self._decode_secs += decode_dt
            with self._lock:
                for lane, (seq, *_rest) in enumerate(decode_args):
                    if seq.done:
                        continue  # cancelled while we computed
                    seq.pos += 1
                    self._emit_token(seq, int(next_tok[lane]))
            step_tokens += len(decode_args)
        self._steps += 1
        self._last_batch = len(decode_args)
        self._last_step_tokens = step_tokens
        # step-cost estimate for deadline admission (prefill + one decode
        # step).  Admission asks "can this POSSIBLY finish", so the
        # estimate is a floor-ish typical cost: a faster step pulls it
        # down immediately, and slow outliers (a GC pause, a first-use
        # kernel build) are clamped so one huge step cannot poison it
        # into shedding healthy traffic
        dt = time.perf_counter() - t_step
        if self._step_ewma == 0.0 or dt < self._step_ewma:
            self._step_ewma = dt
        else:
            self._step_ewma = 0.9 * self._step_ewma \
                + 0.1 * min(dt, 5.0 * self._step_ewma)
        return True

    def run_loop(self) -> Dict[str, Any]:
        """The decode loop: step while there is work, park on the engine
        condition while idle.  Single-flight — a second install returns
        immediately."""
        with self._lock:
            if self._loop_running:
                return {"already_running": True}
            self._loop_running = True
        try:
            while not self._stopped.is_set():
                if not self.step():
                    with self._cond:
                        if not self._queued and not self._active:
                            self._cond.wait(0.05)
            return {"steps": self._steps}
        except BaseException as e:
            # a broken engine must fail its consumers, not hang them
            with self._lock:
                for seq in list(self._active) + list(self._queued):
                    if not seq.done:
                        seq.error = e
                        self._finish_seq(seq, cancelled=True)
                        if seq.cond is not None:
                            seq.cond.notify_all()
                self._cond.notify_all()
            raise
        finally:
            with self._lock:
                self._loop_running = False

    def stop(self) -> None:
        self._stopped.set()
        with self._cond:
            self._cond.notify_all()

    # ------------------------------------------------- sync (static batch)

    def generate_batch(self, requests: List[Dict[str, Any]]
                       ) -> List[List[int]]:
        """Static batching: admit the whole batch, run it to completion,
        disband.  Only for engines with no running loop."""
        seqs = []
        try:
            for r in requests:
                seqs.append(self.submit(r))
        except BaseException:
            # a failed admission mid-list must not strand the earlier
            # sequences holding pages for nobody
            with self._lock:
                for s in seqs:
                    self._finish_seq(s, cancelled=True)
            raise
        while any(not s.done for s in seqs):
            if not self.step():
                time.sleep(0.001)
        for s in seqs:
            self.release(s)
        return [list(s.generated) for s in seqs]

    # ------------------------------------------------------- observability

    def _shared_page_count(self) -> int:
        """Lock held: pages referenced by more than one sequence."""
        return sum(1 for r in self._page_refs if r > 1)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"steps": self._steps,
                    "attention_impl": self.attention_impl,
                    "decode_steps": self._decode_steps,
                    "decode_secs": self._decode_secs,
                    "queued": len(self._queued),
                    "active": len(self._active),
                    "cancelled": self._cancelled_total,
                    "deadline_expired": self._deadline_expired_total,
                    "live_seqs": len(self._by_rid),
                    "free_pages": len(self._free_pages),
                    "used_pages": self.num_pages - 1 - len(self._free_pages),
                    "shared_pages": self._shared_page_count(),
                    "prefix_hits": self._prefix_hits,
                    "prefix_tokens_shared": self._prefix_tokens_shared,
                    "cow_splits": self._cow_splits,
                    "pages_allocated_total": self._pages_alloc_total,
                    "kv_page_bytes": (
                        sum(int(p.nbytes) for p in self._pools["k"])
                        + sum(int(p.nbytes) for p in self._pools["v"]))
                        // self.num_pages,
                    "kv_pages_shipped_out": self._kv_pages_shipped_out,
                    "kv_pages_shipped_in": self._kv_pages_shipped_in,
                    "loop_running": self._loop_running,
                    "last_batch": self._last_batch}

    # ------------------------------------------------------- save / restore

    def save_state(self) -> Dict[str, Any]:
        """Snapshot of in-flight sequences: prompt + tokens generated so
        far.  Params and KV pages are reconstructed, not saved."""
        with self._lock:
            seqs = []
            for seq in list(self._active) + list(self._queued):
                if seq.done:
                    continue
                seqs.append({"request_id": seq.request_id,
                             "tokens": list(seq.prompt),
                             "generated": list(seq.generated),
                             "max_new_tokens": seq.max_new,
                             "eos": seq.eos})
            return {"seqs": seqs}

    def restore_state(self, state: Dict[str, Any]) -> None:
        """Re-admit saved sequences: each re-prefills prompt + known
        tokens and continues decoding.  Consumers re-attach by
        request_id within the grace window."""
        now = time.monotonic()
        with self._lock:
            for s in (state or {}).get("seqs", []):
                rid = s["request_id"]
                if rid in self._by_rid:
                    continue
                seq = _Seq(rid, s["tokens"], s["max_new_tokens"],
                           s.get("eos"), preknown=s.get("generated"))
                seq.cond = threading.Condition(self._lock)
                if len(seq.generated) >= seq.max_new:
                    continue  # finished before the snapshot landed
                seq.detached_at = now  # grace window for re-attach
                self._by_rid[rid] = seq
                self._queued.append(seq)
            self._cond.notify_all()
