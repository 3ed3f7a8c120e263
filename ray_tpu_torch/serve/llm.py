"""LLM serving tier: continuous batching over a paged KV cache.

The port of ray_tpu/serve/llm.py: :class:`LLMEngine` and the replica
side of ``llm_deployment``.  Admission, paging, the copy-on-write prefix
index, deadlines, disaggregated-prefill export/import, save/restore, the
stepping loop, the ``llm_metrics`` families it records, the replica
targets (``_LLMCallable``, ``_LLMBatchCallable``) and the pinned decode
loop (``run_llm_loop``, installed through ``__rt_dag_llm_loop__``) are
the same; only the framework seams differ:

  - one eager :meth:`LLMEngine._forward` over device tensors replaces the
    jitted stepper.  Greedy decoding is ``argmax``; sampling is
    temperature + static top-k + ``torch.multinomial`` drawing from an
    engine-owned ``torch.Generator`` seeded from ``seed``;
  - the KV pools are updated in place (``index_copy_``) where the JAX
    engine donated them to jit;
  - a chunked-prefill batch is shaped by the step's work, not padded to
    the engine's maxima as the jitted stepper's is: a lane for each
    sequence that prefills, rows to the longest chunk and a context to
    the longest one, rounded up to a page;
  - paged decode runs the paged-attention CUDA kernel
    (ops/paged_attention.py) over block tables whose width snaps to the
    same power-of-four buckets; ``auto`` picks it only where the kernel
    takes the model's shape (:func:`resolve_attention_impl`).  On a
    card the paged decode forward is captured at construction as one
    CUDA graph per width bucket over static input buffers, and each
    decode step replays one (:meth:`LLMEngine._capture_decode_graphs`)
    where the jitted stepper ran one compiled program per bucket;
  - a disaggregated KV pack carries the host tensors of
    ``gather_kv_slots``; the decode replica's ``scatter_kv_slots`` moves
    them onto its own device.

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

__all__ = ["LLMEngine", "LLMOverloadedError", "llm_deployment",
           "run_llm_loop"]


class LLMOverloadedError(RuntimeError):
    """Admission shed: queue full or the prompt cannot be paged in."""


def resolve_attention_impl(impl: str, cfg: LlamaConfig,
                           device: torch.device) -> str:
    """The decode attention an engine runs: ``paged`` or ``dense``.
    ``auto`` is ``paged`` where the paged kernel takes the model's shape
    (``paged_attention.kernel_takes``: head_dim, query heads per kv
    head, dtype) or the engine runs on the CPU, whose plain version
    takes every shape; elsewhere ``dense``.  An explicit ``paged`` is
    kept, and raises at the first decode step if the kernel does not
    take the shape."""
    from ray_tpu_torch.ops import paged_attention as pa

    impl = str(impl).lower()
    if impl == "auto":
        takes = device.type == "cpu" or pa.kernel_takes(
            cfg.head_dim, cfg.n_heads // cfg.n_kv_heads, cfg.dtype)
        impl = "paged" if takes else "dense"
    if impl not in ("paged", "dense"):
        raise ValueError(
            f"llm_attention_impl must be auto|paged|dense, got {impl!r}")
    return impl


# sequence states
_QUEUED = "queued"
_PREFILL = "prefill"
_DECODE = "decode"
_SHIP = "ship"  # prefill-only sequence whose pages were just exported

# prefix-index chain seed: block k's key hashes (parent key || block
# tokens), so one digest equality implies the WHOLE prefix matches
_PREFIX_SEED = b"rtpu-prefix-v1"

# a prefill batch's rows are its longest chunk rounded up to this (and
# capped at prefill_chunk): the pad stays under 16 rows, and a 256-row
# chunk takes at most 16 row counts
_PREFILL_ROW_STEP = 16


def _round_up(n: int, step: int) -> int:
    return -(-n // step) * step


def _paged_decode_views(buf, batch: int, width: int) -> tuple:
    """The inputs of a paged decode step as views of one flat int32
    buffer of ``4 * batch + batch * width`` entries: tokens, slots and
    q_pos [batch, 1], context_lens [batch], block_tables [batch, width].
    One layout serves a numpy array and a host or device tensor."""
    b = batch
    return (buf[:b].reshape(b, 1), buf[b:2 * b].reshape(b, 1),
            buf[2 * b:3 * b].reshape(b, 1), buf[3 * b:4 * b],
            buf[4 * b:].reshape(b, width))


def _pack_paged_decode(lanes, batch: int, width: int, page_size: int,
                       out: Optional[np.ndarray] = None) -> np.ndarray:
    """Fill the flat buffer of :func:`_paged_decode_views` (``out``, or
    a new one) for one paged decode step.  ``lanes`` holds a (last
    token, its slot, block table, context length n) per decoding
    sequence; lane i gets the sequence's token at position n - 1, its
    n positions and the table's first ceil(n / page_size) pages.  The
    lanes past them keep token 0, slot 0 (the garbage slot), position
    0, context length 0 and a table of page 0."""
    if out is None:
        out = np.zeros(4 * batch + batch * width, np.int32)
    else:
        out.fill(0)
    tokens, slots, q_pos, context_lens, tables = _paged_decode_views(
        out, batch, width)
    for lane, (_tok, _slot, table, n) in enumerate(lanes):
        used = -(-n // page_size)
        tables[lane, :used] = table[:used]
    if lanes:
        k = len(lanes)
        tok, slot, _tables, n = zip(*lanes)
        tokens[:k, 0] = tok
        slots[:k, 0] = slot
        context_lens[:k] = n
        q_pos[:k, 0] = context_lens[:k] - 1
    return out


class _DecodeGraph:
    """The paged decode forward captured at one block-table width: the
    pinned staging buffer the host packs, the device buffer the graph
    reads, the graph and its output (next tokens, or the picked logits
    of a sampling engine)."""

    __slots__ = ("width", "host", "host_np", "dev", "graph", "out")

    def __init__(self, width, host, dev, graph, out):
        self.width, self.host, self.dev = width, host, dev
        self.host_np = host.numpy()
        self.graph, self.out = graph, out


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
        impl = resolve_attention_impl(
            attention_impl or config.llm_attention_impl, cfg, self.device)
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
        # made once and updated in place, never reallocated (save/restore
        # re-queues sequences, it does not rebuild the pools): the decode
        # graphs hold these pools' addresses
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
        self._metrics = None
        # decode-step accumulators (mean step cost is a delta between
        # two stats() snapshots)
        self._decode_steps = 0
        self._decode_secs = 0.0
        # paged decode graphs by block-table width (a card only), and
        # the decode steps a replay served
        self._decode_graphs: Dict[int, _DecodeGraph] = {}
        self._decode_graph_replays = 0
        # prefill-step accumulators; cells = lanes x rows x context
        # width, the attention scores each prefill step computed
        self._prefill_steps = 0
        self._prefill_secs = 0.0
        self._prefill_cells = 0
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
                 last_idx) -> torch.Tensor:
        """One eager forward over the paged cache through dense
        ``ctx``/``ctx_pos``/``ctx_mask`` gather arrays (chunked prefill,
        dense decode) -> next tokens at ``last_idx`` (a device tensor;
        the pools update in place).  The host arrays move to the
        engine's device here, every step; slot and context indices
        become int64, which torch indexing needs."""
        cache = {"k": self._pools["k"], "v": self._pools["v"],
                 "slots": self._to_device(slot_arr, torch.int64),
                 "q_pos": self._to_device(q_pos),
                 "ctx": self._to_device(ctx, torch.int64),
                 "ctx_pos": self._to_device(ctx_pos),
                 "ctx_mask": self._to_device(ctx_mask)}
        logits, _pools = self._model(self._to_device(tokens), cache)
        lanes = torch.arange(logits.shape[0], device=self.device)
        return self._pick(
            logits[lanes, self._to_device(last_idx, torch.int64)])

    def _pick(self, picked: torch.Tensor) -> torch.Tensor:
        """Next tokens from each lane's logits [B, V]: greedy argmax, or
        a draw from this engine's generator after temperature and
        top-k."""
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
        """On a card, build and load the paged-attention kernel library
        and capture every width bucket's decode graph before any request
        arrives: a first-use ``nvcc`` run or capture would otherwise
        stall a decode step of a request in flight.  Where the kernel
        does not take the model's shape no graph is captured, and an
        explicit ``paged`` engine raises at its first decode step."""
        if self.device.type != "cuda":
            return
        from ray_tpu_torch.ops import paged_attention as pa

        pa.load_kernel()
        cfg = self.cfg
        if pa.kernel_takes(cfg.head_dim, cfg.n_heads // cfg.n_kv_heads,
                           cfg.dtype):
            with torch.cuda.device(self.device):
                self._capture_decode_graphs()

    @torch.no_grad()
    def _paged_decode_forward(self, buf: torch.Tensor,
                              width: int) -> torch.Tensor:
        """The paged decode forward over ``buf``, the flat buffer of
        :func:`_paged_decode_views` on the engine's device: next tokens
        [B], or a sampling engine's picked logits [B, V], which
        :meth:`_pick` draws from after it so that the generator runs
        eagerly.  A card captures it in a graph per width; a CPU engine
        runs it every step."""
        tokens, slots, q_pos, context_lens, tables = _paged_decode_views(
            buf, self.max_batch, width)
        cache = {"k": self._pools["k"], "v": self._pools["v"],
                 "slots": slots.long(), "q_pos": q_pos,
                 "block_tables": tables, "context_lens": context_lens}
        logits, _pools = self._model(tokens, cache)
        picked = logits[:, 0]
        return self._pick(picked) if self.temperature <= 0.0 else picked

    def _capture_decode_graphs(self) -> None:
        """Capture the paged decode forward once per width bucket as a
        CUDA graph over static buffers of ``max_batch`` lanes, after a
        warm-up on a side stream; the graphs share one memory pool, as
        no two replay at once.  Every lane of the warm-up and the
        capture is inactive: they write the garbage slot 0 and read
        nothing."""
        b = self.max_batch
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        for width in self._paged_width_buckets():
            n = 4 * b + b * width
            host = torch.zeros(n, dtype=torch.int32, pin_memory=True)
            dev = torch.zeros(n, dtype=torch.int32, device=self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._paged_decode_forward(dev, width)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = self._paged_decode_forward(dev, width)
            self._decode_graphs[width] = _DecodeGraph(
                width, host, dev, graph, out)

    def _replay_decode(self, g: _DecodeGraph, lanes) -> torch.Tensor:
        """One paged decode step through ``g``: pack the lanes into the
        pinned buffer, one copy to the device and a replay on the
        current stream, after whatever KV imports and copy-on-write
        copies this step queued there.  The step's token read syncs
        before the next pack reuses the buffer.  Returns the graph's
        output (:meth:`_paged_decode_forward`)."""
        _pack_paged_decode(lanes, self.max_batch, g.width, self.page_size,
                           out=g.host_np)
        g.dev.copy_(g.host, non_blocking=True)
        g.graph.replay()
        self._decode_graph_replays += 1
        return g.out

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
                m = self.metrics()
                if m is not None:
                    m["prefix_hits"].inc(
                        tags={"kind": "cow" if cow else "page"})
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
            m = self.metrics()
            if m is not None:
                m["ttft"].observe(seq.first_token_at - seq.submitted_at)
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
            n_pages = -(-n // self.page_size)
            self._kv_pages_shipped_in += n_pages
            m = self.metrics()
            if m is not None:
                m["shipped"].inc(n_pages, tags={"direction": "in"})
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
            m = self.metrics()
            if m is not None:
                m["ttft"].observe(seq.first_token_at - seq.submitted_at)
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
        m = self.metrics()
        if m is not None:
            m["shipped"].inc(n_pages, tags={"direction": "out"})
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
                self._set_gauges()  # idle publishes zeros, not the last
                # busy step's values
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
            t_pre = time.perf_counter()
            # the batch takes its shape from this step's work: a lane a
            # prefilling sequence, rows to the longest chunk, context to
            # the longest one (a whole page); the eager forward needs no
            # fixed shape, and positions past a lane's hi only ever
            # carried -1e30 into the softmax
            lanes = len(prefill_args)
            c = min(self.prefill_chunk, _round_up(
                max(hi - lo for _s, lo, hi, *_r in prefill_args),
                _PREFILL_ROW_STEP))
            width = _round_up(max(hi for _s, _lo, hi, *_r in prefill_args),
                              self.page_size)
            tokens = np.zeros((lanes, c), np.int32)
            slot_arr = np.zeros((lanes, c), np.int32)
            ctx = np.zeros((lanes, width), np.int32)
            ctx_pos = np.zeros((lanes, width), np.int32)
            ctx_mask = np.zeros((lanes, width), bool)
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
            self._prefill_steps += 1
            self._prefill_secs += time.perf_counter() - t_pre
            self._prefill_cells += lanes * c * width
            chunk_tokens = sum(hi - lo for _s, lo, hi, *_r in prefill_args)
            step_tokens += chunk_tokens
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
            m = self.metrics()
            if m is not None:
                m["tokens"].inc(chunk_tokens, tags={"phase": "prefill"})
        # ---- token-level decode batch
        if decode_args:
            b = self.max_batch
            t_dec = time.perf_counter()
            if self.attention_impl == "paged":
                # page-granular context: block tables + context lengths.
                # The table width snaps to the smallest bucket covering
                # the max used pages across lanes; on a card its graph
                # replays
                max_used = max(-(-n // self.page_size)
                               for *_a, n in decode_args)
                width = next(w for w in self._paged_width_buckets()
                             if w >= max_used)
                lanes = [(last, slot, table, n)
                         for _s, last, slot, _c, table, n in decode_args]
                graph = self._decode_graphs.get(width)
                if graph is not None:
                    out = self._replay_decode(graph, lanes)
                else:
                    out = self._paged_decode_forward(self._to_device(
                        _pack_paged_decode(lanes, b, width,
                                           self.page_size)), width)
                next_tok = out if self.temperature <= 0.0 \
                    else self._pick(out)
            else:
                tokens = np.zeros((b, 1), np.int32)
                slot_arr = np.zeros((b, 1), np.int32)
                q_pos = np.zeros((b, 1), np.int32)
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
                    np.zeros((b,), np.int32))
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
            m = self.metrics()
            if m is not None:
                m["tokens"].inc(len(decode_args), tags={"phase": "decode"})
                m["decode_step"].observe(decode_dt)
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
        self._set_gauges()
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

    def metrics(self):
        """This process's ``llm_metrics()`` and ``llm_prefix_metrics()``
        families (_private/metrics.py), or None if they cannot load."""
        if self._metrics is None:
            try:
                from ray_tpu_torch._private.metrics import (
                    llm_metrics, llm_prefix_metrics)

                (tokens, pages, batch, ttft, queue, tps,
                 decode_step) = llm_metrics()
                prefix_hits, shipped = llm_prefix_metrics()
                self._metrics = {"tokens": tokens, "pages": pages,
                                 "batch": batch, "ttft": ttft,
                                 "queue": queue, "tps": tps,
                                 "decode_step": decode_step,
                                 "prefix_hits": prefix_hits,
                                 "shipped": shipped}
            except Exception:
                return None
        return self._metrics

    def _shared_page_count(self) -> int:
        """Lock held: pages referenced by more than one sequence."""
        return sum(1 for r in self._page_refs if r > 1)

    def _set_gauges(self) -> None:
        m = self.metrics()
        if m is None:
            return
        m["pages"].set(self.num_pages - 1 - len(self._free_pages),
                       tags={"state": "used"})
        m["pages"].set(len(self._free_pages), tags={"state": "free"})
        m["pages"].set(self._shared_page_count(), tags={"state": "shared"})
        m["batch"].set(self._last_batch)
        m["queue"].set(len(self._queued))
        m["tps"].set(self._last_step_tokens)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"steps": self._steps,
                    "attention_impl": self.attention_impl,
                    "decode_steps": self._decode_steps,
                    "decode_secs": self._decode_secs,
                    "decode_graph_replays": self._decode_graph_replays,
                    "decode_graph_captures": len(self._decode_graphs),
                    "prefill_steps": self._prefill_steps,
                    "prefill_secs": self._prefill_secs,
                    "prefill_cells": self._prefill_cells,
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


# ----------------------------------------------------------- replica target


class _LLMCallable:
    """The deployment target hosted by each ``llm_deployment`` replica.

    ``__call__`` is the streaming endpoint: it admits the request and
    yields token items as the pinned loop (installed by the controller
    through ``__rt_dag_llm_loop__``) produces them.  The generator's
    finally detaches the consumer, so an abandoned stream (SSE
    disconnect -> generator cancel) frees its KV pages after the grace
    window instead of decoding to max_seq_len."""

    def __init__(self, warm: bool = True, **engine_kwargs):
        self._engine = LLMEngine(**engine_kwargs)
        if warm:
            # run both step shapes (a prefill chunk, a decode step) HERE,
            # inside the replica constructor: the deploy health gate
            # (serve_replica_health_timeout_s) covers the kernel build
            # and cuBLAS's first calls, which the first real request
            # would otherwise pay while health probes run
            self._engine.generate_batch(
                [{"tokens": [1], "max_new_tokens": 2}])

    def __call__(self, request):
        emit_from = 0
        kv_pack = None
        if isinstance(request, dict):
            emit_from = int(request.get("emit_from") or 0)
            if request.get("kv_ref") is not None:
                # disaggregated prefill: resolve the shipped KV pages.
                # ANY failure (pull error, pack corruption) falls back to
                # a local prefill: always correct, just slower.
                request = dict(request)
                ref = request.pop("kv_ref")
                try:
                    import ray_tpu_torch
                    from ray_tpu_torch._private.object_transfer import \
                        unpack_kv_pages

                    kv_pack = unpack_kv_pages(
                        ray_tpu_torch.get(ref, timeout=30.0))
                except Exception:
                    kv_pack = None
        seq = self._engine.submit(request, kv_pack=kv_pack)
        try:
            yield from self._engine.iter_tokens(seq, emit_from)
        finally:
            self._engine.release(seq)

    def prefill(self, request):
        """Prefill-pool endpoint: run the prefill phase only, put the
        packed KV pages (host tensors) into the object store, and return
        the shipping metadata the handle forwards to a decode replica."""
        import ray_tpu_torch
        from ray_tpu_torch._private.object_transfer import pack_kv_pages

        payload = self._engine.prefill_request(request)
        buf = pack_kv_pages(payload["meta"], payload["rows"])
        meta = payload["meta"]
        return {"request_id": meta["request_id"],
                "kv_ref": ray_tpu_torch.put(buf),
                "first_token": meta["first_token"],
                "n": meta["n"], "pages": meta["pages"],
                "nbytes": len(buf)}

    def generate(self, request):
        """Non-streaming convenience: the full generation as one list
        (still continuous-batched with everything else in flight)."""
        toks: List[int] = []
        for item in self(request):
            toks.extend(item["tokens"])
        return {"request_id": None, "tokens": toks}

    def stats(self):
        return self._engine.stats()

    def __rt_save__(self):
        return self._engine.save_state()

    def __rt_restore__(self, state):
        self._engine.restore_state(state)


class _LLMBatchCallable:
    """The ``@serve.batch`` static-batching baseline: requests coalesce
    into a fixed batch, the whole batch generates to completion in one
    call, then disbands.  ``__call__`` serves the same streaming
    contract as the continuous path (items of <= stream_flush_tokens
    tokens), but can only start emitting once the whole batch finished."""

    def __init__(self, max_batch_size: int = 8,
                 batch_wait_timeout_s: float = 0.005, warm: bool = True,
                 **engine_kwargs):
        from ray_tpu_torch.serve.api import batch

        self._engine = LLMEngine(**engine_kwargs)
        if warm:
            self._engine.generate_batch(
                [{"tokens": [1], "max_new_tokens": 2}])
        self._gen = batch(self._run_batch,
                          max_batch_size=max_batch_size,
                          batch_wait_timeout_s=batch_wait_timeout_s)

    def _run_batch(self, requests):
        return self._engine.generate_batch(requests)

    def __call__(self, request):
        toks = self._gen(request)  # blocks until this request's batch ends
        flush = self._engine.stream_flush_tokens
        for i in range(0, len(toks), flush):
            yield {"i": i, "tokens": toks[i:i + flush],
                   "done": i + flush >= len(toks)}


def run_llm_loop(worker, instance, *_args) -> Dict[str, Any]:
    """Worker-side entry for the ``__rt_dag_llm_loop__`` system method
    (_private/worker.py): pins this exec thread to the replica engine's
    decode loop until the replica dies."""
    target = getattr(instance, "_callable", instance)
    engine = getattr(target, "_engine", None)
    if not isinstance(engine, LLMEngine):
        raise TypeError(
            "__rt_dag_llm_loop__ requires an llm_deployment replica "
            f"(got {type(target).__name__})")
    return engine.run_loop()


def llm_deployment(name: str = "llm", *, num_replicas: Any = 1,
                   max_ongoing_requests: int = 64,
                   ray_actor_options: Optional[Dict[str, Any]] = None,
                   autoscaling_config: Optional[Dict[str, Any]] = None,
                   request_timeout_s: Optional[float] = None,
                   hedge_after_s: Any = None, idempotent: bool = False,
                   prefill_replicas: int = 0,
                   **engine_kwargs):
    """Build an LLM serving Application: replicas host an
    :class:`LLMEngine` and the controller installs the pinned decode
    loop on each one.  ``engine_kwargs`` go to :class:`LLMEngine`
    (model=, params=, page_size=, num_pages=, max_batch=, prefill_chunk=,
    max_queue=, seed=, detach_grace_s=, prefix_sharing=, dtype=,
    device=); unset knobs fall back to the ``llm_*`` config defaults,
    and the device to ``cuda``: a replica that cannot see a card raises
    in its constructor unless given ``device="cpu"``.

    ``prefill_replicas > 0`` disaggregates the two serving phases: a
    sibling ``{name}-prefill`` pool (same engine config and actor
    options) runs chunked prefill and ships the finished KV pages to
    this deployment's decode replicas through the object store.
    ``ray_actor_options={"num_gpus": 0.5}`` puts a prefill and a decode
    replica on one card.

    Usage::

        app = serve.llm_deployment("chat", model="tiny", max_batch=16,
                                   ray_actor_options={"num_gpus": 1})
        handle = serve.run(app)
        # stream over HTTP: POST /chat with Accept: text/event-stream
    """
    from ray_tpu_torch.serve.api import Deployment

    d = Deployment(_LLMCallable, name, num_replicas=num_replicas,
                   max_ongoing_requests=max_ongoing_requests,
                   ray_actor_options=dict(ray_actor_options or {}),
                   autoscaling_config=dict(autoscaling_config)
                   if autoscaling_config else None,
                   llm=True, request_timeout_s=request_timeout_s,
                   hedge_after_s=hedge_after_s, idempotent=idempotent,
                   prefill_replicas=int(prefill_replicas))
    return d.bind(**engine_kwargs)
