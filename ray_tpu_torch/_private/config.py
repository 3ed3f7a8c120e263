"""Config knobs of the LLM serving tier.

The ``llm_*`` entries of ray_tpu's config registry that the engine
reads, with the same names and defaults; each is overridable per process
with an ``RT_<NAME>`` environment variable (JSON-decoded when it parses,
else the raw string).  ``llm_disagg_min_prompt`` is read only by the
deployment routing and comes with it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

_DEFS: Dict[str, Any] = {
    "llm_page_size": 16,           # KV-cache tokens per page
    "llm_kv_pages": 0,             # pages per engine; 0 = sized so
    # max_batch sequences can run at max_seq_len simultaneously
    "llm_max_batch_size": 32,      # decode lanes per engine step
    "llm_prefill_chunk": 64,       # prompt tokens prefilled per step —
    # bounds how long one long prompt can stall in-flight decodes
    "llm_prefill_lanes": 8,        # sequences prefilling one chunk each
    # per step (batched prefill: admitting N streams costs N/lanes steps)
    "llm_stream_flush_tokens": 4,  # tokens coalesced per stream item
    # after the first (the first token flushes immediately for TTFT)
    "llm_admission_queue": 256,    # queued sequences before a shed
    "llm_detach_grace_s": 2.0,     # KV pages survive a vanished consumer
    # this long (the re-attach window) before recycling
    "llm_done_seq_ttl_s": 30.0,    # finished sequences replayable (by
    # request_id) this long for duplicate/late retries
    "llm_prefix_sharing": True,    # copy-on-write prefix sharing over
    # refcounted page-aligned prompt prefixes
    "llm_attention_impl": "auto",  # decode attention: "paged" = the paged
    # CUDA kernel over block tables (cost tracks USED context), "dense" =
    # gather-then-dense reference (cost tracks max context), "auto" = paged
    "llm_temperature": 0.0,        # 0 = greedy argmax
    "llm_top_k": 0,                # 0 = full vocab; >0 = sample among top-k
}


class _Config:
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in _DEFS:
            raise AttributeError(f"Unknown config: {name}")
        env = os.environ.get(f"RT_{name.upper()}")
        if env is not None:
            try:
                return json.loads(env)
            except json.JSONDecodeError:
                return env
        return _DEFS[name]


config = _Config()
