"""Cluster pub/sub over named channels, backed by the head service.

Equivalent of the reference's pub/sub layer
(reference: src/ray/pubsub/publisher.h:307 + subscriber.h — typed
channels carrying node events, actor state, and error info).  Built-in
channels the head publishes to:

  node_events   — {"event": "registered"|"dead", "node_id", ...}
  actor_events  — {"actor_id", "state": ALIVE|RESTARTING|DEAD, ...}
  error_info    — {"kind": "worker_died", "worker_id", "reason", ...}

Any other channel name works for application events via publish().
Events live in a 1000-entry ring per channel; a slow subscriber that
falls further behind than that misses the overwritten events (same
bounded-buffer semantics as the reference's publisher).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional


def _head():
    import ray_tpu_torch

    return ray_tpu_torch.api._worker().head


def publish(channel: str, payload: Any) -> int:
    """Publish an event; returns its sequence number."""
    return _head().call("publish", channel=channel, payload=payload)["seq"]


def poll(channel: str, after_seq: int = 0,
         timeout_s: float = 0.0) -> List[Dict[str, Any]]:
    """Events with seq > after_seq; blocks up to timeout_s when empty."""
    reply = _head().call(
        "subscribe_poll", channel=channel, after_seq=after_seq,
        timeout_ms=int(timeout_s * 1000),
        timeout=timeout_s + 30.0)
    return reply["events"]


def latest_seq(channel: str) -> int:
    return _head().call("subscribe_poll", channel=channel,
                        after_seq=1 << 60, timeout_ms=0)["latest_seq"]


def listen(channel: str, from_seq: Optional[int] = None,
           poll_timeout_s: float = 10.0,
           stop_after_idle_s: Optional[float] = None) -> Iterator[Dict[str, Any]]:
    """Generator yielding events as they arrive.  Starts at the current
    tail unless from_seq is given.  Stops after stop_after_idle_s of
    silence (None = forever)."""
    seq = latest_seq(channel) if from_seq is None else from_seq
    last_event = time.monotonic()
    while True:
        events = poll(channel, after_seq=seq, timeout_s=poll_timeout_s)
        if events:
            last_event = time.monotonic()
            for e in events:
                seq = max(seq, e["seq"])
                yield e
        elif (stop_after_idle_s is not None
              and time.monotonic() - last_event >= stop_after_idle_s):
            return
