"""End-to-end request deadlines: context propagation + enforcement glue.

Every robustness layer before this handled crash-stop failures; tail
latency comes from components that are *slow, not dead* — and nothing
slow can be routed around unless requests carry a latency bound.  This
module makes a deadline first-class task metadata, the way trace
context already is (tracing.py):

  - A deadline is an ABSOLUTE wall-clock instant (epoch seconds,
    ``time.time()`` base) so it survives process hops — the gRPC
    deadline model, not a per-hop timeout that resets at every layer.
  - The ACTIVE deadline rides a contextvar.  ``.options(timeout_s=…)``
    stamps ``min(now + timeout_s, ambient)`` into the TaskSpec;
    the executing worker re-activates the spec's deadline, so nested
    ``.remote()`` calls and ``get()`` calls inside the task body
    inherit the caller's remaining budget automatically.
  - Serve's HTTP ingress continues external deadlines from an
    ``X-Request-Deadline-Ms`` header (absolute epoch milliseconds);
    malformed values are ignored, never an error.

Enforcement sites (each increments
``ray_tpu_deadline_exceeded_total{where=…}``):
  queued     owner pump / agent lease queue / worker task queue — the
             task fails fast with DeadlineExceededError WITHOUT running
  running    the owner's deadline sweep resolves an in-flight task and
             cancels it on the worker (cooperative, then force)
  get        ``get()`` spends only the remaining ambient budget
  admission  the LLM engine refuses sequences whose remaining budget
             cannot cover prefill + one decode step
"""

from __future__ import annotations

import contextvars
import time
from typing import Optional

DEADLINE_HEADER = "x-request-deadline-ms"

_current: "contextvars.ContextVar[Optional[float]]" = \
    contextvars.ContextVar("rt_deadline", default=None)

_metric = None


def current_deadline() -> Optional[float]:
    """The active absolute deadline (epoch seconds), or None."""
    return _current.get()


def activate(deadline: Optional[float]):
    """Make `deadline` the active deadline on this thread/coroutine;
    returns a token for `restore`.  None clears (an explicitly
    undeadlined scope inside a deadlined one)."""
    return _current.set(deadline)


def restore(token) -> None:
    _current.reset(token)


def effective_deadline(timeout_s: Optional[float] = None,
                       now: Optional[float] = None) -> Optional[float]:
    """Combine an explicit per-call timeout with the ambient deadline:
    the TIGHTER of the two wins (a callee can shrink its budget, never
    grow past the caller's).  None when neither applies."""
    ambient = _current.get()
    if timeout_s is None:
        return ambient
    now = time.time() if now is None else now
    mine = now + float(timeout_s)
    return mine if ambient is None else min(mine, ambient)


def remaining(deadline: Optional[float] = None,
              now: Optional[float] = None) -> Optional[float]:
    """Seconds left on `deadline` (the ambient one when omitted); never
    negative.  None = unbounded."""
    if deadline is None:
        deadline = _current.get()
    if deadline is None:
        return None
    now = time.time() if now is None else now
    return max(0.0, deadline - now)


def expired(deadline: Optional[float],
            now: Optional[float] = None) -> bool:
    if not deadline:
        return False
    return (time.time() if now is None else now) >= deadline


def from_header(value) -> Optional[float]:
    """Parse an ``X-Request-Deadline-Ms`` header: absolute epoch
    MILLISECONDS.  Malformed or non-positive values return None — the
    request proceeds unbounded, never an error (matching the
    traceparent contract in tracing.py)."""
    if value is None:
        return None
    try:
        ms = float(str(value).strip())
    except (TypeError, ValueError):
        return None
    if ms <= 0:
        return None
    return ms / 1000.0


def count_exceeded(where: str, n: int = 1) -> None:
    """Increment ``ray_tpu_deadline_exceeded_total{where=…}``
    (where = queued | running | get | admission)."""
    global _metric
    if _metric is None:
        from ray_tpu_torch._private.metrics import deadline_metrics

        _metric = deadline_metrics()
    _metric.inc(n, tags={"where": where})
