"""End-to-end request deadlines (copied from ray_tpu's deadlines module).

A deadline is an ABSOLUTE wall-clock instant (epoch seconds,
``time.time()`` base) so it survives process hops.  The active deadline
rides a contextvar; ``X-Request-Deadline-Ms`` style values (absolute
epoch milliseconds) parse through :func:`from_header`, and malformed
values are ignored, never an error.

The metrics registry is not ported yet, so :func:`count_exceeded` counts
into the module-level ``EXCEEDED`` dict (where -> count).
"""

from __future__ import annotations

import contextvars
import threading
import time
from typing import Dict, Optional

DEADLINE_HEADER = "x-request-deadline-ms"

_current: "contextvars.ContextVar[Optional[float]]" = \
    contextvars.ContextVar("rt_deadline", default=None)

EXCEEDED: Dict[str, int] = {}
_exceeded_lock = threading.Lock()


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
    the TIGHTER of the two wins.  None when neither applies."""
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
    """Parse an absolute epoch-MILLISECONDS deadline.  Malformed or
    non-positive values return None — the request proceeds unbounded."""
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
    """Count one enforcement (where = queued | running | get |
    admission) into ``EXCEEDED``."""
    with _exceeded_lock:
        EXCEEDED[where] = EXCEEDED.get(where, 0) + n
