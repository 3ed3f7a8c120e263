"""A bound on a blocking call in the port's cluster tests.

``bounded(fn, seconds)`` runs ``fn`` on a daemon thread and fails the
test when it has not returned within ``seconds``, so a stalled cluster
fails one test instead of holding the whole run until its time limit.
The thread is left behind: the module's cluster fixture shuts the
cluster down, which ends whatever the call still waits on.

Imports nothing of JAX: the port's test modules and the helpers their
workers import may use it.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import pytest


def bounded(fn: Callable[[], Any], seconds: float, what: str = "") -> Any:
    """``fn()``'s result or exception, or a test failure after
    ``seconds``."""
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["error"] = e

    t = threading.Thread(target=run, name="bounded-call", daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"{what or getattr(fn, '__name__', 'call')} did not "
                    f"return within {seconds:g} s")
    if "error" in out:
        raise out["error"]
    return out["value"]
