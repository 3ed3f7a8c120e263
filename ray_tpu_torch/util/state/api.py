"""State API: cluster introspection for humans and tools.

Equivalent of the reference's state API
(reference: python/ray/util/state/api.py — list_tasks/list_actors/
list_objects/list_nodes backed by the state head aggregating GCS
tables and per-raylet GetTasksInfo/GetObjectsInfo;
src/ray/gcs/gcs_server/gcs_task_manager.h for the task-event store).
`timeline()` renders the task-event store as a Chrome trace, the
equivalent of `ray.timeline()`.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def _head():
    import ray_tpu_torch

    return ray_tpu_torch.api._worker().head


def list_tasks(state: str = "", name: str = "",
               limit: int = 1000) -> List[Dict[str, Any]]:
    """Task records merged from worker-flushed state transitions.
    Filters: state in SUBMITTED/RUNNING/FINISHED/FAILED, task name."""
    return _head().call("list_tasks", state=state, name=name,
                        limit=limit)["tasks"]


def list_actors() -> List[Dict[str, Any]]:
    return _head().call("list_actors")["actors"]


def list_nodes() -> List[Dict[str, Any]]:
    table = _head().call("node_table")
    return list(table.values())


def list_objects(limit: int = 1000) -> List[Dict[str, Any]]:
    """Plasma object summaries aggregated across every node's store."""
    return _head().call("list_objects", limit=limit)["objects"]


def list_placement_groups() -> List[Dict[str, Any]]:
    return _head().call("list_placement_groups")["placement_groups"]


def summarize_tasks() -> Dict[str, Dict[str, Any]]:
    """Per-function task aggregates off the head's task-event store
    (reference: `ray summary tasks`): for each task/method name, state
    counts plus queued (submitted→leased) and running (running→done)
    p50/p99/mean percentiles — ``{name: {"kind", "states",
    "queued": {p50_ms, p99_ms, ...} | None, "running": ...}}``."""
    return _head().call("cluster_summary")["tasks"]


def summarize_actors() -> Dict[str, Any]:
    """Actor rollup (reference: `ray summary actors`): counts by state
    plus per-method call counts from the task-event store."""
    return _head().call("cluster_summary")["actors"]


def summarize_objects() -> Dict[str, Any]:
    """Cluster object-store rollup from the per-node heartbeat byte
    breakdowns (reference: `ray summary objects`): totals for arena,
    pinned, spilled and channel bytes plus the per-node breakdowns."""
    return _head().call("cluster_summary")["objects"]


def memory_summary(top_n: int = 0) -> Dict[str, Any]:
    """The joined cluster memory view behind `rtpu memory` (reference:
    `ray memory`): per-node byte breakdowns, top-N objects by size with
    owner + creation call-site, per-owner ref counts, and the `leaks`
    tripwire section (dead-owner pins, borrowed refs past TTL, orphaned
    channel slots)."""
    return _head().call("memory_view", top_n=top_n, timeout=60)


def task_timeline_events(records) -> List[Dict[str, Any]]:
    """Chrome-trace events from merged task records (shared by
    `timeline()` and the head's /api/timeline):

    - one ``ph:"X"`` duration slice per executed task (as before);
    - ``ph:"s"``/``ph:"f"`` flow events tying the submit point (on the
      submitter's track) to the execution slice (on the executor's
      track), so Perfetto draws submit→execute causality arrows;
    - one ``ph:"i"`` instant event for tasks that FAILED without ever
      reaching ``running`` (cancelled/errored while queued) — previously
      these were silently dropped from the trace.
    """
    events: List[Dict[str, Any]] = []
    for t in records:
        start = t.get("running_ts")
        end = t.get("finished_ts") or t.get("failed_ts")
        name = t.get("name") or t.get("task_id", "")[:8]
        if start is not None and end is not None:
            events.append({
                "name": name,
                "cat": t.get("kind", "task"),
                "ph": "X",
                "ts": int(start * 1e6),
                "dur": max(1, int((end - start) * 1e6)),
                "pid": t.get("node_id", "")[:8],
                "tid": t.get("worker_id", "")[:8],
                "args": {"task_id": t.get("task_id"),
                         "state": t.get("state")},
            })
            sub = t.get("submitted_ts")
            if sub is not None:
                fid = t.get("task_id", "")[:16]
                events.append({
                    "name": "submit", "cat": "task_flow", "ph": "s",
                    "id": fid, "ts": int(sub * 1e6),
                    "pid": (t.get("caller_node_id")
                            or t.get("node_id", ""))[:8],
                    "tid": (t.get("caller_worker_id")
                            or t.get("worker_id", ""))[:8],
                })
                events.append({
                    "name": "submit", "cat": "task_flow", "ph": "f",
                    "bt": "e", "id": fid,
                    "ts": int(start * 1e6),
                    "pid": t.get("node_id", "")[:8],
                    "tid": t.get("worker_id", "")[:8],
                })
        elif end is not None:
            # never ran: instant event at the failure point so
            # queue-time failures stay visible in the trace
            events.append({
                "name": name,
                "cat": t.get("kind", "task"),
                "ph": "i", "s": "p",
                "ts": int(end * 1e6),
                "pid": (t.get("node_id")
                        or t.get("caller_node_id", ""))[:8],
                "tid": (t.get("worker_id")
                        or t.get("caller_worker_id", ""))[:8],
                "args": {"task_id": t.get("task_id"),
                         "state": t.get("state"),
                         "error": t.get("error", "")},
            })
    return events


def timeline(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """Chrome-trace events (chrome://tracing / perfetto) from the task
    event store (reference: ray.timeline(), task profile events).
    Returns the event list; writes JSON to `path` if given."""
    events = task_timeline_events(list_tasks(limit=100_000))
    if path:
        with open(path, "w") as f:
            json.dump(events, f)
    return events


def list_traces(limit: int = 100) -> List[Dict[str, Any]]:
    """Summaries of recent traces from the head's trace store, newest
    first (reference: ray.util.tracing — exported spans, here queryable
    in-cluster)."""
    return _head().call("list_traces", limit=limit)["traces"]


def get_trace(trace_id: str) -> Dict[str, Any]:
    """One trace: every flushed span, sorted by start time.  Raises
    ValueError if the trace is unknown (not sampled, expired from the
    bounded store, or not flushed yet)."""
    reply = _head().call("get_trace", trace_id=trace_id)
    if not reply.get("found"):
        raise ValueError(f"no trace {trace_id!r} in the trace store")
    return reply["trace"]


def get_log(node_id: str = "", filename: str = "",
            tail: int = 1000) -> str:
    """Read a daemon/worker log from the session directory
    (reference: ray.util.state.get_log)."""
    import glob
    import os

    import ray_tpu_torch

    w = ray_tpu_torch.api._worker()
    session = getattr(w, "session_dir", None)
    if session is None:
        base = os.environ.get("RT_TMPDIR", "/tmp/ray_tpu")
        sessions = sorted(glob.glob(os.path.join(base, "session_*")))
        if not sessions:
            return ""
        session = sessions[-1]
    logs = os.path.join(session, "logs")
    if filename:
        # an explicit filename must resolve exactly — silently falling
        # back to "latest log" here returned the WRONG file on typos
        target = os.path.join(logs, filename)
        if not os.path.exists(target):
            raise FileNotFoundError(
                f"no log file {filename!r} under {logs}")
    else:
        candidates = sorted(glob.glob(os.path.join(logs, "*.log")))
        if not candidates:
            return ""
        target = candidates[-1]
    with open(target, errors="replace") as f:
        lines = f.readlines()
    return "".join(lines[-tail:])
