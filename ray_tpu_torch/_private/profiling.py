"""Live introspection: stack dumps, a sampling profiler, loop-lag probes.

Equivalent role to the reference's reporter/profiling stack
(reference: dashboard/modules/reporter/profile_manager.py:79 — py-spy
dump/record driven over the reporter agent; `ray stack` in
scripts.py:1830) — but in-process: every daemon and worker answers a
``proc_stack``/``profile`` RPC itself via ``sys._current_frames()`` and
a timer-thread sampler, so no external profiler binary or ptrace
capability is needed.

Three pieces:
  - ``capture_stacks()`` / ``format_stacks()``: a point-in-time traceback
    of every thread in this process (the `rtpu stack` payload);
  - ``StackSampler``: an on-demand sampling profiler (configurable hz)
    whose aggregate emits collapsed-stack text (flamegraph.pl input) or
    speedscope-compatible JSON;
  - ``loop_lag_probe()``: an always-on asyncio coroutine measuring event
    -loop scheduling lag, exported as the
    ``ray_tpu_event_loop_lag_seconds{role=...}`` gauge — the first
    number to look at when a head/agent/worker feels wedged.

``IntrospectionRpcMixin`` gives any RpcHost (head, node agent, core
worker) the ``proc_stack`` and ``profile`` RPC surface.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple


# ---------------------------------------------------------------- stack dumps


def capture_stacks() -> List[Dict[str, Any]]:
    """Tracebacks of every live thread, outermost frame first
    (msgpack/json-safe — this is the ``proc_stack`` RPC payload)."""
    threads = {t.ident: t for t in threading.enumerate()}
    me = threading.get_ident()
    out: List[Dict[str, Any]] = []
    for ident, frame in sys._current_frames().items():
        t = threads.get(ident)
        frames = [{"file": fs.filename, "line": fs.lineno or 0,
                   "func": fs.name, "code": (fs.line or "").strip()}
                  for fs in traceback.extract_stack(frame)]
        out.append({
            "thread_id": ident,
            "name": t.name if t is not None else f"thread-{ident}",
            "daemon": bool(t.daemon) if t is not None else True,
            "current": ident == me,  # the dumping (RPC) thread itself
            "frames": frames,
        })
    # stable order: main thread first, then by name
    out.sort(key=lambda s: (s["name"] != "MainThread", s["name"]))
    return out


def format_stacks(stacks: List[Dict[str, Any]], title: str = "") -> str:
    """faulthandler-style text rendering of ``capture_stacks()``."""
    lines: List[str] = []
    if title:
        lines.append(title)
    for s in stacks:
        flags = []
        if s.get("daemon"):
            flags.append("daemon")
        if s.get("current"):
            flags.append("introspection rpc")
        suffix = f" ({', '.join(flags)})" if flags else ""
        lines.append(f"Thread {s['thread_id']} [{s['name']}]{suffix}:")
        for f in s.get("frames") or []:
            lines.append(f"  File \"{f['file']}\", line {f['line']}, "
                         f"in {f['func']}")
            if f.get("code"):
                lines.append(f"    {f['code']}")
        lines.append("")
    return "\n".join(lines)


def proc_stack_payload() -> Dict[str, Any]:
    stacks = capture_stacks()
    return {
        "pid": os.getpid(),
        "argv0": sys.argv[0] if sys.argv else "",
        "threads": stacks,
        "text": format_stacks(stacks, title=f"process {os.getpid()}"),
    }


# ----------------------------------------------------------- sampling profiler


class StackSampler:
    """Timer-thread sampler: every 1/hz seconds snapshot every thread's
    stack via ``sys._current_frames()`` and aggregate counts per unique
    stack (reference role: `py-spy record`, without the dependency —
    the GIL makes the snapshot itself consistent)."""

    def __init__(self, hz: float):
        self.hz = max(1.0, float(hz))
        self.interval = 1.0 / self.hz
        self.started_at = time.time()
        self._t0 = time.monotonic()
        self.duration_s = 0.0
        self.samples = 0  # sampling ticks taken
        # (thread_name, ((file, line, func), ... root->leaf)) -> count
        self._counts: Dict[Tuple[str, Tuple], int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="rt-profiler", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        self.duration_s = time.monotonic() - self._t0

    def _run(self) -> None:
        own = threading.get_ident()
        names: Dict[int, str] = {}
        refresh = 0
        while not self._stop.wait(self.interval):
            if refresh <= 0:  # thread-name map refreshes ~1/s, not per tick
                names = {t.ident: t.name for t in threading.enumerate()}
                refresh = int(self.hz) or 1
            refresh -= 1
            frames = sys._current_frames()
            self.samples += 1
            for ident, frame in frames.items():
                if ident == own:
                    continue
                stack: List[Tuple[str, int, str]] = []
                f = frame
                while f is not None:
                    code = f.f_code
                    stack.append((code.co_filename, f.f_lineno,
                                  code.co_name))
                    f = f.f_back
                stack.reverse()  # root first
                key = (names.get(ident, f"thread-{ident}"), tuple(stack))
                self._counts[key] = self._counts.get(key, 0) + 1

    # ---- output formats ----------------------------------------------------

    @staticmethod
    def _frame_label(file: str, line: int, func: str) -> str:
        return f"{func}@{os.path.basename(file)}:{line}"

    def collapsed(self) -> str:
        """flamegraph.pl-compatible collapsed stacks: semicolon-joined
        frames (thread name as the root frame), space, sample count."""
        lines = []
        for (tname, stack), count in sorted(
                self._counts.items(), key=lambda kv: -kv[1]):
            path = ";".join(
                [tname.replace(";", "_").replace(" ", "_")]
                + [self._frame_label(*fr) for fr in stack])
            lines.append(f"{path} {count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def speedscope(self, name: str = "") -> Dict[str, Any]:
        """speedscope "sampled" profile (https://www.speedscope.app —
        schema per its file-format-schema.json): one profile merging all
        threads, weights in seconds (count * sampling interval)."""
        frame_index: Dict[Tuple[str, int, str], int] = {}
        frames_out: List[Dict[str, Any]] = []

        def idx(fr: Tuple[str, int, str]) -> int:
            i = frame_index.get(fr)
            if i is None:
                i = frame_index[fr] = len(frames_out)
                frames_out.append({"name": fr[2], "file": fr[0],
                                   "line": fr[1]})
            return i

        samples: List[List[int]] = []
        weights: List[float] = []
        total = 0.0
        for (tname, stack), count in self._counts.items():
            chain = [idx((f"[thread {tname}]", 0, f"[thread {tname}]"))]
            chain.extend(idx(fr) for fr in stack)
            samples.append(chain)
            w = count * self.interval
            weights.append(w)
            total += w
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "shared": {"frames": frames_out},
            "profiles": [{
                "type": "sampled",
                "name": name or f"pid {os.getpid()}",
                "unit": "seconds",
                "startValue": 0,
                "endValue": total,
                "samples": samples,
                "weights": weights,
            }],
            "exporter": "ray_tpu-profiler",
        }


# process-singleton sampler handle (one profile at a time per process)
_sampler_lock = threading.Lock()
_active_sampler: Optional[StackSampler] = None


def start_sampler(hz: float = 0) -> Dict[str, Any]:
    from ray_tpu_torch._private.config import config

    global _active_sampler
    with _sampler_lock:
        if _active_sampler is not None:
            return {"ok": False, "error": "profiler already running"}
        s = StackSampler(hz or float(config.profiler_default_hz))
        # start inside the lock: a concurrent stop_sampler() must never
        # observe (and join) a published-but-unstarted thread
        s.start()
        _active_sampler = s
    return {"ok": True, "hz": s.hz, "pid": os.getpid()}


def stop_sampler(fmt: str = "collapsed") -> Dict[str, Any]:
    global _active_sampler
    with _sampler_lock:
        s, _active_sampler = _active_sampler, None
    if s is None:
        return {"ok": False, "error": "no profiler running"}
    s.stop()
    if fmt == "speedscope":
        profile = json.dumps(s.speedscope())
    else:
        fmt = "collapsed"
        profile = s.collapsed()
    return {"ok": True, "format": fmt, "profile": profile,
            "pid": os.getpid(), "hz": s.hz, "samples": s.samples,
            "duration_s": round(s.duration_s, 3)}


def sampler_status() -> Dict[str, Any]:
    with _sampler_lock:
        s = _active_sampler
    if s is None:
        return {"running": False, "pid": os.getpid()}
    return {"running": True, "pid": os.getpid(), "hz": s.hz,
            "samples": s.samples,
            "elapsed_s": round(time.monotonic() - s._t0, 3)}


# ------------------------------------------------------------ loop-lag probes


async def loop_lag_probe(role: str,
                         on_sample: Optional[Callable[[float], None]] = None,
                         tags: Optional[Dict[str, str]] = None
                         ) -> None:
    """Always-on health probe for the calling event loop: sleep a fixed
    interval and measure how late the wakeup lands.  A loop wedged by a
    long callback (accidental sync IO, GIL-hogging deserialization)
    shows up here seconds before anything times out.  Exported as
    ``ray_tpu_event_loop_lag_seconds{role=...}``; ``tags`` adds extra
    labels beside role (the head's ingest shards probe their own loops
    as ``{role=head_shard,shard=...}``); ``on_sample`` lets the host
    also fold the value into heartbeats/time-series."""
    from ray_tpu_torch._private.config import config
    from ray_tpu_torch._private.metrics import loop_lag_gauge

    gauge = loop_lag_gauge()
    gauge_tags = {"role": role, **(tags or {})}
    interval = max(0.05, config.loop_lag_probe_interval_ms / 1000.0)
    loop = asyncio.get_running_loop()
    while True:
        t0 = loop.time()
        await asyncio.sleep(interval)
        lag = max(0.0, loop.time() - t0 - interval)
        try:
            gauge.set(lag, tags=gauge_tags)
            if on_sample is not None:
                on_sample(lag)
        except Exception:
            pass


# ------------------------------------------------------------- RPC surface


class IntrospectionRpcMixin:
    """proc_stack + profile RPCs for any RpcHost-derived daemon.  The
    handlers run on the host's IO/event loop, which stays responsive
    while user code occupies other threads — exactly why the stack of a
    busy worker is still observable."""

    async def rpc_proc_stack(self):
        return proc_stack_payload()

    async def rpc_profile(self, op: str = "run", hz: float = 0,
                          duration_s: float = 2.0, fmt: str = "collapsed"):
        """op="run": start → sleep duration_s → stop, returning the
        profile in one call (the CLI path).  op="start"/"stop"/"status"
        expose the same sampler for long manual sessions."""
        from ray_tpu_torch._private.config import config

        if op == "start":
            return start_sampler(hz)
        if op == "stop":
            return stop_sampler(fmt)
        if op == "status":
            return sampler_status()
        started = start_sampler(hz)
        if not started.get("ok"):
            return started
        try:
            await asyncio.sleep(
                min(float(duration_s), float(config.profiler_max_duration_s)))
        finally:
            result = stop_sampler(fmt)
        return result
