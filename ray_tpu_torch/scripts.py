"""CLI: stand clusters up and operate them from the shell.

Equivalent of the reference's `ray` CLI
(reference: python/ray/scripts/scripts.py — start :568, stop :1044,
status; job CLI in dashboard/modules/job/cli.py; summary/state CLI in
python/ray/util/state/state_cli.py).  Installed as `rtpu` via
[project.scripts].

  rtpu start --head [--port N] [--num-cpus N] [--resources JSON]
  rtpu start --address HOST:PORT [--num-cpus N]     # join as a worker node
  rtpu status [--watch] [--address HOST:PORT]
  rtpu stop   [--address HOST:PORT]
  rtpu job submit [--address A] [--working-dir D] -- python train.py
  rtpu job status|logs|stop JOB_ID
  rtpu job list
  rtpu summary [tasks|actors|objects]   # per-function aggregates + percentiles
  rtpu memory [--top N] [--json]        # who owns the cluster's bytes + leaks
  rtpu timeline -o trace.json
  rtpu trace list [--limit N]
  rtpu trace get TRACE_ID [-o trace.json]
  rtpu stack [TARGET]               # live tracebacks: head/agents/workers
  rtpu profile TARGET --duration N  # sampling profiler (collapsed/speedscope)
  rtpu logs [--follow] [--tail N]   # worker logs streamed off the agents

Cluster discovery: `start --head` records the address in
$RT_TMPDIR/latest_cluster.json; other commands use --address,
RT_ADDRESS, or that file, in that order.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Tuple


def _registry_path() -> str:
    base = os.environ.get("RT_TMPDIR", "/tmp/ray_tpu")
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, "latest_cluster.json")


def _resolve_address(explicit: Optional[str]) -> Tuple[str, int]:
    addr = explicit or os.environ.get("RT_ADDRESS")
    if not addr:
        try:
            with open(_registry_path()) as f:
                addr = json.load(f)["address"]
        except Exception:
            raise SystemExit(
                "no cluster address: pass --address, set RT_ADDRESS, or "
                "run `rtpu start --head` on this machine first")
    host, port_s = addr.rsplit(":", 1)
    return host, int(port_s)


def _head_client(addr: Tuple[str, int]):
    from ray_tpu_torch._private.rpc import EventLoopThread, SyncRpcClient

    io = EventLoopThread(name="rtpu-cli")
    return SyncRpcClient(addr[0], addr[1], io, label="head"), io


# ---------------------------------------------------------------- start/stop


def cmd_start(args) -> int:
    from ray_tpu_torch._private import node as node_mod

    if not args.head and not args.address:
        print("pass --head to start a cluster or --address to join one",
              file=sys.stderr)
        return 2
    session_dir = node_mod.new_session_dir()
    if args.head:
        head_proc, head_addr = node_mod.start_head(session_dir,
                                                   port=args.port)
        res = node_mod.default_resources(args.num_cpus,
                                         json.loads(args.resources))
        agent_proc, info = node_mod.start_node_agent(
            session_dir, head_addr, res,
            object_store_memory=args.object_store_memory,
            is_head_node=True)
        address = f"{head_addr[0]}:{head_addr[1]}"
        with open(_registry_path(), "w") as f:
            json.dump({"address": address, "session_dir": session_dir,
                       "head_pid": head_proc.proc.pid,
                       "agent_pids": [agent_proc.proc.pid]}, f)
        print(f"cluster started at {address}")
        print(f"session dir: {session_dir}")
        print(f"connect with ray_tpu_torch.init(address=\"{address}\") "
              f"or RT_ADDRESS={address}")
    else:
        head_addr = _resolve_address(args.address)
        res = node_mod.default_resources(args.num_cpus,
                                         json.loads(args.resources))
        _, info = node_mod.start_node_agent(
            session_dir, head_addr, res,
            object_store_memory=args.object_store_memory)
        print(f"node {info['node_id'][:12]} joined "
              f"{head_addr[0]}:{head_addr[1]}")
    return 0


def cmd_stop(args) -> int:
    addr = _resolve_address(args.address)
    head, io = _head_client(addr)
    try:
        head.call("shutdown_cluster", timeout=10)
        print("cluster shutdown requested")
    except Exception as e:
        print(f"head unreachable ({e}); nothing to stop?", file=sys.stderr)
        return 1
    finally:
        head.close()
        io.stop()
    try:
        os.unlink(_registry_path())
    except OSError:
        pass
    return 0


def _print_status(addr, head) -> None:
    table = head.call("node_table", timeout=10)
    res = head.call("cluster_resources", timeout=10)
    auto = head.call("autoscaler_state", timeout=10)
    print(f"cluster at {addr[0]}:{addr[1]} — {len(table)} node(s)")
    for nid, n in table.items():
        r = n["resources"]
        role = " (head)" if n.get("is_head_node") else ""
        print(f"  {nid[:12]}{role}  total={r['total']}  "
              f"available={r['available']}")
    print(f"resources: total={res['total']} available={res['available']}")
    pending = sum(len(n["pending"]) for n in auto["nodes"])
    if pending or auto["pending_pg_bundles"] or auto["pending_actors"]:
        print(f"pending demands: {pending} lease(s), "
              f"{len(auto['pending_pg_bundles'])} pg bundle(s), "
              f"{len(auto['pending_actors'])} actor(s)")
    _print_shards(head)
    _print_autoscaler(head)


def _print_shards(head) -> None:
    """Head ingest shard pane: which planes run on their own loop and
    how laggy each loop is — the first place to look when the head
    feels slow (count 0 = single-loop compat mode)."""
    try:
        snap = head.call("autoscaler_snapshot", timeout=10)
    except Exception:
        return
    sh = snap.get("shards") or {}
    planes = sh.get("planes") or {}
    if not planes:
        return
    parts = []
    for name, p in sorted(planes.items()):
        where = "own loop" if p.get("own_thread") else "head loop"
        part = f"{name}={where} lag {p.get('lag_s', 0) * 1000:.1f}ms"
        if p.get("dropped"):
            part += f" dropped {p['dropped']}"
        parts.append(part)
    print(f"head ingest shards: {sh.get('count', 0)}  " + "  ".join(parts))


def _print_autoscaler(head) -> None:
    """Autoscaler pane: pending launches, draining nodes, the last
    decision and live/finished drain records (also at /api/autoscaler)
    — the debuggability surface for scale events."""
    try:
        st = head.call("autoscaler_status", timeout=10)
    except Exception:
        return
    report = st.get("report") or {}
    draining = st.get("draining") or []
    drains = st.get("drains") or {}
    if not report and not draining and not drains \
            and not st.get("registered_types"):
        return  # no autoscaler attached: keep status terse
    print("autoscaler:")
    if st.get("registered_types"):
        types = ", ".join(sorted(st["registered_types"]))
        print(f"  node types: {types}")
    if report:
        print(f"  pending launches: {report.get('pending_launches', 0)}  "
              f"scale events: up={report.get('scale_up_total', 0)} "
              f"down={report.get('scale_down_total', 0)}")
        if report.get("last_decision"):
            print(f"  last decision: {report['last_decision']}")
    if draining:
        print(f"  draining now: {', '.join(n[:12] for n in draining)}")
    for nid, rec in list(drains.items())[-4:]:
        extra = ""
        if rec.get("state") == "drained":
            extra = (f" in {rec.get('drain_s', 0)}s, "
                     f"{rec.get('migrated_actors', 0)} actor(s) migrated, "
                     f"{rec.get('replicated_objects', 0)} object(s) "
                     f"re-replicated")
        elif rec.get("detail"):
            extra = f": {rec['detail']}"
        print(f"  drain {nid[:12]}: {rec.get('state')}"
              f"/{rec.get('phase', '')}{extra}")


def _print_timeseries(head) -> None:
    """Latest value (+ tiny text sparkline) per head time-series —
    the `status --watch` health pane."""
    blocks = " ▁▂▃▄▅▆▇█"
    series = head.call("timeseries", timeout=10).get("series") or []
    if not series:
        return
    print("gauges (head time-series ring):")
    for s in series:
        pts = [v for _, v in s.get("points") or []]
        if not pts:
            continue
        lo, hi = min(pts), max(pts)
        span = (hi - lo) or 1.0
        spark = "".join(
            blocks[int((v - lo) / span * (len(blocks) - 1))]
            for v in pts[-30:])
        print(f"  {s['name']:<24} @{s['node']:<12} "
              f"{pts[-1]:>12.6g}  {spark}")


def cmd_status(args) -> int:
    addr = _resolve_address(args.address)
    head, io = _head_client(addr)
    try:
        while True:
            if args.watch:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear, home
            _print_status(addr, head)
            _print_timeseries(head)
            if not args.watch:
                return 0
            sys.stdout.flush()
            try:
                time.sleep(args.interval)
            except KeyboardInterrupt:
                return 0
    finally:
        head.close()
        io.stop()


# ------------------------------------------------------- live introspection


def cmd_stack(args) -> int:
    """Live stack dumps for every process in the cluster (or one node /
    worker / the head via TARGET) — `ray stack` equivalent, no py-spy."""
    addr = _resolve_address(args.address)
    head, io = _head_client(addr)
    try:
        out = head.call("cluster_stack", target=args.target or "",
                        timeout=30)
    finally:
        head.close()
        io.stop()
    shown = 0

    def _one(title: str, payload) -> None:
        nonlocal shown
        if not isinstance(payload, dict):
            return
        if payload.get("error"):
            print(f"==== {title}: unreachable ({payload['error']}) ====")
            return
        print(f"==== {title} (pid {payload.get('pid')}) ====")
        print(payload.get("text", ""))
        shown += 1

    if "head" in out:
        _one("head", out["head"])
    want_worker = args.target or ""
    for nid, node in (out.get("nodes") or {}).items():
        if not isinstance(node, dict) or node.get("error"):
            print(f"==== node {nid[:12]}: unreachable "
                  f"({node.get('error') if isinstance(node, dict) else node})"
                  f" ====")
            continue
        workers = node.get("workers") or {}
        worker_only = (want_worker
                       and not nid.startswith(want_worker)
                       and want_worker != "head")
        if not worker_only:
            _one(f"node {nid[:12]} agent", node.get("agent") or {})
        for wid, w in workers.items():
            if worker_only and not wid.startswith(want_worker):
                continue
            _one(f"node {nid[:12]} worker {wid[:12]}", w)
    if shown == 0:
        print(f"no process matched target {args.target!r}", file=sys.stderr)
        return 1
    return 0


def cmd_profile(args) -> int:
    """Run the in-process sampling profiler on a target process and
    print (or save) the collapsed stacks / speedscope JSON."""
    addr = _resolve_address(args.address)
    head, io = _head_client(addr)
    try:
        reply = head.call("profile_target", target=args.target,
                          hz=args.hz, duration_s=args.duration,
                          fmt=args.format,
                          timeout=args.duration + 60)
    finally:
        head.close()
        io.stop()
    if not reply.get("ok"):
        print(f"profile failed: {reply.get('error', reply)}",
              file=sys.stderr)
        return 1
    print(f"profiled pid {reply.get('pid')} at {reply.get('hz')}Hz for "
          f"{reply.get('duration_s')}s ({reply.get('samples')} samples)",
          file=sys.stderr)
    if args.output:
        with open(args.output, "w") as f:
            f.write(reply["profile"])
        print(f"wrote {args.format} profile to {args.output}",
              file=sys.stderr)
    else:
        sys.stdout.write(reply["profile"])
        if not reply["profile"].endswith("\n"):
            sys.stdout.write("\n")
    return 0


def _print_log_batch(node_id: str, batch) -> None:
    for ent in batch or []:
        prefix = f"(pid={ent.get('pid')}, node={node_id[:12]}) "
        for line in ent.get("lines") or []:
            print(prefix + line)


def cmd_logs(args) -> int:
    """Tail worker logs across the cluster; with --follow, subscribe to
    every node agent's log monitor and stream increments live."""
    from ray_tpu_torch._private.rpc import EventLoopThread, SyncRpcClient

    addr = _resolve_address(args.address)
    head, io = _head_client(addr)
    agents = []
    try:
        table = head.call("node_table", timeout=10)
        head.close()
        for nid, entry in table.items():
            ahost, aport = entry["addr"]

            def on_push(method, payload, _nid=nid):
                if method == "log_lines":
                    _print_log_batch(payload.get("node_id", _nid),
                                     payload.get("batch"))

            client = SyncRpcClient(ahost, aport, io,
                                   label=f"agent-{nid[:8]}",
                                   on_push=on_push if args.follow else None)
            agents.append((nid, client))
        if not agents:
            print("no nodes registered", file=sys.stderr)
            return 1
        if not args.follow:
            for nid, client in agents:
                reply = client.call("tail_logs", lines=args.tail, timeout=10)
                _print_log_batch(reply.get("node_id", nid),
                                 reply.get("batch"))
            return 0
        for nid, client in agents:
            reply = client.call("subscribe_logs", tail=args.tail, timeout=10)
            _print_log_batch(reply.get("node_id", nid),
                             reply.get("backlog"))
        print("-- following (Ctrl-C to stop) --", file=sys.stderr)
        try:
            while True:
                time.sleep(0.5)
        except KeyboardInterrupt:
            return 0
    finally:
        head.close()
        for _, client in agents:
            client.close()
        io.stop()


# ---------------------------------------------------------------------- jobs


def cmd_job(args) -> int:
    from ray_tpu_torch.job_submission import JobSubmissionClient

    addr = _resolve_address(args.address)
    client = JobSubmissionClient(f"{addr[0]}:{addr[1]}")
    try:
        if args.job_cmd == "submit":
            entrypoint = " ".join(args.entrypoint)
            if not entrypoint:
                print("nothing to run: rtpu job submit -- python x.py",
                      file=sys.stderr)
                return 2
            job_id = client.submit_job(
                entrypoint, working_dir=args.working_dir or None)
            print(f"submitted {job_id}")
            if args.wait:
                status = client.wait_until_finish(job_id)
                print(f"{job_id}: {status}")
                sys.stdout.write(client.get_job_logs(job_id))
                return 0 if status == "SUCCEEDED" else 1
            return 0
        if args.job_cmd == "status":
            print(json.dumps(client.get_job_info(args.job_id), indent=2))
            return 0
        if args.job_cmd == "logs":
            sys.stdout.write(client.get_job_logs(args.job_id))
            return 0
        if args.job_cmd == "stop":
            client.stop_job(args.job_id)
            print(f"stop requested for {args.job_id}")
            return 0
        if args.job_cmd == "list":
            for info in client.list_jobs():
                print(f"{info['job_id']}  {info['status']:<10} "
                      f"{info.get('entrypoint', '')[:60]}")
            return 0
    finally:
        client.close()
    return 2


# ----------------------------------------------------------- state/summary


def _fmt_bytes(n) -> str:
    n = float(n or 0)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def _fmt_pct(p) -> str:
    if not p:
        return "-"
    return (f"n={p['count']} p50={p['p50_ms']:.1f}ms "
            f"p99={p['p99_ms']:.1f}ms")


def cmd_summary(args) -> int:
    """Per-function task aggregates (state counts + queued/running
    percentiles), actor rollups, and the per-node object-store byte
    rollup — straight off the head, no driver attach."""
    head, io = _head_client(_resolve_address(args.address))
    try:
        s = head.call("cluster_summary", timeout=30)
    finally:
        head.close()
        io.stop()
    if args.json:
        print(json.dumps(s, indent=2, default=str))
        return 0
    if args.what in ("tasks", "all"):
        print("tasks (per function):")
        rows = sorted(s["tasks"].items(),
                      key=lambda kv: -sum(kv[1]["states"].values()))
        for name, row in rows:
            states = " ".join(f"{k}={v}" for k, v in
                              sorted(row["states"].items()))
            print(f"  {name[:48]:<48} [{row['kind']}] {states}")
            print(f"    queued:  {_fmt_pct(row.get('queued'))}")
            print(f"    running: {_fmt_pct(row.get('running'))}")
    if args.what in ("actors", "all"):
        a = s["actors"]
        print(f"actors: {a['num_actors']} total, by state "
              f"{a['by_state']}")
        for m, n in sorted(a["methods"].items(), key=lambda kv: -kv[1]):
            print(f"  method {m[:48]:<48} calls={n}")
    if args.what in ("objects", "all"):
        o = s["objects"]
        print(f"objects: {o['total_objects']} in store, "
              f"arena={_fmt_bytes(o['total_arena_used'])} "
              f"pinned={_fmt_bytes(o['total_pinned_bytes'])} "
              f"spilled={_fmt_bytes(o['total_spilled_bytes'])} "
              f"channels={_fmt_bytes(o['total_channel_bytes'])}")
        for nid, m in o["nodes"].items():
            print(f"  node {nid[:12]}: "
                  f"arena {_fmt_bytes(m.get('arena_used'))}/"
                  f"{_fmt_bytes(m.get('capacity'))}, "
                  f"{m.get('num_objects', 0)} objects, "
                  f"pinned {_fmt_bytes(m.get('pinned_bytes'))}, "
                  f"spilled {_fmt_bytes(m.get('spilled_bytes'))} "
                  f"({m.get('spilled_files', 0)} files)")
    scan = s.get("last_leak_scan") or {}
    stale = " (held from last complete scan — view currently partial)" \
        if scan.get("partial") else ""
    if scan.get("leaked_bytes"):
        print(f"LEAKS: {_fmt_bytes(scan['leaked_bytes'])} flagged "
              f"({scan.get('counts')}){stale} — run `rtpu memory` "
              f"for detail")
    elif scan.get("partial"):
        print("LEAKS: detection suspended (partial ownership join) — "
              "run `rtpu memory` for the gap list")
    return 0


def cmd_memory(args) -> int:
    """`rtpu memory`: the joined cluster memory view — per-node byte
    breakdowns, top objects by size with owner + creation call-site,
    and the leak tripwire section (reference: `ray memory`)."""
    head, io = _head_client(_resolve_address(args.address))
    try:
        v = head.call("memory_view", top_n=args.top, timeout=60)
    finally:
        head.close()
        io.stop()
    if args.json:
        print(json.dumps(v, indent=2, default=str))
        return 0
    for nid, b in v["nodes"].items():
        print(f"node {nid[:12]}: arena {_fmt_bytes(b.get('arena_used'))}"
              f"/{_fmt_bytes(b.get('capacity'))} "
              f"({b.get('num_objects', 0)} objects) | "
              f"pinned {_fmt_bytes(b.get('pinned_bytes'))} | "
              f"channels {b.get('channel_slots', 0)} slots "
              f"{_fmt_bytes(b.get('channel_bytes'))} | "
              f"spilled {_fmt_bytes(b.get('spilled_bytes'))} "
              f"({b.get('spilled_files', 0)} files) | "
              f"mmap cache {_fmt_bytes(b.get('mmap_cache_bytes'))} | "
              f"{b.get('inflight_pulls', 0)} pulls in flight")
    attributed, total = v["attributed_bytes"], v["store_object_bytes"]
    pct = 100.0 * attributed / total if total else 100.0
    print(f"{v['num_objects']} store objects, "
          f"{_fmt_bytes(total)} payload bytes, "
          f"{pct:.1f}% attributed to live owners")
    if v.get("errors"):
        # the gap list `rtpu summary` points operators at: who could
        # not be joined and why the view is partial
        print(f"PARTIAL VIEW — {len(v['errors'])} gap(s):")
        for e in v["errors"]:
            print(f"  {e}")
    if v["objects"]:
        print(f"top {len(v['objects'])} objects:")
        print(f"  {'object':<20} {'size':>10} {'node':<12} {'loc':<5} "
              f"{'pins':>4}  owner / call-site")
        # "(no live owner)" is only trustworthy on a complete join — on
        # a partial one the owner may simply be unreachable/truncated
        no_owner = ("(owner unknown — partial view)"
                    if (v.get("leaks") or {}).get("partial")
                    else "(no live owner)")
        for o in v["objects"]:
            own = o.get("owner") or {}
            who = (f"{own.get('kind', '?')}:"
                   f"{own.get('worker_id', '')[:8]} "
                   f"{own.get('name', '')} @ {own.get('call_site', '')}"
                   if own else no_owner)
            flags = "C" if o.get("channel") else ""
            print(f"  {o['object_id'][:20]:<20} "
                  f"{_fmt_bytes(o['size']):>10} {o['node_id'][:12]:<12} "
                  f"{o['location']:<5} {o.get('pins', 0):>4}{flags:<1} {who}")
    leaks = v["leaks"]
    n_leaks = sum(len(leaks[k]) for k in
                  ("dead_owner", "borrowed_ttl", "channel_slots"))
    if n_leaks:
        print(f"leaks ({_fmt_bytes(leaks['leaked_bytes'])} past "
              f"{leaks['ttl_s']}s TTL"
              + (", PARTIAL view" if leaks.get("partial") else "") + "):")
        for e in leaks["dead_owner"]:
            print(f"  dead-owner  {e['object_id'][:20]} "
                  f"{_fmt_bytes(e['size'])} on {e['node_id'][:12]} "
                  f"age={e['age_s']:.0f}s pins={e.get('pins', 0)}")
        for e in leaks["borrowed_ttl"]:
            print(f"  borrowed    {e['object_id'][:20]} "
                  f"held by {e['worker_id'][:12]} age={e['age_s']:.0f}s")
        for e in leaks["channel_slots"]:
            print(f"  channel     {e['object_id'][:20]} "
                  f"{_fmt_bytes(e['size'])} on {e['node_id'][:12]} "
                  f"age={e['age_s']:.0f}s")
    else:
        print("no leaks flagged"
              + (" (partial view)" if leaks.get("partial") else ""))
    return 0


def cmd_chaos(args) -> int:
    """`rtpu chaos inject|schedule|clear|status`: drive the cluster's
    fault-injection plane through the head's chaos RPC (the head applies
    rules locally and gossips them to every agent)."""
    head, io = _head_client(_resolve_address(args.address))
    try:
        if args.chaos_cmd == "inject":
            reply = head.call("chaos", op="inject", rule={
                "site": args.site, "action": args.action, "p": args.p,
                "count": args.count, "delay_s": args.delay,
                "target": args.target, "seed": args.seed})
        elif args.chaos_cmd == "schedule":
            reply = head.call(
                "chaos", op="schedule", seed=args.seed,
                sites=[s for s in args.sites.split(",") if s],
                events_per_site=args.events_per_site, span=args.span)
        elif args.chaos_cmd == "clear":
            reply = head.call("chaos", op="clear")
        else:
            reply = head.call("chaos", op="status")
        print(json.dumps(reply, indent=2))
    finally:
        head.close()
        io.stop()
    return 0


def cmd_quarantine(args) -> int:
    """`rtpu quarantine [list|clear [KEY]]`: inspect and lift the head's
    poison-task quarantine (classes whose executions OOM-killed or
    crashed workers poison_task_threshold consecutive times; their
    submissions fail fast with PoisonedTaskError until the TTL expires
    or this clears them)."""
    head, io = _head_client(_resolve_address(args.address))
    try:
        if args.quarantine_cmd == "clear":
            reply = head.call("quarantine", op="clear", key=args.key)
            print(json.dumps(reply, indent=2))
            return 0
        reply = head.call("quarantine", op="list")
        entries = reply.get("entries", {})
        if not entries:
            print("no task classes under quarantine or kill watch")
            return 0
        for key, e in sorted(entries.items(),
                             key=lambda kv: -kv[1]["kills"]):
            state = (f"QUARANTINED ({e['expires_in_s']}s left)"
                     if e["quarantined"] else "watching")
            print(f"{key[:16]:17} {e['name'] or '?':24} "
                  f"kills={e['kills']:<3} {state}")
            for h in e.get("history", []):
                print(f"                  - {h}")
    finally:
        head.close()
        io.stop()
    return 0


def cmd_trace(args) -> int:
    """Inspect distributed traces straight off the head's trace store
    (no driver attach needed — plain head RPCs)."""
    addr = _resolve_address(args.address)
    head, io = _head_client(addr)
    try:
        if args.trace_cmd == "list":
            reply = head.call("list_traces", limit=args.limit, timeout=10)
            traces = reply["traces"]
            if not traces:
                print("no traces recorded (tracing disabled, sampled "
                      "out, or nothing ran yet)")
                return 0
            for t in traces:
                print(f"{t['trace_id']}  spans={t['num_spans']:<4} "
                      f"dur={t['duration_s'] * 1000:8.1f}ms  "
                      f"root={t.get('root', '')}")
            if reply.get("spans_dropped"):
                print(f"(head dropped {reply['spans_dropped']} spans "
                      f"over the per-trace cap)", file=sys.stderr)
            return 0
        reply = head.call("get_trace", trace_id=args.trace_id, timeout=10)
        if not reply.get("found"):
            print(f"no trace {args.trace_id!r}", file=sys.stderr)
            return 1
        blob = json.dumps(reply["trace"], indent=2, default=str)
        if args.output:
            with open(args.output, "w") as f:
                f.write(blob)
            print(f"wrote {len(reply['trace']['spans'])} spans to "
                  f"{args.output}")
        else:
            print(blob)
        return 0
    finally:
        head.close()
        io.stop()


def cmd_timeline(args) -> int:
    import ray_tpu_torch

    addr = _resolve_address(args.address)
    ray_tpu_torch.init(address=f"{addr[0]}:{addr[1]}")
    try:
        from ray_tpu_torch.util.state import timeline

        events = timeline(args.output)
        print(f"wrote {len(events)} events to {args.output}")
    finally:
        ray_tpu_torch.shutdown()
    return 0


# ----------------------------------------------------------------- argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rtpu",
                                 description="ray_tpu cluster CLI")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="start a head or join a cluster")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", default="")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--resources", default="{}")
    p.add_argument("--object-store-memory", type=int, default=None)
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="shut the cluster down")
    p.add_argument("--address", default="")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("status", help="nodes, resources, pending demand")
    p.add_argument("--address", default="")
    p.add_argument("--watch", action="store_true",
                   help="refresh continuously with the head's gauge series")
    p.add_argument("--interval", type=float, default=2.0)
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("stack",
                       help="live stack dumps of cluster processes")
    p.add_argument("target", nargs="?", default="",
                   help='"head", a node id prefix, or a worker id prefix')
    p.add_argument("--address", default="")
    p.set_defaults(fn=cmd_stack)

    p = sub.add_parser("profile", help="sampling-profile one process")
    p.add_argument("target",
                   help='"head", a node id prefix, or a worker id prefix')
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--hz", type=float, default=0,
                   help="sampling rate (default: profiler_default_hz)")
    p.add_argument("--format", choices=["collapsed", "speedscope"],
                   default="collapsed")
    p.add_argument("-o", "--output", default="")
    p.add_argument("--address", default="")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("logs", help="tail worker logs across the cluster")
    p.add_argument("--follow", "-f", action="store_true",
                   help="stream new lines as they appear")
    p.add_argument("--tail", type=int, default=100,
                   help="backlog lines per file")
    p.add_argument("--address", default="")
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser("job", help="submit and manage jobs")
    p.add_argument("--address", default="")
    jsub = p.add_subparsers(dest="job_cmd", required=True)
    js = jsub.add_parser("submit")
    js.add_argument("--working-dir", default="")
    js.add_argument("--wait", action="store_true",
                    help="block until the job finishes, stream its logs")
    js.add_argument("entrypoint", nargs=argparse.REMAINDER,
                    help="-- command to run")
    for name in ("status", "logs", "stop"):
        jp = jsub.add_parser(name)
        jp.add_argument("job_id")
    jsub.add_parser("list")
    p.set_defaults(fn=cmd_job)

    p = sub.add_parser("summary", help="task/actor/object summaries "
                                       "(state counts + percentiles)")
    p.add_argument("what", nargs="?", default="all",
                   choices=["all", "tasks", "actors", "objects"])
    p.add_argument("--json", action="store_true")
    p.add_argument("--address", default="")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("memory", help="cluster memory/object accounting "
                                      "with owners, call-sites, and leaks")
    p.add_argument("--top", type=int, default=0,
                   help="objects in the top-N table "
                        "(default: memory_view_top_n)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--address", default="")
    p.set_defaults(fn=cmd_memory)

    p = sub.add_parser("timeline", help="export a Chrome trace")
    p.add_argument("-o", "--output", default="timeline.json")
    p.add_argument("--address", default="")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser(
        "chaos", help="deterministic fault injection (chaos engineering)")
    p.add_argument("--address", default="")
    csub = p.add_subparsers(dest="chaos_cmd", required=True)
    ci = csub.add_parser("inject", help="arm one fault-injection rule")
    ci.add_argument("--site", required=True,
                    help="rpc.send|rpc.recv|xfer.send|lease.grant|"
                         "worker.kill|worker.stall|agent.kill|head.kill")
    ci.add_argument("--action", required=True,
                    help="drop|delay|sever|truncate|corrupt|kill|stall")
    ci.add_argument("--p", type=float, default=1.0,
                    help="firing probability per matching invocation")
    ci.add_argument("--count", type=int, default=-1,
                    help="max firings PER PROCESS (-1 = unlimited): every "
                         "agent enforces its own cap — scope cluster-wide "
                         "one-shots with --target")
    ci.add_argument("--delay", type=float, default=0.05,
                    help="seconds, for --action delay")
    ci.add_argument("--target", default="",
                    help="substring match on the site key "
                         "(worker id, node id, method, oid)")
    ci.add_argument("--seed", type=int, default=None)
    cs = csub.add_parser(
        "schedule", help="compile a seed into a reproducible failure "
                         "schedule across sites")
    cs.add_argument("--seed", type=int, required=True)
    cs.add_argument("--sites", default="rpc.send,rpc.recv",
                    help="comma-separated site list")
    cs.add_argument("--events-per-site", type=int, default=3)
    cs.add_argument("--span", type=int, default=100,
                    help="invocation horizon the events land in")
    csub.add_parser("clear", help="disarm every rule cluster-wide")
    csub.add_parser("status", help="live rule set + firing counts")
    p.set_defaults(fn=cmd_chaos)

    p = sub.add_parser(
        "quarantine",
        help="poison-task quarantine: list kill watch, clear entries")
    p.add_argument("--address", default="")
    qsub = p.add_subparsers(dest="quarantine_cmd")
    qsub.add_parser("list", help="kill counts + quarantined classes")
    qc = qsub.add_parser("clear",
                         help="lift quarantines now (before the TTL)")
    qc.add_argument("key", nargs="?", default="",
                    help="function/class id to clear ('' = all tripped)")
    p.set_defaults(fn=cmd_quarantine, quarantine_cmd="list")

    p = sub.add_parser("trace", help="inspect distributed traces")
    p.add_argument("--address", default="")
    tsub = p.add_subparsers(dest="trace_cmd", required=True)
    tl = tsub.add_parser("list", help="recent traces, newest first")
    tl.add_argument("--limit", type=int, default=20)
    tg = tsub.add_parser("get", help="dump one trace's spans as JSON")
    tg.add_argument("trace_id")
    tg.add_argument("-o", "--output", default="")
    p.set_defaults(fn=cmd_trace)

    args = ap.parse_args(argv)
    # strip a leading "--" from REMAINDER entrypoints
    if getattr(args, "entrypoint", None) and args.entrypoint[0] == "--":
        args.entrypoint = args.entrypoint[1:]
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
