"""Web dashboard: a dependency-free single-page app served by the head.

Plays the role of the reference's React dashboard client
(reference: dashboard/client/src — 21k LoC of React/TS built by webpack;
here ONE JavaScript file served straight from the head's metrics port,
rendering live cluster state from /api/snapshot): overview stat tiles
with sparklines, and tables for nodes, actors, tasks (filterable by
state), placement groups, and jobs, plus a Chrome-trace timeline
download (/api/timeline — open in chrome://tracing or Perfetto).

Design notes (kept deliberately boring): all dynamic text is inserted
via textContent (no innerHTML of cluster-supplied strings — node labels,
actor names and error strings are user input and must not XSS the
operator); sparklines are single-series inline SVG (one hue, no legend
needed — the tile title names the series); state chips pair color WITH
the state text, never color alone.
"""

APP_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu dashboard</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
:root {
  --surface: #fcfcfb; --ink: #222; --muted: #6b6b68; --line: #e4e4e0;
  --accent: #3987e5; --good: #0ca30c; --warn: #fab219; --crit: #d03b3b;
}
* { box-sizing: border-box; }
body { margin: 0; background: var(--surface); color: var(--ink);
       font: 14px/1.45 system-ui, sans-serif; }
header { display: flex; align-items: baseline; gap: 1em;
         padding: 14px 22px; border-bottom: 1px solid var(--line); }
header h1 { font-size: 17px; margin: 0; }
header .links { margin-left: auto; font-size: 13px; }
header a { color: var(--accent); text-decoration: none; margin-left: 1em; }
main { padding: 18px 22px; max-width: 1200px; }
.tiles { display: flex; gap: 14px; flex-wrap: wrap; margin-bottom: 20px; }
.tile { border: 1px solid var(--line); border-radius: 8px;
        padding: 10px 14px; min-width: 170px; background: #fff; }
.tile .label { color: var(--muted); font-size: 12px; }
.tile .value { font-size: 24px; font-weight: 600; margin: 2px 0 4px; }
nav.tabs { display: flex; gap: 2px; border-bottom: 1px solid var(--line);
           margin-bottom: 12px; }
nav.tabs button { border: none; background: none; padding: 8px 14px;
  font: inherit; color: var(--muted); cursor: pointer;
  border-bottom: 2px solid transparent; }
nav.tabs button.active { color: var(--ink);
  border-bottom-color: var(--accent); }
table { border-collapse: collapse; width: 100%; background: #fff; }
th, td { border: 1px solid var(--line); padding: 5px 10px;
         text-align: left; font-size: 13px; }
th { color: var(--muted); font-weight: 500; }
code { font-size: 12px; }
.chip { display: inline-block; padding: 0 8px; border-radius: 9px;
        font-size: 12px; border: 1px solid var(--line); }
.chip::before { content: "●"; margin-right: 5px; }
.chip.ok::before { color: var(--good); }
.chip.warn::before { color: var(--warn); }
.chip.bad::before { color: var(--crit); }
.chip.idle::before { color: var(--muted); }
select { font: inherit; margin-bottom: 10px; }
.empty { color: var(--muted); padding: 16px 0; }
#error { color: var(--crit); display: none; padding: 8px 0; }
</style></head>
<body>
<header><h1>ray_tpu cluster</h1><span id="updated" class="label"
style="color:var(--muted);font-size:12px"></span>
<span class="links"><a href="/api/snapshot">snapshot</a>
<a href="/api/timeline" download="timeline.json">timeline</a>
<a href="/metrics">metrics</a></span></header>
<main>
<div id="error"></div>
<div class="tiles" id="tiles"></div>
<div id="shards" style="color:var(--muted);font-size:12px;
padding:2px 0 6px"></div>
<nav class="tabs" id="tabs"></nav>
<div id="view"></div>
</main>
<script src="/app.js"></script>
</body></html>
"""

APP_JS = r"""// ray_tpu dashboard app (single file, no build step)
"use strict";
let SNAP = null;
let TSERIES = null;  // /api/timeseries: head + per-agent gauge rings
let MEM = null;      // /api/memory: joined memory/object accounting
let TAB = "nodes";
let TASK_FILTER = "";

const TABS = [
  ["nodes", "Nodes"], ["actors", "Actors"], ["tasks", "Tasks"],
  ["pgs", "Placement groups"], ["jobs", "Jobs"], ["traces", "Traces"],
  ["memory", "Memory"], ["series", "Series"],
];

function el(tag, attrs, ...children) {
  const e = document.createElement(tag);
  for (const [k, v] of Object.entries(attrs || {})) {
    if (k === "class") e.className = v;
    else if (k.startsWith("on")) e.addEventListener(k.slice(2), v);
    else e.setAttribute(k, v);
  }
  for (const c of children) {
    if (c == null) continue;
    e.append(c.nodeType ? c : document.createTextNode(String(c)));
  }
  return e;
}

function chip(state) {
  const good = ["ALIVE", "CREATED", "FINISHED", "SUCCEEDED", "RUNNING"];
  const bad = ["DEAD", "FAILED", "STOPPED"];
  const warn = ["RESTARTING", "PENDING", "SUBMITTED"];
  let cls = "idle";
  if (good.includes(state)) cls = "ok";
  else if (bad.includes(state)) cls = "bad";
  else if (warn.includes(state)) cls = "warn";
  return el("span", {class: "chip " + cls}, state || "?");
}

// single-series sparkline: 2px accent line on a plain surface, no axes
// (the tile label names the series; a legend would be noise)
function sparkline(values) {
  const W = 140, H = 34, P = 2;
  const svg = document.createElementNS("http://www.w3.org/2000/svg", "svg");
  svg.setAttribute("width", W); svg.setAttribute("height", H);
  if (!values || values.length < 2) return svg;
  const lo = Math.min(...values), hi = Math.max(...values);
  const span = (hi - lo) || 1;
  const pts = values.map((v, i) => [
    P + (i * (W - 2 * P)) / (values.length - 1),
    H - P - ((v - lo) * (H - 2 * P)) / span,
  ]);
  const path = document.createElementNS("http://www.w3.org/2000/svg", "path");
  path.setAttribute("d", "M" + pts.map(p =>
    p[0].toFixed(1) + " " + p[1].toFixed(1)).join("L"));
  path.setAttribute("fill", "none");
  path.setAttribute("stroke", "#3987e5");
  path.setAttribute("stroke-width", "2");
  svg.appendChild(path);
  return svg;
}

function tile(label, value, series) {
  return el("div", {class: "tile"},
    el("div", {class: "label"}, label),
    el("div", {class: "value"}, value),
    series ? sparkline(series) : null);
}

function fmtRes(res) {
  const total = res.total || {}, avail = res.available || {};
  return Object.keys(total).sort().filter(k => !k.startsWith("node:"))
    .map(k => `${k}: ${avail[k] ?? 0}/${total[k]}`).join(", ");
}

function table(headers, rows) {
  if (!rows.length) return el("div", {class: "empty"}, "nothing here yet");
  const t = el("table", {},
    el("tr", {}, ...headers.map(h => el("th", {}, h))));
  for (const r of rows) t.appendChild(el("tr", {}, ...r.map(c =>
    c && c.nodeType ? el("td", {}, c) : el("td", {}, c == null ? "" : c))));
  return t;
}

const VIEWS = {
  nodes: s => {
    const t = table(
      ["node", "address", "role", "resources (avail/total)", "labels"],
      s.nodes.map(n => [
        el("code", {}, n.node_id.slice(0, 12)),
        `${n.addr[0]}:${n.addr[1]}`,
        n.is_head_node ? "head" : (n.draining ? chip("DRAINING") : "worker"),
        fmtRes(n.resources || {}),
        JSON.stringify(n.labels || {}),
      ]));
    const a = s.autoscaler || {};
    const rep = a.report || {};
    if (!rep.ts && !(a.draining || []).length) return t;
    const line = el("p", {}, "autoscaler: pending launches " +
      (rep.pending_launches || 0) + " · scale events up=" +
      (rep.scale_up_total || 0) + " down=" + (rep.scale_down_total || 0) +
      (rep.last_decision ? " · " + rep.last_decision : "") +
      ((a.draining || []).length
        ? " · draining " + a.draining.map(n => n.slice(0, 12)).join(", ")
        : ""));
    return el("div", {}, line, t);
  },
  actors: s => table(
    ["id", "name", "state", "node", "restarts left"],
    s.actors.map(a => [
      el("code", {}, (a.actor_id || "").slice(0, 12)),
      a.name || "", chip(a.state),
      el("code", {}, (a.node_id || "").slice(0, 12)),
      a.restarts_left,
    ])),
  tasks: s => {
    const states = [...new Set(s.tasks.map(t => t.state))].sort();
    const sel = el("select", {onchange: e => {
      TASK_FILTER = e.target.value; render();
    }}, el("option", {value: ""}, "all states"),
      ...states.map(st => {
        const o = el("option", {value: st}, st);
        if (st === TASK_FILTER) o.selected = true;
        return o;
      }));
    const rows = s.tasks.filter(
      t => !TASK_FILTER || t.state === TASK_FILTER);
    return el("div", {}, sel, table(
      ["id", "name", "state", "node", "error"],
      rows.map(t => [
        el("code", {}, (t.task_id || "").slice(0, 12)),
        t.name || "", chip(t.state),
        el("code", {}, (t.node_id || "").slice(0, 12)),
        (t.error || "").slice(0, 90),
      ])));
  },
  pgs: s => table(
    ["id", "state", "strategy", "bundles", "placements"],
    s.placement_groups.map(p => [
      el("code", {}, (p.pg_id || "").slice(0, 12)),
      chip(p.state), p.strategy,
      JSON.stringify(p.bundles),
      (p.placements || []).map(
        x => x ? x.node_id.slice(0, 8) : "-").join(", "),
    ])),
  jobs: s => table(
    ["job", "status", "entrypoint", "message"],
    s.jobs.map(j => [
      el("code", {}, j.job_id || ""), chip(j.status),
      j.entrypoint || "", (j.message || "").slice(0, 90),
    ])),
  // recent traces off the head's trace store; the trace id links to
  // the span dump at /api/traces/<id> (same data as `rtpu trace get`)
  traces: s => table(
    ["trace", "root span", "spans", "duration"],
    (s.traces || []).map(t => [
      el("a", {href: "/api/traces/" + t.trace_id},
         el("code", {}, (t.trace_id || "").slice(0, 16))),
      t.root || "", t.num_spans,
      (t.duration_s * 1000).toFixed(1) + " ms",
    ])),
  // joined memory/object accounting (/api/memory): per-node byte
  // breakdowns, top objects with owner + call-site, leak tripwires
  memory: () => {
    if (!MEM) return el("div", {class: "empty"}, "loading memory view…");
    const fb = n => {
      n = n || 0;
      if (n < 1024) return n + "B";
      if (n < 1048576) return (n / 1024).toFixed(1) + "KiB";
      if (n < 1073741824) return (n / 1048576).toFixed(1) + "MiB";
      return (n / 1073741824).toFixed(2) + "GiB";
    };
    const nodes = table(
      ["node", "arena used/cap", "objects", "pinned", "channels",
       "spilled", "mmap cache", "pulls in flight"],
      Object.entries(MEM.nodes || {}).map(([nid, b]) => [
        el("code", {}, nid.slice(0, 12)),
        fb(b.arena_used) + " / " + fb(b.capacity),
        b.num_objects,
        fb(b.pinned_bytes),
        (b.channel_slots || 0) + " (" + fb(b.channel_bytes) + ")",
        fb(b.spilled_bytes) + " (" + (b.spilled_files || 0) + " files)",
        fb(b.mmap_cache_bytes),
        b.inflight_pulls || 0,
      ]));
    const lk = MEM.leaks || {};
    // "DEAD" is only trustworthy on a complete join — a partial view
    // (unreachable worker, truncated table) just means UNKNOWN owner
    const noOwner = lk.partial ? "unknown" : "DEAD";
    const objs = table(
      ["object", "size", "node", "loc", "pins", "owner", "call-site"],
      (MEM.objects || []).map(o => [
        el("code", {}, (o.object_id || "").slice(0, 16)),
        fb(o.size),
        el("code", {}, (o.node_id || "").slice(0, 12)),
        o.location + (o.channel ? " (chan)" : ""),
        o.pins,
        o.owner ? (o.owner.kind + ":" + o.owner.worker_id.slice(0, 8)
                   + " " + (o.owner.name || ""))
                : chip(noOwner),
        el("code", {}, (o.owner && o.owner.call_site) || ""),
      ]));
    const leakRows = []
      .concat((lk.dead_owner || []).map(e =>
        ["dead-owner", e.object_id.slice(0, 16), fb(e.size),
         Math.round(e.age_s) + "s", (e.node_id || "").slice(0, 12)]))
      .concat((lk.borrowed_ttl || []).map(e =>
        ["borrowed>TTL", e.object_id.slice(0, 16), fb(e.size),
         Math.round(e.age_s) + "s", (e.worker_id || "").slice(0, 12)]))
      .concat((lk.channel_slots || []).map(e =>
        ["channel slot", e.object_id.slice(0, 16), fb(e.size),
         Math.round(e.age_s) + "s", (e.node_id || "").slice(0, 12)]));
    const attributed = MEM.store_object_bytes
      ? Math.round(100 * MEM.attributed_bytes / MEM.store_object_bytes)
      : 100;
    return el("div", {},
      el("div", {class: "tiles"},
        tile("store objects", MEM.num_objects || 0),
        tile("payload bytes", fb(MEM.store_object_bytes)),
        tile("attributed to owners", attributed + "%"),
        tile("leaked bytes", fb(lk.leaked_bytes))),
      el("h3", {}, "per-node breakdown"), nodes,
      el("h3", {}, "top objects"), objs,
      el("h3", {}, "leaks" + (lk.partial ? " (partial view)" : "")),
      leakRows.length
        ? table(["kind", "object", "size", "age", "where"], leakRows)
        : el("div", {class: "empty"}, "no leaks flagged"));
  },
  // head time-series ring (/api/timeseries): loop lag and health
  // gauges per node, one sparkline tile per series
  series: () => {
    const rows = (TSERIES && TSERIES.series) || [];
    if (!rows.length) return el("div", {class: "empty"},
                                "no samples yet (first heartbeat pending)");
    return el("div", {class: "tiles"}, ...rows.map(r => {
      const vals = r.points.map(p => p[1]);
      const last = vals.length ? vals[vals.length - 1] : 0;
      const shown = Math.abs(last) < 1 && last !== 0
        ? last.toExponential(2) : String(Math.round(last * 1000) / 1000);
      return tile(`${r.name} @ ${r.node}`, shown, vals);
    }));
  },
};

function render() {
  if (!SNAP) return;
  const s = SNAP;
  const tiles = document.getElementById("tiles");
  tiles.replaceChildren(
    tile("nodes", s.nodes.length, s.series.map(p => p.nodes)),
    tile("CPUs available", s.summary.cpus_avail + " / " + s.summary.cpus_total,
         s.series.map(p => p.cpus_avail)),
    tile("actors alive", s.summary.actors_alive,
         s.series.map(p => p.actors_alive)),
    tile("tasks finished / 10s", s.summary.task_rate,
         s.series.map(p => p.task_rate)),
  );
  // head ingest shard topology + per-loop lag (shards: 0 = single-loop
  // compat mode, every plane rides the scheduling loop)
  const sh = s.shards || {count: 0, planes: {}};
  const shardLine = document.getElementById("shards");
  if (sh.count > 0) {
    const parts = Object.entries(sh.planes).map(([name, p]) =>
      `${name}: ${p.own_thread ? "own loop" : "head loop"}` +
      ` lag ${((p.lag_s || 0) * 1000).toFixed(1)}ms` +
      (p.dropped ? ` dropped ${p.dropped}` : ""));
    shardLine.textContent =
      `head ingest shards: ${sh.count} — ` + parts.join(" · ");
  } else {
    shardLine.textContent =
      "head ingest shards: 0 (single-loop compat)";
  }
  const tabs = document.getElementById("tabs");
  tabs.replaceChildren(...TABS.map(([id, label]) => {
    const counts = {nodes: s.nodes.length, actors: s.actors.length,
                    tasks: s.tasks.length, pgs: s.placement_groups.length,
                    jobs: s.jobs.length, traces: (s.traces || []).length,
                    memory: MEM ? (MEM.num_objects || 0) : 0,
                    series: ((TSERIES && TSERIES.series) || []).length};
    const b = el("button", {class: id === TAB ? "active" : "",
                            onclick: () => {
                              TAB = id;
                              if (id === "memory")
                                refreshMemory(true).then(render);
                              render();
                            }},
                 `${label} (${counts[id]})`);
    return b;
  }));
  document.getElementById("view").replaceChildren(VIEWS[TAB](s));
  document.getElementById("updated").textContent =
    "updated " + new Date().toLocaleTimeString();
}

let MEM_TS = 0;
async function refreshMemory(force) {
  // fetched only while the Memory tab is active, and at most every
  // 10s: the view fans out to every agent + owner, so it must not
  // ride the 2s background poll (force = explicit tab activation)
  if (!force && Date.now() - MEM_TS < 10000) return;
  MEM_TS = Date.now();
  try {
    MEM = await (await fetch("/api/memory")).json();
  } catch (e) { /* memory tab degrades to loading note */ }
}

async function refresh() {
  try {
    const r = await fetch("/api/snapshot");
    SNAP = await r.json();
    try {
      TSERIES = await (await fetch("/api/timeseries")).json();
    } catch (e) { /* series tab degrades to empty */ }
    if (TAB === "memory") await refreshMemory();
    document.getElementById("error").style.display = "none";
    render();
  } catch (e) {
    const box = document.getElementById("error");
    box.textContent = "head unreachable: " + e;
    box.style.display = "block";
  }
}
refresh();
setInterval(refresh, 2000);
"""
