"""The port head's dashboard and the CLI's introspection commands.

With ``_private/dashboard.py`` in the port, the head starts its metrics
HTTP server: ``metrics_port`` is non-zero and the single-page app, its
JSON data plane and ``/metrics`` are served.  A cluster that claims one
GPU (faked: no card is touched) shows it in ``/api/state``, taken while
a ``num_gpus=1`` actor holds it.  Then the cases of
tests/test_observability.py (the dashboard app), the CLI cases of
tests/test_introspection.py (``stack``, ``logs``, ``status``),
tests/test_memory_accounting.py (``memory``, ``summary``) and
tests/test_tracing.py (``trace``) on the port, through
``ray_tpu_torch.scripts.main`` in this process.  All tests share one
cluster.
"""

import json
import os
import re
import time
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import scripts
from ray_tpu_torch.util.state import get_trace, list_traces

from tests.torch_waits import bounded

CALL_S = 60
MB = 1 << 20
_SAMPLE = re.compile(r"^[A-Za-z_:][A-Za-z0-9_:]*(\{[^}]*\})? (\S+)$")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    bounded(lambda: rt.init(num_cpus=4, resources={"GPU": 1},
                            object_store_memory=64 * MB), 120, "rt.init")
    try:
        yield rt
    finally:
        bounded(rt.shutdown, 60, "rt.shutdown")
        os.environ.pop("RT_TMPDIR", None)


def _get(ref):
    return bounded(lambda: rt.get(ref, timeout=CALL_S), CALL_S + 10, "get")


def _head():
    return rt.api._worker().head


def _address() -> str:
    return "%s:%d" % tuple(rt.api._worker().head_addr)


def _fetch(path: str):
    port = _head().call("metrics_port")["port"]
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.headers.get("Content-Type", ""), r.read()


def _prometheus_samples(text: str) -> dict:
    """name{labels} -> value of every sample line; raises on a line that
    is neither a sample, a comment nor blank."""
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        m = _SAMPLE.match(ln)
        assert m, f"not Prometheus text: {ln!r}"
        out[ln.rsplit(" ", 1)[0]] = float(m.group(2))
    return out


def test_port_head_serves_metrics_and_state(cluster):
    """The port's head runs its dashboard: a non-zero metrics port,
    Prometheus text at /metrics and the node's GPU in /api/state, total
    1 and available 0 while a num_gpus=1 actor holds it."""
    port = _head().call("metrics_port")["port"]
    assert port > 0
    samples = _prometheus_samples(_fetch("/metrics")[1].decode())
    assert samples.get("rt_head_nodes") == 1.0, samples

    def gpus():
        # a resource with nothing left drops out of "available"
        node = json.loads(_fetch("/api/state")[1])["nodes"][0]
        res = node["resources"]
        return res["total"].get("GPU"), res["available"].get("GPU", 0.0)

    def wait_for(want):
        deadline = time.monotonic() + 30
        while gpus() != want and time.monotonic() < deadline:
            time.sleep(0.2)
        assert gpus() == want

    wait_for((1.0, 1.0))

    @rt.remote(num_gpus=1)
    class Holder:
        def visible(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    h = Holder.remote()
    assert _get(h.visible.remote()) == "0"
    wait_for((1.0, 0.0))
    rt.kill(h)
    wait_for((1.0, 1.0))


def test_head_dashboard_spa(cluster):
    """The head serves the single-page dashboard app and its JSON data
    plane, and the snapshot reflects live cluster state."""
    ct, html = _fetch("/")
    assert ct.startswith("text/html")
    assert "ray_tpu cluster" in html.decode()
    assert '<script src="/app.js">' in html.decode()
    ct, js = _fetch("/app.js")
    assert ct.startswith("application/javascript")
    for needle in ("api/snapshot", "sparkline", "Placement groups",
                   "Traces", "Memory", "api/memory"):
        assert needle in js.decode()

    @rt.remote
    def probe():
        return 1

    assert _get(probe.remote()) == 1

    @rt.remote
    class DashActor:
        def ping(self):
            return "pong"

    a = DashActor.remote()
    assert _get(a.ping.remote()) == "pong"

    snap = json.loads(_fetch("/api/snapshot")[1])
    for key in ("nodes", "actors", "tasks", "placement_groups", "jobs",
                "traces", "series", "summary"):
        assert key in snap, key
    assert len(snap["nodes"]) == 1
    assert any(x["state"] == "ALIVE" for x in snap["actors"])
    assert any(t.get("state") == "FINISHED" for t in snap["tasks"])
    assert snap["summary"]["cpus_total"] > 0

    # the timeline is a Chrome trace event list: duration slices plus
    # flow events ("s"/"f" submit->execute arrows); the submit half
    # rides the periodic flush tick
    deadline = time.monotonic() + 45
    while True:
        events = json.loads(_fetch("/api/timeline")[1])
        assert isinstance(events, list) and events
        assert all(e["ph"] in ("X", "s", "f", "i") and "ts" in e
                   for e in events)
        slices = [e for e in events if e["ph"] == "X"]
        assert slices and all("dur" in e for e in slices)
        flow_starts = {e["id"] for e in events if e["ph"] == "s"}
        flow_ends = {e["id"] for e in events if e["ph"] == "f"}
        if flow_starts or time.monotonic() >= deadline:
            break
        time.sleep(0.5)
    assert flow_starts and flow_starts == flow_ends

    state = json.loads(_fetch("/api/state")[1])
    assert len(state["nodes"]) == 1 and "actors_by_state" in state
    rt.kill(a)


def test_stack_dump_names_spinning_task(cluster, capsys):
    """`stack <node>` prints a live traceback naming the function a
    worker is spinning in; a worker id narrows it to that worker."""

    @rt.remote
    def spin_marker_fn():
        t0 = time.time()
        while time.time() - t0 < 60:
            sum(range(256))
        return 1

    ref = spin_marker_fn.remote()
    try:
        deadline = time.monotonic() + 30
        blob = ""
        while time.monotonic() < deadline:
            out = _head().call("cluster_stack", timeout=30)
            blob = json.dumps(out)
            if "spin_marker_fn" in blob:
                break
            time.sleep(0.3)
        assert "spin_marker_fn" in blob, "live frame never appeared"
        assert out.get("head", {}).get("pid")

        node_id = next(iter(out["nodes"]))
        rc = scripts.main(["stack", node_id[:12], "--address", _address()])
        printed = capsys.readouterr().out
        assert rc == 0
        assert "spin_marker_fn" in printed
        assert "worker" in printed and "agent" in printed

        wid = next(w for w, data in out["nodes"][node_id]["workers"].items()
                   if "spin_marker_fn" in json.dumps(data))
        rc = scripts.main(["stack", wid[:12], "--address", _address()])
        printed = capsys.readouterr().out
        assert rc == 0 and "spin_marker_fn" in printed
        assert "agent (pid" not in printed

        http_blob = json.loads(_fetch("/api/stack?target=head")[1])
        assert http_blob.get("head", {}).get("threads")
    finally:
        rt.cancel(ref, force=True)


def test_stack_unknown_target_fails(cluster, capsys):
    rc = scripts.main(["stack", "ffffffffffff", "--address", _address()])
    capsys.readouterr()
    assert rc == 1


def test_logs_tail_cli(cluster, capsys):
    marker = f"cli-tail-marker-{os.getpid()}"

    @rt.remote
    def shouty():
        print(marker)
        return 1

    assert _get(shouty.remote()) == 1
    deadline = time.monotonic() + 15
    out = ""
    while marker not in out and time.monotonic() < deadline:
        time.sleep(0.3)  # let the line reach the log file
        capsys.readouterr()
        rc = scripts.main(["logs", "--tail", "50", "--address", _address()])
        out = capsys.readouterr().out
        assert rc == 0
    assert marker in out
    assert "(pid=" in out and "node=" in out


def test_status_cli(cluster, capsys):
    rc = scripts.main(["status", "--address", _address()])
    out = capsys.readouterr().out
    assert rc == 0 and "1 node(s)" in out and "'GPU': 1.0" in out


def test_cli_memory_and_summary(cluster, capsys):
    ref = rt.put(os.urandom(3 * MB))
    assert scripts.main(["memory", "--address", _address()]) == 0
    out = capsys.readouterr().out
    assert "arena" in out and "attributed to live owners" in out
    assert os.path.basename(__file__) in out  # call-site shown
    assert scripts.main(["summary", "--address", _address()]) == 0
    out = capsys.readouterr().out
    assert "tasks (per function):" in out and "objects:" in out
    assert scripts.main(["memory", "--address", _address(), "--json"]) == 0
    parsed = json.loads(capsys.readouterr().out)
    assert "leaks" in parsed
    del ref


def _wait_for_trace(predicate, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for summary in list_traces():
            if summary["num_spans"] < 2:
                continue
            t = get_trace(summary["trace_id"])
            if predicate(t):
                return t
        time.sleep(0.3)
    raise AssertionError("trace never complete")


def test_trace_cli(cluster, tmp_path, capsys):
    """`trace list` and `trace get` against the live head."""
    @rt.remote
    def cli_probe():
        return 1

    _get(cli_probe.remote())
    trace = _wait_for_trace(
        lambda t: any("cli_probe" in s["name"] for s in t["spans"]))
    assert scripts.main(["trace", "--address", _address(), "list",
                         "--limit", "500"]) == 0
    out = capsys.readouterr().out
    assert trace["trace_id"] in out
    dest = str(tmp_path / "trace.json")
    assert scripts.main(["trace", "--address", _address(), "get",
                         trace["trace_id"], "-o", dest]) == 0
    dumped = json.load(open(dest))
    assert dumped["trace_id"] == trace["trace_id"]
    assert len(dumped["spans"]) >= 2
    assert scripts.main(["trace", "--address", _address(), "get",
                         "f" * 32]) == 1
