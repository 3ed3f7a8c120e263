"""The port's autoscaler (ray_tpu_torch.autoscaler): the cases of
tests/test_autoscaler.py on the port, with GPU nodes in place of TPU
hosts.

The decision units run the port's StandardAutoscaler over a fake head,
provider and clock, and the serve decision units the port's
ServeController.  The fake-multinode e2e cases (slow) start real node
agents on this machine through ``AutoscalingCluster``; a ``tpu-worker``
``{"TPU": 4}`` node type there is a ``gpu-worker`` ``{"GPU": 1}`` here.
One e2e case runs in the fast tier: a head that advertises ``GPU: 0``
launches a ``{"GPU": 1}`` node for a pending ``num_gpus=1`` actor, which
sees card "0" (a faked card: the agent maps its GPU count onto
``CUDA_VISIBLE_DEVICES`` entries), and the node drains and is
terminated once the actor is killed.  On one machine the head advertises
no card, so the scaled node owns it and no card is handed out twice.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import (AutoscalerConfig, NodeProvider,
                                      ProviderNode, StandardAutoscaler)
from ray_tpu_torch.cluster_utils import AutoscalingCluster

from tests.torch_waits import bounded


# --------------------------------------------------------------- fast units


class _FakeHead:
    """Stands in for the head's autoscaler RPCs: scripted snapshots,
    recorded drain requests, controllable drain status + epoch."""

    def __init__(self):
        self.epoch = "epoch-1"
        self.nodes = []
        self.signals = {"lease_queue_depth": {},
                        "sched_queued_p99_ms": 0.0, "serve": {}}
        self.drain_requests = []
        self.drain_state = {}
        self.calls = []
        self.reports = []

    def node(self, node_id, total, available, pending=(), head=False,
             arena_used=0):
        self.nodes.append({
            "node_id": node_id, "is_head_node": head, "total": dict(total),
            "available": dict(available), "pending": list(pending),
            "draining": False, "heartbeat_age_s": 0.0,
            "memory": {"arena_used": arena_used, "arena_free": 1 << 30,
                       "num_objects": 0}})

    def call(self, method, **kw):
        self.calls.append((method, kw))
        if method == "autoscaler_snapshot":
            return {"epoch": self.epoch, "nodes": [dict(n) for n in
                                                   self.nodes],
                    "pending_pg_bundles": [], "pending_actors": [],
                    "signals": dict(self.signals), "drains": {}}
        if method == "drain_node_graceful":
            self.drain_requests.append(kw["node_id"])
            return {"ok": True, "state": "draining"}
        if method == "drain_status":
            return dict(self.drain_state.get(kw["node_id"],
                                             {"state": "draining"}))
        if method == "autoscaler_report":
            self.reports.append(kw["status"])
        return {"ok": True, "epoch": self.epoch}

    def close(self):
        pass


class _FakeProvider(NodeProvider):
    def __init__(self):
        self.nodes = {}
        self.created = []
        self.terminated = []
        self._n = 0

    def create_node(self, node_type, resources, count=1):
        out = []
        for _ in range(count):
            self._n += 1
            pid = f"fake-{self._n}"
            node = ProviderNode(pid, node_type, f"node-{self._n}")
            self.nodes[pid] = node
            self.created.append((node_type, pid))
            out.append(node)
        return out

    def terminate_node(self, provider_id):
        self.nodes.pop(provider_id, None)
        self.terminated.append(provider_id)

    def non_terminated_nodes(self):
        return list(self.nodes.values())


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _make(head, provider, clock, **cfg):
    types = cfg.pop("node_types", {
        "cpu-worker": {"resources": {"CPU": 4}, "min_workers": 0,
                       "max_workers": 4}})
    a = StandardAutoscaler(
        None, provider,
        AutoscalerConfig(types, idle_timeout_s=cfg.pop("idle_timeout_s", 5.0),
                         upscale_consecutive=cfg.pop("upscale_consecutive",
                                                     3), **cfg),
        head_client=head, clock=clock)
    return a


def _settle(a):
    """Join in-flight background launches so assertions are stable."""
    for p in list(a._pending):
        p.thread.join(timeout=2)


def test_infeasible_demand_scales_up_immediately():
    head, provider, clock = _FakeHead(), _FakeProvider(), _Clock()
    head.node("head-1", {"CPU": 2}, {"CPU": 2}, head=True)
    # {"CPU": 4} fits NO live node's totals: waiting cannot help
    head.nodes[0]["pending"] = [{"CPU": 4}]
    a = _make(head, provider, clock)
    a.update()
    _settle(a)
    assert [t for t, _ in provider.created] == ["cpu-worker"]
    a.stop()


def test_sustained_backlog_scales_up_after_hysteresis():
    head, provider, clock = _FakeHead(), _FakeProvider(), _Clock()
    # a busy 4-CPU worker: demand FITS totals, queues behind occupancy
    head.node("head-1", {"CPU": 2}, {"CPU": 2}, head=True)
    head.node("node-0", {"CPU": 4}, {"CPU": 0},
              pending=[{"CPU": 4}])
    provider.create_node("cpu-worker", {"CPU": 4})  # the busy node
    provider.nodes["fake-1"].cluster_node_id = "node-0"
    head.signals["lease_queue_depth"] = {"node-0": [1, 2, 2]}
    a = _make(head, provider, clock, upscale_consecutive=3)
    a.update()
    a.update()
    _settle(a)
    assert len(provider.created) == 1, "backlog must wait out hysteresis"
    a.update()
    _settle(a)
    assert len(provider.created) == 2, \
        "3 consecutive backlog passes must scale up"
    a.stop()


def test_pending_actor_backlog_scales_despite_quiet_lease_ring():
    """Head-parked demand (PENDING actors) never enters any agent's
    lease queue, so the queue-depth ring stays 0 — its presence in the
    current snapshot must itself count as live pressure, or an actor
    whose shape fits a busy node's totals would park forever."""
    head, provider, clock = _FakeHead(), _FakeProvider(), _Clock()
    head.node("head-1", {"CPU": 2}, {"CPU": 2}, head=True)
    head.node("node-0", {"CPU": 4}, {"CPU": 0})  # busy worker
    provider.create_node("cpu-worker", {"CPU": 4})
    provider.nodes["fake-1"].cluster_node_id = "node-0"
    # agents report the gauge every beat — all zeros (no lease queue)
    head.signals["lease_queue_depth"] = {"node-0": [0, 0, 0]}
    a = _make(head, provider, clock, upscale_consecutive=3)

    def call(method, **kw):
        r = _FakeHead.call(head, method, **kw)
        if method == "autoscaler_snapshot":
            r["pending_actors"] = [{"CPU": 4}]
        return r

    head_proxy = type("H", (), {"call": staticmethod(call),
                                "close": head.close})()
    a.head = head_proxy
    a.update()
    a.update()
    a.update()
    _settle(a)
    assert len(provider.created) == 2, \
        "sustained pending-actor demand must launch despite a 0 ring"
    a.stop()


def test_single_spike_rejected_by_hysteresis():
    head, provider, clock = _FakeHead(), _FakeProvider(), _Clock()
    head.node("head-1", {"CPU": 2}, {"CPU": 2}, head=True)
    head.node("node-0", {"CPU": 4}, {"CPU": 0}, pending=[{"CPU": 4}])
    provider.create_node("cpu-worker", {"CPU": 4})
    provider.nodes["fake-1"].cluster_node_id = "node-0"
    head.signals["lease_queue_depth"] = {"node-0": [3]}
    a = _make(head, provider, clock, upscale_consecutive=3)
    a.update()
    a.update()
    # the spike drains on its own before the streak completes
    head.nodes[1]["pending"] = []
    head.nodes[1]["available"] = {"CPU": 4}
    head.signals["lease_queue_depth"] = {"node-0": [3, 0, 0]}
    for _ in range(4):
        a.update()
    # demand returns once: streak restarted, still no launch
    head.nodes[1]["pending"] = [{"CPU": 4}]
    head.nodes[1]["available"] = {"CPU": 0}
    a.update()
    _settle(a)
    assert len(provider.created) == 1, \
        "a spike that drained must not have launched a node"
    a.stop()


def test_idle_scale_down_is_drain_based_and_blocks_until_drained():
    head, provider, clock = _FakeHead(), _FakeProvider(), _Clock()
    head.node("head-1", {"CPU": 2}, {"CPU": 2}, head=True)
    head.node("node-0", {"CPU": 4}, {"CPU": 4})
    provider.create_node("cpu-worker", {"CPU": 4})
    provider.nodes["fake-1"].cluster_node_id = "node-0"
    a = _make(head, provider, clock, idle_timeout_s=5.0)
    a.update()          # idle clock starts
    clock.t += 6.0
    a.update()          # idle past timeout: drain requested
    assert head.drain_requests == ["node-0"]
    assert provider.terminated == [], \
        "provider must NOT terminate while the drain is in flight " \
        "(a sole primary copy may still be re-replicating)"
    a.update()          # drain still reports 'draining'
    assert provider.terminated == []
    head.drain_state["node-0"] = {"state": "drained"}
    a.update()
    assert provider.terminated == ["fake-1"], \
        "terminate only after the head reports drained"
    assert a.scale_down_total == 1
    a.stop()


def test_failed_drain_releases_node_back_to_service():
    head, provider, clock = _FakeHead(), _FakeProvider(), _Clock()
    head.node("head-1", {"CPU": 2}, {"CPU": 2}, head=True)
    head.node("node-0", {"CPU": 4}, {"CPU": 4})
    provider.create_node("cpu-worker", {"CPU": 4})
    provider.nodes["fake-1"].cluster_node_id = "node-0"
    a = _make(head, provider, clock, idle_timeout_s=5.0)
    a.update()
    clock.t += 6.0
    a.update()
    assert head.drain_requests == ["node-0"]
    head.drain_state["node-0"] = {"state": "failed",
                                  "detail": "re-replication failed"}
    a.update()
    assert provider.terminated == []
    assert "node-0" not in a._draining
    a.stop()


def test_idle_scale_down_respects_min_workers():
    head, provider, clock = _FakeHead(), _FakeProvider(), _Clock()
    head.node("head-1", {"CPU": 2}, {"CPU": 2}, head=True)
    head.node("node-0", {"CPU": 4}, {"CPU": 4})
    provider.create_node("cpu-worker", {"CPU": 4})
    provider.nodes["fake-1"].cluster_node_id = "node-0"
    a = _make(head, provider, clock, node_types={
        "cpu-worker": {"resources": {"CPU": 4}, "min_workers": 1,
                       "max_workers": 4}}, idle_timeout_s=5.0)
    a.update()
    clock.t += 100.0
    a.update()
    a.update()
    assert head.drain_requests == [], \
        "the last min_workers node must never drain"
    a.stop()


def test_drain_victim_is_cheapest_by_store_bytes():
    head, provider, clock = _FakeHead(), _FakeProvider(), _Clock()
    head.node("head-1", {"CPU": 2}, {"CPU": 2}, head=True)
    head.node("node-0", {"CPU": 4}, {"CPU": 4}, arena_used=500)
    head.node("node-1", {"CPU": 4}, {"CPU": 4}, arena_used=5)
    provider.create_node("cpu-worker", {"CPU": 4})
    provider.create_node("cpu-worker", {"CPU": 4})
    provider.nodes["fake-1"].cluster_node_id = "node-0"
    provider.nodes["fake-2"].cluster_node_id = "node-1"
    a = _make(head, provider, clock, idle_timeout_s=5.0)
    a.update()
    clock.t += 6.0
    a.update()
    assert head.drain_requests == ["node-1"], \
        "the idle node with the fewest stored bytes drains first " \
        "(cheapest re-replication)"
    a.stop()


def test_head_restart_reregisters_node_types_on_epoch_change():
    head, provider, clock = _FakeHead(), _FakeProvider(), _Clock()
    head.node("head-1", {"CPU": 2}, {"CPU": 2}, head=True)
    a = _make(head, provider, clock)  # construction registers once
    a.update()
    a.update()
    regs = [c for c in head.calls if c[0] == "register_autoscaler"]
    assert len(regs) == 1, "steady state: no re-registration per pass"
    head.epoch = "epoch-2"  # head restarted
    a.update()
    regs = [c for c in head.calls if c[0] == "register_autoscaler"]
    assert len(regs) == 2, "epoch change must re-register node types"
    a.stop()


def test_stop_is_idempotent_and_adopts_inflight_launches():
    head, provider, clock = _FakeHead(), _FakeProvider(), _Clock()
    head.node("head-1", {"CPU": 2}, {"CPU": 2}, head=True)
    head.nodes[0]["pending"] = [{"CPU": 4}]
    a = _make(head, provider, clock)
    a.update()
    a.stop()
    a.stop()  # second stop must be a no-op, not a crash
    # the launch the first pass started was joined or adopted: the
    # provider still tracks its node either way
    assert provider.non_terminated_nodes(), "launched node was adopted"


def test_status_reported_to_head():
    head, provider, clock = _FakeHead(), _FakeProvider(), _Clock()
    head.node("head-1", {"CPU": 2}, {"CPU": 2}, head=True)
    head.nodes[0]["pending"] = [{"CPU": 4}]
    a = _make(head, provider, clock)
    a.update()
    _settle(a)
    a.update()
    assert head.reports, "every pass reports status to the head"
    last = head.reports[-1]
    assert "last_decision" in last and "pending_launches" in last
    # every completed launch was reported exactly once (the fake head
    # never shows the new nodes, so each pass may launch again)
    assert sum(r.get("events_delta", {}).get("up", 0)
               for r in head.reports) == len(provider.created)
    a.stop()


def test_serve_autoscale_decision_hysteresis():
    """ServeController._autoscale_desired as a pure decision unit:
    upscale needs consecutive rounds over target, a shed jumps past
    the current count, downscale waits out the delay."""
    from ray_tpu_torch.serve.api import ServeController

    ctrl = object.__new__(ServeController)
    import threading

    ctrl._lock = threading.Lock()
    now = time.monotonic()
    app = {"desired": 1, "ongoing": {"h1": (6, now)}, "sheds": {},
           "autoscaling": {"min_replicas": 1, "max_replicas": 8,
                           "target_ongoing_requests": 2,
                           "upscale_consecutive": 2,
                           "downscale_delay_s": 5.0}}
    assert ctrl._autoscale_desired(app, 1) == 1, \
        "first over-target round must not scale yet (hysteresis)"
    assert ctrl._autoscale_desired(app, 1) == 3, \
        "second consecutive round scales to ceil(6/2)"
    # load vanishes: downscale only after the delay
    app["ongoing"] = {}
    assert ctrl._autoscale_desired(app, 3) == 3
    app["below_since"] = time.monotonic() - 6.0
    assert ctrl._autoscale_desired(app, 3) == 1
    # a shed means capacity is short NOW: desired jumps past current
    app["desired"] = 1
    app["up_streak"] = 0
    app["sheds"] = {"h1": (3, time.monotonic())}
    ctrl._autoscale_desired(app, 2)
    assert ctrl._autoscale_desired(app, 2) == 3, \
        "sheds push desired past the current replica count"


def test_llm_engine_queue_feeds_autoscale_decision():
    from ray_tpu_torch.serve.api import ServeController

    ctrl = object.__new__(ServeController)
    import threading

    ctrl._lock = threading.Lock()
    app = {"desired": 1, "ongoing": {}, "sheds": {},
           "replica_queue": {"r1": 8},
           "autoscaling": {"min_replicas": 1, "max_replicas": 8,
                           "target_ongoing_requests": 2,
                           "upscale_consecutive": 1}}
    assert ctrl._autoscale_desired(app, 1) == 4, \
        "replica-side queued sequences count as load"


# ------------------------------------------------------ fake-multinode e2e


@pytest.fixture
def autoscaling_cluster(tmp_path, monkeypatch):
    monkeypatch.setenv("RT_TMPDIR", str(tmp_path))
    cluster = AutoscalingCluster(
        head_resources={"CPU": 2, "GPU": 0},
        worker_node_types={
            "cpu-worker": {"resources": {"CPU": 4}, "min_workers": 0,
                           "max_workers": 2},
            "gpu-worker": {"resources": {"CPU": 2, "GPU": 1},
                           "min_workers": 0, "max_workers": 2},
        },
        idle_timeout_s=2.0, update_period_s=0.3)
    ray_tpu_torch.init(address=cluster.address)
    try:
        yield cluster
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


@pytest.mark.slow
def test_scale_up_on_infeasible_task(autoscaling_cluster):
    """A {"CPU": 4} task cannot fit the 2-CPU head; the autoscaler must
    launch a cpu-worker and the task must then run (reference:
    autoscaler.py resolves infeasibility — the task pends, not fails)."""
    @ray_tpu_torch.remote(num_cpus=4)
    def big():
        return "scaled"

    assert ray_tpu_torch.get(big.remote(), timeout=120) == "scaled"
    assert len(autoscaling_cluster.provider.non_terminated_nodes()) >= 1


@pytest.mark.slow
def test_scale_up_for_gpu_resource(autoscaling_cluster):
    @ray_tpu_torch.remote(num_gpus=1)
    def gpu_task():
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    assert ray_tpu_torch.get(gpu_task.remote(), timeout=120) == "0"
    types = [n.node_type for n in
             autoscaling_cluster.provider.non_terminated_nodes()]
    assert "gpu-worker" in types


@pytest.mark.slow
def test_pending_actor_triggers_scale_up(autoscaling_cluster):
    @ray_tpu_torch.remote(num_cpus=4)
    class Big:
        def ping(self):
            return "actor-scaled"

    a = Big.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=120) == "actor-scaled"


@pytest.mark.slow
def test_pending_pg_triggers_scale_up(autoscaling_cluster):
    from ray_tpu_torch.util.placement_group import (
        placement_group, remove_placement_group)

    pg = placement_group([{"CPU": 4}], strategy="PACK")
    assert pg.wait(timeout=120), "placement group never became ready"
    remove_placement_group(pg)


@pytest.mark.slow
def test_idle_nodes_scale_down(autoscaling_cluster):
    @ray_tpu_torch.remote(num_cpus=4)
    def big():
        return 1

    assert ray_tpu_torch.get(big.remote(), timeout=120) == 1
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if not autoscaling_cluster.provider.non_terminated_nodes():
            return
        time.sleep(0.5)
    raise AssertionError("idle worker was never scaled down")


@pytest.mark.slow
def test_max_workers_cap(autoscaling_cluster):
    """More demand than max_workers allows: cluster grows to the cap and
    work completes there (queued, not failed)."""
    @ray_tpu_torch.remote(num_cpus=4)
    def big(i):
        time.sleep(0.2)
        return i

    refs = [big.remote(i) for i in range(8)]
    assert sorted(ray_tpu_torch.get(refs, timeout=180)) == list(range(8))
    cpu_workers = [n for n in
                   autoscaling_cluster.provider.non_terminated_nodes()
                   if n.node_type == "cpu-worker"]
    assert len(cpu_workers) <= 2


@pytest.mark.slow
def test_truly_infeasible_still_errors(autoscaling_cluster):
    """Demand no configured node type can ever satisfy fails fast."""
    @ray_tpu_torch.remote(resources={"GPU": 8})
    def impossible():
        return 0

    with pytest.raises(ray_tpu_torch.SchedulingError):
        ray_tpu_torch.get(impossible.remote(), timeout=60)


def test_pending_gpu_actor_scales_up_a_gpu_node_then_down(tmp_path,
                                                          monkeypatch):
    """A head with ``GPU: 0``: a ``num_gpus=1`` actor pends until the
    autoscaler launches ``gpu-worker``, whose agent hands it card "0";
    once the actor is killed the node goes idle, drains and is
    terminated."""
    monkeypatch.setenv("RT_TMPDIR", str(tmp_path))
    cluster = bounded(lambda: AutoscalingCluster(
        head_resources={"CPU": 2, "GPU": 0},
        worker_node_types={
            "gpu-worker": {"resources": {"CPU": 2, "GPU": 1},
                           "min_workers": 0, "max_workers": 1}},
        idle_timeout_s=2.0, update_period_s=0.3), 120,
        "AutoscalingCluster")
    try:
        bounded(lambda: ray_tpu_torch.init(address=cluster.address), 120,
                "init")
        assert ray_tpu_torch.cluster_resources().get("GPU", 0) == 0

        @ray_tpu_torch.remote(num_gpus=1)
        class GpuReader:
            def visible(self):
                return os.environ.get("CUDA_VISIBLE_DEVICES")

            def node(self):
                return ray_tpu_torch.api._worker().node_id

        a = GpuReader.remote()
        assert bounded(lambda: ray_tpu_torch.get(a.visible.remote(),
                                                 timeout=90),
                       100, "visible") == "0"
        nodes = cluster.provider.non_terminated_nodes()
        assert [n.node_type for n in nodes] == ["gpu-worker"]
        assert ray_tpu_torch.get(a.node.remote(), timeout=30) == \
            nodes[0].cluster_node_id
        ray_tpu_torch.kill(a)
        deadline = time.monotonic() + 60
        while cluster.provider.non_terminated_nodes() \
                and time.monotonic() < deadline:
            time.sleep(0.3)
        assert not cluster.provider.non_terminated_nodes(), \
            "the idle GPU node was never terminated"
        st = cluster.status()
        assert st["scale_up_total"] == 1, st
    finally:
        bounded(ray_tpu_torch.shutdown, 60, "shutdown")
        cluster.shutdown()


# ---------------------------------------------------- graceful drain (e2e)


def _head_call(method, **kw):
    return ray_tpu_torch.api._worker().head.call(method, timeout=30, **kw)


def _wait_drained(node_id, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rec = _head_call("drain_status", node_id=node_id)
        if rec.get("state") == "drained":
            return rec
        assert rec.get("state") != "failed", f"drain failed: {rec}"
        time.sleep(0.2)
    raise AssertionError("drain never completed")


@pytest.mark.slow
def test_graceful_drain_preserves_objects_and_actor_state():
    """The drain-loses-nothing contract: a node holding the SOLE
    primary copies of live objects and a stateful actor drains — the
    copies re-replicate over the bulk plane (promoted to primary on the
    target, findable via the directory), the actor migrates via
    __rt_save__/__rt_restore__ with state intact, and the leak gauge
    stays 0."""
    import urllib.request

    import numpy as np

    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster(head_node_args={"num_cpus": 0})
    worker_a = cluster.add_node(num_cpus=4)  # the only CPU node at first
    ray_tpu_torch.init(address=cluster.address)
    try:
        cluster.wait_for_nodes(2)

        @ray_tpu_torch.remote(num_cpus=1, max_retries=0)
        def produce(n):
            # max_retries=0: if the copy died with the node, get()
            # raises instead of reconstruction masking the loss
            return np.arange(n, dtype=np.uint8)

        # one directory-worthy object (>= locality_min_bytes) and one
        # small sole-copy object (only the head's injected directory
        # entry makes it findable after the drain)
        big = produce.remote(2 * 1024 * 1024)
        small = produce.remote(200 * 1024)

        # max_restarts=0: a crash would NOT revive this actor — only
        # the drain's save-hook migration can.  max_task_retries covers
        # the caller's stale-address push racing the migration, same
        # contract as chaos restarts (test_chaos.py).
        @ray_tpu_torch.remote(num_cpus=1, max_restarts=0, max_task_retries=2)
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

            def node(self):
                import ray_tpu_torch as rt

                return rt.api._worker().node_id

            def __rt_save__(self):
                return {"n": self.n}

            def __rt_restore__(self, state):
                self.n = state["n"]

        counter = Counter.remote()
        assert ray_tpu_torch.get(
            [counter.incr.remote() for _ in range(3)], timeout=60
        ) == [1, 2, 3]
        assert ray_tpu_torch.get(counter.node.remote(),
                           timeout=30) == worker_a.node_id
        assert ray_tpu_torch.get(big, timeout=60).shape == (2 * 1024 * 1024,)

        # fresh capacity for the migration target, then drain A
        cluster.add_node(num_cpus=4)
        cluster.wait_for_nodes(3)
        r = _head_call("drain_node_graceful", node_id=worker_a.node_id)
        assert r.get("ok"), r
        rec = _wait_drained(worker_a.node_id)
        assert rec["replicated_objects"] >= 2, rec
        assert rec["migrated_actors"] == 1, rec

        # the node is gone from the table
        assert worker_a.node_id not in {
            n["node_id"] for n in ray_tpu_torch.nodes()}
        # drain lost nothing: both sole copies survive (no lineage —
        # max_retries=0 — so this is the re-replicated bytes)
        a = ray_tpu_torch.get(big, timeout=60)
        assert a.shape == (2 * 1024 * 1024,) and a[-1] == 255
        assert ray_tpu_torch.get(small, timeout=60).shape == (200 * 1024,)
        # the actor resumed elsewhere with state intact
        assert ray_tpu_torch.get(counter.incr.remote(), timeout=120) == 4
        assert ray_tpu_torch.get(counter.node.remote(),
                           timeout=30) != worker_a.node_id
        # and the leak tripwires saw nothing across the scale-down
        port = _head_call("metrics_port")["port"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            text = resp.read().decode()
        for ln in text.splitlines():
            if ln.startswith("ray_tpu_object_leaked_bytes"):
                assert float(ln.rsplit(" ", 1)[1]) == 0.0, ln
        # the scale event is debuggable: /api/autoscaler carries the
        # drain record with its migration/replication counts
        import json as _json

        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/autoscaler",
                timeout=10) as resp:
            view = _json.loads(resp.read().decode())
        rec2 = view["drains"][worker_a.node_id]
        assert rec2["state"] == "drained"
        assert rec2["replicated_objects"] >= 2
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


@pytest.mark.slow
def test_autoscaler_grows_and_drains_back_under_burst():
    """Fake provider grows 1 -> 3 nodes under a task burst, then the
    drain-based scale-down empties the fleet once idle (the subprocess
    e2e half of the scale-event coverage)."""
    cluster = AutoscalingCluster(
        head_resources={"CPU": 2},
        worker_node_types={
            "cpu-worker": {"resources": {"CPU": 4}, "min_workers": 0,
                           "max_workers": 2}},
        idle_timeout_s=2.0, update_period_s=0.3)
    ray_tpu_torch.init(address=cluster.address)
    try:
        @ray_tpu_torch.remote(num_cpus=4)
        def burst(i):
            time.sleep(0.5)
            return i

        refs = [burst.remote(i) for i in range(6)]
        grew = 0
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            grew = max(grew,
                       len(cluster.provider.non_terminated_nodes()))
            if grew >= 2:
                break
            time.sleep(0.2)
        assert sorted(ray_tpu_torch.get(refs, timeout=120)) == list(range(6))
        assert grew >= 2, "burst must have grown the fleet to 3 nodes"
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            if not cluster.provider.non_terminated_nodes():
                break
            time.sleep(0.3)
        assert not cluster.provider.non_terminated_nodes(), \
            "idle fleet must drain back down"
        # the provider empties the moment the drained agent process
        # exits; the autoscaler's drain-status poll records the
        # scale-down a pass later — wait it out
        deadline = time.monotonic() + 15
        st = cluster.status()
        while time.monotonic() < deadline \
                and st["scale_down_total"] < 2:
            time.sleep(0.3)
            st = cluster.status()
        assert st["scale_up_total"] >= 1
        assert st["scale_down_total"] >= 2, st
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
