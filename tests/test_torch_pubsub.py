"""User pub/sub over the head's channels (ray_tpu_torch.experimental.
pubsub) and client mode (``rt://``) on a port cluster: the cases of
tests/test_pubsub_client.py.  The TPU-visibility cases there have their
GPU counterparts in tests/test_torch_runtime.py.

The client-mode case stands up its own cluster, so it runs first, before
the module's shared cluster starts.
"""

import os
import threading
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.experimental import pubsub

from tests.torch_waits import bounded

CALL_S = 60


def test_client_mode_objects_tasks_actors(tmp_path, monkeypatch):
    """rt:// drivers have no arena mmap: puts/gets proxy over RPC."""
    from ray_tpu_torch._private.object_store import RpcPlasmaClient
    from ray_tpu_torch._private.worker import global_worker_or_none
    from ray_tpu_torch.cluster_utils import Cluster

    monkeypatch.setenv("RT_TMPDIR", str(tmp_path))
    cluster = bounded(lambda: Cluster(head_node_args={"num_cpus": 2}), 120,
                      "Cluster()")
    try:
        bounded(lambda: rt.init(address=f"rt://{cluster.address}"), 120,
                "rt.init")
        assert isinstance(global_worker_or_none().plasma, RpcPlasmaClient)
        arr = np.arange(200_000, dtype=np.float32)  # > inline threshold
        ref = rt.put(arr)
        assert np.array_equal(_get(ref), arr)

        @rt.remote
        def double(x):
            return x * 2

        assert np.array_equal(_get(double.remote(ref)), arr * 2)

        @rt.remote
        class Acc:
            def __init__(self):
                self.v = 0

            def add(self, x):
                self.v += int(x)
                return self.v

        a = Acc.remote()
        assert _get(a.add.remote(5)) == 5
        assert _get(a.add.remote(7)) == 12
    finally:
        bounded(rt.shutdown, 60, "rt.shutdown")
        cluster.shutdown()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    bounded(lambda: rt.init(num_cpus=2, object_store_memory=64 << 20),
            120, "rt.init")
    try:
        yield rt
    finally:
        bounded(rt.shutdown, 60, "rt.shutdown")
        os.environ.pop("RT_TMPDIR", None)


def _get(ref):
    return bounded(lambda: rt.get(ref, timeout=CALL_S), CALL_S + 10, "get")


def test_pubsub_roundtrip(cluster):
    seq1 = pubsub.publish("app-chan", {"x": 1})
    seq2 = pubsub.publish("app-chan", {"x": 2})
    assert seq2 == seq1 + 1
    events = pubsub.poll("app-chan", after_seq=0)
    assert [e["payload"]["x"] for e in events] == [1, 2]
    assert pubsub.poll("app-chan", after_seq=seq2) == []
    # long-poll wakes on publish
    got = []
    t = threading.Thread(target=lambda: got.extend(
        pubsub.poll("app-chan", after_seq=seq2, timeout_s=10)))
    t.start()
    time.sleep(0.3)
    pubsub.publish("app-chan", {"x": 3})
    t.join(timeout=15)
    assert [e["payload"]["x"] for e in got] == [3]


def test_pubsub_builtin_channels(cluster):
    # the single-node cluster registered one node at init
    events = pubsub.poll("node_events", after_seq=0)
    assert any(e["payload"]["event"] == "registered" for e in events)

    @rt.remote
    class A:
        def ping(self):
            return 1

    a = A.remote()
    _get(a.ping.remote())
    deadline = time.time() + 15
    while time.time() < deadline:
        ev = pubsub.poll("actor_events", after_seq=0)
        if any(e["payload"]["state"] == "ALIVE" for e in ev):
            break
        time.sleep(0.2)
    assert any(e["payload"]["state"] == "ALIVE" for e in ev)
    rt.kill(a)
