"""The port's util libraries (ray_tpu_torch.util) on a cluster of faked
GPU nodes.

``cluster_utils.Cluster`` starts the port's head and three node agents
as processes: a CPU-only head node and two nodes that claim two GPUs
each (no card is touched: the tests read ``CUDA_VISIBLE_DEVICES``
only).  The placement-group cases are those of
tests/test_placement_group.py with GPU bundles in place of TPU ones,
plus the case of two fractional leases inside one bundle while another
lease holds part of a card: they must share the bundle's own card, and
removing the group must give every share back.  The ActorPool, Queue
and ``multiprocessing.Pool`` cases are those of
tests/test_util_extras.py; the host collectives are checked against
numpy on the same seeded inputs; the state API reads the port's head.

Actor classes are defined inside the test functions, so cloudpickle
sends them by value.  Every blocking call is bounded.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import placement_group, remove_placement_group
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.multiprocessing import Pool
from ray_tpu_torch.util.placement_group import placement_group_table
from ray_tpu_torch.util.queue import Empty, Full, Queue

from tests.torch_waits import bounded

CALL_S = 60


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    c = bounded(lambda: Cluster(head_node_args={"num_cpus": 2}), 120,
                "Cluster()")
    try:
        # node_a / node_b name the two GPU nodes, so a test can pin a
        # lease and a bundle to the same one
        c.add_node(num_cpus=3, resources={"GPU": 2, "node_a": 8})
        c.add_node(num_cpus=3, resources={"GPU": 2, "node_b": 8})
        bounded(lambda: rt.init(address=c.address), 120, "rt.init")
        bounded(lambda: c.wait_for_nodes(3), 60, "wait_for_nodes")
        yield c
    finally:
        bounded(rt.shutdown, 60, "rt.shutdown")
        c.shutdown()
        os.environ.pop("RT_TMPDIR", None)


def _get(refs, what="get"):
    return bounded(lambda: rt.get(refs, timeout=CALL_S), CALL_S + 10, what)


def _ready(pg):
    return bounded(lambda: pg.ready(timeout=30), 40, "pg.ready")


def _gpu_reader():
    class GpuReader:
        def gpus(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

        def node(self):
            import ray_tpu_torch

            return ray_tpu_torch.api._worker().node_id
    return GpuReader


def _wait_gpus_free(total=4.0, seconds=30):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if rt.available_resources().get("GPU", 0) >= total:
            return True
        time.sleep(0.1)
    return False


# -------------------------------------------------------- placement groups


def test_pack_bundles_each_run_a_task(cluster):
    pg = _ready(placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK"))
    try:
        def where():
            return os.getpid()

        refs = [rt.remote(placement_group=pg,
                          placement_group_bundle_index=i)(where).remote()
                for i in range(2)]
        assert all(_get(refs))
    finally:
        remove_placement_group(pg)


def test_strict_spread_lands_on_distinct_gpu_nodes(cluster):
    pg = _ready(placement_group([{"GPU": 2, "CPU": 1}] * 2,
                                strategy="STRICT_SPREAD"))
    try:
        nodes = [p["node_id"] for p in pg._info()["placements"]]
        assert len(set(nodes)) == 2
        cls = _gpu_reader()
        actors = [rt.remote(num_gpus=2, placement_group=pg,
                            placement_group_bundle_index=i)(cls).remote()
                  for i in range(2)]
        got = _get([a.node.remote() for a in actors])
        assert sorted(got) == sorted(nodes)
        # each holds both cards of its own node
        assert _get([a.gpus.remote() for a in actors]) == ["0,1", "0,1"]
    finally:
        remove_placement_group(pg)


def test_gang_reservation_is_all_or_nothing(cluster):
    """Three two-card bundles spread over two GPU nodes cannot all
    reserve: none may stay reserved, so two fit right after."""
    pg = placement_group([{"GPU": 2}] * 3, strategy="STRICT_SPREAD")
    try:
        assert not bounded(lambda: pg.wait(timeout=3), 20, "pg.wait")
        assert _wait_gpus_free()
        pg2 = placement_group([{"GPU": 2}] * 2, strategy="STRICT_SPREAD")
        assert bounded(lambda: pg2.wait(timeout=30), 40, "pg2.wait")
        remove_placement_group(pg2)
    finally:
        remove_placement_group(pg)


def test_task_and_actor_inside_a_gpu_bundle(cluster):
    pg = _ready(placement_group([{"GPU": 2, "CPU": 1}]))
    try:
        def with_cards():
            return os.environ.get("CUDA_VISIBLE_DEVICES")

        assert _get(rt.remote(num_gpus=2, placement_group=pg)(
            with_cards).remote()) == "0,1"
        cls = _gpu_reader()
        a, b = [rt.remote(num_gpus=1, num_cpus=0,
                          placement_group=pg)(cls).remote()
                for _ in range(2)]
        seen = _get([a.gpus.remote(), b.gpus.remote()])
        assert sorted(seen) == ["0", "1"]
    finally:
        remove_placement_group(pg)


def test_remove_frees_the_bundles(cluster):
    pg = _ready(placement_group([{"GPU": 2}] * 2, strategy="STRICT_SPREAD"))
    remove_placement_group(pg)
    assert _wait_gpus_free()
    pg2 = placement_group([{"GPU": 2}] * 2, strategy="STRICT_SPREAD")
    assert bounded(lambda: pg2.wait(timeout=30), 40, "pg2.wait")
    states = {p["pg_id"]: p["state"] for p in placement_group_table()}
    assert states.get(pg.id) != "CREATED" and states[pg2.id] == "CREATED"
    remove_placement_group(pg2)


def test_fractional_leases_share_their_bundles_card(cluster):
    """A lease outside any group holds half of card 0 on node_a; a
    one-card bundle on that node then hosts two half-card actors.  Both
    must land on the bundle's card, not one on card 0's free half and
    one on card 1.  After the group is removed every share is back: a
    whole-card actor gets card 1 (card 0 still has the outside lease's
    half taken)."""
    cls = _gpu_reader()
    outside = rt.remote(num_gpus=0.5, num_cpus=0,
                        resources={"node_a": 1})(cls).remote()
    try:
        assert _get(outside.gpus.remote()) == "0"
        pg = _ready(placement_group([{"GPU": 1, "CPU": 2, "node_a": 1}]))
        inside = [rt.remote(num_gpus=0.5, num_cpus=1, placement_group=pg)(
            cls).remote() for _ in range(2)]
        seen = _get([a.gpus.remote() for a in inside])
        assert seen == ["1", "1"], seen
        remove_placement_group(pg)
        assert _wait_gpus_free(3.5)
        whole = rt.remote(num_gpus=1, num_cpus=0,
                          resources={"node_a": 1})(cls).remote()
        assert _get(whole.gpus.remote()) == "1"
        rt.kill(whole)
    finally:
        rt.kill(outside)


# ------------------------------------------------------------- ActorPool


def _doubler():
    class Doubler:
        def double(self, v):
            return 2 * v
    return rt.remote(Doubler)


def test_actor_pool_ordered(cluster):
    cls = _doubler()
    pool = ActorPool([cls.remote() for _ in range(2)])
    out = bounded(lambda: list(pool.map(lambda a, v: a.double.remote(v),
                                        range(8))), CALL_S, "map")
    assert out == [2 * v for v in range(8)]


def test_actor_pool_unordered_and_queueing(cluster):
    cls = _doubler()
    pool = ActorPool([cls.remote() for _ in range(2)])
    out = bounded(lambda: sorted(pool.map_unordered(
        lambda a, v: a.double.remote(v), range(6))), CALL_S, "map")
    assert out == [2 * v for v in range(6)]


def test_actor_pool_submit_get_next(cluster):
    pool = ActorPool([_doubler().remote()])
    assert not pool.has_next()
    pool.submit(lambda a, v: a.double.remote(v), 10)
    pool.submit(lambda a, v: a.double.remote(v), 11)   # queues: one actor
    assert pool.has_next()
    assert pool.get_next(timeout=30) == 20
    assert pool.get_next(timeout=30) == 22
    assert not pool.has_next()
    with pytest.raises(StopIteration):
        pool.get_next()


def test_actor_pool_push_pop(cluster):
    cls = _doubler()
    a, b = cls.remote(), cls.remote()
    pool = ActorPool([a])
    assert pool.pop_idle() is a
    assert pool.pop_idle() is None
    pool.push(b)
    assert pool.has_free()
    with pytest.raises(ValueError):
        pool.push(b)


# ----------------------------------------------------------------- Queue


def test_queue_fifo_and_batches(cluster):
    q = Queue(maxsize=5)
    for i in range(3):
        q.put(i, timeout=10)
    assert q.qsize() == 3 and not q.empty() and not q.full()
    assert [q.get(timeout=10) for _ in range(3)] == [0, 1, 2]
    q.put_nowait_batch([7, 8, 9])
    assert q.get_nowait_batch(3) == [7, 8, 9]
    q.shutdown()


def test_queue_empty_full(cluster):
    q = Queue(maxsize=1)
    q.put_nowait("x")
    assert q.full()
    with pytest.raises(Full):
        q.put_nowait("y")
    with pytest.raises(Full):
        q.put("y", timeout=0.2)
    assert q.get_nowait() == "x"
    with pytest.raises(Empty):
        q.get_nowait()
    with pytest.raises(Empty):
        q.get(timeout=0.2)
    q.shutdown()


def test_queue_batch_failure_drains_nothing(cluster):
    q = Queue(maxsize=5)
    q.put_nowait_batch([1, 2])
    with pytest.raises(Empty):
        q.get_nowait_batch(3)
    assert q.qsize() == 2
    with pytest.raises(Full):
        q.put_nowait_batch([3, 4, 5, 6])
    assert q.qsize() == 2
    q.shutdown()


def test_queue_cross_actor(cluster):
    q = Queue()

    class Producer:
        def produce(self, q, n):
            for i in range(n):
                q.put(i)
            return True

    p = rt.remote(Producer).remote()
    assert _get(p.produce.remote(q, 4))
    assert sorted(q.get(timeout=10) for _ in range(4)) == [0, 1, 2, 3]
    q.shutdown()


# ------------------------------------------------- multiprocessing.Pool


def test_mp_pool_map(cluster):
    square = lambda x: x * x  # noqa: E731 — pickled by value
    with Pool(processes=2) as pool:
        assert bounded(lambda: pool.map(square, range(10)), CALL_S,
                       "map") == [x * x for x in range(10)]


def test_mp_pool_apply_starmap_imap(cluster):
    square = lambda x: x * x  # noqa: E731
    pool = Pool(processes=2)
    try:
        assert pool.apply(divmod, (7, 3)) == (2, 1)
        res = pool.apply_async(square, (6,))
        assert res.get(timeout=60) == 36 and res.successful()
        assert pool.starmap(pow, [(2, 3), (3, 2)]) == [8, 9]
        assert list(pool.imap(square, range(5), chunksize=2)) == \
            [0, 1, 4, 9, 16]
        assert sorted(pool.imap_unordered(square, range(5))) == \
            [0, 1, 4, 9, 16]
    finally:
        pool.terminate()


def test_mp_pool_closed_raises(cluster):
    pool = Pool(processes=1)
    pool.close()
    with pytest.raises(ValueError):
        pool.map(len, [[1]])
    pool.join()


def test_mp_pool_timed_out_get_recovers(cluster):
    pool = Pool(processes=1)
    try:
        res = pool.apply_async(time.sleep, (1.5,))
        with pytest.raises(rt.GetTimeoutError):
            res.get(timeout=0.2)
        assert res.get(timeout=30) is None
        assert res.successful()
    finally:
        pool.terminate()


def test_mp_pool_callback_fires_without_get(cluster):
    hits = []
    pool = Pool(processes=1)
    try:
        pool.apply_async(int, ("42",), callback=hits.append)
        deadline = time.time() + 30
        while not hits and time.time() < deadline:
            time.sleep(0.1)
        assert hits == [42]
    finally:
        pool.terminate()


# ------------------------------------------------------ host collectives


WORLD = 3
INPUTS = np.random.default_rng(0).standard_normal((WORLD, 5)).astype(
    np.float32)


@pytest.fixture(scope="module")
def members(cluster):
    class Member:
        def setup(self, world, rank, group):
            from ray_tpu_torch.util import collective

            collective.init_collective_group(world, rank, group)
            self.rank, self.group = rank, group
            return rank

        def allreduce(self, data):
            from ray_tpu_torch.util import collective

            return collective.allreduce(data, "sum", self.group)

        def allgather(self, data):
            from ray_tpu_torch.util import collective

            return collective.allgather(data, self.group)

        def broadcast(self, data):
            from ray_tpu_torch.util import collective

            return collective.broadcast(data if self.rank == 0 else None,
                                        0, self.group)

        def barrier(self):
            from ray_tpu_torch.util import collective

            collective.barrier(self.group)
            return True

    group = [rt.remote(Member).remote() for _ in range(WORLD)]
    assert _get([m.setup.remote(WORLD, i, "g")
                 for i, m in enumerate(group)]) == list(range(WORLD))
    return group


def test_allreduce_equals_numpy_sum(members):
    out = _get([m.allreduce.remote(INPUTS[i]) for i, m in enumerate(members)])
    for o in out:
        np.testing.assert_allclose(np.asarray(o), INPUTS.sum(0), rtol=1e-6)


def test_allgather_equals_the_inputs_in_rank_order(members):
    out = _get([m.allgather.remote(INPUTS[i]) for i, m in enumerate(members)])
    for o in out:
        np.testing.assert_array_equal(np.stack(o), INPUTS)


def test_broadcast_carries_rank_zeros_array(members):
    out = _get([m.broadcast.remote(INPUTS[0]) for m in members])
    for o in out:
        np.testing.assert_array_equal(np.asarray(o), INPUTS[0])


def test_barrier_releases_every_member(members):
    assert _get([m.barrier.remote() for m in members]) == [True] * WORLD


# ------------------------------------------------------------- state API


def test_state_api_on_the_ports_head(cluster, tmp_path):
    from ray_tpu_torch.util import state

    def named_for_state():
        return 7

    f = rt.remote(named_for_state)
    assert _get([f.remote() for _ in range(3)]) == [7, 7, 7]
    deadline = time.monotonic() + 30
    done = []
    while time.monotonic() < deadline and len(done) < 3:
        done = [t for t in state.list_tasks()
                if "named_for_state" in (t.get("name") or "")
                and t["state"] == "FINISHED"]
        time.sleep(0.2)
    assert len(done) == 3
    summary = state.summarize_tasks()
    assert any("named_for_state" in k for k in summary), summary
    actor = rt.remote(_gpu_reader()).remote()
    _get(actor.gpus.remote())
    assert any(a["state"] == "ALIVE" for a in state.list_actors())
    events = state.timeline(str(tmp_path / "trace.json"))
    assert any("named_for_state" in (e.get("name") or "") for e in events)
    assert (tmp_path / "trace.json").stat().st_size > 0
    rt.kill(actor)
