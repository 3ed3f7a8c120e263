"""The port's compiled graphs (ray_tpu_torch/dag), on its own runtime.

The cases of tests/test_dag_compiled.py, moved onto ray_tpu_torch: the
mutable channels (ring semantics, backpressure, fan-out, error versions
and poison, remote push with its RPC fallback) and channel-compiled
graphs with pinned actor loops, plus the dynamic compiled path.  The
port's dag modules are ray_tpu's after ``runtime_copy.rename``
(tests/test_torch_runtime.py guards that); what differs is the
serialization beneath them, so a torch tensor's trip through a ring is
tested here too: a CPU tensor read from a ring owns its memory and keeps
its values after the slot is released and rewritten.

The graph tests share one cluster.  Every blocking call has a timeout:
its own, or the library's (a compile waits at most 120 s for its
actors, a teardown ``dag_teardown_timeout_s``).
"""

import os
import threading
import time

import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private.object_store import StoreCore
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.dag import channel as chmod
from tests.torch_waits import bounded

torch.set_num_threads(2)   # six xdist workers share the test machine


# ----------------------------------------------------------- channel units


@pytest.fixture
def store(tmp_path):
    s = StoreCore(str(tmp_path / "arena"), 8 * 1024 * 1024,
                  str(tmp_path / "spill"))
    yield s
    s.close(unlink=True)


def _local_channel(store, oid="ch-test", mif=2, n_readers=1,
                   slot=64 * 1024):
    spec = chmod.ChannelSpec(oid=oid, max_in_flight=mif, slot_size=slot,
                             n_readers=n_readers, writer_node="n0",
                             reader_nodes=["n0"] * n_readers, nodes={})
    loc = store.create_channel(oid, spec.total_size())
    view = store.arena.view[loc["offset"]:loc["offset"] + spec.total_size()]
    chmod.init_view(view, spec.header_wire())
    return spec, view


def test_channel_ring_wraparound(store):
    """Versions stay intact across several wraps of a 2-deep ring."""
    spec, view = _local_channel(store, mif=2)
    w = chmod.ChannelWriter(spec, view=view)
    r = chmod.ChannelReader(spec, 0, view=view)
    for seq in range(1, 8):
        w.write({"seq": seq, "data": b"x" * seq})
        value, is_err = r.read(seq, timeout=5)
        assert not is_err and value == {"seq": seq, "data": b"x" * seq}
        r.advance(seq)


def test_channel_backpressure_blocks_writer(store):
    """A slow reader BLOCKS the writer at max_in_flight versions —
    versions are never dropped."""
    spec, view = _local_channel(store, mif=2)
    w = chmod.ChannelWriter(spec, view=view)
    r = chmod.ChannelReader(spec, 0, view=view)
    w.write(1)
    w.write(2)
    with pytest.raises(chmod.ChannelTimeoutError):
        w.write(3, timeout=0.2)
    value, _ = r.read(1, timeout=5)
    assert value == 1
    r.advance(1)
    w.write(3, timeout=5)  # slot freed: write proceeds
    assert r.read(2, timeout=5)[0] == 2
    r.advance(2)
    assert r.read(3, timeout=5)[0] == 3


def test_channel_multi_reader_fanout(store):
    """Every reader sees every version; the writer only advances once
    ALL readers have consumed the slot it needs."""
    spec, view = _local_channel(store, mif=2, n_readers=2)
    w = chmod.ChannelWriter(spec, view=view)
    r0 = chmod.ChannelReader(spec, 0, view=view)
    r1 = chmod.ChannelReader(spec, 1, view=view)
    w.write("a")
    w.write("b")
    for seq, expect in ((1, "a"), (2, "b")):
        assert r0.read(seq, timeout=5)[0] == expect
        r0.advance(seq)
    # r1 has consumed nothing: the ring is still full for the writer
    with pytest.raises(chmod.ChannelTimeoutError):
        w.write("c", timeout=0.2)
    assert r1.read(1, timeout=5)[0] == "a"
    r1.advance(1)
    w.write("c", timeout=5)
    assert r1.read(2, timeout=5)[0] == "b"
    r1.advance(2)
    assert r1.read(3, timeout=5)[0] == "c"
    assert r0.read(3, timeout=5)[0] == "c"


def test_channel_error_version_and_poison(store):
    spec, view = _local_channel(store)
    w = chmod.ChannelWriter(spec, view=view)
    r = chmod.ChannelReader(spec, 0, view=view)
    w.write(ValueError("boom"), error=True)
    value, is_err = r.read(1, timeout=5)
    assert is_err and isinstance(value, ValueError)
    r.advance(1)
    chmod.poison_view(view, chmod.pickle_error(
        rt.ActorDiedError("actor gone")))
    with pytest.raises(rt.ActorDiedError):
        r.read(2, timeout=5)
    with pytest.raises(rt.ActorDiedError):
        w.write("after poison")


def test_channel_close_wakes_reader(store):
    spec, view = _local_channel(store)
    w = chmod.ChannelWriter(spec, view=view)
    r = chmod.ChannelReader(spec, 0, view=view)
    w.write(1)
    assert r.read(1, timeout=5)[0] == 1
    r.advance(1)
    w.close()
    with pytest.raises(chmod.ChannelClosedError):
        r.read(2, timeout=5)


def test_channel_cpu_bf16_tensor_owns_its_memory_after_advance(store):
    """A bf16 CPU tensor read from a ring is the port's own copy: after
    ``advance()`` releases its slot and later versions overwrite that
    slot (a 2-deep ring wraps twice), the tensor still holds what was
    written, bit for bit."""
    spec, view = _local_channel(store, mif=2)
    w = chmod.ChannelWriter(spec, view=view)
    r = chmod.ChannelReader(spec, 0, view=view)
    gen = torch.Generator().manual_seed(0)
    sent = [torch.randn((16, 64), generator=gen).to(torch.bfloat16)
            for _ in range(5)]
    got = []
    for seq, x in enumerate(sent, start=1):
        w.write(x, timeout=5)
        value, is_err = r.read(seq, timeout=5)
        assert not is_err
        r.advance(seq)
        got.append(value)
    for x, y in zip(sent, got):
        assert y.dtype == torch.bfloat16 and y.shape == x.shape
        assert torch.equal(y.view(torch.int16), x.view(torch.int16))
    got[0].add_(1)   # writable, and not a view of the ring
    assert not torch.equal(got[0], sent[0])


from ray_tpu_torch._private.rpc import RpcHost


class _MiniAgent(RpcHost):
    """Just enough of a node agent for the compat channel RPC path."""

    def __init__(self, store):
        self.store = store

    def _entry(self, oid):
        e = self.store.objects.get(oid)
        return e if e is not None and e.channel else None

    async def rpc_channel_write(self, oid, offset, data):
        e = self._entry(oid)
        if e is None or offset < 0 or offset + len(data) > e.size:
            return {"ok": False, "error": "bad channel write"}
        base = e.offset
        self.store.arena.view[base + offset:base + offset + len(data)] = data
        return {"ok": True}

    async def rpc_channel_read(self, oid, offset, length):
        e = self._entry(oid)
        if e is None:
            return {"ok": False, "error": "no channel"}
        base = e.offset
        return {"ok": True, "data": bytes(
            self.store.arena.view[base + offset:base + offset + length])}


def _remote_pair(tmp_path, xfer_port_of):
    """Writer store + reader store with a transfer server and a compat
    RPC agent on the reader side; returns (spec, wview, rview, cleanup)."""
    import asyncio

    from ray_tpu_torch._private.object_transfer import ObjectTransferServer
    from ray_tpu_torch._private.rpc import EventLoopThread, RpcServer

    store_w = StoreCore(str(tmp_path / "arena-w"), 8 << 20,
                        str(tmp_path / "spill-w"))
    store_r = StoreCore(str(tmp_path / "arena-r"), 8 << 20,
                        str(tmp_path / "spill-r"))
    xfer = ObjectTransferServer(store_r)
    io = EventLoopThread(name="rt-test-agent")
    xfer_port = io.run(xfer.start())
    server = RpcServer(_MiniAgent(store_r), "127.0.0.1", 0)
    rpc_port = io.run(server.start())

    spec = chmod.ChannelSpec(
        oid="ch-remote", max_in_flight=2, slot_size=64 * 1024, n_readers=1,
        writer_node="nw", reader_nodes=["nr"],
        nodes={"nw": {"agent": ["127.0.0.1", 1], "xfer_port": 0},
               "nr": {"agent": ["127.0.0.1", rpc_port],
                      "xfer_port": xfer_port_of(xfer_port)}})
    for st in (store_w, store_r):
        loc = st.create_channel(spec.oid, spec.total_size())
        view = st.arena.view[loc["offset"]:loc["offset"] + spec.total_size()]
        chmod.init_view(view, spec.header_wire())
    wview = store_w.arena.view[
        store_w.objects[spec.oid].offset:][:spec.total_size()]
    rview = store_r.arena.view[
        store_r.objects[spec.oid].offset:][:spec.total_size()]

    def cleanup():
        io.run(xfer.stop())
        io.run(server.stop())
        io.stop()
        store_w.close(unlink=True)
        store_r.close(unlink=True)

    return spec, wview, rview, cleanup


@pytest.mark.parametrize("plane", ["bulk", "rpc_fallback"])
def test_channel_remote_push(tmp_path, plane):
    """Remote-reader delivery: versions are PUSHED into the reader
    node's mirror over the bulk plane; with the bulk listener
    unreachable the writer falls back to the compat RPC path, and
    backpressure still flows back through the mirror's cursors."""
    spec, wview, rview, cleanup = _remote_pair(
        tmp_path,
        (lambda p: p) if plane == "bulk" else (lambda p: 1))  # port 1: dead
    try:
        w = chmod.ChannelWriter(spec, view=wview)
        r = chmod.ChannelReader(spec, 0, view=rview)
        for seq in range(1, 6):
            w.write({"v": seq}, timeout=10)
            assert r.read(seq, timeout=10)[0] == {"v": seq}
            r.advance(seq)
        if plane == "rpc_fallback":
            assert not w._targets[0].bulk_ok
        else:
            assert w._targets[0].bulk_ok
        # slow remote reader: ring full blocks the writer
        w.write("x", timeout=10)
        w.write("y", timeout=10)
        with pytest.raises(chmod.ChannelTimeoutError):
            w.write("z", timeout=0.3)
        assert r.read(6, timeout=10)[0] == "x"
        r.advance(6)
        w.write("z", timeout=10)
        assert r.read(7, timeout=10)[0] == "y"
        r.advance(7)
        assert r.read(8, timeout=10)[0] == "z"
        r.advance(8)
        w.detach()
    finally:
        cleanup()


# ------------------------------------------------------ compiled graph e2e


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    bounded(lambda: rt.init(num_cpus=4,
                            object_store_memory=64 * 1024 * 1024),
            120, "rt.init")
    try:
        yield rt
    finally:
        bounded(rt.shutdown, 60, "rt.shutdown")
        os.environ.pop("RT_TMPDIR", None)


def test_compiled_graph_chain(cluster):
    @rt.remote
    class Stage:
        def __init__(self):
            self.calls = 0

        def step(self, x):
            self.calls += 1
            return x + self.calls

    with InputNode() as inp:
        dag = Stage.bind().step.bind(Stage.bind().step.bind(inp))
    g = dag.experimental_compile(use_channels=True, max_in_flight=4)
    try:
        # state persists across executes: calls accumulate per stage
        assert g.execute(10).get(timeout=60) == 12   # 10+1 then +1
        assert g.execute(10).get(timeout=60) == 14   # 10+2 then +2
        refs = [g.execute(0) for _ in range(3)]
        assert [r.get(timeout=60) for r in refs] == [6, 8, 10]
    finally:
        g.teardown()


def test_compiled_graph_multi_output_and_fanout(cluster):
    @rt.remote
    class A:
        def tag(self, x):
            return ("a", x)

    @rt.remote
    class B:
        def tag(self, pair):
            return ("b",) + pair

    with InputNode() as inp:
        shared = A.bind().tag.bind(inp)
        dag = MultiOutputNode([B.bind().tag.bind(shared),
                               B.bind().tag.bind(shared)])
    g = dag.experimental_compile(use_channels=True)
    try:
        out = g.execute(7).get(timeout=60)
        assert out == [("b", "a", 7), ("b", "a", 7)]
    finally:
        g.teardown()


def test_compiled_graph_error_propagates(cluster):
    @rt.remote
    class S:
        def step(self, x):
            if x < 0:
                raise ValueError("negative input")
            return x * 2

    with InputNode() as inp:
        dag = S.bind().step.bind(S.bind().step.bind(inp))
    g = dag.experimental_compile(use_channels=True)
    try:
        assert g.execute(3).get(timeout=60) == 12
        with pytest.raises(ValueError, match="negative input"):
            g.execute(-1).get(timeout=60)
        # the pipeline survives a value-level error
        assert g.execute(5).get(timeout=60) == 20
    finally:
        g.teardown()


def test_compiled_graph_value_level_write_failures_survive(cluster):
    """An oversized or unserializable RESULT degrades to a per-execution
    error (re-raised by that ref's get, re-raisable on a retried get)
    without killing the actor loop or poisoning the pipeline."""
    @rt.remote
    class S:
        def step(self, x):
            if x == "big":
                return b"x" * (256 * 1024)  # exceeds the 64KB slot below
            return x

    @rt.remote
    class T:
        def step(self, x):
            return x

    with InputNode() as inp:
        dag = T.bind().step.bind(S.bind().step.bind(inp))
    g = dag.experimental_compile(use_channels=True,
                                 buffer_size_bytes=64 * 1024)
    try:
        assert g.execute("ok").get(timeout=60) == "ok"
        ref = g.execute("big")
        with pytest.raises(rt.RayError, match="exceeds the channel"):
            ref.get(timeout=60)
        # a retried get re-raises the ORIGINAL error, not an
        # eviction/bookkeeping artifact
        with pytest.raises(rt.RayError, match="exceeds the channel"):
            ref.get(timeout=60)
        # the pipeline survives the value-level failure
        assert g.execute("after").get(timeout=60) == "after"
    finally:
        g.teardown()


def test_compiled_graph_teardown_idempotent_and_rejects_execute(
        cluster):
    @rt.remote
    class S:
        def step(self, x):
            return x

    with InputNode() as inp:
        dag = S.bind().step.bind(inp)
    g = dag.experimental_compile(use_channels=True)
    # while the graph is live, its pinned slots are visible in the
    # store breakdown AND claimed by this driver (not leak candidates)
    from ray_tpu_torch import api as _api

    agent = _api._worker().agent
    live = agent.call("node_memory", include_workers=False)["breakdown"]
    assert live["channel_slots"] > 0 and live["channel_bytes"] > 0
    assert g.execute(1).get(timeout=60) == 1
    g.teardown()
    # leak tripwire self-test: teardown must free
    # every pinned channel slot — the accounting API is the assert
    after = agent.call("node_memory", include_workers=False)["breakdown"]
    assert after["channel_slots"] == 0, after
    assert after["channel_bytes"] == 0, after
    from ray_tpu_torch.dag import execution as _exec

    assert _exec.live_channel_oids() == []
    g.teardown()  # idempotent
    with pytest.raises(rt.RayError):
        g.execute(2)


def test_compiled_graph_actor_death_fails_inflight_gets(cluster):
    """An actor killed mid-pipeline must fail in-flight get()s within
    the monitor interval instead of hanging them."""
    @rt.remote(max_restarts=0)
    class Flaky:
        def step(self, x):
            if x == "die":
                os._exit(1)
            return x

    @rt.remote
    class Tail:
        def step(self, x):
            return x

    with InputNode() as inp:
        dag = Tail.bind().step.bind(Flaky.bind().step.bind(inp))
    g = dag.experimental_compile(use_channels=True, max_in_flight=4)
    try:
        assert g.execute("ok").get(timeout=60) == "ok"
        ref = g.execute("die")
        with pytest.raises(rt.RayError):
            ref.get(timeout=30)
        with pytest.raises(rt.RayError):
            g.execute("after")  # pipeline is poisoned
    finally:
        g.teardown()


# ----------------------------------------------- dynamic-path satellites


def test_dynamic_compiled_backpressure_surfaces_actor_death(cluster):
    """dag/compiled.py::_apply_backpressure used to silently re-block up
    to 300s per round when a DAG actor died mid-pipeline; it must now
    surface ActorDiedError from the oldest in-flight group."""
    @rt.remote(max_restarts=0)
    class S:
        def step(self, x):
            if x >= 2:
                os._exit(1)
            time.sleep(0.05)
            return x

    with InputNode() as inp:
        dag = S.bind().step.bind(inp)
    c = dag.experimental_compile(max_in_flight=2)
    t0 = time.monotonic()
    with pytest.raises(rt.ActorDiedError):
        for i in range(10):
            c.execute(i)
    assert time.monotonic() - t0 < 60  # not a 300s wait round
    c.teardown()


def test_dynamic_compiled_teardown_waits_and_is_idempotent(cluster):
    @rt.remote
    class S:
        def step(self, x):
            return x

    with InputNode() as inp:
        dag = S.bind().step.bind(inp)
    c = dag.experimental_compile()
    assert rt.get(c.execute(1), timeout=60) == 1
    c.teardown()
    c.teardown()  # double-teardown: no-op
    with pytest.raises(rt.RayError):
        c.execute(2)


def test_dynamic_compiled_teardown_after_actor_crash(cluster):
    @rt.remote(max_restarts=0)
    class S:
        def boom(self):
            os._exit(1)

    dag = S.bind().boom.bind()
    c = dag.experimental_compile()
    with pytest.raises(rt.RayError):
        rt.get(c.execute(), timeout=60)
    c.teardown()  # actors already dead: still synchronous, no raise
    c.teardown()


def test_dynamic_diamond_shared_stage_runs_once(cluster):
    """Regression (MultiOutputNode memo): a diamond DAG's shared
    upstream stage must execute exactly once per execute()."""
    @rt.remote
    class Counting:
        def __init__(self):
            self.calls = 0

        def produce(self, x):
            self.calls += 1
            return (x, self.calls)

        def count(self):
            return self.calls

    @rt.remote
    def branch(tagged, label):
        return (label,) + tagged

    node = Counting.options(name="diamond_shared").bind()
    with InputNode() as inp:
        shared = node.produce.bind(inp)
        dag = MultiOutputNode([branch.bind(shared, "l"),
                               branch.bind(shared, "r")])
    c = dag.experimental_compile()
    try:
        for i in range(1, 4):
            left, right = rt.get(c.execute(i), timeout=60)
            # both branches saw the SAME single execution of the stage
            assert left == ("l", i, i) and right == ("r", i, i)
        counter = rt.get_actor("diamond_shared")
        assert rt.get(counter.count.remote(), timeout=60) == 3
    finally:
        c.teardown()


def test_per_channel_ring_overrides(cluster):
    """Port of test_train_pipeline.py:100: with_channel_options sizes ONE
    edge's ring without touching the compile-wide defaults (deep
    activation edges vs shallow grad edges)."""
    @rt.remote
    class Echo:
        def step(self, x):
            return x

    with InputNode() as inp:
        inp.with_channel_options(max_in_flight=3)
        mid = Echo.bind().step.bind(inp)
        mid.with_channel_options(max_in_flight=16,
                                 buffer_size_bytes=4096)
        out = Echo.bind().step.bind(mid)
    g = out.experimental_compile(use_channels=True, max_in_flight=4)
    try:
        assert g._input_spec.max_in_flight == 3
        mid_spec = g._out_specs[id(mid)]
        out_spec = g._out_specs[id(out)]
        assert mid_spec.max_in_flight == 16
        assert mid_spec.slot_size == 4096
        assert out_spec.max_in_flight == 4  # inherits the compile-wide
        assert g.execute(7).get(timeout=30) == 7
    finally:
        g.teardown()
    with pytest.raises(ValueError):
        mid.with_channel_options(max_in_flight=0)
