"""The port's copy of the actor runtime (ray_tpu_torch/_private, api.py).

The copied modules are guarded against drifting from ray_tpu's: each
equals its source after ``runtime_copy.rename``.  The rest of the file
drives a port cluster on the CPU: tasks, actors, the object store with
torch tensors in it, and GPU leases pinned through CUDA_VISIBLE_DEVICES
on a cluster that claims four GPUs (no card is touched: the tests read
the variable only).  All tests share one cluster.
"""

import os
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private import runtime_copy, serialization
from tests.torch_waits import bounded

torch.set_num_threads(2)   # six xdist workers share the test machine

REPO = Path(__file__).resolve().parent.parent
SRC, PORT = REPO / "ray_tpu", REPO / "ray_tpu_torch"


# -------------------------------------------------------- the copy guard


@pytest.mark.parametrize("rel", runtime_copy.COPIED)
def test_copied_module_equals_its_source_after_the_rename(rel):
    assert (PORT / rel).read_text() == \
        runtime_copy.rename((SRC / rel).read_text()), \
        f"{rel} drifted: rerun python -m ray_tpu_torch._private.runtime_copy"


def test_every_runtime_module_is_copied_or_ported_by_name():
    """Every module of ray_tpu's runtime and libraries that the port has
    is listed: copied verbatim or ported with a reason.  A ported module
    differs from its copy (else it belongs in COPIED)."""
    assert not set(runtime_copy.COPIED) & set(runtime_copy.PORTED)
    runtime = [p.relative_to(PORT).as_posix()
               for d in ("_private", "_native", "util", "util/state",
                         "data", "tune", "autoscaler", "workflow",
                         "experimental")
               for p in (PORT / d).iterdir()
               if p.suffix in (".py", ".c") and p.read_text().strip()
               and (SRC / d / p.name).exists()]
    runtime += ["api.py", "cluster_utils.py", "train/session.py",
                "job_submission.py", "scripts.py"]
    for rel in ("util/state/__init__.py", "data/dataset.py",
                "tune/tuner.py", "cluster_utils.py",
                "autoscaler/autoscaler.py", "workflow/executor.py",
                "experimental/pubsub.py", "_private/dashboard.py"):
        assert rel in runtime, rel
    listed = set(runtime_copy.COPIED) | set(runtime_copy.PORTED)
    assert sorted(set(runtime) - listed) == []
    for rel, why in runtime_copy.PORTED.items():
        assert why and (PORT / rel).exists(), rel
        assert (PORT / rel).read_text() != \
            runtime_copy.rename((SRC / rel).read_text()), rel


def test_placement_group_module_is_its_copy_without_tpu_slice_bundles():
    copy = runtime_copy.rename(
        (SRC / "util/placement_group.py").read_text())
    cut = copy.index("\n\ndef tpu_slice_bundles(")
    assert (PORT / "util/placement_group.py").read_text() == \
        copy[:cut] + "\n"


def test_rename_touches_module_paths_only():
    src = ("import ray_tpu\nfrom ray_tpu import _native\n"
           "from ray_tpu._private.rpc import RpcHost\n"
           "cmd = fast_python_cmd('ray_tpu._private.head')\n"
           "m = Counter('ray_tpu_actor_restarts_total')\n"
           "print('ray_tpu head listening')\n"
           "self._reconcile_one(ray_tpu, name, app)\n"
           "self._apply_backpressure(ray_tpu)\n")
    assert runtime_copy.rename(src) == (
        "import ray_tpu_torch\nfrom ray_tpu_torch import _native\n"
        "from ray_tpu_torch._private.rpc import RpcHost\n"
        "cmd = fast_python_cmd('ray_tpu_torch._private.head')\n"
        "m = Counter('ray_tpu_actor_restarts_total')\n"
        "print('ray_tpu head listening')\n"
        "self._reconcile_one(ray_tpu_torch, name, app)\n"
        "self._apply_backpressure(ray_tpu_torch)\n")


# ------------------------------------------------- the memory store's lock


def test_evict_from_a_collection_inside_the_store_lock_finishes(
        monkeypatch):
    """A garbage collection that starts while ``_entry`` holds the store's
    lock (its allocation of a new entry) frees the last reference to an
    owned object, whose ``__del__`` evicts it from the same store on the
    same thread, as ObjectRef.__del__ -> _free_object does.  The evict
    must not wait on the lock its own thread holds: the call finishes,
    and the evicted entry is gone afterwards."""
    import gc
    import threading

    from ray_tpu_torch._private import memory_store

    store = memory_store.MemoryStore()
    store.set_value("owned", 1)

    class Ref:                      # stands in for the last ObjectRef
        def __del__(self):
            store.evict("owned")

    held = [Ref()]
    inside, fired = [], []

    def drop_last_ref(phase, _info):
        if phase == "start" and held and inside:
            fired.append(True)
            held.pop()              # refcount 0: __del__ runs right here

    class CollectingEntry(memory_store._Entry):
        __slots__ = ()

        def __init__(self):
            inside.append(True)     # _entry holds the lock around this
            gc.collect()            # a collection inside the allocation
            inside.clear()
            super().__init__()

    monkeypatch.setattr(memory_store, "_Entry", CollectingEntry)
    gc.callbacks.append(drop_last_ref)
    try:
        worker = threading.Thread(target=store.ensure, args=("new",),
                                  daemon=True)
        worker.start()
        worker.join(timeout=10)     # a regression fails here, not hangs
    finally:
        gc.callbacks.remove(drop_last_ref)
    assert fired, "the collection never ran inside the lock"
    assert not worker.is_alive(), "evict deadlocked on the store's lock"
    assert not store.known("owned") and store.known("new")
    store.evict("new")              # the lock was left free
    assert not store.known("new")


# --------------------------------------------- the reference counter's lock


def test_ref_finalised_inside_the_counters_lock_is_counted_down_after(
        monkeypatch):
    """A garbage collection that starts while ``add_local`` holds the
    reference counter's lock (its allocation of a new record) frees the
    last ObjectRef to a borrowed object, whose ``__del__`` unregisters
    it on the same thread, as ObjectRef.__del__ does.  That must not
    wait on the lock its own thread holds: ``add_local`` finishes, and
    then the borrowed ref is counted down, its cached value evicted and
    its owner told, as outside the lock."""
    import gc
    import threading
    from types import SimpleNamespace

    from ray_tpu_torch._private import reference_count
    from ray_tpu_torch._private.worker import CoreWorker

    worker = CoreWorker.__new__(CoreWorker)    # the ref plumbing only
    worker._shutdown = False
    worker.rc = reference_count.ReferenceCounter(lambda oid: None)
    evicted, told = [], []
    worker.memory = SimpleNamespace(evict=evicted.append)
    worker._send_remove_borrow = lambda owner, oid: (owner, oid)
    worker._spawn = told.append

    class Ref:                      # stands in for the last ObjectRef
        oid, owner_addr = "borrowed", ("owner", 1)

        def __del__(self):
            worker.unregister_local_ref(self)

    worker.rc.add_local("borrowed", owned=False)
    held = [Ref()]
    inside, fired = [], []

    def drop_last_ref(phase, _info):
        if phase == "start" and held and inside:
            fired.append(True)
            held.pop()              # refcount 0: __del__ runs right here

    class CollectingRef(reference_count._Ref):
        __slots__ = ()

        def __init__(self, owned):
            inside.append(True)     # add_local holds the lock around this
            gc.collect()            # a collection inside the allocation
            inside.clear()
            super().__init__(owned)

    monkeypatch.setattr(reference_count, "_Ref", CollectingRef)
    gc.callbacks.append(drop_last_ref)
    try:
        thread = threading.Thread(target=worker.rc.add_local,
                                  args=("new", True), daemon=True)
        thread.start()
        thread.join(timeout=10)     # a regression fails here, not hangs
    finally:
        gc.callbacks.remove(drop_last_ref)
    assert fired, "the collection never ran inside the lock"
    assert not thread.is_alive(), "the ref deadlocked on the counter's lock"
    assert worker.rc.count("borrowed") == 0 and worker.rc.count("new") == 1
    assert evicted == ["borrowed"]
    assert told == [(("owner", 1), "borrowed")]


# ------------------------------------------------------------ the cluster


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    bounded(lambda: rt.init(num_cpus=2, resources={"GPU": 4},
                            object_store_memory=64 * 1024 * 1024),
            120, "rt.init")
    try:
        yield rt
    finally:
        bounded(rt.shutdown, 60, "rt.shutdown")
        os.environ.pop("RT_TMPDIR", None)


def test_tasks_actors_put_get_and_kill(cluster):
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get([add.remote(i, 1) for i in range(8)], timeout=60) == \
        list(range(1, 9))
    ref = rt.put({"k": np.arange(5)})
    assert rt.get(add.remote(rt.get(ref)["k"], 1), timeout=60).tolist() \
        == [1, 2, 3, 4, 5]

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self, by=1):
            self.n += by
            return self.n

    c = Counter.remote()
    assert rt.get([c.incr.remote() for _ in range(3)], timeout=60) == \
        [1, 2, 3]
    rt.kill(c)
    with pytest.raises(rt.RayError):
        rt.get(c.incr.remote(), timeout=60)
    ready, rest = rt.wait([add.remote(1, 1)], timeout=60)
    assert len(ready) == 1 and not rest


def test_large_cpu_tensor_travels_out_of_band(cluster):
    """A CPU tensor pickles as one out-of-band frame of its bytes (so a
    large one is copied into the arena once) and comes back equal, as a
    writable tensor of its own, through the store and through a task."""
    x = torch.arange(4 << 20, dtype=torch.float32).reshape(1024, -1)
    frames, _ = serialization.serialize(x)
    assert len(frames) == 2 and frames[1].nbytes == x.numel() * 4
    y = rt.get(rt.put(x), timeout=60)
    assert torch.equal(x, y) and y.dtype == x.dtype
    y.add_(1)   # its own memory: the arena's copy is untouched
    assert torch.equal(rt.get(rt.put(x), timeout=60), x)

    @rt.remote
    def twice(t):
        return t * 2

    b = torch.randn(3, 7).to(torch.bfloat16).requires_grad_()
    out = rt.get(twice.remote(x), timeout=60)
    assert torch.equal(out, x * 2)
    back = rt.get(rt.put(b), timeout=60)
    assert back.dtype == torch.bfloat16 and back.requires_grad
    assert torch.equal(back.detach(), b.detach())


class _CudaTensorPayload:
    """What a CUDA tensor pickles to, made without a card."""

    def __reduce__(self):
        return serialization._rebuild_tensor, (
            pickle.PickleBuffer(bytearray(16)), torch.float32, (4,), "cuda",
            False)


def test_cuda_tensor_get_without_a_cuda_device_raises(cluster):
    with pytest.raises(serialization.SerializationError, match="no CUDA"):
        rt.get(rt.put(_CudaTensorPayload()), timeout=60)

    @rt.remote
    def fetch(boxed):
        return rt.get(boxed[0])

    with pytest.raises(rt.RayTaskError, match="no CUDA device"):
        rt.get(fetch.remote([rt.put(_CudaTensorPayload())]), timeout=60)


def test_gpu_leases_see_disjoint_cuda_visible_devices(cluster, tmp_path):
    """Port of test_pubsub_client.py:95: leases holding GPUs pin
    specific cards; concurrent tasks on one node see disjoint
    CUDA_VISIBLE_DEVICES."""
    sync_dir = str(tmp_path)

    @rt.remote(num_gpus=2, num_cpus=1)
    def cards():
        mine = os.environ.get("CUDA_VISIBLE_DEVICES", "")
        with open(f"{sync_dir}/{os.getpid()}.gpus", "w") as f:
            f.write(mine)
        deadline = time.time() + 30   # both leases held at once
        while time.time() < deadline and len(
                [n for n in os.listdir(sync_dir) if n.endswith(".gpus")]) < 2:
            time.sleep(0.05)
        return mine

    a, b = rt.get([cards.remote(), cards.remote()], timeout=120)
    sa, sb = set(a.split(",")), set(b.split(","))
    assert len(sa) == 2 and len(sb) == 2 and not sa & sb, (a, b)
    assert sa | sb == {"0", "1", "2", "3"}


def test_actor_keeps_its_cards_across_method_calls(cluster):
    """Port of test_pubsub_client.py:143: method pushes keep the
    constructor's assignment (torch initialises CUDA lazily, typically
    in a method, not in __init__)."""
    @rt.remote(num_gpus=2)
    class T:
        def cards(self):
            return os.environ.get("CUDA_VISIBLE_DEVICES")

    t = T.remote()
    first = rt.get(t.cards.remote(), timeout=60)
    second = rt.get(t.cards.remote(), timeout=60)
    assert first is not None and len(first.split(",")) == 2
    assert second == first
    rt.kill(t)


def test_cpu_task_on_a_reused_worker_sees_no_card(cluster):
    """A CPU lease on a worker that held a GPU lease must not inherit
    its cards: the variable is set empty, which hides every card."""
    @rt.remote(num_gpus=1)
    def gpu_task():
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    @rt.remote
    def cpu_task():
        time.sleep(0.05)
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")

    pid, cards = rt.get(gpu_task.remote(), timeout=60)
    assert cards and len(cards.split(",")) == 1
    for _ in range(10):
        seen = dict(rt.get([cpu_task.remote() for _ in range(4)],
                           timeout=60))
        if pid in seen:
            break
    assert seen.get(pid) == "", seen
    assert all(v == "" for v in seen.values()), seen


def test_actor_process_holds_nothing_of_jax_or_ray_tpu(cluster):
    @rt.remote
    class Probe:
        def roots(self):
            import sys

            return sorted({k.split(".")[0] for k in sys.modules
                           if k.split(".")[0] in
                           ("jax", "jaxlib", "flax", "optax", "ray_tpu")})

        def argv(self):
            import sys

            return sys.argv, sys.flags.no_site

    p = Probe.remote()
    assert rt.get(p.roots.remote(), timeout=60) == []
    argv, no_site = rt.get(p.argv.remote(), timeout=60)
    assert no_site == 1
    assert argv[0].endswith(os.path.join("ray_tpu_torch", "_private",
                                         "worker_main.py")), argv
    rt.kill(p)
