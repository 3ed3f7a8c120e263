"""The end-to-end user pipeline of tests/test_e2e_pipeline.py on the port:
Data -> TorchTrainer -> checkpoint storage -> Serve -> the RPC ingress.

The JAX side runs the original pipeline's training half (``JaxTrainer``,
two workers, each on its shard of the same dataset) in a ray_tpu
cluster, shut down before the port's cluster starts.  The port's
``TorchTrainer`` then trains the same regression, y = 3x - 1, with two
gloo workers on the CPU, each on its dataset shard, by torch in fp32;
its final weights must match the JAX pipeline's within that test's own
0.1.  They are persisted and fetched through ``StorageContext``, served
by a two-replica deployment, and queried through a handle and through
the binary ingress.

Train loops and the deployment are built inside functions, so
cloudpickle sends them by value: a worker imports nothing of this file
(nor of JAX).  Every blocking call is bounded.
"""

import json
import os

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch as rt

from tests.conftest import force_cpu_jax
from tests.torch_waits import bounded

torch.set_num_threads(2)   # six xdist workers share the test machine

WEIGHT_ATOL = 0.1          # the JAX pipeline test's bound
FIT_S = 240
XS = np.linspace(-1, 1, 256).astype(np.float32)
COLUMNS = {"x": XS, "y": 3.0 * XS - 1.0}


def _jax_loop():
    def loop(config):
        import numpy as np

        from ray_tpu.train import get_dataset_shard

        rows = get_dataset_shard("train").take_all()
        x = np.array([r["x"] for r in rows], dtype=np.float32)
        y = np.array([r["y"] for r in rows], dtype=np.float32)
        w, b = 0.0, 0.0
        for _ in range(200):
            err = w * x + b - y
            w -= 0.3 * float((err * x).mean())
            b -= 0.3 * float(err.mean())
        return {"w": w, "b": b}
    return loop


def _port_loop():
    def loop(config):
        import json
        import os

        import torch

        from ray_tpu_torch.train import (get_context, get_dataset_shard,
                                         report)

        torch.set_num_threads(1)
        batches = list(get_dataset_shard("train").iter_batches(
            batch_size=1024))
        x = torch.from_numpy(np.concatenate([b["x"] for b in batches]))
        y = torch.from_numpy(np.concatenate([b["y"] for b in batches]))
        w = torch.zeros((), dtype=torch.float32)
        b = torch.zeros((), dtype=torch.float32)
        for step in range(200):
            err = w * x + b - y
            w = w - 0.3 * (err * x).mean()
            b = b - 0.3 * err.mean()
            if step % 50 == 49:
                ckpt = os.path.join(config["out"],
                                    f"w{get_context().rank}-{step}")
                os.makedirs(ckpt, exist_ok=True)
                with open(os.path.join(ckpt, "weights.json"), "w") as f:
                    json.dump({"w": float(w), "b": float(b)}, f)
                report({"loss": float((err ** 2).mean())}, checkpoint=ckpt)
        return {"w": float(w), "b": float(b), "rows": int(x.numel()),
                "world": torch.distributed.get_world_size()}
    return loop


@pytest.fixture(scope="module")
def jax_weights():
    force_cpu_jax()
    from ray_tpu import data as jdata
    from ray_tpu.train import JaxTrainer, ScalingConfig

    ray_tpu.init(num_cpus=4, object_store_memory=96 << 20)
    try:
        result = bounded(JaxTrainer(
            _jax_loop(), scaling_config=ScalingConfig(num_workers=2),
            train_loop_config={},
            datasets={"train": jdata.from_numpy(COLUMNS)}).fit,
            FIT_S, "JaxTrainer.fit()")
        return [dict(f) for f in result.per_worker_final]
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def cluster(jax_weights, tmp_path_factory):
    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    bounded(lambda: rt.init(num_cpus=4, object_store_memory=96 << 20),
            120, "rt.init")
    try:
        yield rt
    finally:
        from ray_tpu_torch import serve

        bounded(serve.shutdown, 60, "serve.shutdown")
        bounded(rt.shutdown, 60, "rt.shutdown")
        os.environ.pop("RT_TMPDIR", None)


def test_data_train_checkpoint_serve(cluster, jax_weights, tmp_path):
    from ray_tpu_torch import data, serve
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.storage import StorageContext

    # 1-2. Data into two gloo workers, each on its round-robin shard
    result = bounded(TorchTrainer(
        _port_loop(),
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False),
        train_loop_config={"out": str(tmp_path / "store")},
        datasets={"train": data.from_numpy(COLUMNS)}).fit, FIT_S,
        "TorchTrainer.fit()")
    finals = result.per_worker_final
    assert [f["world"] for f in finals] == [2, 2]
    assert sum(f["rows"] for f in finals) == len(XS)
    for got, want in zip(finals, jax_weights):
        assert abs(got["w"] - want["w"]) < WEIGHT_ATOL
        assert abs(got["b"] - want["b"]) < WEIGHT_ATOL
    final = {"w": finals[0]["w"], "b": finals[0]["b"]}
    assert abs(final["w"] - 3.0) < WEIGHT_ATOL
    assert abs(final["b"] + 1.0) < WEIGHT_ATOL
    assert result.checkpoint and os.path.exists(
        os.path.join(result.checkpoint, "weights.json"))

    # 3. persist to "remote" storage, fetch on a "fresh host" path; the
    # in-memory filesystem is one per process, shared with any other
    # test that ran here, so the path is this test's own
    sc = StorageContext(f"memory://torch-e2e/{tmp_path.name}/run", "exp")
    src = tmp_path / "final"
    src.mkdir()
    (src / "weights.json").write_text(json.dumps(final))
    sc.persist_dir(str(src), "checkpoints/final")
    restored = sc.fetch_dir("checkpoints/final", str(tmp_path / "restored"))
    weights = json.loads(open(f"{restored}/weights.json").read())
    assert weights == final

    # 4. serve the trained model: a handle, then the binary ingress
    def linreg():
        @serve.deployment(name="linreg", num_replicas=2)
        class LinReg:
            def __init__(self, w, b):
                self.w, self.b = w, b

            def __call__(self, x):
                return {"y": self.w * float(x) + self.b}
        return LinReg

    handle = bounded(lambda: serve.run(
        linreg().bind(weights["w"], weights["b"])), 120, "serve.run")
    y = bounded(lambda: rt.get(handle.remote(2.0), timeout=60), 70,
                "handle")["y"]
    assert abs(y - 5.0) < 0.3
    host, port = serve.start_rpc_ingress()
    client = serve.RpcIngressClient(host, port)
    try:
        got = bounded(lambda: client.invoke("linreg", 0.0), 60, "ingress")
        assert abs(got["y"] + 1.0) < 0.3
    finally:
        client.close()
        serve.stop_rpc_ingress()
        serve.delete("linreg")
