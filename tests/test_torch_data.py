"""The port's Data library (ray_tpu_torch.data) held against ray_tpu.data.

The same pipelines, taken from tests/test_data.py, run on the same
seeded numpy inputs through both packages: first every pipeline through
ray_tpu.data in a ray_tpu cluster (its results copied out, the cluster
shut down), then each through ray_tpu_torch.data in one port cluster.
Integer results must be equal, float aggregates agree within 1e-6, and
row order must match wherever the op defines one (map/filter chains,
sort, split shards, iter_batches, limit); a random shuffle is compared
as a multiset.  Blocks are Arrow tables in the port's object store: a
last case checks that the port's serializer carries a table out of band
and that a batch made by torch on the CPU comes back as the same numpy.

Pipelines are built inside a function, so cloudpickle sends their
lambdas by value: a worker of either cluster imports nothing of this
file.  Every blocking call is bounded.
"""

import os

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch as rt

from tests.torch_waits import bounded

FLOAT_ATOL = 1e-6
RUN_S = 120

_RNG = np.random.default_rng(0)
KEYS = _RNG.permutation(200).astype(np.int64)
XS = _RNG.standard_normal(100)
FEAT = _RNG.random((20, 8)).astype(np.float32)


def _pipelines():
    """name -> fn(data module, scratch dir) -> plain Python / numpy."""

    def fusion(d, tmp):
        ds = (d.range(50, num_blocks=4)
              .map_batches(lambda b: {"id": b["id"], "sq": b["id"] ** 2})
              .filter(lambda r: r["sq"] % 3 == 0)
              .map(lambda r: {"v": r["id"] + r["sq"]}))
        return {"rows": [r["v"] for r in ds.take_all()],
                "explain": ds.explain()}

    def sort(d, tmp):
        rows = [{"k": int(k), "p": i} for i, k in enumerate(KEYS)]
        up = d.from_items(rows, num_blocks=6).sort("k")
        down = d.from_items(rows, num_blocks=5).sort("k", descending=True)
        return {"up": [(r["k"], r["p"]) for r in up.take_all()],
                "down": [(r["k"], r["p"]) for r in down.take_all()],
                "blocks": up.num_blocks()}

    def groupby(d, tmp):
        ds = d.from_items([{"g": f"k{i % 5}", "x": float(x)}
                           for i, x in enumerate(XS)], num_blocks=8)
        out = {}
        for name, agg in (("count()", lambda g: g.count()),
                          ("sum(x)", lambda g: g.sum("x")),
                          ("mean(x)", lambda g: g.mean("x")),
                          ("std(x)", lambda g: g.std("x"))):
            out[name] = {r["g"]: r[name]
                         for r in agg(ds.groupby("g")).take_all()}
        both = ds.groupby("g").aggregate(("min", "x"), ("max", "x"))
        out["minmax"] = {r["g"]: (r["min(x)"], r["max(x)"])
                         for r in both.take_all()}
        return out

    def aggregates(d, tmp):
        ds = d.from_numpy({"x": XS}, num_blocks=3)
        return {"sum": ds.sum("x"), "min": ds.min("x"), "max": ds.max("x"),
                "mean": ds.mean("x"), "count": ds.count()}

    def shuffle(d, tmp):
        return [r["id"] for r in
                d.range(60, num_blocks=3).random_shuffle(seed=7).take_all()]

    def split(d, tmp):
        shards = d.range(40, num_blocks=4).split(2)
        return [[r["id"] for r in s.take_all()] for s in shards]

    def tensor_column(d, tmp):
        ds = d.from_numpy({"feat": FEAT, "label": np.arange(20)},
                          num_blocks=3)
        return [(b["feat"].copy(), b["label"].copy())
                for b in ds.iter_batches(batch_size=8)]

    def parquet(d, tmp):
        out = os.path.join(tmp, "parquet")
        d.from_numpy({"id": np.arange(30), "x": XS[:30]},
                     num_blocks=3).write_parquet(out)
        back = d.read_parquet(out)
        return sorted((r["id"], r["x"]) for r in back.take_all())

    def limit(d, tmp):
        ds = d.range(100, num_blocks=10)
        return {
            "map_after": [r["id"] for r in ds.limit(5).map(
                lambda r: {"id": r["id"] * 2}).take_all()],
            "filter_before": [r["id"] for r in ds.filter(
                lambda r: r["id"] % 2 == 0).limit(4).take_all()],
            "two_caps": [r["id"] for r in ds.limit(10).filter(
                lambda r: r["id"] < 8).limit(3).take_all()],
            "count": ds.limit(6).count(),
            "plan": [(op.name, op.payload if op.name == "limit" else None)
                     for op in d.logical.optimize(ds.limit(10).map(
                         lambda r: r).limit(5)._logical)],
        }

    return {"fusion": fusion, "sort": sort, "groupby": groupby,
            "aggregates": aggregates, "shuffle": shuffle, "split": split,
            "tensor_column": tensor_column, "parquet": parquet,
            "limit": limit}


def _own(x):
    """A deep copy holding no view of a cluster's arena."""
    if isinstance(x, dict):
        return {k: _own(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_own(v) for v in x)
    if isinstance(x, np.ndarray):
        return np.array(x, copy=True)
    return x


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    from ray_tpu import data as jdata

    tmp = str(tmp_path_factory.mktemp("jax"))
    ray_tpu.init(num_cpus=4, object_store_memory=96 << 20)
    try:
        return {name: _own(bounded(lambda fn=fn: fn(jdata, tmp), RUN_S,
                                   f"ray_tpu.data {name}"))
                for name, fn in _pipelines().items()}
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def cluster(jax_results, tmp_path_factory):
    from ray_tpu_torch import data as tdata

    os.environ["RT_TMPDIR"] = str(tmp_path_factory.mktemp("rt"))
    bounded(lambda: rt.init(num_cpus=4, object_store_memory=96 << 20),
            120, "rt.init")
    try:
        yield tdata
    finally:
        bounded(rt.shutdown, 60, "rt.shutdown")
        os.environ.pop("RT_TMPDIR", None)


def _close(got, want, path="result"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float):
        assert abs(got - want) <= FLOAT_ATOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", sorted(_pipelines()))
def test_pipeline_matches_ray_tpu_data(cluster, jax_results, name,
                                       tmp_path):
    got = bounded(lambda: _pipelines()[name](cluster, str(tmp_path)),
                  RUN_S, f"ray_tpu_torch.data {name}")
    want = jax_results[name]
    if name == "shuffle":
        assert sorted(got) == sorted(want) == list(range(60))
        assert got != list(range(60))
        return
    _close(got, want)


def test_fusion_runs_as_one_task_per_block(cluster):
    ds = cluster.range(10, num_blocks=2).map(lambda r: r).filter(
        lambda r: True).flat_map(lambda r: [r])
    plan = cluster.logical.optimize(ds._logical)
    assert [op.name for op in plan] == ["fused_map"]
    assert len(plan[0].payload) == 3


def test_arrow_blocks_travel_out_of_band_and_torch_batches_come_back(
        cluster):
    """A block is an Arrow table: the port's serializer hands its
    column buffers out of band (the payload stays small), and a put/get
    returns an equal table.  A map_batches step that computes with
    torch on the CPU and hands back numpy gives the numpy answer."""
    import pyarrow as pa

    from ray_tpu_torch._private import serialization

    table = pa.table({"x": XS, "k": KEYS[:100]})
    frames, _ = serialization.serialize(table)
    assert len(frames) >= 3 and frames[0].nbytes < 4096
    assert rt.get(rt.put(table), timeout=30).equals(table)

    def torch_double(batch):
        import torch

        t = torch.from_numpy(batch["x"])
        return {"x2": (t * 2).numpy(), "k": batch["k"]}

    ds = cluster.from_numpy({"x": XS, "k": KEYS[:100]}, num_blocks=4)
    rows = bounded(lambda: ds.map_batches(torch_double).take_all(), RUN_S,
                   "map_batches")
    np.testing.assert_array_equal([r["x2"] for r in rows], XS * 2)
    np.testing.assert_array_equal([r["k"] for r in rows], KEYS[:100])
