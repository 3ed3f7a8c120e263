"""Dataset: lazy, distributed transforms over object-store blocks.

Equivalent of the reference's Dataset + execution layer
(reference: python/ray/data/dataset.py — map_batches :371, iter_batches
:3640, materialize :4520; planner/executor under _internal/): a Dataset
is a logical plan; consecutive per-block transforms fuse into one task
per block (reference: rules/operator_fusion.py); iteration streams block
tasks with a bounded in-flight window (streaming_executor.py
backpressure); shuffles are two-phase map/reduce tasks.
"""

from __future__ import annotations

import builtins
import random as _random
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple, Union)

import numpy as np

from ray_tpu_torch.data import logical
from ray_tpu_torch.data.block import BlockAccessor, block_from_numpy, build_block

# streaming backpressure bounds (count clamps around the bytes budget;
# see _StreamBudget)
_WINDOW_MIN = 2
_WINDOW_MAX = 64
_BUDGET_FRACTION = 0.25        # of free store capacity per iteration
_BUDGET_FALLBACK = 64 * 1024 * 1024   # store stats unavailable
_BLOCK_EST_INIT = 1 * 1024 * 1024     # until real block sizes arrive
_OCCUPANCY_REFRESH_S = 0.5


def _store_usage() -> Tuple[int, int]:
    """(allocated, capacity) of the local object store, best-effort.
    Module-level so tests can monkeypatch the probe."""
    import ray_tpu_torch

    usage = ray_tpu_torch.api._worker().agent.call("node_info", timeout=2.0)["store"]
    return int(usage["allocated"]), int(usage["capacity"])


# one process-wide occupancy snapshot, refreshed at most every
# _OCCUPANCY_REFRESH_S: budgets stay per-execution, but the blocking
# node_info RPC behind them is amortized across all live iterators (a
# driver loop calling take(1)/schema() repeatedly must not pay a
# synchronous RPC — up to the 2s timeout against a wedged agent — per
# iteration start).  Failures are cached for the same window.
_usage_snapshot: Tuple[float, Optional[Tuple[int, int]]] = (0.0, None)


def _store_usage_cached() -> Tuple[int, int]:
    global _usage_snapshot
    now = time.monotonic()
    ts, val = _usage_snapshot
    if ts and now - ts < _OCCUPANCY_REFRESH_S:
        if val is None:
            raise RuntimeError("store stats unavailable (cached failure)")
        return val
    try:
        val = _store_usage()
    except Exception:
        _usage_snapshot = (now, None)
        raise
    _usage_snapshot = (now, val)
    return val


class _StreamBudget:
    """Per-EXECUTION streaming backpressure (reference:
    _internal/execution/streaming_executor.py + backpressure_policy/ —
    the reference bounds each execution by a resource budget and pauses
    on object-store pressure).

    Every ``iter_blocks()`` call constructs its own instance, so two
    concurrent iterations each get an independent budget instead of
    sharing one process-global window (the former 2-entry
    ``_stream_window`` cache meant iterator A's refresh dictated
    iterator B's concurrency).  The budget is in BYTES: a quarter of the
    store capacity that was free when the iteration began, spent against
    a running per-block size estimate (EWMA of consumed blocks), with
    [_WINDOW_MIN, _WINDOW_MAX] count clamps so tiny blocks still bound
    task fan-out and huge blocks still make progress.  Store occupancy
    is re-probed every _OCCUPANCY_REFRESH_S per instance; above 80% the
    effective budget halves.
    """

    __slots__ = ("budget_bytes", "inflight", "est_bytes", "_pressure",
                 "_probe_at")

    def __init__(self, budget_bytes: Optional[int] = None):
        if budget_bytes is None:
            try:
                allocated, capacity = _store_usage_cached()
                free = max(0, capacity - allocated)
                budget_bytes = int(free * _BUDGET_FRACTION) \
                    or _BUDGET_FALLBACK
            except Exception:
                budget_bytes = _BUDGET_FALLBACK
        self.budget_bytes = budget_bytes
        self.inflight = 0              # launched - consumed block tasks
        self.est_bytes = float(_BLOCK_EST_INIT)
        self._pressure = False
        self._probe_at = 0.0

    def _effective(self) -> float:
        now = time.monotonic()
        if now >= self._probe_at:
            self._probe_at = now + _OCCUPANCY_REFRESH_S
            try:
                allocated, capacity = _store_usage_cached()
                self._pressure = bool(capacity) \
                    and allocated / capacity > 0.8
            except Exception:
                self._pressure = False
        return self.budget_bytes / 2 if self._pressure else self.budget_bytes

    def admit(self) -> bool:
        """May one more block task launch right now?"""
        if self.inflight < _WINDOW_MIN:
            return True
        if self.inflight >= _WINDOW_MAX:
            return False
        return (self.inflight + 1) * self.est_bytes <= self._effective()

    def launched(self) -> None:
        self.inflight += 1

    def consumed(self, nbytes: int) -> None:
        self.inflight -= 1
        if nbytes > 0:
            self.est_bytes = 0.5 * (self.est_bytes + float(nbytes))


# --------------------------------------------------------------------- ops


class ActorPoolStrategy:
    """Run class-based UDFs on a pool of actors
    (reference: python/ray/data/_internal/compute.py ActorPoolStrategy,
    operators/actor_pool_map_operator.py)."""

    def __init__(self, size: Optional[int] = None,
                 min_size: Optional[int] = None,
                 max_size: Optional[int] = None):
        if size is not None:
            min_size = max_size = size
        self.min_size = min_size or 1
        self.max_size = max_size or max(self.min_size, 4)
        if self.min_size < 1 or self.max_size < self.min_size:
            raise ValueError("invalid actor pool bounds")


class _Op:
    """One fusable per-block transform.  For class UDFs (`is_actor`),
    ``fn`` is the class; each pool actor instantiates it once and the
    instance is called per batch."""

    def __init__(self, kind: str, fn: Optional[Callable] = None,
                 batch_size: Optional[int] = None,
                 is_actor: bool = False, ctor_args: tuple = (),
                 ctor_kwargs: Optional[dict] = None,
                 compute: Optional[ActorPoolStrategy] = None):
        self.kind = kind
        self.fn = fn
        self.batch_size = batch_size
        self.is_actor = is_actor
        self.ctor_args = ctor_args
        self.ctor_kwargs = ctor_kwargs or {}
        self.compute = compute


def _apply_ops(block, ops: List[_Op]):
    """Runs inside a worker task: apply a fused chain of ops to a block."""
    import pyarrow as pa

    for op in ops:
        acc = BlockAccessor(block)
        if op.kind == "map_batches":
            batch = acc.to_numpy()
            out = op.fn(batch)
            if isinstance(out, dict):
                block = block_from_numpy(out)
            else:
                block = build_block(list(out))
        elif op.kind == "map":
            block = build_block([op.fn(r) for r in acc.to_rows()])
        elif op.kind == "flat_map":
            rows = []
            for r in acc.to_rows():
                rows.extend(op.fn(r))
            block = build_block(rows)
        elif op.kind == "filter":
            block = build_block([r for r in acc.to_rows() if op.fn(r)])
        else:
            raise ValueError(f"unknown op {op.kind}")
    return block


def _fused_block_task(block, ops: List[_Op]):
    return _apply_ops(block, ops)


class _PoolMapWorker:
    """Actor applying a fused op chain; class UDFs are instantiated once
    per actor (reference: actor_pool_map_operator.py _MapWorker)."""

    def __init__(self, ops: List[_Op]):
        self.ops = []
        for op in ops:
            if op.is_actor:
                inst = op.fn(*op.ctor_args, **op.ctor_kwargs)
                op = _Op(op.kind, inst, op.batch_size)
            self.ops.append(op)

    def apply(self, block):
        return _apply_ops(block, self.ops)


def _shuffle_map(block, n_out: int, seed: int):
    """Phase 1 of a shuffle: split rows into n_out parts."""
    rows = BlockAccessor(block).to_rows()
    rng = _random.Random(seed)
    rng.shuffle(rows)
    parts: List[List[dict]] = [[] for _ in builtins.range(n_out)]
    for i, r in enumerate(rows):
        parts[i % n_out].append(r)
    out = tuple(build_block(p) for p in parts)
    return out if n_out > 1 else out[0]


def _shuffle_reduce(seed: int, *parts):
    rows = []
    for p in parts:
        rows.extend(BlockAccessor(p).to_rows())
    _random.Random(seed).shuffle(rows)
    return build_block(rows)


def _sort_block(block, key: str, descending: bool):
    import pyarrow.compute as pc

    idx = pc.sort_indices(block, sort_keys=[(key, "descending" if descending
                                             else "ascending")])
    return block.take(idx)


def _sort_sample(block, key: str, k: int = 20):
    """A few key values per block — the only sort data the driver sees."""
    col = block.column(key).to_pylist()
    if len(col) <= k:
        return col
    return _random.sample(col, k)


def _sort_map(block, key: str, bounds: List[Any], descending: bool,
              n_out: int):
    """Range-partition one block: sort ascending, cut at the sampled
    boundaries; part j holds keys in [bounds[j-1], bounds[j])."""
    import bisect

    sorted_block = _sort_block(block, key, False)
    col = sorted_block.column(key).to_pylist()
    cuts = [bisect.bisect_left(col, b) for b in bounds] + [len(col)]
    parts, prev = [], 0
    for cut in cuts:
        parts.append(sorted_block.slice(prev, cut - prev))
        prev = cut
    return tuple(parts) if n_out > 1 else parts[0]


def _sort_reduce(key: str, descending: bool, *parts):
    import pyarrow as pa

    tables = [p for p in parts if p.num_rows > 0]
    if not tables:
        return build_block([])
    return _sort_block(pa.concat_tables(tables), key, descending)


def _stable_hash(value) -> int:
    """Deterministic across processes (builtin hash() is seeded per
    interpreter, which would scatter one group over many partitions)."""
    import zlib

    return zlib.crc32(repr(value).encode("utf-8", "backslashreplace"))


def _canon_key(value):
    """Canonical form of a group key BEFORE it is hashed or bucketed.

    Partitioning hashes the key's repr (_stable_hash), but Python
    equality is looser than repr equality: ``2 == 2.0 == True+True`` yet
    their reprs differ, so without canonicalization equal keys land in
    different partitions and the same group emits one aggregate row per
    partition it leaked into.  Numerics therefore normalize (bool → int,
    integral float → int, numpy scalar → Python scalar) so that any two
    keys equal under ``==`` share one canonical repr.

    Supported key types: None, bool, int, float (non-NaN), str, bytes,
    numpy scalars of those, and tuples/lists thereof (canonicalized
    element-wise to a tuple, so ``('a', 2)`` and ``['a', 2.0]`` share a
    group — Arrow stores sequence keys as list columns, so a tuple key
    written into a block reads back as a list and must canonicalize to
    the same value).  Anything else — dicts, NaN (which is not even
    equal to itself), arbitrary objects — is rejected loudly rather
    than silently mis-partitioned.
    """
    if isinstance(value, np.generic):
        value = value.item()
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, float):
        if value != value:
            raise TypeError("NaN groupby keys are unsupported (NaN != NaN: "
                            "no grouping is well-defined)")
        return int(value) if value.is_integer() else value
    if value is None or isinstance(value, (int, str, bytes)):
        return value
    if isinstance(value, (tuple, list)):
        return tuple(_canon_key(v) for v in value)
    raise TypeError(
        f"unsupported groupby key type {type(value).__name__!r}: keys must "
        "be None, bool, int, float, str, bytes, numpy scalars of those, "
        "or tuples/lists thereof")


def _groupby_map(block, key: str, n_out: int):
    """Hash-partition one block's rows by CANONICAL group key.  The key
    column is rewritten to its canonical value: equal-under-== keys now
    share a partition, so without normalization one partition block
    could mix bool and numeric key values, which Arrow refuses to
    type-unify."""
    parts: List[List[dict]] = [[] for _ in builtins.range(n_out)]
    for r in BlockAccessor(block).to_rows():
        k = _canon_key(r[key])
        parts[_stable_hash(k) % n_out].append({**r, key: k})
    out = tuple(build_block(p) for p in parts)
    return out if n_out > 1 else out[0]


def _group_rows(key: str, parts) -> Dict[Any, List[dict]]:
    """Bucket rows by canonical key; the canonical value is also what
    the output row carries (2.0 and 2 grouped together report key 2)."""
    groups: Dict[Any, List[dict]] = {}
    for p in parts:
        for r in BlockAccessor(p).to_rows():
            groups.setdefault(_canon_key(r[key]), []).append(r)
    return groups


def _groupby_agg(key: str, specs: List[Tuple[str, Optional[str]]], *parts):
    """Per-partition aggregation: every row of a group is local here
    (hash partitioning), so each agg is a plain in-memory fold."""
    out_rows = []
    groups = _group_rows(key, parts)
    for k in sorted(groups.keys(), key=repr):
        rows = groups[k]
        row = {key: k}
        for kind, on in specs:
            if kind == "count":
                row["count()"] = len(rows)
                continue
            vals = np.asarray([r[on] for r in rows], dtype=np.float64)
            if kind == "sum":
                row[f"sum({on})"] = float(vals.sum())
            elif kind == "min":
                row[f"min({on})"] = float(vals.min())
            elif kind == "max":
                row[f"max({on})"] = float(vals.max())
            elif kind == "mean":
                row[f"mean({on})"] = float(vals.mean())
            elif kind == "std":
                row[f"std({on})"] = float(vals.std(ddof=1)) \
                    if len(vals) > 1 else 0.0
            else:
                raise ValueError(f"unknown aggregate {kind!r}")
        out_rows.append(row)
    return build_block(out_rows)


def _groupby_apply(key: str, fn, *parts):
    """map_groups: the UDF sees all rows of one group, returns rows."""
    out_rows = []
    groups = _group_rows(key, parts)
    for k in sorted(groups.keys(), key=repr):
        out_rows.extend(fn(groups[k]))
    return build_block(out_rows)


def _read_file_task(path: str, fmt: str):
    import pyarrow as pa

    if fmt == "parquet":
        import pyarrow.parquet as pq

        return pq.read_table(path)
    if fmt == "csv":
        from pyarrow import csv as pcsv

        return pcsv.read_csv(path)
    if fmt == "json":
        from pyarrow import json as pjson

        return pjson.read_json(path)
    raise ValueError(fmt)


def _write_parquet_task(block, path: str):
    import pyarrow.parquet as pq

    pq.write_table(block, path)
    return path


# ----------------------------------------------------------------- dataset


class Dataset:
    def __init__(self, block_refs: List[Any],
                 plan: Optional[List["logical.LogicalOp"]] = None):
        self._block_refs = block_refs   # source blocks (ObjectRefs)
        # the LOGICAL plan: transforms append LogicalOp nodes; the
        # executor consumes the rewritten (rule-optimized) plan — see
        # data/logical.py (reference: _internal/logical/ + planner/)
        self._logical: List[logical.LogicalOp] = plan or []
        self._ops_cache: Optional[List[_Op]] = None
        self._phys_cache: Optional[Tuple[List[_Op], List[Tuple[int, List[_Op]]]]] = None
        self._materialized: Optional[List[Any]] = None
        self._last_stats: Dict[str, Any] = {}

    # ---- plan building ----

    @property
    def _ops(self) -> List[_Op]:
        """Physical fused op chain, derived by running the rewrite rules
        over the logical plan (FuseMapOperators collapses the map-likes
        into one task-per-block chain).  Cached: the plan is immutable
        after construction (_chain builds a NEW Dataset)."""
        if self._ops_cache is None:
            pre, segments = self._phys_plan()
            ops = list(pre)
            for _, seg_ops in segments:
                ops.extend(seg_ops)
            self._ops_cache = ops
        return self._ops_cache

    def _phys_plan(self) -> Tuple[List[_Op], List[Tuple[int, List[_Op]]]]:
        """Physical plan split at limit nodes: (ops before the first
        limit — run distributed, one task per launched block — and
        [(limit, trailing ops), ...] segments applied driver-side to
        the ≤limit rows that survive).  Non-empty segments switch
        iter_blocks to the early-stopping executor that never launches
        block tasks past the limit."""
        if self._phys_cache is None:
            pre: List[_Op] = []
            segments: List[Tuple[int, List[_Op]]] = []
            cur = pre
            for node in logical.optimize(self._logical):
                if node.name == "fused_map":
                    cur.extend(node.payload)
                elif node.name == "limit":
                    segments.append((int(node.payload), []))
                    cur = segments[-1][1]
                else:
                    # fail loudly: a plan node the executor doesn't know
                    # must never silently vanish from execution
                    raise ValueError(
                        f"no physical execution for logical op "
                        f"{node.name!r}")
            self._phys_cache = (pre, segments)
        return self._phys_cache

    def _chain(self, op: _Op) -> "Dataset":
        return Dataset(self._block_refs,
                       self._logical + [logical.LogicalOp(op.kind, op)])

    def map_batches(self, fn: Callable[[Dict[str, np.ndarray]], Any],
                    batch_size: Optional[int] = None,
                    compute: Optional[ActorPoolStrategy] = None,
                    concurrency: Optional[int] = None,
                    fn_constructor_args: tuple = (),
                    fn_constructor_kwargs: Optional[dict] = None) -> "Dataset":
        """Per-batch transform.  A class `fn` runs on an actor pool: each
        actor constructs one instance (amortizing model loads) and calls
        it per batch (reference: dataset.py map_batches :371 +
        actor_pool_map_operator.py)."""
        is_cls = isinstance(fn, type)
        if is_cls and compute is None:
            compute = ActorPoolStrategy(size=concurrency) if concurrency \
                else ActorPoolStrategy()
        if not is_cls and (compute or fn_constructor_args
                           or fn_constructor_kwargs):
            raise ValueError("compute/fn_constructor_* require a class UDF")
        return self._chain(_Op(
            "map_batches", fn, batch_size, is_actor=is_cls,
            ctor_args=tuple(fn_constructor_args),
            ctor_kwargs=fn_constructor_kwargs, compute=compute))

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        return self._chain(_Op("map", fn))

    def flat_map(self, fn: Callable[[dict], Iterable[dict]]) -> "Dataset":
        return self._chain(_Op("flat_map", fn))

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        return self._chain(_Op("filter", fn))

    # ---- execution ----

    def _make_budget(self) -> _StreamBudget:
        """One fresh backpressure budget per iteration (test seam)."""
        return _StreamBudget()

    def _submit_block(self, ref) -> Any:
        """Launch the fused op chain on one source block; returns a ref."""
        if not self._ops:
            return ref
        fn = _remote_fused()
        return fn.remote(ref, self._ops)

    def _has_actor_op(self) -> bool:
        return any(op.is_actor for op in self._ops)

    def _make_pool(self, ops: Optional[List[_Op]] = None) -> List[Any]:
        """Actors for the chain's class UDFs, sized to the workload
        within the strategy's [min_size, max_size]."""
        import ray_tpu_torch

        ops = self._ops if ops is None else ops
        compute = next((op.compute for op in ops
                        if op.is_actor and op.compute), None) \
            or ActorPoolStrategy()
        n = min(compute.max_size,
                max(compute.min_size, len(self._block_refs)))
        cls = ray_tpu_torch.remote(_PoolMapWorker)
        return [cls.remote(ops) for _ in builtins.range(n)]

    def _execute(self) -> List[Any]:
        if self._materialized is None:
            if self._phys_plan()[1]:
                # a limit in the plan: the early-stopping iterator
                # bounds what reaches the driver to ≤limit rows, which
                # then re-enter the store as fresh blocks
                import ray_tpu_torch

                self._materialized = [ray_tpu_torch.put(b)
                                      for b in self.iter_blocks()]
            elif self._has_actor_op():
                import weakref

                actors = self._make_pool()
                refs = [actors[i % len(actors)].apply.remote(r)
                        for i, r in enumerate(self._block_refs)]
                # the pool must outlive its in-flight results
                for ref in refs:
                    weakref.finalize(ref, lambda _h: None, tuple(actors))
                self._materialized = refs
            else:
                self._materialized = [self._submit_block(r)
                                      for r in self._block_refs]
        return self._materialized

    def materialize(self) -> "Dataset":
        import ray_tpu_torch

        refs = self._execute()
        ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=None)
        return Dataset(refs)

    def num_blocks(self) -> int:
        return len(self._block_refs)

    def explain(self) -> str:
        """Human-readable plan: the logical op list, then the
        rule-rewritten plan the executor runs (reference: the planner's
        plan dump, _internal/planner/planner.py)."""
        lines = [f"Source[{len(self._block_refs)} blocks]"]
        if self._logical:
            lines.append("  logical:   " + logical.describe(self._logical))

        def _label(op: _Op) -> str:
            label = op.kind
            if op.is_actor:
                compute = op.compute or ActorPoolStrategy()
                label += (f"(actor_pool[{compute.min_size}"
                          f"..{compute.max_size}], "
                          f"{getattr(op.fn, '__name__', 'cls')})")
            else:
                label += f"({getattr(op.fn, '__name__', 'fn')})"
            return label

        # mirror the executor's split: distributed ops, then each limit
        # with its driver-side residual — a Limit in the plan must show
        # up here, not silently fold into the fused chain
        pre, segments = self._phys_plan()
        parts: List[str] = []
        if pre:
            parts.append("Fused[" + " | ".join(_label(o) for o in pre) + "]"
                         + (" on actor pool"
                            if any(o.is_actor for o in pre)
                            else " per-block task"))
        for n, seg in segments:
            parts.append(f"Limit[{n}]")
            if seg:
                parts.append("Fused[" + " | ".join(_label(o) for o in seg)
                             + "] driver-side")
        if parts:
            lines.append("  optimized: " + " -> ".join(parts))
        return "\n".join(lines)

    def stats(self) -> Dict[str, Any]:
        """Execution stats from the last iteration/materialization."""
        return dict(self._last_stats)

    # ---- consumption ----

    def iter_blocks(self) -> Iterator[Any]:
        """Stream result blocks under a per-execution bytes budget
        derived from object-store occupancy (reference: streaming
        executor backpressure).  Each call gets its OWN _StreamBudget —
        concurrent iterations never share a window."""
        import time as _time

        import ray_tpu_torch

        t0 = _time.perf_counter()
        stats = {"blocks": 0, "rows": 0, "bytes": 0}

        def tally(block):
            stats["blocks"] += 1
            acc = BlockAccessor(block)
            stats["rows"] += acc.num_rows()
            stats["bytes"] += getattr(block, "nbytes", 0)
            return block

        def finish():
            stats["wall_s"] = round(_time.perf_counter() - t0, 4)
            self._last_stats = stats

        # try/finally: early-stopping consumers (take, schema) close the
        # generator mid-stream — partial stats still finalize
        try:
            if self._materialized is not None:
                for ref in self._materialized:
                    yield tally(ray_tpu_torch.get(ref, timeout=600))
                return
            pending = list(self._block_refs)
            pre_ops, segments = self._phys_plan()
            if segments:
                yield from self._iter_blocks_limited(
                    pending, tally, pre_ops, segments)
                return
            in_flight: List[Any] = []
            if self._has_actor_op():
                actors = self._make_pool()
                rr = 0
                while pending or in_flight:
                    # ≤2 queued per actor keeps the pool busy without
                    # flooding any single replica's mailbox
                    while pending and len(in_flight) < 2 * len(actors):
                        in_flight.append(
                            actors[rr % len(actors)].apply.remote(
                                pending.pop(0)))
                        rr += 1
                    yield tally(ray_tpu_torch.get(in_flight.pop(0), timeout=600))
                return
            budget = self._make_budget()
            if self._ops and len(pending) >= 4:
                # enough work to amortize shard tasks: the generator-based
                # executor replaces per-block task submission
                yield from self._iter_blocks_stream_shards(
                    pending, tally, budget)
                return
            while pending or in_flight:
                while pending and budget.admit():
                    in_flight.append(self._submit_block(pending.pop(0)))
                    budget.launched()
                ref = in_flight.pop(0)
                block = ray_tpu_torch.get(ref, timeout=600)
                budget.consumed(getattr(block, "nbytes", 0))
                yield tally(block)
        finally:
            finish()

    def _iter_blocks_stream_shards(self, refs: List[Any], tally,
                                   budget: _StreamBudget):
        """Task-path executor rebuilt on streaming generators: shard
        tasks each pull their source blocks and YIELD each transformed
        block as it is produced, so consumption overlaps production
        without a driver-side in-flight window (reference: the streaming
        executor consuming generator outputs —
        data/_internal/execution/streaming_executor.py + the
        generator-backed MapOperator).

        A launched shard's unconsumed yields buffer owner-side, so the
        per-execution budget governs both the CHUNK size (about half the
        blocks the budget covers, so lookahead has byte-granularity) and
        whether a lookahead shard may launch at all; the whole chunk is
        charged at launch and credited back block-by-block as
        consumption drains it.  Streaming tasks are not auto-retried; a
        shard that dies mid-stream is resubmitted here for only its
        unconsumed suffix."""
        import ray_tpu_torch

        budget_blocks = max(1, int(budget.budget_bytes
                                   // max(budget.est_bytes, 1.0)))
        size = max(1, min((len(refs) + 3) // 4,  # ≥4 shards when possible
                          max(1, budget_blocks // 2)))
        chunks = [refs[i:i + size]
                  for i in builtins.range(0, len(refs), size)]
        fn = _remote_fused_stream()
        gens: List[Any] = [None] * len(chunks)

        def launch(i, force=False):
            if i < len(chunks) and gens[i] is None \
                    and (force or budget.admit()):
                gens[i] = fn.remote(chunks[i], self._ops)
                for _ in chunks[i]:
                    budget.launched()

        launch(0, force=True)  # progress even when budget < one chunk
        launch(1)
        for ci, chunk in enumerate(chunks):
            consumed = 0
            attempts = 3
            if gens[ci] is None:
                launch(ci, force=True)
            gen = gens[ci]
            while consumed < len(chunk):
                try:
                    ref = gen.next_ref(timeout=600)
                except StopIteration:
                    raise RuntimeError(
                        f"shard stream ended after {consumed}/{len(chunk)} "
                        "blocks — op chain yielded short")
                except ray_tpu_torch.RayWorkerError:
                    # worker died mid-stream: streaming tasks don't
                    # auto-retry, so resubmit the unconsumed suffix
                    attempts -= 1
                    if attempts <= 0:
                        raise
                    gen = fn.remote(chunk[consumed:], self._ops)
                    continue
                # deterministic op errors (RayTaskError) propagate —
                # re-running the chain would just fail again
                block = ray_tpu_torch.get(ref, timeout=600)
                budget.consumed(getattr(block, "nbytes", 0))
                yield tally(block)
                consumed += 1
                launch(ci + 1)
                launch(ci + 2)

    def _iter_blocks_limited(self, refs: List[Any], tally,
                             pre_ops: List[_Op],
                             segments: List[Tuple[int, List[_Op]]]):
        """Early-stopping executor for plans with a limit: launch block
        tasks with a 2-deep lookahead and STOP launching once the first
        limit's rows have been produced — source blocks past the limit
        never become tasks (the limit-pushdown satellite).  The residual
        segments (ops/limits after the first limit) apply driver-side to
        the ≤limit surviving rows.  Class-UDF chains fall back to the
        actor pool for the pre-limit ops, still consumed with the same
        early stop."""
        import ray_tpu_torch

        n1 = segments[0][0]
        counters = [0] * len(segments)
        produced = 0
        # post-limit class UDFs run driver-side on the capped rows:
        # instantiate them once here (the pool path would apply them
        # remotely BEFORE the cap)
        segments = [(lim, [_Op(op.kind,
                               op.fn(*op.ctor_args, **op.ctor_kwargs),
                               op.batch_size) if op.is_actor else op
                           for op in ops])
                    for lim, ops in segments]
        use_actors = any(op.is_actor for op in pre_ops)
        fn = _remote_fused() if pre_ops and not use_actors else None
        actors = self._make_pool(pre_ops) if use_actors else None
        in_flight: List[Any] = []
        idx = 0
        lookahead = 2 if not use_actors else 2 * len(actors)
        while produced < n1 and (idx < len(refs) or in_flight):
            while idx < len(refs) and len(in_flight) < lookahead:
                ref = refs[idx]
                if use_actors:
                    ref = actors[idx % len(actors)].apply.remote(ref)
                elif fn is not None:
                    ref = fn.remote(ref, pre_ops)
                in_flight.append(ref)
                idx += 1
            block = ray_tpu_torch.get(in_flight.pop(0), timeout=600)
            acc = BlockAccessor(block)
            take_rows = min(acc.num_rows(), n1 - produced)
            produced += take_rows
            if take_rows <= 0:
                continue
            if take_rows < acc.num_rows():
                block = acc.slice(0, take_rows)
            block = self._apply_limit_suffix(block, segments, counters)
            if BlockAccessor(block).num_rows() > 0:
                yield tally(block)
            if len(segments) > 1 and all(
                    counters[i] >= segments[i][0]
                    for i in builtins.range(1, len(segments))):
                # every TRAILING limit is already full: rows still due
                # under the first (larger) limit can only come out as
                # empty blocks — stop launching/fetching now
                break

    @staticmethod
    def _apply_limit_suffix(block, segments, counters):
        """Ops after the first limit (and any further limits) run
        driver-side: every row here already survived the first cap, so
        the work is bounded by it."""
        if segments[0][1]:
            block = _apply_ops(block, segments[0][1])
        for i in builtins.range(1, len(segments)):
            lim, ops = segments[i]
            acc = BlockAccessor(block)
            take_rows = min(acc.num_rows(), lim - counters[i])
            if take_rows < acc.num_rows():
                block = acc.slice(0, take_rows)
            counters[i] += take_rows
            if ops and BlockAccessor(block).num_rows() > 0:
                block = _apply_ops(block, ops)
        return block

    def iter_rows(self) -> Iterator[dict]:
        for block in self.iter_blocks():
            yield from BlockAccessor(block).to_rows()

    def iter_batches(self, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator[Any]:
        carry = None
        for block in self.iter_blocks():
            if carry is not None and carry.num_rows > 0:
                block = BlockAccessor.concat([carry, block])
            acc = BlockAccessor(block)
            n = acc.num_rows()
            start = 0
            while n - start >= batch_size:
                yield self._format(acc.slice(start, start + batch_size),
                                   batch_format)
                start += batch_size
            carry = acc.slice(start, n)
        if carry is not None and BlockAccessor(carry).num_rows() > 0 \
                and not drop_last:
            yield self._format(carry, batch_format)

    @staticmethod
    def _format(block, batch_format: str):
        acc = BlockAccessor(block)
        if batch_format == "numpy":
            return acc.to_numpy()
        if batch_format == "pandas":
            return acc.to_pandas()
        if batch_format == "pyarrow":
            return acc.block
        raise ValueError(batch_format)

    def take(self, n: int = 20) -> List[dict]:
        """First n rows.  Routed through limit(n), so the executor stops
        launching block tasks once n rows exist instead of streaming the
        whole dataset at the driver."""
        out: List[dict] = []
        for row in self.limit(n).iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[dict]:
        return list(self.iter_rows())

    def count(self) -> int:
        return sum(BlockAccessor(b).num_rows() for b in self.iter_blocks())

    def schema(self):
        for block in self.iter_blocks():
            if BlockAccessor(block).num_rows() > 0:
                return BlockAccessor(block).schema()
        return None

    def sum(self, on: str) -> float:
        return builtins.sum(
            float(np.sum(BlockAccessor(b).to_numpy()[on]))
            for b in self.iter_blocks())

    def min(self, on: str) -> float:
        return builtins.min(float(np.min(BlockAccessor(b).to_numpy()[on]))
                            for b in self.iter_blocks()
                            if BlockAccessor(b).num_rows())

    def max(self, on: str) -> float:
        return builtins.max(float(np.max(BlockAccessor(b).to_numpy()[on]))
                            for b in self.iter_blocks()
                            if BlockAccessor(b).num_rows())

    def mean(self, on: str) -> float:
        total, count = 0.0, 0
        for b in self.iter_blocks():
            arr = BlockAccessor(b).to_numpy()[on]
            total += float(np.sum(arr))
            count += len(arr)
        return total / max(count, 1)

    # ---- exchange ops (materializing) ----

    def repartition(self, num_blocks: int) -> "Dataset":
        """Coalesce/split into `num_blocks` blocks of even row counts."""
        import ray_tpu_torch

        rows = self.take_all()
        per = max(1, (len(rows) + num_blocks - 1) // num_blocks)
        blocks = []
        for i in builtins.range(num_blocks):
            chunk = rows[i * per:(i + 1) * per]
            blocks.append(ray_tpu_torch.put(build_block(chunk)))
        return Dataset(blocks)

    def random_shuffle(self, seed: Optional[int] = None) -> "Dataset":
        """Two-phase distributed shuffle (map splits, reduce merges)."""
        import ray_tpu_torch

        seed = seed if seed is not None else _random.randint(0, 1 << 30)
        refs = self._execute()
        n = len(refs)
        if n == 0:
            return Dataset([])
        mapper = _remote_shuffle_map(n)
        parts = [mapper.remote(ref, n, seed + i) for i, ref in enumerate(refs)]
        if n == 1:
            parts = [[p] for p in parts]
        reducer = _remote_shuffle_reduce()
        out = [reducer.remote(seed + 1000 + j, *[parts[i][j]
                                                 for i in builtins.range(n)])
               for j in builtins.range(n)]
        return Dataset(out)

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Global sort via sample-based range partitioning: sample keys
        from every block (only the SAMPLES touch the driver), cut N-1
        boundaries, range-partition each block in a map task, merge each
        range in a reduce task.  Block i of the result holds range i, so
        concatenation order IS global order — no driver-side row merge
        (reference: _internal/planner/exchange/sort_task_spec.py
        SortTaskSpec.sample_boundaries + push_based_shuffle)."""
        import ray_tpu_torch

        refs = self._execute()
        n = len(refs)
        if n == 0:
            return Dataset([])
        if n == 1:
            sorter = _remote_sort_block()
            return Dataset([sorter.remote(refs[0], key, descending)])
        sampler = _remote_sort_sample()
        samples = ray_tpu_torch.get(
            [sampler.remote(r, key) for r in refs], timeout=600)
        merged = sorted(v for s in samples for v in s)
        if not merged:
            return Dataset(refs)
        # n-1 equi-spaced boundaries over the sampled key distribution
        bounds = [merged[(i * len(merged)) // n]
                  for i in builtins.range(1, n)]
        mapper = _remote_sort_map(n)
        parts = [mapper.remote(r, key, bounds, descending, n) for r in refs]
        reducer = _remote_sort_reduce()
        out = [reducer.remote(key, descending,
                              *[parts[i][j] for i in builtins.range(n)])
               for j in builtins.range(n)]
        if descending:
            out.reverse()
        return Dataset(out)

    def groupby(self, key: str) -> "GroupedData":
        """Group rows by a column for per-group aggregation
        (reference: python/ray/data/grouped_data.py:36 GroupedData)."""
        return GroupedData(self, key)

    def union(self, *others: "Dataset") -> "Dataset":
        refs = list(self._execute())
        for o in others:
            refs.extend(o._execute())
        return Dataset(refs)

    def limit(self, n: int) -> "Dataset":
        """Lazy row cap: appends a ``limit`` node to the logical plan.
        The LimitPushdown rule merges/hops it and the executor stops
        launching block tasks once n rows are produced — no full
        materialization on the driver (the former behavior)."""
        if self._materialized is not None:
            # plan already ran: cap the materialized blocks directly
            # rather than re-launching the op chain over the sources
            return Dataset(self._materialized,
                           [logical.LogicalOp("limit", int(n))])
        return Dataset(self._block_refs,
                       self._logical + [logical.LogicalOp("limit", int(n))])

    # ---- splitting (train ingest) ----

    def split(self, n: int) -> List["Dataset"]:
        """Round-robin block split (reference: Dataset.split for ingest)."""
        refs = self._execute()
        shards: List[List[Any]] = [[] for _ in builtins.range(n)]
        for i, ref in enumerate(refs):
            shards[i % n].append(ref)
        return [Dataset(s) for s in shards]

    def write_parquet(self, dir_path: str) -> List[str]:
        import os

        import ray_tpu_torch

        os.makedirs(dir_path, exist_ok=True)
        writer = _remote_writer()
        refs = [writer.remote(ref, os.path.join(dir_path, f"part-{i:05d}.parquet"))
                for i, ref in enumerate(self._execute())]
        return ray_tpu_torch.get(refs, timeout=600)

    def __repr__(self):
        return (f"Dataset(num_blocks={len(self._block_refs)}, "
                f"pending_ops={len(self._ops)})")


class GroupedData:
    """Distributed group-by: rows hash-partition by key in map tasks, so
    each reduce task holds every row of its groups and aggregates (or
    applies a UDF) locally — no group's rows ever gather on the driver
    (reference: python/ray/data/grouped_data.py:36; the hash exchange in
    _internal/planner/exchange/).

    Aggregates: count(), sum/min/max/mean/std(on), multi-agg via
    aggregate(("sum", "x"), ("max", "y")); per-group UDFs via
    map_groups(fn) where fn(list-of-rows) -> list-of-rows.
    """

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _partitions(self) -> List[List[Any]]:
        """Hash-exchange the dataset: returns per-partition part lists
        (partition j = parts[i][j] over every input block i)."""
        refs = self._ds._execute()
        n = len(refs)
        if n == 0:
            return []
        mapper = _remote_groupby_map(n)
        parts = [mapper.remote(r, self._key, n) for r in refs]
        if n == 1:
            parts = [[p] for p in parts]
        return [[parts[i][j] for i in builtins.range(n)]
                for j in builtins.range(n)]

    def aggregate(self, *specs: Tuple[str, Optional[str]]) -> Dataset:
        """Each spec is ("count", None) or ("sum"|"min"|"max"|"mean"|
        "std", column); output has one row per group with columns like
        "sum(x)" (reference: AggregateFn result naming)."""
        if not specs:
            raise ValueError("aggregate() needs at least one spec")
        agg = _remote_groupby_agg()
        out = [agg.remote(self._key, list(specs), *plist)
               for plist in self._partitions()]
        return Dataset(out)

    def count(self) -> Dataset:
        return self.aggregate(("count", None))

    def sum(self, on: str) -> Dataset:
        return self.aggregate(("sum", on))

    def min(self, on: str) -> Dataset:
        return self.aggregate(("min", on))

    def max(self, on: str) -> Dataset:
        return self.aggregate(("max", on))

    def mean(self, on: str) -> Dataset:
        return self.aggregate(("mean", on))

    def std(self, on: str) -> Dataset:
        return self.aggregate(("std", on))

    def map_groups(self, fn: Callable[[List[dict]], List[dict]]) -> Dataset:
        apply = _remote_groupby_apply()
        out = [apply.remote(self._key, fn, *plist)
               for plist in self._partitions()]
        return Dataset(out)


# -------------------------------------------------- remote fn construction

_remote_cache: Dict[str, Any] = {}


def _fused_stream_task(refs, ops):
    """Shard executor body: fetch each source block, run the fused op
    chain, and yield the result — one streamed item per block."""
    import ray_tpu_torch

    for r in refs:
        yield _apply_ops(ray_tpu_torch.get(r), ops)


def _remote_fused():
    return _remote_simple("fused", _fused_block_task)


def _remote_fused_stream():
    key = "fused_stream"
    fn = _remote_cache.get(key)
    if fn is None:
        import ray_tpu_torch

        fn = _remote_cache[key] = ray_tpu_torch.remote(
            num_returns="streaming")(_fused_stream_task)
    return fn


def _remote_simple(name: str, fn):
    key = f"simple:{name}"
    cached = _remote_cache.get(key)
    if cached is None:
        import ray_tpu_torch

        cached = _remote_cache[key] = ray_tpu_torch.remote(fn)
    return cached


def _remote_multi(name: str, fn, n_out: int):
    key = f"multi:{name}:{n_out}"
    cached = _remote_cache.get(key)
    if cached is None:
        import ray_tpu_torch

        cached = _remote_cache[key] = ray_tpu_torch.remote(num_returns=n_out)(fn)
    return cached


def _remote_sort_block():
    return _remote_simple("sort_block", _sort_block)


def _remote_sort_sample():
    return _remote_simple("sort_sample", _sort_sample)


def _remote_sort_map(n_out: int):
    return _remote_multi("sort_map", _sort_map, n_out)


def _remote_sort_reduce():
    return _remote_simple("sort_reduce", _sort_reduce)


def _remote_groupby_map(n_out: int):
    return _remote_multi("groupby_map", _groupby_map, n_out)


def _remote_groupby_agg():
    return _remote_simple("groupby_agg", _groupby_agg)


def _remote_groupby_apply():
    return _remote_simple("groupby_apply", _groupby_apply)


def _remote_shuffle_map(n_out: int):
    return _remote_multi("shuffle_map", _shuffle_map, n_out)


def _remote_shuffle_reduce():
    return _remote_simple("shuffle_reduce", _shuffle_reduce)


def _remote_writer():
    return _remote_simple("writer", _write_parquet_task)


def _remote_reader():
    return _remote_simple("reader", _read_file_task)


# ------------------------------------------------------------ constructors


def from_items(items: List[Any], num_blocks: int = 8) -> Dataset:
    import ray_tpu_torch

    rows = [it if isinstance(it, dict) else {"item": it} for it in items]
    num_blocks = max(1, min(num_blocks, len(rows) or 1))
    per = (len(rows) + num_blocks - 1) // num_blocks
    refs = [ray_tpu_torch.put(build_block(rows[i * per:(i + 1) * per]))
            for i in builtins.range(num_blocks)]
    return Dataset(refs)


def range(n: int, num_blocks: int = 8) -> Dataset:
    import ray_tpu_torch

    num_blocks = max(1, min(num_blocks, n or 1))
    per = (n + num_blocks - 1) // num_blocks
    refs = []
    for i in builtins.range(num_blocks):
        lo, hi = i * per, min((i + 1) * per, n)
        refs.append(ray_tpu_torch.put(block_from_numpy(
            {"id": np.arange(lo, hi, dtype=np.int64)})))
    return Dataset(refs)


def from_numpy(arrays: Dict[str, np.ndarray], num_blocks: int = 8) -> Dataset:
    import ray_tpu_torch

    n = len(next(iter(arrays.values())))
    num_blocks = max(1, min(num_blocks, n or 1))
    per = (n + num_blocks - 1) // num_blocks
    refs = []
    for i in builtins.range(num_blocks):
        chunk = {k: np.asarray(v)[i * per:(i + 1) * per]
                 for k, v in arrays.items()}
        refs.append(ray_tpu_torch.put(block_from_numpy(chunk)))
    return Dataset(refs)


def _read_files(paths: Union[str, List[str]], fmt: str) -> Dataset:
    import glob as globmod
    import os

    if isinstance(paths, str):
        if os.path.isdir(paths):
            files = sorted(globmod.glob(os.path.join(paths, "*")))
        else:
            files = sorted(globmod.glob(paths)) or [paths]
    else:
        files = list(paths)
    reader = _remote_reader()
    return Dataset([reader.remote(f, fmt) for f in files])


def read_parquet(paths: Union[str, List[str]]) -> Dataset:
    return _read_files(paths, "parquet")


def read_csv(paths: Union[str, List[str]]) -> Dataset:
    return _read_files(paths, "csv")


def read_json(paths: Union[str, List[str]]) -> Dataset:
    return _read_files(paths, "json")
