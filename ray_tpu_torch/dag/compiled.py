"""Compiled DAG: freeze a bound task/actor graph into a replayable plan.

Equivalent of the reference's accelerated DAG
(reference: python/ray/dag/compiled_dag_node.py:174).  The reference
pre-allocates mutable plasma channels between GPU actors and replays
the graph without per-call scheduling.  Here compilation:

  * creates every ``ClassNode`` actor exactly once (dynamic ``execute``
    re-creates them per call);
  * exports every task function/actor class once so replays skip the
    function-table round trip;
  * pipelines successive ``execute`` calls up to ``max_in_flight``
    before applying backpressure — the driver can keep a TPU serving
    pipeline full without unbounded queue growth.

Cross-actor data still flows through the object store (refs as task
args, owner-resolved), which on TPU is the right substrate: device
arrays stay device-side inside each actor's jitted step and only
host-level handles cross the wire.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ray_tpu_torch.dag.nodes import (ClassNode, DAGNode, InputNode,
                               MultiOutputNode)


class CompiledDAG:
    def __init__(self, root: DAGNode, max_in_flight: int = 8):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        self._root = root
        self._order = root.topological()
        self._max_in_flight = max_in_flight
        self._in_flight: List[Any] = []
        self._torn_down = False
        inputs = [n for n in self._order if isinstance(n, InputNode)]
        if len(inputs) > 1:
            raise ValueError("a DAG can reference at most one InputNode")
        # actors AND their constructor dependencies are part of the
        # compiled plan: resolved once at compile, reused every execute
        # (re-running a constructor dep per call would repeat its work
        # and side effects)
        self._plan_memo: Dict[int, Any] = {}
        self._actors: Dict[int, Any] = {}
        for node in self._order:
            if isinstance(node, ClassNode):
                for dep in node.topological():
                    if id(dep) not in self._plan_memo:
                        if isinstance(dep, (InputNode, MultiOutputNode)):
                            raise ValueError(
                                "actor constructor args cannot depend on "
                                "the runtime input")
                        self._plan_memo[id(dep)] = dep._apply(
                            self._plan_memo, (), {})
                self._actors[id(node)] = self._plan_memo[id(node)]

    def execute(self, *input_args):
        """Submit one traversal; returns the root ref (or list of refs).
        Blocks only when ``max_in_flight`` prior executions are still
        unfinished."""
        import ray_tpu_torch

        if self._torn_down:
            raise ray_tpu_torch.RayError(
                "this CompiledDAG has been torn down; rebuild and "
                "recompile the DAG to execute again")
        self._apply_backpressure(ray_tpu_torch)
        memo: Dict[int, Any] = dict(self._plan_memo)
        for node in self._order:
            if id(node) not in memo:
                memo[id(node)] = node._apply(memo, input_args, {})
        out = memo[id(self._root)]
        # one in-flight *group* per execute: every output ref counts, so
        # a slow branch of a MultiOutputNode still exerts backpressure
        self._in_flight.append(list(out) if isinstance(out, list) else [out])
        return out

    def _apply_backpressure(self, ray_tpu_torch):
        # drop groups whose every ref already finished
        if self._in_flight:
            flat = [r for g in self._in_flight for r in g]
            ready, _ = ray_tpu_torch.wait(flat, num_returns=len(flat), timeout=0)
            done = set(ready)
            self._in_flight = [g for g in self._in_flight
                               if not all(r in done for r in g)]
        while len(self._in_flight) >= self._max_in_flight:
            oldest = self._in_flight[0]
            # short wait rounds instead of one 300s block: a DAG actor
            # dying mid-pipeline resolves the oldest group's refs with
            # ActorDiedError, which must surface here — silently
            # re-blocking would wedge the caller for minutes per round
            ready, _ = ray_tpu_torch.wait(oldest, num_returns=len(oldest),
                                    timeout=1.0)
            if len(ready) < len(oldest):
                continue  # stragglers: the cap stays real, block again
            self._in_flight.pop(0)
            try:
                ray_tpu_torch.get(ready, timeout=0)
            except ray_tpu_torch.ActorDiedError:
                raise
            except Exception:
                # app-level task errors keep dynamic-execute semantics:
                # they surface at the caller's own get(), not here
                pass

    def teardown(self, timeout: float = 10.0):
        """Kill the plan's actors and wait for them to die.  Synchronous
        and idempotent: a second call (or a call after the actors have
        already crashed) is a no-op, and ``execute()`` afterwards raises
        instead of replaying over dead actors."""
        if self._torn_down:
            return
        self._torn_down = True
        import time as _time

        import ray_tpu_torch
        from ray_tpu_torch import api as _api

        from ray_tpu_torch._private.rpc import ConnectionLost, RpcError

        actors, self._actors = self._actors, {}
        for handle in actors.values():
            try:
                ray_tpu_torch.kill(handle)
            except (ray_tpu_torch.RayError, RpcError, ConnectionLost, OSError):
                pass  # already dead / cluster shutting down
        w = _api._worker()
        deadline = _time.monotonic() + timeout
        for handle in actors.values():
            while _time.monotonic() < deadline:
                try:
                    info = w.head.call("get_actor_info",
                                       actor_id=handle._actor_id)
                except Exception:
                    return  # head unreachable: nothing left to wait on
                if info.get("state") == "DEAD":
                    break
                _time.sleep(0.05)
