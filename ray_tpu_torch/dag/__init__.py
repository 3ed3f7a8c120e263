"""DAG authoring and execution.

Equivalent of the reference's ``ray.dag`` (reference:
python/ray/dag/dag_node.py:1, compiled_dag_node.py:174).

Build a graph driver-side with ``.bind()``:

    with InputNode() as inp:
        dag = post.process.bind(model.infer.bind(prep.load.bind(inp)))

then run it one of three ways, in increasing order of per-call cost
removed:

* ``dag.execute(x)`` — **dynamic**: every node becomes a regular
  task/actor call and refs flow as arguments.  Fresh actors per call;
  full scheduling per node.  Works for any mix of FunctionNodes and
  actor methods.
* ``dag.experimental_compile()`` — **dynamic replay**
  (:class:`~ray_tpu_torch.dag.compiled.CompiledDAG`): actors and their
  constructor dependencies resolve once at compile time; each
  ``execute()`` still submits real tasks, pipelined up to
  ``max_in_flight`` with backpressure.  Returns normal ObjectRefs
  (use ``ray_tpu_torch.get``).
* ``dag.experimental_compile(use_channels=True)`` — **channel-compiled**
  (:class:`~ray_tpu_torch.dag.execution.CompiledGraph`): actor-method graphs
  only.  Compilation pre-allocates one mutable shared-memory channel
  (:mod:`ray_tpu_torch.dag.channel`) per cross-process edge and pins a
  persistent execution loop inside every actor; ``execute()`` writes
  the input channel and returns a
  :class:`~ray_tpu_torch.dag.execution.CompiledDAGRef` whose ``.get()`` reads
  the output channel — zero task specs, scheduler visits, or object
  refs per call.  Remote readers get versions pushed over the bulk
  transfer plane.  ``node.with_channel_options(max_in_flight=…,
  buffer_size_bytes=…)`` overrides one edge's ring depth/payload
  capacity (deep data edges + shallow control edges in one graph —
  the MPMD training pipeline in ``train/pipeline.py`` rides this
  sizing model).  Errors serialize into channel versions and re-raise
  from ``.get()``; actor death poisons the pipeline (bounded by
  ``dag_monitor_interval_s``) instead of hanging it; ``teardown()`` is
  synchronous and idempotent.

Exports: ``DAGNode`` (base), ``FunctionNode`` (``fn.bind``),
``ClassNode`` (``Actor.bind``), ``ClassMethodNode``
(``actor_node.method.bind``), ``InputNode`` / ``InputAttributeNode``
(runtime input and its projections), ``MultiOutputNode`` (multi-leaf
root), ``CompiledDAG`` (dynamic replay), ``CompiledGraph`` /
``CompiledDAGRef`` (channel-compiled execution).
"""

from ray_tpu_torch.dag.nodes import (ClassMethodNode, ClassNode, DAGNode,
                               FunctionNode, InputAttributeNode, InputNode,
                               MultiOutputNode)
from ray_tpu_torch.dag.compiled import CompiledDAG
from ray_tpu_torch.dag.execution import CompiledDAGRef, CompiledGraph

__all__ = ["DAGNode", "FunctionNode", "ClassNode", "ClassMethodNode",
           "InputNode", "InputAttributeNode", "MultiOutputNode",
           "CompiledDAG", "CompiledGraph", "CompiledDAGRef"]
