"""Worker process entry point.

Ported from ray_tpu's worker_main, less the lazy JAX site hook (torch
registers no plugin).

Equivalent of the reference's default_worker.py
(reference: python/ray/_private/workers/default_worker.py): the node
agent's worker pool forks this executable; it connects back to its agent
and the head, then executes pushed tasks on the main thread until told
to exit.
"""

from __future__ import annotations

import os
import sys


def main():
    head = (os.environ["RT_HEAD_HOST"], int(os.environ["RT_HEAD_PORT"]))
    agent = (os.environ["RT_AGENT_HOST"], int(os.environ["RT_AGENT_PORT"]))
    arena = os.environ["RT_ARENA_PATH"]
    node_id = os.environ["RT_NODE_ID"]
    worker_id = os.environ["RT_WORKER_ID"]

    from ray_tpu_torch._private.ids import JobID
    from ray_tpu_torch._private.worker import CoreWorker, MODE_WORKER, set_global_worker

    # runtime env (reference: default_worker.py applies the env before
    # task execution): extracted package dirs go on sys.path, and the
    # working_dir becomes the process cwd
    for extra in reversed(os.environ.get("RT_PY_MODULES", "").split(os.pathsep)):
        if extra:
            sys.path.insert(0, extra)
    working_dir = os.environ.get("RT_WORKING_DIR")
    if working_dir:
        sys.path.insert(0, working_dir)
        os.chdir(working_dir)

    worker = CoreWorker(MODE_WORKER, head, agent, arena, node_id,
                        worker_id=worker_id, job_id=JobID.nil().hex())
    set_global_worker(worker)
    # chaos rules active when this worker was spawned (the agent stamps
    # them into the env): worker-side sites (worker.oom, rpc.*) fire in
    # THIS process too, not just in daemons.  Later rule changes reach
    # running workers via the agent's chaos_rules forward.
    rules = os.environ.get("RT_CHAOS_RULES")
    if rules:
        import json

        from ray_tpu_torch._private import fault_injection

        try:
            payload = json.loads(rules)
            fault_injection.install(payload.get("rules", []),
                                    payload.get("version"))
        except Exception:
            pass
    reply = worker.agent.call("worker_ready", worker_id=worker_id,
                              port=worker.address[1])
    if not reply.get("ok"):
        sys.stderr.write("agent rejected worker registration\n")
        sys.exit(1)
    try:
        worker.exec_loop()
    finally:
        set_global_worker(None)
        worker.shutdown()


if __name__ == "__main__":
    main()
