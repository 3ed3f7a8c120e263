"""User-facing exception taxonomy.

Equivalent of the reference's exception set
(reference: python/ray/exceptions.py — RayError, RayTaskError,
RayActorError, WorkerCrashedError, ObjectLostError, ObjectFreedError,
GetTimeoutError).
"""

from __future__ import annotations


class RayError(Exception):
    """Base for all framework errors."""


class RayTaskError(RayError):
    """A task/actor method raised; carries the remote traceback.

    Like the reference (python/ray/exceptions.py RayTaskError.as_instanceof_cause),
    the original exception is chained as `cause` when it was picklable.
    """

    def __init__(self, function_name: str, traceback_str: str,
                 cause: BaseException | None = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"{function_name} failed:\n{traceback_str}")

    def __reduce__(self):
        # default exception pickling would replay __init__ with the joined
        # message as the only argument; rebuild from the real fields
        return (type(self), (self.function_name, self.traceback_str, self.cause))


class RayWorkerError(RayError):
    """The worker process executing the task died."""


class OutOfMemoryError(RayWorkerError):
    """The node agent's memory watchdog deliberately killed the worker
    running this task because node memory crossed
    ``memory_usage_threshold`` — a kill with a receipt, not a mystery
    death (reference: python/ray/exceptions.py OutOfMemoryError +
    memory_monitor.h).  Carries the victim's RSS and the node's memory
    breakdown at kill time.  Subclasses RayWorkerError so every handler
    that treats worker death as retriable replica/worker loss (Serve
    dead-replica retry, the circuit breaker's error accounting) applies
    unchanged.  Owner-side, OOM kills draw from the separate
    ``task_oom_retries`` budget — never from ``max_retries``."""

    def __init__(self, message: str = "worker killed by the memory "
                 "monitor", rss_bytes: int = 0, node_usage: float = 0.0,
                 node_id: str = "", worker_id: str = "",
                 breakdown: dict | None = None):
        self.rss_bytes = int(rss_bytes)
        self.node_usage = float(node_usage)
        self.node_id = node_id
        self.worker_id = worker_id
        # node memory breakdown at kill time (per-worker RSS list +
        # store arena buckets) — the "receipt" the owner can log/act on
        self.breakdown = dict(breakdown or {})
        super().__init__(message)

    def __reduce__(self):
        return (type(self), (str(self.args[0]) if self.args else "",
                             self.rss_bytes, self.node_usage,
                             self.node_id, self.worker_id,
                             self.breakdown))


class PoisonedTaskError(RayError):
    """Submissions of this task/actor class are quarantined: its
    executions OOM-killed or crashed workers ``poison_task_threshold``
    consecutive times across the cluster, so further attempts would
    only churn workers.  Fails fast at submission/lease time with the
    kill history instead of burning retries into the same wall.  The
    quarantine expires after ``poison_task_ttl_s`` and can be lifted
    early via ``rtpu quarantine clear``."""

    def __init__(self, message: str = "task class is quarantined",
                 key: str = "", history: list | None = None):
        self.key = key          # function/class id the quarantine keys on
        self.history = list(history or [])  # human-readable kill records
        super().__init__(message)

    def __reduce__(self):
        return (type(self), (str(self.args[0]) if self.args else "",
                             self.key, self.history))


class ActorDiedError(RayError):
    """The actor is dead (creation failed, killed, or out of restarts)."""


class ActorUnavailableError(RayError):
    """The actor is temporarily unreachable (restarting)."""


class ObjectLostError(RayError):
    """The object's value was lost (e.g. the node holding it died)."""


class ObjectFreedError(RayError):
    """The object was freed by its owner; the value is permanently gone."""


class GetTimeoutError(RayError, TimeoutError):
    """ray_tpu_torch.get(..., timeout=...) expired."""


class DeadlineExceededError(RayError, TimeoutError):
    """The request's end-to-end deadline (``.options(timeout_s=...)``
    or an ``X-Request-Deadline-Ms`` ingress header) expired before the
    work completed.  Raised owner-side for tasks still queued, by the
    deadline sweep for running tasks, by ``get()`` when the ambient
    budget runs out, and by the LLM engine at admission when the
    remaining budget cannot cover prefill + one decode step
    (see _private/deadlines.py)."""

    def __init__(self, message: str = "deadline exceeded",
                 where: str = ""):
        self.where = where  # queued | running | get | admission
        super().__init__(message)

    def __reduce__(self):
        return (type(self), (str(self.args[0]) if self.args else
                             "deadline exceeded", self.where))


class SchedulingError(RayError):
    """The task's resource demand can never be satisfied by the cluster."""


class RuntimeEnvSetupError(RayError):
    """The task's runtime environment could not be prepared on the node
    (reference: python/ray/exceptions.py RuntimeEnvSetupError)."""


class TaskCancelledError(RayError):
    """The task was cancelled via ray_tpu_torch.cancel()
    (reference: python/ray/exceptions.py TaskCancelledError)."""


class DeploymentFailedError(RayError):
    """A serve deployment could not come healthy: replica constructors
    failed or did not pass the health check within
    ``serve_replica_health_timeout_s``."""
