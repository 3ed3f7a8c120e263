"""Runtime config registry.

Equivalent of the reference's RAY_CONFIG X-macro registry
(reference: src/ray/common/ray_config_def.h — 219 entries, env-overridable
via RAY_<name> and cluster-wide via ray.init(_system_config=...)).

Here: declarative entries overridable per-process via ``RT_<NAME>`` env vars
and cluster-wide via ``ray_tpu_torch.init(_system_config={...})`` (the dict is
serialized and handed to every spawned daemon/worker).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict


_DEFS: Dict[str, Any] = {}


def _def(name: str, default: Any) -> None:
    _DEFS[name] = default


# --- scheduling -------------------------------------------------------------
_def("max_direct_call_object_size", 100 * 1024)  # inline returns/args below this
_def("worker_lease_timeout_ms", 30_000)
_def("worker_pool_prestart_workers", 0)
_def("worker_idle_timeout_ms", 60_000)
_def("scheduler_top_k_fraction", 0.2)  # hybrid policy: top-k random among best
_def("scheduler_top_k_absolute", 5)    # ref: ray_config_def.h scheduler_top_k_absolute
_def("scheduler_spread_threshold", 0.5)
_def("task_retry_delay_ms", 100)
# how long a bundle reservation queues on the node agent for capacity to
# free (e.g. lingering task leases) before the head replans elsewhere
_def("pg_reserve_wait_ms", 2_000)
_def("actor_creation_retries", 3)
# --- object store -----------------------------------------------------------
_def("object_store_memory_bytes", 512 * 1024 * 1024)
_def("object_store_fallback_directory", "/tmp/ray_tpu_spill")
_def("object_spilling_threshold", 0.8)
_def("object_transfer_chunk_bytes", 4 * 1024 * 1024)
# --- bulk object-transfer plane (see _private/object_transfer.py) -----------
_def("object_transfer_enabled", True)   # False: legacy obj_chunk RPC pulls
_def("object_transfer_window", 8)       # in-flight chunk requests per stream
# objects at/above this ride several parallel stripe streams
_def("object_transfer_parallel_threshold", 64 * 1024 * 1024)
_def("object_transfer_max_streams", 2)
_def("object_transfer_sock_buf_bytes", 4 * 1024 * 1024)  # SO_SNDBUF/SO_RCVBUF
# --- locality-aware scheduling ----------------------------------------------
# minimum argument bytes a node must already hold before locality
# overrides the hybrid policy; also the floor for the object directory
# entries piggybacked on heartbeats (0 disables locality scheduling)
_def("locality_min_bytes", 1024 * 1024)
_def("object_directory_max_entries", 128)  # per-node heartbeat summary cap
# head object directory shard count: independent lock+version per
# oid-hash bucket, so heartbeat deltas / lookups / gossip on different
# buckets never serialize on one structure (see object_directory.py)
_def("object_directory_shards", 16)
# --- dispatch batching (see worker.py owner pump) ----------------------------
# max leases one batched request_leases frame may ask an agent for
_def("lease_request_batch_max", 16)
# executor-side result micro-batching: flush a batch_results frame when
# this many are buffered, or this many ms after the first
_def("dispatch_result_batch_max", 32)
_def("dispatch_result_flush_ms", 5)
# how long an agent waits after an owner's connection drops before
# reclaiming its leases — a transiently-dropped owner re-binds them on
# its next lease request within this window
_def("lease_orphan_grace_s", 3.0)
# --- control plane ----------------------------------------------------------
_def("gcs_health_check_period_ms", 3_000)   # ref: ray_config_def.h:841-847
_def("gcs_health_check_failure_threshold", 5)
_def("gcs_persist_interval_ms", 200)        # head table snapshot debounce
_def("gcs_reconnect_grace_s", 15.0)         # client retry window across a
                                            # head restart (ref: NotifyGCSRestart)
_def("pubsub_poll_timeout_ms", 30_000)
_def("rpc_connect_timeout_s", 10.0)
_def("rpc_call_timeout_s", 120.0)
# --- workers ----------------------------------------------------------------
_def("worker_register_timeout_s", 30.0)
_def("worker_startup_parallelism", 4)
# --- memory monitor (reference: memory_monitor.h:52 + ray_config_def.h
# memory_usage_threshold / memory_monitor_refresh_ms) -------------------------
_def("memory_usage_threshold", 0.95)          # node memory fraction
_def("memory_monitor_refresh_ms", 250)        # 0 disables the monitor
_def("memory_monitor_min_kill_interval_ms", 1_000)
_def("memory_monitor_test_usage_file", "")    # test hook: fraction in a file
# virtual node-memory total: > 0 makes the watchdog compute pressure as
# sum(per-worker RSS) / this total instead of reading /proc/meminfo —
# several agents on one host each get an ISOLATED, deterministic memory
# envelope (tests/bench overcommit a 512MB "node" without ever stressing
# the real machine), and it doubles as the node's `memory` resource
# total for bin-packing
_def("memory_monitor_node_total_bytes", 0)
# OOM kills draw from this separate per-task retry budget — never from
# max_retries — with jittered exponential backoff so the retry lands
# after pressure clears instead of immediately back into the same wall
# (-1 = unlimited, mirroring max_retries semantics)
_def("task_oom_retries", 5)
_def("task_oom_retry_max_backoff_ms", 5_000)
# --- poison-task quarantine (head.py) ----------------------------------------
# a task/actor class whose executions OOM-kill or crash workers this
# many CONSECUTIVE times across the cluster is quarantined: further
# submissions fail fast with PoisonedTaskError instead of churning
# workers.  TTL-expiring; `rtpu quarantine clear` lifts it early.
_def("poison_task_threshold", 3)
_def("poison_task_ttl_s", 60.0)
# --- checksummed transfers ---------------------------------------------------
# CRC32 per object computed at seal, carried in directory entries and
# the transfer control protocol, verified on pull: a corrupt copy is
# detected, reported back to its holder (which re-verifies and drops a
# genuinely-bad secondary), and the pull retries from an alternate
# holder.  False skips both the seal-time hash and pull verification.
_def("object_checksums", True)
# --- put() backpressure ------------------------------------------------------
# a put whose shm allocation fails while the arena holds bytes that can
# still free (pinned entries whose pins will release) waits up to this
# long — bounded further by the ambient deadline — for room before
# taking the disk-fallback path; 0 restores immediate fallback
_def("put_backpressure_max_s", 10.0)
# --- head control-plane sharding (see _private/head_shards.py) ---------------
# ingest event-loop threads beside the head's scheduling loop:
#   0 = single-loop compat (planes run on the head loop, no threads)
#   1 = one shared ingest loop for both planes
#   2 = task-event loop + telemetry loop (the default topology)
_def("head_ingest_shards", 2)
# task-event inbox bound, in FRAMES: past this the oldest queued frame
# drops (counted in ray_tpu_task_events_dropped_total{shard=...}) so a
# runaway burst cannot grow head memory without bound; 0 = unbounded
_def("head_inbox_max_frames", 4096)
# --- observability ----------------------------------------------------------
_def("task_events_buffer_size", 10_000)
_def("metrics_report_interval_ms", 5_000)
_def("event_stats", True)
# --- memory/object accounting (rtpu memory / rtpu summary) -------------------
# head-side leak-scan cadence: every interval the head joins the agents'
# store breakdowns with the owners' reference tables, flags leaks, and
# sets ray_tpu_object_leaked_bytes (0 disables the loop; on-demand
# /api/memory views still work).  The scan fans out to every agent and
# registered driver, so the cadence is deliberately lazy relative to
# the TTL — detection latency is bounded by interval + ttl
_def("memory_scan_interval_s", 5.0)
# a borrowed ref still registered past this age, a pinned object with no
# live owner older than this, or a channel slot no live compiled graph
# claims for this long, is flagged in the `leaks` view
_def("object_leak_ttl_s", 30.0)
# bounded aggregation: refs per worker summary (largest first),
# store entries per node payload, and objects in the head's joined
# top-N table.  BOTH caps must sit far above normal working-set sizes:
# truncating either marks the whole view partial, which suspends the
# dead-owner/channel tripwires until the population shrinks (a 10k-ref
# driver is an ordinary workload — see tests/test_scale.py).
_def("memory_summary_max_refs", 20000)
_def("memory_summary_max_objects", 20000)
_def("memory_view_top_n", 50)
# record the user call-site (file:line:function) on put()/.remote()
# minted refs; False drops the ~µs frame walk from the submit hot path
_def("memory_record_call_sites", True)
# --- live introspection (see _private/profiling.py + log_monitor.py) ---------
_def("profiler_default_hz", 99)            # sampling rate when none given
_def("profiler_max_duration_s", 300.0)     # hard cap on one profile run
_def("loop_lag_probe_interval_ms", 500)    # event-loop lag probe cadence
_def("log_monitor_poll_ms", 250)           # agent-side log tail cadence
_def("log_monitor_max_read_bytes", 256 * 1024)  # per file per poll
_def("log_to_driver", True)                # stream worker logs to drivers
_def("timeseries_max_samples", 240)        # head ring depth per series
# --- serve data plane (see serve/http.py) ------------------------------------
_def("serve_max_inflight_requests", 1024)  # proxy-wide gate; 503 beyond
_def("serve_max_header_bytes", 65536)      # request line + headers cap (431)
_def("serve_max_body_bytes", 32 * 1024 * 1024)  # request body cap (413)
_def("serve_pipeline_depth", 32)  # pipelined requests per connection
# --- compiled-DAG channels (see dag/channel.py + dag/execution.py) -----------
_def("dag_channel_buffer_bytes", 1024 * 1024)  # per-version payload capacity
_def("dag_channel_poll_max_s", 0.002)  # backoff cap while polling a channel
_def("dag_monitor_interval_s", 0.2)    # driver loop-ref death-watch cadence;
# bounds how long in-flight CompiledDAGRef.get() calls can hang past an
# actor death before they raise
_def("dag_teardown_timeout_s", 10.0)
# --- chaos fault injection (see _private/fault_injection.py) -----------------
_def("chaos_enabled", True)   # the plane is inert until rules are installed
_def("chaos_seed", 0)         # default seed for rules created without one
# --- fault tolerance ---------------------------------------------------------
# stateful actor restarts (__rt_save__/__rt_restore__ hooks, worker.py):
# snapshot storage root ("" = <session_dir>/actor_state), save cadence in
# completed method calls, and snapshots retained per actor
_def("actor_state_storage_path", "")
_def("actor_state_save_every_n", 1)
_def("actor_state_keep", 2)
# serve: replica health-check budget at deploy time (was a hardcoded
# 600 — one wedged replica constructor stalled deploys for 10 minutes),
# and how many surviving replicas a handle call retries against when the
# one it picked died mid-flight
_def("serve_replica_health_timeout_s", 120.0)
_def("serve_dead_replica_retries", 3)
# --- LLM serving tier (see serve/llm.py) -------------------------------------
_def("llm_page_size", 16)           # KV-cache tokens per page
_def("llm_kv_pages", 0)             # pages per replica; 0 = sized so
# max_batch sequences can run at max_seq_len simultaneously
_def("llm_max_batch_size", 32)      # decode lanes per engine step
_def("llm_prefill_chunk", 64)       # prompt tokens prefetched per step —
# bounds how long one long prompt can stall in-flight decodes
_def("llm_prefill_lanes", 8)        # sequences prefilling one chunk each
# per step (batched prefill: admitting N streams costs N/lanes steps)
_def("llm_stream_flush_tokens", 4)  # tokens coalesced per stream item
# after the first (the first token flushes immediately for TTFT); each
# item costs a stream push + a ref resolution + an SSE chunk, so this
# is the per-token transport amortizer
_def("llm_admission_queue", 256)    # queued sequences before 503 shed
_def("llm_detach_grace_s", 2.0)     # KV pages survive a vanished consumer
# this long (the re-attach window for proxy resume) before recycling
_def("llm_done_seq_ttl_s", 30.0)    # finished sequences replayable (by
# request_id) this long for duplicate/late retries
_def("llm_prefix_sharing", True)    # copy-on-write prefix sharing: admit
# sequences whose page-aligned prompt prefix matches a live sequence's
# onto the SAME physical KV pages (refcounted; recycled at refcount 0),
# prefilling only from the first unshared token
_def("llm_attention_impl", "auto")  # decode attention: "paged" = Pallas
# paged-attention kernel over block tables (cost tracks USED context),
# "dense" = gather-then-dense reference (cost tracks max context),
# "auto" = paged
_def("llm_disagg_min_prompt", 0)    # disaggregated prefill: prompts at
# least this long route their prefill to the dedicated prefill pool
# (when llm_deployment(prefill_replicas=N) created one); shorter
# prompts prefill on the decode replica where queueing costs more than
# the shipped-KV hop saves
# --- elastic autoscaling (see autoscaler/ + head drain state machine) --------
# sustained-demand hysteresis: backlog (demand that FITS existing nodes
# but queues behind busy capacity) must persist for this many
# consecutive autoscaler passes before it launches nodes — one burst
# that drains on its own must not thrash the cluster.  Demand NO
# existing node can ever fit scales up immediately (waiting cannot
# resolve infeasibility).
_def("autoscaler_upscale_consecutive", 3)
# graceful drain budget: past this the drain is abandoned (the node
# keeps running; the autoscaler retries later) rather than force-killed
_def("drain_timeout_s", 60.0)
# how long a drained node's agent gets to finish in-flight leases
# before the remaining (non-migratable) workers are cut loose
_def("drain_lease_grace_s", 20.0)
# scheduler-latency SLO pressure: queued-phase p99 above this for a
# sustained window counts as scale-up pressure even without parked
# infeasible demand (0 disables the signal)
_def("autoscaler_sched_p99_threshold_ms", 0.0)
# --- serve replica autoscaling (num_replicas="auto") -------------------------
# target ongoing requests per replica before another replica is added
_def("serve_autoscale_target_ongoing", 2)
_def("serve_autoscale_min_replicas", 1)
_def("serve_autoscale_max_replicas", 8)
# upscale needs the computed desired above current for this many
# consecutive reconcile rounds; downscale needs it below for this long
_def("serve_autoscale_up_consecutive", 2)
_def("serve_autoscale_down_delay_s", 10.0)
# --- LLM sampling (jit-static decode knobs; see serve/llm.py) ----------------
_def("llm_temperature", 0.0)  # 0 = greedy argmax (the decode-identity tier)
_def("llm_top_k", 0)          # 0 = full vocab; >0 = sample among top-k
# --- end-to-end deadlines (see _private/deadlines.py) ------------------------
# owner-side deadline sweep cadence: how often queued/in-flight tasks
# with deadlines are checked (the sweep only runs while any exist)
_def("deadline_check_interval_ms", 50)
# after the cooperative cancel of a deadline-expired RUNNING task, how
# long before the force path (worker exit) fires if it is still running
_def("deadline_force_cancel_grace_s", 1.0)
# --- serve tail tolerance (see serve/api.py) ---------------------------------
# hedge delay used by hedge_after="p99" until enough latency samples
# exist to compute a real p99 (and its floor thereafter)
_def("serve_hedge_min_delay_s", 0.05)
# per-replica circuit breaker: failure score (time-decayed; errors and
# hedge-slow events each add 1) at which the circuit opens, the decay
# horizon, and how long an open circuit waits before one half-open
# probe is let through
_def("serve_circuit_fail_threshold", 3.0)
_def("serve_circuit_decay_s", 5.0)
_def("serve_circuit_cooldown_s", 1.0)
# --- distributed tracing (see _private/tracing.py) ---------------------------
_def("tracing_enabled", True)
_def("trace_sampling_ratio", 1.0)      # root-span sampling probability
_def("trace_buffer_size", 4096)        # per-process finished-span buffer
_def("trace_store_max_traces", 1000)   # head-side bounded trace store
_def("trace_store_max_spans", 512)     # per-trace span cap at the head


class _Config:
    def __init__(self):
        self._overrides: Dict[str, Any] = {}

    def initialize(self, system_config: Dict[str, Any] | None) -> None:
        if system_config:
            for k, v in system_config.items():
                if k not in _DEFS:
                    raise ValueError(f"Unknown system config key: {k}")
                self._overrides[k] = v

    def serialize(self) -> str:
        return json.dumps(self._overrides)

    @classmethod
    def deserialize_into_env(cls, serialized: str) -> Dict[str, str]:
        """Build the env-var dict to pass to a child process."""
        overrides = json.loads(serialized)
        return {f"RT_{k.upper()}": json.dumps(v) for k, v in overrides.items()}

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in _DEFS:
            raise AttributeError(f"Unknown config: {name}")
        env = os.environ.get(f"RT_{name.upper()}")
        if env is not None:
            try:
                return json.loads(env)
            except json.JSONDecodeError:
                return env
        if name in self._overrides:
            return self._overrides[name]
        return _DEFS[name]


config = _Config()
