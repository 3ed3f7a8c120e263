"""MPMD pipeline-parallel training on compiled-graph channels.

The port of ray_tpu/train/pipeline.py.  The schedule (``one_f_one_b``),
the partition, the channels, the driver (``TrainPipeline``: the monitor,
``step``, ``resume``, ``teardown``) and the stage's control ops are
ray_tpu's; the stage itself is PyTorch:

    driver ──tokens──▶ [stage 0] ──act──▶ [stage 1] ─ … ─▶ [stage S-1]
       │                   ◀──grad──          ◀──grad──        │ ▲tokens
       └────────────────◀──────── per-stage reports ◀──────────┘

  * :func:`partition_layers` splits the Llama stack into contiguous,
    param/FLOP-balanced layer ranges (embedding weighted onto stage 0,
    the lm_head matmul onto the last stage).
  * One :class:`PipelineStage` actor per stage holds a
    :class:`~ray_tpu_torch.models.llama.LlamaStage` and its AdamW on its
    leased card (``num_gpus`` per stage: a whole card, or a share of one
    that several stages time-slice), or on the CPU when the pipeline is
    built with ``device="cpu"``.  A stage over ``n > 1`` devices (an
    in-stage mesh of fsdp/tp/sp/dp, ``stage_mesh``) is ``n`` actors, one
    whole card each, in a process group of the stage's own (nccl; gloo
    on the CPU): the JAX package's stage is one process over ``n``
    devices.  Every rank reads the stage's rings and takes its slice of
    each microbatch; rank 0 writes the stage's output, gathered over
    the group.
  * All edges are mutable compiled-graph channels (dag/channel.py):
    pre-allocated shm rings, remote readers fed by bulk-plane pushes.
    Activation channels are DEEP (ring depth bounds the in-flight
    microbatches of the 1F1B schedule) while grad/report channels stay
    shallow.  A tensor crosses a ring through the host: a CUDA tensor is
    copied off the card by its writer and onto the reader's card by the
    reader; a CPU tensor read from a ring is the reader's own copy.
  * Each stage runs a PINNED exec loop (worker dispatch
    ``__rt_dag_pipeline_loop__``, exactly like the compiled-DAG loop)
    replaying :func:`one_f_one_b`'s op list per step: warm-up forwards,
    steady-state 1F1B, drain, then AdamW on the grads summed over the
    step's microbatches and scaled by 1/m.  A forward keeps no autograd
    graph; the backward RE-RUNS the stage forward under autograd (the
    JAX package's recompute inside the vjp), so a stage keeps only its
    in-flight microbatch INPUTS.  The last stage computes the loss, its
    parameter grads and its input grad in its forward op.
  * The driver writes m microbatch token versions per step and reads one
    report per stage (loss from the last stage, busy-time split from
    all) — the report timestamps drive ``ray_tpu_pipeline_bubble_pct``.
    Each timed region ends in a host read of its result, so the split
    counts the device's work.

Failure model: a dying stage fails its loop task; the driver monitor
poisons every channel within ``dag_monitor_interval_s`` so all blocked
parties raise instead of hanging, and kills the ranks that a poisoned
channel cannot reach: the dead rank's stage peers, and any rank still
inside a collective of its group.  With checkpointing on (``save_every``
> 0, stage actors created with ``max_restarts``), stages persist
(step, params, opt_state) through the ``__rt_save__``/``__rt_restore__``
hooks at step boundaries (each rank its own shards) and
:meth:`TrainPipeline.resume` forms the stages' groups again, rolls
every rank back to the newest COMMON snapshot step, rebuilds fresh
channels, and reinstalls the loops.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ray_tpu_torch._private.errors import RayError
# single source of truth for the system-method names: the worker defines
# them (its _execute_inner dispatches on them); we submit with them
from ray_tpu_torch._private.worker import (PIPELINE_CTL_METHOD,
                                     PIPELINE_EXEC_METHOD)


class PipelineError(RayError):
    pass


# ------------------------------------------------------------------ schedule


def one_f_one_b(stage: int, n_stages: int,
                n_microbatches: int) -> List[Tuple[str, int]]:
    """The 1F1B op list for one optimizer step of one stage.

    ``min(n_stages - 1 - stage, m)`` warm-up forwards, then strict
    forward/backward alternation, then the backward drain — the last
    stage alternates from op one, the first stage fills the pipe.  The
    in-flight microbatch count (forwards minus backwards) never exceeds
    :func:`in_flight_bound`, which is what sizes the activation
    channels' rings.
    """
    if not (0 <= stage < n_stages):
        raise ValueError(f"stage {stage} out of range for {n_stages}")
    if n_microbatches < 1:
        raise ValueError("need at least one microbatch")
    warmup = min(n_stages - 1 - stage, n_microbatches)
    ops: List[Tuple[str, int]] = [("F", k) for k in range(warmup)]
    f, b = warmup, 0
    while f < n_microbatches:
        ops.append(("F", f))
        f += 1
        ops.append(("B", b))
        b += 1
    while b < n_microbatches:
        ops.append(("B", b))
        b += 1
    return ops


def in_flight_bound(stage: int, n_stages: int, n_microbatches: int) -> int:
    """Max microbatches a stage holds between forward and backward."""
    return min(n_stages - stage, n_microbatches)


def bubble_pct(busy_s: Sequence[float], wall_s: float) -> float:
    """Pipeline bubble: the fraction of stage-seconds spent idle.

    ``busy_s`` is per-stage compute time over a window of ``wall_s``
    seconds; S * wall is the total stage-time available.  0 == every
    stage computed the whole window; the 1F1B analytic floor is
    (S-1)/(m+S-1) per step.
    """
    if wall_s <= 0 or not busy_s:
        return 0.0
    frac = sum(busy_s) / (len(busy_s) * wall_s)
    return 100.0 * max(0.0, min(1.0, 1.0 - frac))


# ----------------------------------------------------------------- partition


def partition_layers(cfg, n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous ``[start, end)`` layer ranges, one per stage,
    minimizing the maximum per-stage cost.

    Cost model: a transformer block's fwd+bwd FLOPs are proportional to
    its parameter count; the lm_head matmul (last stage) likewise; the
    embedding lookup is FLOP-free forward but pays a scatter-add
    backward plus optimizer traffic, charged at 0.3x its params.  Every
    stage owns at least one block.
    """
    L = int(cfg.n_layers)
    if not (1 <= n_stages <= L):
        raise ValueError(f"pp={n_stages} needs 1..{L} stages "
                         f"for {L} layers")
    per_layer = float(
        cfg.dim * cfg.n_heads * cfg.head_dim
        + 2 * cfg.dim * cfg.n_kv_heads * cfg.head_dim
        + cfg.n_heads * cfg.head_dim * cfg.dim
        + 3 * cfg.dim * cfg.hidden_dim + 2 * cfg.dim)
    embed_w = 0.3 * cfg.vocab_size * cfg.dim
    head_w = float(cfg.vocab_size * cfg.dim)

    def stage_cost(s: int, n_layers: int) -> float:
        c = n_layers * per_layer
        if s == 0:
            c += embed_w
        if s == n_stages - 1:
            c += head_w
        return c

    INF = float("inf")
    # dp[s][l]: minimal max-cost splitting the first l layers into the
    # first s stages; choice[s][l]: where stage s-1 started
    dp = [[INF] * (L + 1) for _ in range(n_stages + 1)]
    choice = [[0] * (L + 1) for _ in range(n_stages + 1)]
    dp[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for l in range(s, L + 1):
            for k in range(s - 1, l):
                cost = max(dp[s - 1][k], stage_cost(s - 1, l - k))
                if cost < dp[s][l]:
                    dp[s][l] = cost
                    choice[s][l] = k
    ranges: List[Tuple[int, int]] = []
    l = L
    for s in range(n_stages, 0, -1):
        k = choice[s][l]
        ranges.append((k, l))
        l = k
    ranges.reverse()
    return ranges


def slice_params_for_stage(params: Dict[str, Any],
                           ranges: Sequence[Tuple[int, int]],
                           stage: int) -> Dict[str, Any]:
    """Select one stage's entries from a full LlamaModel state dict
    (LlamaStage keeps LlamaModel's names, layers under their global
    index), e.g. to seed a pipeline from a single-program checkpoint."""
    start, end = ranges[stage]
    keep = [f"layers.{i}." for i in range(start, end)]
    if stage == 0:
        keep.append("embed.")
    if stage == len(ranges) - 1:
        keep += ["final_norm.", "lm_head."]
    return {k: v for k, v in params.items()
            if any(k.startswith(prefix) for prefix in keep)}


# ------------------------------------------------------------- stage actor


def _host_copy(value: Any) -> Any:
    """A CPU copy of a tensor's local part (a DTensor's own shard) that
    shares no memory with it (``.cpu()`` of a CPU tensor is the tensor
    itself); other values as they are."""
    if isinstance(value, torch.Tensor):
        return _local(value).detach().to("cpu", copy=True)
    return value


def _local(t: torch.Tensor) -> torch.Tensor:
    """The part of ``t`` this process holds: a DTensor's local shard."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _like(p: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` (a shard saved from a tensor laid out as ``p``) laid
    out as ``p`` again, on its device."""
    from torch.distributed.tensor import DTensor

    local = local.to(_local(p).device)
    if isinstance(p, DTensor):
        return DTensor.from_local(local, p.device_mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride())
    return local


class PipelineStage:
    """Actor hosting ONE rank of ONE pipeline stage: its share of the
    stage's LlamaStage and AdamW on the rank's device (``spec["device"]``,
    or the lease's card), the stage functions of
    ``build_llama_stage_state``, and the pinned 1F1B loop (entered via
    the ``__rt_dag_pipeline_loop__`` system method, so the exec thread
    stays pinned exactly like a compiled-DAG loop).

    A stage of one rank builds itself at once.  A stage of ``n > 1``
    ranks is one process per device, as a JAX stage is one process over
    several: its ranks build only once the driver has them join the
    stage's own process group (the ``join`` control op), whose mesh
    (``spec["mesh_axes"]``) the stage is laid out on."""

    def __init__(self, spec: Dict[str, Any]):
        self.spec = spec
        self.stage = int(spec["stage"])
        self.rank = int(spec.get("rank", 0))
        self.n_ranks = int(spec.get("n_ranks", 1))
        self.n_stages = int(spec["n_stages"])
        self.num_microbatches = int(spec["num_microbatches"])
        self._step = 0
        self._st: Optional[Dict[str, Any]] = None
        if self.n_ranks == 1:
            self._build()

    # ----------------------------------------------------------- the stage

    def _build(self) -> None:
        from ray_tpu_torch.parallel.mesh import MeshSpec, make_mesh
        from ray_tpu_torch.train.gspmd import (build_llama_stage_state,
                                               load_params)

        spec = self.spec
        axes = MeshSpec(**spec.get("mesh_axes", {}))
        # one rank: the lease's card (CUDA_VISIBLE_DEVICES), or the
        # device named; several: the mesh over the stage's group
        self._mesh = (make_mesh(axes, devices=[spec.get("device")])
                      if self.n_ranks == 1 else make_mesh(axes))
        start, end = spec["ranges"][self.stage]
        self._first = self.stage == 0
        self._last = self.stage == self.n_stages - 1
        self._st = build_llama_stage_state(
            spec["cfg"], self._mesh, (start, end),
            first=self._first, last=self._last,
            microbatch_size=int(spec["microbatch_size"]),
            seq_len=int(spec["seq_len"]),
            num_microbatches=self.num_microbatches,
            rng_seed=int(spec.get("rng_seed", 0)),
            learning_rate=float(spec.get("learning_rate", 3e-4)))
        initial = spec.get("initial_params")
        if initial is not None:
            # whole tensors: each rank keeps its shard of them
            load_params(self._st["params"], initial)

    def _join(self, coordinator: str) -> None:
        """Join the stage's process group at ``coordinator`` and build
        the stage on it; a group and stage from before are dropped
        first (``resume`` forms every group again)."""
        from ray_tpu_torch.parallel import (init_distributed,
                                            shutdown_distributed)

        self._st = None
        shutdown_distributed()
        init_distributed(coordinator, self.n_ranks, self.rank,
                         device=self.spec.get("device"))
        self._build()

    # --------------------------------------------------- save/restore hooks

    def __rt_save__(self) -> Dict[str, Any]:
        """(step, params, AdamW state) as CPU tensors, each keyed by its
        parameter's name in the stage's state dict; a rank of a stage
        over several devices saves its own shards.  No collective runs
        here: the driver saves one rank after another."""
        model, opt = self._st["params"], self._st["opt_state"]
        host = {name: _host_copy(p) for name, p in model.named_parameters()}
        moments = {}
        for name, p in model.named_parameters():
            st = opt.state.get(p)
            if st:
                moments[name] = {k: _host_copy(v) for k, v in st.items()}
        return {"step": self._step, "params": host, "opt": moments}

    @torch.no_grad()
    def __rt_restore__(self, state: Dict[str, Any]) -> None:
        if self._st is None:
            # a restarted rank of a stage over several devices: resume()
            # loads the snapshot once the stage's group has formed again
            return
        model, opt = self._st["params"], self._st["opt_state"]
        for name, p in model.named_parameters():
            _local(p).copy_(state["params"][name])
            saved = state["opt"].get(name)
            if saved:
                opt.state[p] = {k: v if k == "step" else _like(p, v)
                                for k, v in saved.items()}
        self._step = int(state["step"])

    # ------------------------------------------------------------ exec loop

    def _read(self, reader, seq: int):
        value, is_err = reader.read(seq)
        if is_err:
            raise value
        return value

    def _run_loop(self, worker, plan: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.dag import channel as ch

        st = self._st
        m = self.num_microbatches
        first, last = self._first, self._last
        save_every = int(plan.get("save_every", 0))
        self._step = int(plan.get("start_step", self._step))
        chans = plan["channels"]
        device = self._mesh.device
        gather = st["gather_value"]

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        def mk_reader(key):
            c = chans.get(key)
            if c is None:
                return None
            return ch.ChannelReader(ch.ChannelSpec(**c["spec"]),
                                    c["index"])

        def mk_writer(key):
            c = chans.get(key)
            if c is None:
                return None
            return ch.ChannelWriter(ch.ChannelSpec(**c["spec"]))

        # every rank reads its stage's rings; only rank 0 writes
        in_r = mk_reader("input")     # tokens: first + last stages
        act_r = mk_reader("act_in")   # activations from upstream
        gy_r = mk_reader("grad_in")   # activation grads from downstream
        act_w = mk_writer("act_out")
        gx_w = mk_writer("grad_out")
        rep_w = mk_writer("report")
        ops = one_f_one_b(self.stage, self.n_stages, m)
        t_local = 0
        completed = 0

        def take(reader, seq, prepare):
            """Blocking read -> a tensor on the stage's device (the
            rank's slice, or the whole microbatch); the ring slot is
            released only once the value is the stage's own (a numpy
            value read from a ring aliases ring memory)."""
            value = self._read(reader, seq)
            out = prepare(value)
            reader.advance(seq)
            return out

        def host(value, writer):
            """The host copy that ``writer`` takes (the copy syncs); a
            rank that writes nothing syncs its device instead."""
            if writer is not None:
                return value.cpu()
            sync()
            return None

        try:
            while True:
                base = t_local * m
                inputs: Dict[int, Any] = {}
                pending: Dict[int, Tuple[float, Any]] = {}
                loss_sum = 0.0
                fwd_s = bwd_s = 0.0
                t_step0 = time.perf_counter()
                st["zero_grads"](st["params"])
                for op, k in ops:
                    seq = base + k + 1
                    if op == "F":
                        x = take(act_r if not first else in_r, seq,
                                 st["shard_value"])
                        if last:
                            targets = take(in_r, seq, st["whole_value"])
                            t0 = time.perf_counter()
                            loss, gx = st["loss_bwd"](st["params"], x,
                                                      targets)
                            if gx is not None:
                                gx = gather(gx)
                            loss = float(loss)  # syncs the fused step
                            bwd_s += time.perf_counter() - t0
                            pending[k] = (loss, gx)
                        else:
                            t0 = time.perf_counter()
                            y_host = host(gather(st["fwd"](st["params"], x)),
                                          act_w)
                            fwd_s += time.perf_counter() - t0
                            if act_w is not None:
                                act_w.write(y_host)
                            inputs[k] = x
                    else:  # "B"
                        gx_host = None
                        if last:
                            loss, gx = pending.pop(k)
                            loss_sum += loss
                            if gx is not None:
                                t0 = time.perf_counter()
                                gx_host = host(gx, gx_w)  # sync residue
                                bwd_s += time.perf_counter() - t0
                        else:
                            gy = take(gy_r, seq, st["shard_value"])
                            x = inputs.pop(k)
                            t0 = time.perf_counter()
                            gx = st["bwd"](st["params"], x, gy)
                            if gx is not None:
                                gx_host = host(gather(gx), gx_w)
                            else:
                                sync()
                            bwd_s += time.perf_counter() - t0
                        if gx_w is not None:
                            gx_w.write(gx_host)
                t0 = time.perf_counter()
                st["opt_step"](st["params"], st["opt_state"])
                sync()
                opt_s = time.perf_counter() - t0
                self._step += 1
                wall = time.perf_counter() - t_step0
                if save_every > 0 and self._step % save_every == 0:
                    worker.persist_actor_state()
                if rep_w is not None:
                    # rank 0's times: its peers run the same ops in step
                    # with it, each collective waiting for the slowest
                    rep_w.write({
                        "stage": self.stage, "step": self._step,
                        "loss": (loss_sum / m) if last else None,
                        "fwd_s": fwd_s, "bwd_s": bwd_s, "opt_s": opt_s,
                        "busy_s": fwd_s + bwd_s + opt_s, "wall_s": wall,
                    })
                t_local += 1
                completed += 1
        except ch.ChannelClosedError:
            pass  # clean teardown
        finally:
            for writer in (act_w, gx_w, rep_w):
                if writer is not None:
                    try:
                        writer.close()
                    except Exception:
                        pass
                    writer.detach()
            if self.n_ranks > 1:
                # a peer still inside a collective with this rank fails
                # there (gloo) instead of waiting for it; over nccl the
                # driver kills such a peer
                from ray_tpu_torch.parallel import shutdown_distributed

                shutdown_distributed()
        return {"steps_completed": completed, "step": self._step}


def run_stage_loop(worker, instance, plan: Dict[str, Any]) -> Dict[str, Any]:
    """Worker-dispatch target for ``__rt_dag_pipeline_loop__``."""
    return instance._run_loop(worker, plan)


def kernel_launches() -> Dict[str, int]:
    """This process's launch count of each of the port's kernels (the
    wrappers count each launch of a CUDA kernel, never a CPU call of the
    plain version)."""
    from ray_tpu_torch.ops import flash_attention, paged_attention

    return {"flash_attention": flash_attention.LAUNCHES,
            "paged_attention": paged_attention.LAUNCHES}


def run_stage_ctl(worker, instance, req: Dict[str, Any]) -> Dict[str, Any]:
    """Worker-dispatch target for ``__rt_dag_pipeline_ctl__`` — control
    ops that need the worker (checkpoint store access) without tripping
    the per-method autosave (system methods are exempt), so recovery
    probes can never evict the snapshots they are about to restore."""
    import os

    op = req.get("op")
    if op == "info":
        built = instance._st is not None
        device = instance._mesh.device if built else None
        card = None
        if built and device.type == "cuda":
            props = torch.cuda.get_device_properties(device)
            card = {"name": props.name, "uuid": str(props.uuid),
                    "pci_bus_id": getattr(props, "pci_bus_id", None)}
        return {"pid": os.getpid(), "step": instance._step,
                "node_id": worker.node_id, "stage": instance.stage,
                "rank": instance.rank, "device": str(device) if built else None,
                "card": card,
                "visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "kernel_launches": kernel_launches()}
    if op == "rendezvous":
        # the stage group's coordinator, on rank 0's node
        from ray_tpu_torch.train.worker_group import _free_port, _node_ip

        return {"coordinator": f"{_node_ip()}:{_free_port()}"}
    if op == "join":
        instance._join(req["coordinator"])
        return {"ok": True}
    if op == "save_now":
        return {"saved": worker.persist_actor_state(),
                "step": instance._step}
    spec = worker._actor_creation_spec
    ckpt = worker._actor_state_checkpoint(spec.actor_id) \
        if spec is not None and spec.actor_id else None
    if op == "snapshot_steps":
        steps: Dict[int, str] = {}
        if ckpt is not None:
            for name in ckpt.entry_names():
                state = ckpt.load_entry(name)
                if isinstance(state, dict) and "step" in state:
                    steps[int(state["step"])] = name
        return {"steps": sorted(steps)}
    if op == "load_snapshot":
        want = int(req["step"])
        if ckpt is not None:
            for name in reversed(ckpt.entry_names()):
                state = ckpt.load_entry(name)
                if isinstance(state, dict) \
                        and int(state.get("step", -1)) == want:
                    instance.__rt_restore__(state)
                    return {"ok": True, "step": want}
        return {"ok": False, "step": want}
    raise ValueError(f"unknown pipeline ctl op {op!r}")


# ------------------------------------------------------------------- driver


# how long a rank's loop may take to return once the pipeline failed
# before the driver takes it for stuck inside a collective
STUCK_RANK_GRACE_S = 5.0


def _resolve_stage_mesh(cfg, axes: Dict[str, int], devices_per_stage: int,
                        microbatch_size: int, seq_len: int
                        ) -> Dict[str, int]:
    """The in-stage mesh's size on each axis: ``axes`` over
    ``devices_per_stage`` devices (0: the product of ``axes``), as the
    JAX package's ``make_mesh`` resolves it over a stage's devices; the
    microbatch's rows must split over dp·fsdp, its sequence over sp and
    the KV heads over tp."""
    from ray_tpu_torch.parallel.mesh import MeshSpec

    n = devices_per_stage or math.prod(axes.values())
    if n < 1:
        raise ValueError(f"stage_mesh {axes}: a -1 axis fills "
                         f"devices_per_stage, which is not given")
    sizes = MeshSpec(**axes).resolve(n).axis_sizes()
    del sizes["pp"]
    if microbatch_size % (sizes["dp"] * sizes["fsdp"]):
        raise ValueError(f"stage_mesh {sizes}: dp·fsdp does not divide "
                         f"microbatch_size={microbatch_size}")
    if seq_len % sizes["sp"]:
        raise ValueError(f"stage_mesh {sizes}: sp does not divide "
                         f"seq_len={seq_len}")
    if cfg.n_kv_heads % sizes["tp"]:
        raise ValueError(f"stage_mesh {sizes}: tp does not divide "
                         f"n_kv_heads={cfg.n_kv_heads}")
    return sizes


class TrainPipeline:
    """Driver handle for an MPMD pipeline-parallel training run.

    ``step(tokens)`` feeds one global batch (``microbatch_size *
    num_microbatches`` rows) through the 1F1B pipeline and returns the
    step's loss + per-stage busy/bubble accounting.  The driver holds no
    model state — stages own their weights; the driver only moves token
    microbatches and reads reports.

    Each stage runs on ``n`` devices: ``devices_per_stage``, or the
    product of ``stage_mesh`` when it is 0 (a ``-1`` axis of
    ``stage_mesh`` fills ``devices_per_stage``).  Inside a stage the
    mesh's fsdp, tp, sp and dp lay the stage out as the single program
    lays out the whole model.  A stage of one device is one actor
    holding ``num_gpus`` of a card (1: a card of its own; 0.5: two
    stages time-slice one card).  A stage of ``n > 1`` is ``n`` actors,
    one whole card each (``num_gpus`` >= 1), joined in a process group
    of the stage's own; the rings carry whole microbatches, each rank
    reads them and takes its slice, and rank 0 writes the stage's
    gathered output.  Without enough GPUs in the cluster the
    constructor raises at once.  ``device="cpu"`` builds CPU stages
    instead (gloo inside a stage).  ``initial_params`` is a full
    :class:`LlamaModel` state dict (``models.convert.params_from_flax``
    of a flax tree, say); without it each stage draws its slice of
    ``LlamaModel(cfg, seed=rng_seed)``'s init.

    Checkpointing cost: with ``max_restarts > 0``, ``save_every``
    defaults to 1 — every optimizer step each stage copies params
    + AdamW state to host tensors and cloudpickles them through the
    actor-state storage layer.  Cheap at test scale, dominant at real
    model scale: pass an explicit ``save_every`` sized to your step
    time (the resume protocol only needs SOME common saved step, and
    rolls back to the newest one).
    """

    def __init__(self, cfg, *, pp: int, microbatch_size: int,
                 num_microbatches: int, seq_len: int,
                 stage_mesh: Optional[Dict[str, int]] = None,
                 learning_rate: float = 3e-4, rng_seed: int = 0,
                 initial_params: Optional[Dict[str, Any]] = None,
                 devices_per_stage: int = 0,
                 num_gpus: float = 1.0, device: Optional[str] = None,
                 resources_per_stage: Optional[Dict[str, float]] = None,
                 max_restarts: int = 0, save_every: Optional[int] = None,
                 act_depth: Optional[int] = None, grad_depth: int = 2,
                 step_timeout: float = 600.0,
                 compile_timeout: float = 300.0):
        if pp < 2:
            raise ValueError("pipeline parallelism needs pp >= 2 "
                             "(use train/gspmd.py single-program "
                             "training for pp=1)")
        self.cfg = cfg
        self.pp = pp
        self.microbatch_size = int(microbatch_size)
        self.num_microbatches = int(num_microbatches)
        self.seq_len = int(seq_len)
        self._lr = float(learning_rate)
        self._rng_seed = int(rng_seed)
        axes = dict(stage_mesh or {})
        axes.pop("pp", None)  # pp is the actor axis here
        self._stage_mesh = _resolve_stage_mesh(cfg, axes,
                                               int(devices_per_stage),
                                               self.microbatch_size,
                                               self.seq_len)
        self.ranks_per_stage = math.prod(self._stage_mesh.values())
        self._num_gpus = float(num_gpus)
        self._device = device
        self._ranges = partition_layers(cfg, pp)
        self._save_every = (1 if max_restarts > 0 else 0) \
            if save_every is None else int(save_every)
        # the activation ring depth IS the schedule's in-flight bound:
        # 1F1B holds at most `pp` microbatches between fwd and bwd
        self._act_depth = int(act_depth or (pp + 1))
        self._grad_depth = int(grad_depth)
        self._step_timeout = float(step_timeout)
        self._run_id = uuid.uuid4().hex[:10]
        self._generation = 0
        self._torn_down = False
        self._teardown_lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._monitor_stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._reaper: Optional[threading.Thread] = None
        self._local_step = 0     # steps within the current loop generation
        self._global_step = 0
        self._in_writer = None
        self._rep_readers: List[Any] = []
        self._loop_refs: List[Any] = []

        from ray_tpu_torch.dag.execution import ChannelHost

        self._channels = ChannelHost()
        try:
            self._create_actors(initial_params, resources_per_stage,
                                max_restarts)
            self._form_groups(timeout=compile_timeout)
            if self._save_every > 0:
                for h in self._handles:  # step-0 snapshots so resume()
                    self._ctl(h, {"op": "save_now"})  # always has a base
            self._wire(start_step=0, timeout=compile_timeout)
        except BaseException:
            try:
                self.teardown(timeout=5.0)
            except Exception:
                pass
            raise

    # -------------------------------------------------------------- setup

    def stage_handles(self, stage: int) -> List[Any]:
        """The actors of ``stage``, rank 0 first."""
        n = self.ranks_per_stage
        return self._handles[stage * n:(stage + 1) * n]

    def _create_actors(self, initial_params, resources,
                       max_restarts) -> None:
        import ray_tpu_torch
        from ray_tpu_torch._private.errors import SchedulingError

        n = self.ranks_per_stage
        cls = ray_tpu_torch.remote(PipelineStage)
        # a second exec thread serves control ops (info/snapshot/
        # restore probes) while the 1F1B loop pins the first
        opts: Dict[str, Any] = {"max_restarts": int(max_restarts),
                                "max_concurrency": 2}
        if self._device is None:
            if n > 1 and self._num_gpus < 1:
                raise ValueError(
                    f"a stage over {n} devices takes a whole card a rank "
                    f"(nccl puts no two ranks of a group on one card); "
                    f"num_gpus={self._num_gpus:g}")
            # fail at once rather than wait for leases the cluster can
            # never grant; nothing falls back to the CPU
            need = self._num_gpus * self.pp * n
            have = ray_tpu_torch.cluster_resources().get("GPU", 0)
            if need > have:
                raise SchedulingError(
                    f"TrainPipeline needs {need:g} GPU for {self.pp} "
                    f"stages of {n} rank(s) at num_gpus={self._num_gpus:g} "
                    f"but the cluster has {have:g}; pass device='cpu' to "
                    f"train on the CPU")
            opts["num_gpus"] = self._num_gpus
        if resources:
            opts["resources"] = dict(resources)
        self._handles = []
        for s in range(self.pp):
            spec = {
                "stage": s, "n_stages": self.pp, "cfg": self.cfg,
                "ranges": list(self._ranges),
                "mesh_axes": dict(self._stage_mesh), "n_ranks": n,
                "microbatch_size": self.microbatch_size,
                "seq_len": self.seq_len,
                "num_microbatches": self.num_microbatches,
                "learning_rate": self._lr,
                # one seed for every stage: each parameter draws from
                # a generator seeded by the seed and its name, and
                # LlamaStage keeps LlamaModel's names, so stage init
                # matches a sliced full-model init (initial_params
                # overrides regardless)
                "rng_seed": self._rng_seed,
                "device": self._device,
            }
            if initial_params is not None:
                spec["initial_params"] = slice_params_for_stage(
                    initial_params, self._ranges, s)
            for r in range(n):
                self._handles.append(
                    cls.options(**opts).remote({**spec, "rank": r}))

    def _form_groups(self, timeout: float) -> None:
        """Join each stage's ranks in a process group of their own, at a
        coordinator on its rank 0's node, and build the stage on it.
        Stages of one rank need none."""
        import ray_tpu_torch
        from ray_tpu_torch import api as _api

        if self.ranks_per_stage == 1:
            return
        deadline = time.monotonic() + timeout
        w = _api._worker()
        refs = []
        for s in range(self.pp):
            handles = self.stage_handles(s)
            coordinator = self._ctl(
                handles[0], {"op": "rendezvous"},
                timeout=max(1.0, deadline - time.monotonic()))["coordinator"]
            # every rank at once: each waits in init for the others
            refs += [w.submit_actor_task(
                h._actor_id, PIPELINE_CTL_METHOD,
                ({"op": "join", "coordinator": coordinator},), {})[0]
                for h in handles]
        ray_tpu_torch.get(refs,
                          timeout=max(1.0, deadline - time.monotonic()))

    def _ctl(self, handle, req: Dict[str, Any], timeout: float = 120.0):
        import ray_tpu_torch
        from ray_tpu_torch import api as _api

        w = _api._worker()
        ref = w.submit_actor_task(handle._actor_id, PIPELINE_CTL_METHOD,
                                  (req,), {})[0]
        return ray_tpu_torch.get(ref, timeout=timeout)

    def _wire(self, start_step: int, timeout: float) -> None:
        """Fetch placement, allocate this generation's channels, attach
        driver endpoints, install the stage loops, start the monitor."""
        import ray_tpu_torch
        from ray_tpu_torch import api as _api
        from ray_tpu_torch.dag import channel as ch
        from ray_tpu_torch.dag.execution import DAG_INFO_METHOD

        w = _api._worker()
        info_refs = [w.submit_actor_task(h._actor_id, DAG_INFO_METHOD,
                                         (), {})[0]
                     for h in self._handles]
        infos = ray_tpu_torch.get(info_refs, timeout=timeout)
        try:
            xfer_port = int(w.agent.call("node_info").get("xfer_port") or 0)
        except Exception:
            xfer_port = 0
        driver_info = {"node_id": w.node_id, "agent": list(w.agent_addr),
                       "xfer_port": xfer_port}
        S, m, n = self.pp, self.num_microbatches, self.ranks_per_stage
        # an entity is the driver or a (stage, rank)
        entities = {"driver": driver_info,
                    **{(i // n, i % n): info for i, info in enumerate(infos)}}
        node_table = {i["node_id"]: {"agent": i["agent"],
                                     "xfer_port": i["xfer_port"]}
                      for i in entities.values()}

        # activations and activation-grads travel in the model's compute
        # dtype (bf16 by default, but cfg.dtype is a public knob), whole
        itemsize_act = torch.empty((), dtype=self.cfg.dtype).element_size()
        act_bytes = self.microbatch_size * self.seq_len \
            * int(self.cfg.dim) * itemsize_act
        tok_bytes = self.microbatch_size * self.seq_len * 8
        gen = self._generation

        def pad(k: int) -> int:
            return k + k // 8 + 8192  # serialization header + margin

        def make_spec(name, writer, readers, depth, slot) -> ch.ChannelSpec:
            wnode = entities[writer]["node_id"]
            rnodes = [entities[r]["node_id"] for r in readers]
            involved = dict.fromkeys([wnode] + rnodes)
            return ch.ChannelSpec(
                oid=f"pipech-{self._run_id}-g{gen}-{name}",
                max_in_flight=depth, slot_size=pad(slot),
                n_readers=len(readers), writer_node=wnode,
                reader_nodes=rnodes,
                nodes={nid: node_table[nid] for nid in involved})

        def ranks(s: int) -> List[Tuple[int, int]]:
            return [(s, r) for r in range(n)]

        in_depth = max(2, min(m, 64))
        # readers: the first stage's ranks, then the last stage's
        input_spec = make_spec("in", "driver", ranks(0) + ranks(S - 1),
                               in_depth, tok_bytes)
        act_specs = [make_spec(f"act{i}", (i, 0), ranks(i + 1),
                               self._act_depth, act_bytes)
                     for i in range(S - 1)]
        grad_specs = [make_spec(f"grad{i}", (i + 1, 0), ranks(i),
                                self._grad_depth, act_bytes)
                      for i in range(S - 1)]
        rep_specs = [make_spec(f"rep{i}", (i, 0), ["driver"], 4, 32768)
                     for i in range(S)]
        for spec in [input_spec] + act_specs + grad_specs + rep_specs:
            self._channels.create(spec)
        from ray_tpu_torch.dag.execution import _register_live_channels

        # claim the slots so the head's channel-leak tripwire can tell a
        # live pipeline's pinned rings from an abandoned graph's
        _register_live_channels(id(self), self._channels.oids())

        self._in_writer = ch.ChannelWriter(input_spec)
        self._rep_readers = [ch.ChannelReader(spec, 0)
                             for spec in rep_specs]

        def read(spec, index):
            return {"spec": dataclasses.asdict(spec), "index": index}

        def write(spec):
            return {"spec": dataclasses.asdict(spec)}

        self._loop_refs = []
        for i, h in enumerate(self._handles):
            s, r = divmod(i, n)
            chans: Dict[str, Any] = {}
            if s == 0:
                chans["input"] = read(input_spec, r)
            if s == S - 1:
                chans["input"] = read(input_spec, n + r)
            if s > 0:
                chans["act_in"] = read(act_specs[s - 1], r)
            if s < S - 1:
                chans["grad_in"] = read(grad_specs[s], r)
            if r == 0:
                chans["report"] = write(rep_specs[s])
                if s > 0:
                    chans["grad_out"] = write(grad_specs[s - 1])
                if s < S - 1:
                    chans["act_out"] = write(act_specs[s])
            plan = {"channels": chans, "start_step": start_step,
                    "save_every": self._save_every}
            self._loop_refs.append(w.submit_actor_task(
                h._actor_id, PIPELINE_EXEC_METHOD, (plan,), {})[0])
        self._local_step = 0
        self._global_step = start_step
        self._monitor_stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop,
            args=(list(self._loop_refs), self._monitor_stop),
            name=f"rt-pipeline-monitor-{self._run_id}", daemon=True)
        self._monitor.start()

    # -------------------------------------------------------- death watch

    def _monitor_loop(self, refs: List[Any], stop: threading.Event) -> None:
        import ray_tpu_torch
        from ray_tpu_torch._private.config import config

        interval = float(config.dag_monitor_interval_s)
        while refs and not stop.is_set():
            try:
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                        timeout=interval)
            except Exception:
                return  # driver shutting down
            if self._torn_down or stop.is_set():
                return
            for ref in ready:
                failed = refs.index(ref)
                try:
                    ray_tpu_torch.get(ref, timeout=0)
                    # a loop returning outside teardown is itself fatal:
                    # the pipeline can no longer make progress
                    self._fail(PipelineError(
                        "pipeline stage loop exited unexpectedly"), failed)
                except Exception as e:  # noqa: BLE001 — stage death
                    self._fail(e if isinstance(e, RayError) else
                               PipelineError(f"pipeline stage failed: {e}"),
                               failed)
                return

    def _fail(self, error: BaseException,
              failed: Optional[int] = None) -> None:
        """Poison every channel, so every party blocked on one raises.
        ``failed`` is the index of the rank whose loop ended, if one
        did."""
        if self._error is not None:
            return
        from ray_tpu_torch.dag import channel as ch

        self._error = error
        self._channels.poison_all(ch.pickle_error(error))
        if self.ranks_per_stage > 1:
            self._reaper = threading.Thread(
                target=self._stop_stuck_ranks,
                args=(failed, list(self._loop_refs)),
                name=f"rt-pipeline-reaper-{self._run_id}", daemon=True)
            self._reaper.start()

    def _stop_stuck_ranks(self, failed: Optional[int],
                          refs: List[Any]) -> None:
        """A rank blocked inside a collective of its stage's group is
        out of the poisoned channels' reach: end the process of every
        peer of the failed rank whose loop is still running, at once,
        and of every other rank whose loop has not returned within
        ``STUCK_RANK_GRACE_S`` (a force-cancel of its loop task ends
        its worker).  A rank so ended restarts where ``max_restarts``
        allows, and ``resume`` forms its group again."""
        import ray_tpu_torch

        n = self.ranks_per_stage
        peers: List[int] = []
        if failed is not None:
            first = failed - failed % n
            peers = [i for i in range(first, first + n) if i != failed]
        rest = [i for i in range(len(refs))
                if i not in peers and i != failed]

        def end_if_running(i: int) -> None:
            ready, _ = ray_tpu_torch.wait([refs[i]], timeout=0)
            if not ready:
                ray_tpu_torch.cancel(refs[i], force=True)

        try:
            for i in peers:
                end_if_running(i)
            ray_tpu_torch.wait([refs[i] for i in rest],
                               num_returns=len(rest),
                               timeout=STUCK_RANK_GRACE_S)
            for i in rest:
                end_if_running(i)
        except Exception:  # noqa: BLE001 — the driver is shutting down
            pass

    def _ended_loop_error(self, timeout: float = 2.0
                          ) -> Optional[BaseException]:
        """The error of a stage loop that has ended (waiting up to
        ``timeout`` for one to end), or None."""
        import ray_tpu_torch

        ready, _ = ray_tpu_torch.wait(list(self._loop_refs), num_returns=1,
                                      timeout=timeout)
        for ref in ready:
            try:
                ray_tpu_torch.get(ref, timeout=0)
            except Exception as e:  # noqa: BLE001 — handed to the caller
                return e
        return None

    def _check_failure(self) -> None:
        if self._error is not None:
            raise self._error
        if self._torn_down:
            raise PipelineError("this TrainPipeline has been torn down")

    # ----------------------------------------------------------- training

    @property
    def global_batch_size(self) -> int:
        return self.microbatch_size * self.num_microbatches

    def step(self, tokens) -> Dict[str, Any]:
        """One optimizer step: split ``tokens`` [B, S] into microbatches,
        stream them through the pipeline, read every stage's report.
        Returns loss (last stage), wall time, tokens/s, bubble %, and
        the raw per-stage reports."""
        import numpy as np

        from ray_tpu_torch._private.metrics import pipeline_metrics
        from ray_tpu_torch.dag import channel as ch

        self._check_failure()
        tokens = np.ascontiguousarray(tokens)
        B = tokens.shape[0]
        if B != self.global_batch_size:
            raise ValueError(
                f"batch dim {B} != microbatch_size*num_microbatches "
                f"({self.global_batch_size})")
        mb = self.microbatch_size
        t0 = time.perf_counter()
        for k in range(self.num_microbatches):
            self._in_writer.write(tokens[k * mb:(k + 1) * mb],
                                  check=self._check_failure)
        want = self._local_step + 1
        reports = []
        try:
            for reader in self._rep_readers:
                left = max(0.1, self._step_timeout
                           - (time.perf_counter() - t0))
                value, is_err = reader.read(want, timeout=left,
                                            check=self._check_failure,
                                            copy=True)
                if is_err:
                    raise value
                reader.advance(want)
                reports.append(value)
        except BaseException as e:
            # the microbatch writes already landed, so a retried step()
            # would feed the stages a SECOND batch they treat as the
            # next step — driver and stage sequence state desync with
            # loss attribution silently shifted by one.  Fail the
            # pipeline instead; checkpointed runs recover via resume().
            if self._error is None and not self._torn_down:
                # a report ring closes when its stage's loop ends: that
                # loop's own error says why
                cause = (self._ended_loop_error()
                         if isinstance(e, ch.ChannelClosedError) else None)
                self._fail(cause or (
                    e if isinstance(e, RayError) else
                    PipelineError(f"step {want} failed mid-flight "
                                  f"(stage reports unread): {e}")))
                if cause is not None:
                    raise cause from e
            raise
        wall = time.perf_counter() - t0
        self._local_step = want
        self._global_step = reports[-1]["step"]
        busy = [r["busy_s"] for r in reports]
        bubble = bubble_pct(busy, wall)
        gauge, busy_counter = pipeline_metrics()
        for r in reports:
            gauge.set(100.0 * max(0.0, 1.0 - r["busy_s"] / wall)
                      if wall > 0 else 0.0,
                      tags={"stage": str(r["stage"])})
            for phase in ("fwd", "bwd", "opt"):
                busy_counter.inc(r[f"{phase}_s"],
                                 tags={"stage": str(r["stage"]),
                                       "phase": phase})
        gauge.set(bubble, tags={"stage": "all"})
        return {
            "step": self._global_step,
            "loss": reports[-1]["loss"],
            "wall_s": wall,
            "tokens_per_s": B * self.seq_len / wall if wall > 0 else 0.0,
            "bubble_pct": bubble,
            "per_stage": reports,
        }

    # ----------------------------------------------------------- recovery

    def resume(self, timeout: float = 300.0) -> int:
        """After a stage death: form each stage's process group again
        (stages over several devices), roll every rank back to the
        newest COMMON snapshot step, rebuild fresh channels, reinstall
        the loops.  Returns the resumed step.  Requires checkpointing
        (``save_every > 0``) and restartable actors."""
        import ray_tpu_torch
        from ray_tpu_torch import api as _api

        if self._torn_down:
            raise PipelineError("this TrainPipeline has been torn down")
        if self._error is None:
            return self._global_step
        if self._save_every <= 0:
            raise PipelineError(
                "cannot resume without stage checkpointing — construct "
                "with max_restarts>0 (or save_every>0)")
        deadline = time.monotonic() + timeout
        self._monitor_stop.set()
        if self._reaper is not None:
            self._reaper.join(timeout=max(1.0, deadline - time.monotonic()))
        # old loops are dead or draining after the poison; wait them out
        if self._loop_refs:
            ray_tpu_torch.wait(self._loop_refs, num_returns=len(self._loop_refs),
                         timeout=max(1.0, deadline - time.monotonic()))
        if self._in_writer is not None:
            self._in_writer.detach()
        w = _api._worker()
        for h in self._handles:  # restarted stages must be ALIVE again
            while True:
                try:
                    info = w.head.call("get_actor_info",
                                       actor_id=h._actor_id)
                except Exception as e:
                    raise PipelineError(f"head unreachable: {e}")
                if info.get("state") == "ALIVE":
                    break
                if info.get("state") == "DEAD" \
                        or time.monotonic() >= deadline:
                    raise PipelineError(
                        f"stage actor {h._actor_id[:12]} did not restart "
                        f"(state {info.get('state')})")
                time.sleep(0.2)
        self._form_groups(timeout=max(1.0, deadline - time.monotonic()))
        step_sets = []
        for h in self._handles:
            reply = self._ctl(h, {"op": "snapshot_steps"},
                              timeout=max(1.0,
                                          deadline - time.monotonic()))
            step_sets.append(set(reply["steps"]))
        common = sorted(set.intersection(*step_sets)) if step_sets else []
        if not common:
            raise PipelineError(
                f"no common snapshot step across stages: {step_sets}")
        target = common[-1]
        for h in self._handles:
            reply = self._ctl(h, {"op": "load_snapshot", "step": target},
                              timeout=max(1.0,
                                          deadline - time.monotonic()))
            if not reply.get("ok"):
                raise PipelineError(
                    f"stage failed to load snapshot step {target}")
        from ray_tpu_torch.dag.execution import _unregister_live_channels

        _unregister_live_channels(id(self))
        self._channels.destroy_all()
        self._generation += 1
        self._error = None
        self._wire(start_step=target,
                   timeout=max(1.0, deadline - time.monotonic()))
        return target

    # ----------------------------------------------------------- teardown

    def teardown(self, timeout: Optional[float] = None) -> None:
        """Synchronous + idempotent: close channels (loops drain and
        return), kill stage actors, free every pinned slot."""
        import ray_tpu_torch
        from ray_tpu_torch import api as _api
        from ray_tpu_torch._private.config import config

        with self._teardown_lock:
            if self._torn_down:
                return
            self._torn_down = True
        from ray_tpu_torch.dag.execution import _unregister_live_channels

        # this pipeline no longer claims its slots: failed destroys
        # below get flagged leaked by the accounting layer (correctly)
        _unregister_live_channels(id(self))
        self._monitor_stop.set()
        timeout = (float(config.dag_teardown_timeout_s)
                   if timeout is None else timeout)
        deadline = time.monotonic() + timeout
        self._channels.poison_all(close_only=True)
        refs = list(self._loop_refs)
        if refs:
            _ready, pending = ray_tpu_torch.wait(
                refs, num_returns=len(refs),
                timeout=max(0.1, deadline - time.monotonic()))
            for ref in pending:
                try:
                    ray_tpu_torch.cancel(ref, force=True)
                except Exception:
                    pass
        for h in getattr(self, "_handles", []):
            try:
                ray_tpu_torch.kill(h)
            except Exception:
                pass
        try:
            w = _api._worker()
        except Exception:
            w = None
        if w is not None:
            for h in getattr(self, "_handles", []):
                while time.monotonic() < deadline:
                    try:
                        info = w.head.call("get_actor_info",
                                           actor_id=h._actor_id)
                    except Exception:
                        break
                    if info.get("state") == "DEAD":
                        break
                    time.sleep(0.05)
        self._handles = []
        self._channels.destroy_all()
        if self._in_writer is not None:
            self._in_writer.detach()
        self._channels.close()
        if self._monitor is not None \
                and self._monitor is not threading.current_thread():
            self._monitor.join(timeout=1.0)

    def __del__(self):
        try:
            if not self._torn_down:
                self.teardown(timeout=2.0)
        except Exception:
            pass
