"""Tuner + trial controller.

Equivalent of the reference's Tuner/TuneController
(reference: python/ray/tune/tuner.py; execution/tune_controller.py:69 —
step :667 launches trial actors, dispatches train, reacts to results).
Trials reuse the TrainWorker actor (run_async/poll/request_stop), so a
trial IS a 1-worker training run — mirroring the reference where Train
execution *is* Tune execution (base_trainer.py:567).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

from ray_tpu_torch.tune.schedulers import CONTINUE, FIFOScheduler, STOP
from ray_tpu_torch.tune.search import generate_variants


@dataclass
class TuneConfig:
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    metric: str = "loss"
    mode: str = "min"
    scheduler: Optional[Any] = None
    seed: Optional[int] = None


@dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any] = field(default_factory=dict)
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    state: str = "PENDING"  # RUNNING/TERMINATED/STOPPED/ERROR
    error: Optional[str] = None
    checkpoint: Optional[str] = None


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: str, mode: str):
        self.results = results
        self._metric = metric
        self._mode = mode

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [r for r in self.results
                  if r.state in ("TERMINATED", "STOPPED")
                  and metric in r.metrics]
        if not scored:
            raise ValueError("no successful trial reported "
                             f"metric {metric!r}")
        return (min if mode == "min" else max)(
            scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self.results:
            row = {"trial_id": r.trial_id, "state": r.state, **r.metrics}
            row.update({f"config/{k}": v for k, v in r.config.items()})
            rows.append(row)
        return pd.DataFrame(rows)

    def __len__(self):
        return len(self.results)

    def __iter__(self):
        return iter(self.results)


class _Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any]):
        self.id = trial_id
        self.config = config
        self.result = TrialResult(trial_id, config)
        self.actor = None
        self.iteration = 0
        self.stopping = False


class Tuner:
    def __init__(self, trainable: Callable[[Dict[str, Any]], Any],
                 *, param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 storage_path: Optional[str] = None,
                 name: Optional[str] = None,
                 _restored_state: Optional[Dict[str, Any]] = None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.resources_per_trial = resources_per_trial
        self.name = name or "tune_experiment"
        self.storage_path = storage_path
        self._restored_state = _restored_state

    # ---- experiment persistence --------------------------------------------
    # Reference: tune/execution/experiment_state.py — periodic experiment
    # snapshots make `Tuner.restore` possible: finished trials keep their
    # results, interrupted ones re-run.

    @property
    def _experiment_dir(self) -> Optional[str]:
        import os

        if not self.storage_path:
            return None
        d = os.path.join(self.storage_path, self.name)
        os.makedirs(d, exist_ok=True)
        return d

    def _save_experiment(self, trials: List["_Trial"]) -> None:
        import os

        d = self._experiment_dir
        if d is None:
            return
        snap = {
            "param_space": self.param_space,
            "tune_config": self.tune_config,
            "trials": [{"id": t.id, "config": t.config, "result": t.result}
                       for t in trials],
        }
        tmp = os.path.join(d, ".experiment_state.tmp")
        with open(tmp, "wb") as f:
            f.write(cloudpickle.dumps(snap))
        os.replace(tmp, os.path.join(d, "experiment_state.pkl"))

    @classmethod
    def restore(cls, path: str, trainable: Callable[[Dict[str, Any]], Any],
                *, resources_per_trial: Optional[Dict[str, float]] = None
                ) -> "Tuner":
        """Resume an experiment from its snapshot directory
        (reference: Tuner.restore).  Completed trials keep their
        recorded results; unfinished ones run again."""
        import os

        state_file = os.path.join(path, "experiment_state.pkl")
        with open(state_file, "rb") as f:
            snap = cloudpickle.loads(f.read())
        return cls(trainable,
                   param_space=snap["param_space"],
                   tune_config=snap["tune_config"],
                   resources_per_trial=resources_per_trial,
                   storage_path=os.path.dirname(path.rstrip("/")),
                   name=os.path.basename(path.rstrip("/")),
                   _restored_state=snap)

    def _build_trials(self) -> (List["_Trial"], List["_Trial"]):
        """-> (to_run, already_finished)"""
        tc = self.tune_config
        if self._restored_state is None:
            variants = generate_variants(self.param_space, tc.num_samples,
                                         tc.seed)
            return [_Trial(f"trial_{i:05d}", cfg)
                    for i, cfg in enumerate(variants)], []
        to_run, done = [], []
        for rec in self._restored_state["trials"]:
            t = _Trial(rec["id"], rec["config"])
            if rec["result"].state in ("TERMINATED", "STOPPED"):
                t.result = rec["result"]
                done.append(t)
            else:
                if rec["result"].checkpoint:
                    # interrupted mid-run: resume from its last checkpoint
                    t.config = dict(t.config)
                    t.config["__restore_checkpoint__"] = \
                        rec["result"].checkpoint
                    t.result.checkpoint = rec["result"].checkpoint
                to_run.append(t)
        return to_run, done

    def fit(self) -> ResultGrid:
        import ray_tpu_torch
        from ray_tpu_torch.train.worker_group import TrainWorker

        tc = self.tune_config
        scheduler = tc.scheduler or FIFOScheduler()
        trials, finished_restored = self._build_trials()
        cap = tc.max_concurrent_trials or min(8, max(1, len(trials) or 1))
        fn_blob = cloudpickle.dumps(self.trainable)
        actor_cls = ray_tpu_torch.remote(TrainWorker)
        if self.resources_per_trial:
            actor_cls = actor_cls.options(resources=self.resources_per_trial)

        # resume-safe: continue numbering after any restored clone ids
        clone_counter = max(
            [int(t.id.split("_")[1]) for t in trials + finished_restored
             if t.id.startswith("clone_")] or [0])
        pending = list(trials)
        running: List[_Trial] = []
        finished: List[_Trial] = list(finished_restored)
        dirty = False
        last_save = 0.0
        while pending or running:
            # launch up to the concurrency cap
            # (reference: _schedule_trial_actor tune_controller.py:965)
            while pending and len(running) < cap:
                t = pending.pop(0)
                try:
                    t.actor = actor_cls.remote(0, 1)
                    t.result.state = "RUNNING"
                    ray_tpu_torch.get(t.actor.run_async.remote(fn_blob, t.config),
                                timeout=120)
                except ray_tpu_torch.RayError as e:
                    # placement failure must cost only this trial, not the
                    # whole experiment's completed results
                    t.result.state = "ERROR"
                    t.result.error = str(e)
                    if t.actor is not None:
                        try:
                            ray_tpu_torch.kill(t.actor)
                        except Exception:
                            pass
                    finished.append(t)
                    continue
                running.append(t)
            time.sleep(0.02)
            for t in list(running):
                try:
                    poll = ray_tpu_torch.get(t.actor.poll.remote(), timeout=60)
                except ray_tpu_torch.RayError as e:
                    t.result.state = "ERROR"
                    t.result.error = str(e)
                    running.remove(t)
                    finished.append(t)
                    continue
                if poll["reports"]:
                    dirty = True
                self._ingest(t, poll, scheduler)
                if poll["done"]:
                    if poll["error"] is not None and t.result.state != "STOPPED":
                        t.result.state = "ERROR"
                        t.result.error = repr(cloudpickle.loads(poll["error"]))
                    elif t.result.state == "RUNNING":
                        t.result.state = "TERMINATED"
                    scheduler.on_trial_complete(t.id)
                    running.remove(t)
                    finished.append(t)
                    dirty = True
                    ray_tpu_torch.kill(t.actor)
            # PBT-style schedulers queue clone specs (exploit+explore);
            # launch them as fresh trials to keep the population size
            for spec in (scheduler.pop_clones()
                         if hasattr(scheduler, "pop_clones") else []):
                clone_counter += 1
                clone = _Trial(f"clone_{clone_counter:05d}", spec["config"])
                trials.append(clone)
                pending.append(clone)
                dirty = True
            # debounced: snapshotting pickles every trial's history, so
            # only write when something changed and at most ~1/s
            if dirty and time.monotonic() - last_save >= 1.0:
                dirty = False
                last_save = time.monotonic()
                self._save_experiment(trials + finished_restored)
        self._save_experiment(trials + finished_restored)
        return ResultGrid([t.result for t in finished], tc.metric, tc.mode)

    def _ingest(self, t: _Trial, poll: Dict[str, Any], scheduler) -> None:
        import ray_tpu_torch

        for rep in poll["reports"]:
            metrics = rep["metrics"]
            if "_error" in metrics:
                continue
            t.iteration += 1
            metrics = dict(metrics)
            metrics.setdefault("training_iteration", t.iteration)
            t.result.metrics = metrics
            t.result.metrics_history.append(metrics)
            if rep.get("checkpoint"):
                t.result.checkpoint = rep["checkpoint"]
            if hasattr(scheduler, "on_trial_state"):
                scheduler.on_trial_state(t.id, t.config, t.result.checkpoint)
            if not t.stopping and scheduler.on_result(t.id, metrics) == STOP:
                t.stopping = True
                t.result.state = "STOPPED"
                try:
                    ray_tpu_torch.get(t.actor.request_stop.remote(), timeout=30)
                except ray_tpu_torch.RayError:
                    pass
