"""Trial schedulers: FIFO, ASHA early stopping, and PBT.

Equivalent of the reference's schedulers
(reference: python/ray/tune/schedulers/async_hyperband.py ASHA,
pbt.py PopulationBasedTraining, trial_scheduler.py decision protocol):
on_result returns CONTINUE or STOP; ASHA prunes trials that fall below
the top fraction at each rung; PBT stops bottom-quantile trials and
clones top performers with perturbed configs (the Tuner launches the
clones it pops from the scheduler).
"""

from __future__ import annotations

import math
import random
from typing import Any, Callable, Dict, List, Optional, Union

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_result(self, trial_id: str, result: Dict) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        pass


class ASHAScheduler:
    """Asynchronous Successive Halving.

    Rungs at max_t / reduction_factor^k; a trial reaching a rung is
    stopped unless its metric is in the top 1/reduction_factor of all
    results recorded at that rung so far.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4,
                 time_attr: str = "training_iteration"):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        # rung milestone -> list of recorded metric values
        self.rungs: Dict[int, List[float]] = {}
        milestones = []
        t = grace_period
        while t < max_t:
            milestones.append(t)
            t *= reduction_factor
        self.milestones = milestones
        self._trial_rungs: Dict[str, int] = {}

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP  # budget exhausted (not a pruning decision)
        decision = CONTINUE
        for rung in self.milestones:
            if t >= rung and self._trial_rungs.get(trial_id, -1) < rung:
                self._trial_rungs[trial_id] = rung
                recorded = self.rungs.setdefault(rung, [])
                recorded.append(float(value))
                if not self._in_top_fraction(float(value), recorded):
                    decision = STOP
        return decision

    def _in_top_fraction(self, value: float, recorded: List[float]) -> bool:
        if len(recorded) < self.rf:
            return True  # not enough evidence to prune yet
        k = max(1, math.floor(len(recorded) / self.rf))
        ordered = sorted(recorded, reverse=(self.mode == "max"))
        cutoff = ordered[k - 1]
        return value <= cutoff if self.mode == "min" else value >= cutoff

    def on_trial_complete(self, trial_id: str) -> None:
        self._trial_rungs.pop(trial_id, None)


class PopulationBasedTraining:
    """PBT: exploit + explore over a live population
    (reference: tune/schedulers/pbt.py — at each perturbation interval,
    bottom-quantile trials copy a top performer's checkpoint and a
    perturbed copy of its config).

    Runs on the stop-and-clone protocol: a trial chosen to exploit is
    STOPped and the scheduler queues a clone spec — donor config with
    mutations applied, donor checkpoint under "__restore_checkpoint__";
    the Tuner pops clones via pop_clones() and launches them as fresh
    trials, keeping the population size constant.
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 perturbation_interval: int = 2,
                 quantile_fraction: float = 0.25,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 time_attr: str = "training_iteration", seed: int = 0):
        assert mode in ("min", "max")
        assert 0 < quantile_fraction <= 0.5
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.quantile = quantile_fraction
        self.mutations = hyperparam_mutations or {}
        self.time_attr = time_attr
        self._rng = random.Random(seed)
        # trial_id -> latest (score, t, config, checkpoint)
        self._state: Dict[str, Dict[str, Any]] = {}
        self._last_perturb: Dict[str, int] = {}
        self._clones: List[Dict[str, Any]] = []

    def on_trial_state(self, trial_id: str, config: Dict[str, Any],
                       checkpoint: Optional[str]) -> None:
        """Tuner hook: the scheduler needs configs + checkpoints to
        build exploit clones."""
        st = self._state.setdefault(trial_id, {})
        st["config"] = config
        st["checkpoint"] = checkpoint

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        st = self._state.setdefault(trial_id, {})
        st["score"] = float(value)
        st["t"] = int(t)
        if t - self._last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = int(t)
        scored = [(tid, s) for tid, s in self._state.items()
                  if "score" in s and s.get("config") is not None]
        k = max(1, int(len(scored) * self.quantile))
        if len(scored) < 2 * k:
            return CONTINUE  # population too small to rank reliably
        ordered = sorted(scored, key=lambda kv: kv[1]["score"],
                         reverse=(self.mode == "max"))
        top = ordered[:k]
        # only live trials can be stopped; finished ones still rank and
        # donate (fast trainables may complete before peers report)
        bottom = {tid for tid, s in ordered[-k:] if not s.get("done")}
        if trial_id not in bottom:
            return CONTINUE
        donor_id, donor = self._rng.choice(top)
        if donor_id == trial_id:
            return CONTINUE
        clone_config = self._explore(dict(donor["config"]))
        clone_config.pop("__restore_checkpoint__", None)
        if donor.get("checkpoint"):
            clone_config["__restore_checkpoint__"] = donor["checkpoint"]
        self._clones.append({"config": clone_config, "exploited": trial_id,
                             "donor": donor_id})
        self._state.pop(trial_id, None)  # replaced; drop from ranking
        return STOP

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Perturb mutated hyperparams by 1.2x/0.8x or resample
        (reference: pbt.py explore())."""
        for key, spec in self.mutations.items():
            if callable(spec):
                config[key] = spec()
            elif isinstance(spec, (list, tuple)):
                config[key] = self._rng.choice(list(spec))
            elif isinstance(config.get(key), (int, float)):
                factor = self._rng.choice([0.8, 1.2])
                val = config[key] * factor
                config[key] = type(config[key])(val) \
                    if isinstance(config[key], int) else val
        return config

    def pop_clones(self) -> List[Dict[str, Any]]:
        out, self._clones = self._clones, []
        return out

    def on_trial_complete(self, trial_id: str) -> None:
        # keep the record: finished trials still rank and donate
        st = self._state.get(trial_id)
        if st is not None:
            st["done"] = True
