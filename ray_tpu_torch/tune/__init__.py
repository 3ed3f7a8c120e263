"""ray_tpu_torch.tune: hyperparameter search over trial actors.

Equivalent of Ray Tune (reference: python/ray/tune/ — Tuner tuner.py,
TuneController execution/tune_controller.py:69, searchers search/,
schedulers schedulers/): trials are actors running the user trainable
with a report channel; the controller loop launches/polls/stops trials
under a concurrency cap; ASHA prunes at rungs.
"""

from ray_tpu_torch.tune.search import (Domain, choice, grid_search, loguniform,
                                 randint, uniform)
from ray_tpu_torch.tune.schedulers import (ASHAScheduler, FIFOScheduler,
                                     PopulationBasedTraining)
from ray_tpu_torch.tune.tuner import (ResultGrid, TrialResult, TuneConfig, Tuner)

__all__ = ["Tuner", "TuneConfig", "ResultGrid", "TrialResult",
           "grid_search", "choice", "uniform", "loguniform", "randint",
           "ASHAScheduler", "FIFOScheduler", "PopulationBasedTraining",
           "Domain"]
