"""Search-space DSL + basic variant generation.

Equivalent of the reference's sample.py domains and basic_variant.py
(reference: python/ray/tune/search/sample.py, basic_variant.py):
grid_search expands cartesian products; stochastic domains sample per
trial.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Optional, Sequence


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class _Choice(Domain):
    def __init__(self, options: Sequence[Any]):
        self.options = list(options)

    def sample(self, rng):
        return rng.choice(self.options)


class _Uniform(Domain):
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class _LogUniform(Domain):
    def __init__(self, low: float, high: float):
        import math

        self.lo, self.hi = math.log(low), math.log(high)

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(self.lo, self.hi))


class _RandInt(Domain):
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


class _Grid:
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


def choice(options: Sequence[Any]) -> Domain:
    return _Choice(options)


def uniform(low: float, high: float) -> Domain:
    return _Uniform(low, high)


def loguniform(low: float, high: float) -> Domain:
    return _LogUniform(low, high)


def randint(low: int, high: int) -> Domain:
    return _RandInt(low, high)


def grid_search(values: Sequence[Any]) -> _Grid:
    return _Grid(values)


def generate_variants(param_space: Dict[str, Any], num_samples: int,
                      seed: Optional[int] = None) -> List[Dict[str, Any]]:
    """Grid axes expand combinatorially; each combination is repeated
    num_samples times with stochastic domains re-sampled (reference:
    basic_variant.py semantics)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items() if isinstance(v, _Grid)]
    grid_values = [param_space[k].values for k in grid_keys]
    combos = list(itertools.product(*grid_values)) if grid_keys else [()]
    out: List[Dict[str, Any]] = []
    for combo in combos:
        for _ in range(num_samples):
            cfg: Dict[str, Any] = {}
            for k, v in param_space.items():
                if isinstance(v, _Grid):
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            out.append(cfg)
    return out
