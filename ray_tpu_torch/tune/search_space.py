"""Search space primitives + variant generation (port of
``ray_tpu/tune/search_space.py``).

Reference parity: ``python/ray/tune/search/sample.py`` (Domain classes:
uniform/loguniform/randint/choice/...), ``grid_search`` markers, and the
``BasicVariantGenerator`` grid×sample expansion
(``tune/search/basic_variant.py``).

The draws are the reference's, one for one: every domain samples from
the numpy ``Generator`` it is handed, and ``generate_variants``
(``ray_tpu/tune/search_space.py:106``) seeds one ``default_rng`` and walks
the space in the same order, so a seed gives the JAX package's variants
in the same order (``tests/test_torch_tune.py``).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional

import numpy as np


class Domain:
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError


class Uniform(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))


class QUniform(Domain):
    def __init__(self, low, high, q):
        self.low, self.high, self.q = low, high, q

    def sample(self, rng):
        v = rng.uniform(self.low, self.high)
        return float(np.round(v / self.q) * self.q)


class LogUniform(Domain):
    def __init__(self, low, high):
        if low <= 0 or high <= 0:
            raise ValueError("loguniform bounds must be positive")
        self.low, self.high = low, high

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))


class RandInt(Domain):
    def __init__(self, low, high):
        self.low, self.high = low, high

    def sample(self, rng):
        return int(rng.integers(self.low, self.high))


class Choice(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return self.categories[int(rng.integers(0, len(self.categories)))]


class SampleFrom(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None)


def uniform(low, high) -> Uniform:
    return Uniform(low, high)


def quniform(low, high, q) -> QUniform:
    return QUniform(low, high, q)


def loguniform(low, high) -> LogUniform:
    return LogUniform(low, high)


def randint(low, high) -> RandInt:
    return RandInt(low, high)


def choice(categories) -> Choice:
    return Choice(categories)


def sample_from(fn) -> SampleFrom:
    return SampleFrom(fn)


def grid_search(values: list) -> dict:
    return {"grid_search": list(values)}


def _is_grid(v) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


def generate_variants(
    param_space: Dict[str, Any],
    num_samples: int = 1,
    seed: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Cross-product of grid_search values × num_samples draws of sampled
    domains (BasicVariantGenerator semantics: grids multiply, samples
    repeat)."""
    rng = np.random.default_rng(seed)
    grid_keys = [k for k, v in param_space.items() if _is_grid(v)]
    grid_values = [param_space[k]["grid_search"] for k in grid_keys]
    combos = list(itertools.product(*grid_values)) if grid_keys else [()]
    variants = []
    for _ in range(num_samples):
        for combo in combos:
            cfg = {}
            for k, v in param_space.items():
                if k in grid_keys:
                    cfg[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                elif isinstance(v, dict) and not _is_grid(v):
                    cfg[k] = generate_variants(v, 1, int(rng.integers(1 << 31)))[0]
                else:
                    cfg[k] = v
            variants.append(cfg)
    return variants
