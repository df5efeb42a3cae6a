"""Search-space primitives + variant generation.

Reference: python/ray/tune/search/sample.py (Domain/Float/Integer/
Categorical, grid_search) and search/basic_variant.py
(BasicVariantGenerator) — grid cross-products plus random sampling of
Domain leaves.

The port's copy of ``ray_tpu/tune/search_space.py``.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Dict, Iterator, List, Optional


class Domain:
    """A sampleable hyperparameter domain."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False,
                 q: Optional[float] = None):
        self.lower = lower
        self.upper = upper
        self.log = log
        self.q = q

    def sample(self, rng: random.Random) -> float:
        if self.log:
            import math
            v = math.exp(rng.uniform(math.log(self.lower),
                                     math.log(self.upper)))
        else:
            v = rng.uniform(self.lower, self.upper)
        if self.q:
            v = round(v / self.q) * self.q
        return v


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False):
        self.lower = lower
        self.upper = upper
        self.log = log

    def sample(self, rng: random.Random) -> int:
        if self.log:
            import math
            v = math.exp(rng.uniform(math.log(self.lower),
                                     math.log(self.upper)))
            return max(self.lower, min(self.upper - 1, int(v)))
        return rng.randrange(self.lower, self.upper)


class Categorical(Domain):
    def __init__(self, categories: List[Any]):
        self.categories = list(categories)

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.categories)


class Function(Domain):
    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def sample(self, rng: random.Random) -> Any:
        return self.fn()


class GridSearch:
    def __init__(self, values: List[Any]):
        self.values = list(values)


# ---- public constructors (reference: tune.uniform/choice/... sample.py) ----

def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def quniform(lower: float, upper: float, q: float) -> Float:
    return Float(lower, upper, q=q)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def choice(categories: List[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable[[], Any]) -> Function:
    return Function(fn)


def grid_search(values: List[Any]) -> Dict[str, Any]:
    return {"grid_search": list(values)}


def _is_grid(v) -> bool:
    return (isinstance(v, dict) and set(v.keys()) == {"grid_search"}) or \
        isinstance(v, GridSearch)


def _grid_values(v) -> List[Any]:
    return v.values if isinstance(v, GridSearch) else v["grid_search"]


def generate_variants(space: Dict[str, Any], num_samples: int = 1,
                      seed: Optional[int] = None
                      ) -> Iterator[Dict[str, Any]]:
    """Yield resolved configs: the grid cross-product, repeated
    ``num_samples`` times, with Domain leaves re-sampled per repeat
    (reference: BasicVariantGenerator semantics — num_samples multiplies
    the grid)."""
    rng = random.Random(seed)

    grid_keys: List[List[str]] = []
    grid_vals: List[List[Any]] = []

    def walk(prefix: List[str], node: Any):
        if isinstance(node, dict) and not _is_grid(node):
            for k, v in node.items():
                walk(prefix + [k], v)
        elif _is_grid(node):
            grid_keys.append(list(prefix))
            grid_vals.append(_grid_values(node))

    walk([], space)

    def resolve(node: Any, assignment: Dict[tuple, Any],
                path: List[str]) -> Any:
        if _is_grid(node):
            return assignment[tuple(path)]
        if isinstance(node, dict):
            return {k: resolve(v, assignment, path + [k])
                    for k, v in node.items()}
        if isinstance(node, Domain):
            return node.sample(rng)
        return node

    combos = list(itertools.product(*grid_vals)) if grid_vals else [()]
    for _ in range(max(1, num_samples)):
        for combo in combos:
            assignment = {tuple(k): v
                          for k, v in zip(grid_keys, combo)}
            yield resolve(space, assignment, [])
