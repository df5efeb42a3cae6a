"""Pluggable search algorithms (reference: python/ray/tune/search/ —
Searcher base searcher.py:40, BasicVariantGenerator basic_variant.py, and
the Optuna/HyperOpt integrations whose role the built-in TPE fills here,
since no external search library ships in this image).

A Searcher proposes configs one trial at a time and learns from completed
results, so proposals sharpen as the experiment progresses (vs the
variant generator's up-front sampling).

The port's copy of ``ray_tpu/tune/search.py``.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.search_space import (Categorical, Domain, Float,
                                             Integer, _is_grid,
                                             generate_variants)


class Searcher:
    """Interface: suggest(trial_id) -> config | None (None = budget done);
    on_trial_complete(trial_id, result) feeds the metric back."""

    def set_experiment(self, space: Dict[str, Any], metric: str, mode: str,
                       num_samples: int, seed: Optional[int]):
        self._space = space
        self._metric = metric
        self._mode = mode
        self._num_samples = num_samples
        self._seed = seed

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]):
        pass

    def on_restore(self, num_existing: int):
        """Called after an experiment restore with the number of trials
        already created, so the suggestion budget accounts for them."""
        pass


class BasicVariantGenerator(Searcher):
    """Random/grid sampling behind the Searcher interface (reference:
    tune/search/basic_variant.py)."""

    def set_experiment(self, space, metric, mode, num_samples, seed):
        super().set_experiment(space, metric, mode, num_samples, seed)
        self._variants = generate_variants(space, num_samples, seed)

    def suggest(self, trial_id: str):
        try:
            return next(self._variants)
        except StopIteration:
            return None

    def on_restore(self, num_existing: int):
        for _ in range(num_existing):
            next(self._variants, None)


def _flatten(space: Dict[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], Any]:
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in space.items():
        if isinstance(v, dict) and not _is_grid(v):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _set_path(cfg: Dict[str, Any], path: Tuple[str, ...], value: Any):
    d = cfg
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator (independent per dimension).

    Completed trials are split into good/bad by the gamma quantile of the
    metric; numeric dimensions model each group with a Gaussian KDE and
    propose the candidate maximizing l(x)/g(x); categorical dimensions use
    smoothed count ratios. The first ``n_startup`` trials sample randomly.
    """

    def __init__(self, n_startup: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24):
        self._n_startup = n_startup
        self._gamma = gamma
        self._n_cand = n_candidates
        self._obs: List[Tuple[Dict[Tuple[str, ...], Any], float]] = []
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._count = 0

    def set_experiment(self, space, metric, mode, num_samples, seed):
        super().set_experiment(space, metric, mode, num_samples, seed)
        self._rng = random.Random(seed)
        self._dims = _flatten(space)
        for path, dom in self._dims.items():
            if _is_grid(dom):
                raise ValueError(
                    f"TPESearcher does not support grid_search (at "
                    f"{'.'.join(path)}); use tune.choice() so the searcher "
                    f"can model the dimension")

    # ---- proposal -----------------------------------------------------------

    def suggest(self, trial_id: str):
        if self._count >= self._num_samples:
            return None
        self._count += 1
        cfg: Dict[str, Any] = {}
        use_tpe = len(self._obs) >= self._n_startup
        split = self._split() if use_tpe else None
        flat: Dict[Tuple[str, ...], Any] = {}
        for path, dom in self._dims.items():
            if isinstance(dom, (Float, Integer)) and use_tpe:
                value = self._suggest_numeric(path, dom, split)
            elif isinstance(dom, Categorical) and use_tpe:
                value = self._suggest_categorical(path, dom, split)
            elif isinstance(dom, Domain):
                value = dom.sample(self._rng)
            else:
                value = dom  # constant
            flat[path] = value
            _set_path(cfg, path, value)
        self._configs[trial_id] = flat
        return cfg

    def _split(self):
        ordered = sorted(self._obs, key=lambda o: o[1],
                         reverse=(self._mode == "max"))
        n_good = max(1, int(math.ceil(self._gamma * len(ordered))))
        return ordered[:n_good], ordered[n_good:]

    def _suggest_numeric(self, path, dom, split):
        good, bad = split
        log = getattr(dom, "log", False)

        def xform(v):
            return math.log(v) if log else float(v)

        lo, hi = xform(dom.lower), xform(dom.upper)
        if hi <= lo:  # degenerate domain: only one value exists
            return dom.sample(self._rng)
        gx = [xform(o[0][path]) for o in good if path in o[0]]
        bx = [xform(o[0][path]) for o in bad if path in o[0]]
        if not gx:
            return dom.sample(self._rng)
        # Scott-style bandwidth from the GOOD points' spread (floored):
        # the old (hi-lo)/sqrt(n) rule stayed range-wide for small n, and
        # clamping its out-of-range samples piled candidate mass on the
        # domain boundaries — an artificial attractor at lo/hi.
        if len(gx) > 1:
            mean = sum(gx) / len(gx)
            std = (sum((v - mean) ** 2 for v in gx) / len(gx)) ** 0.5
        else:
            std = 0.0
        bw = max(std * len(gx) ** -0.2, 0.05 * (hi - lo), 1e-12)

        def kde(xs, x):
            if not xs:
                return 1.0 / (hi - lo)
            s = sum(math.exp(-0.5 * ((x - xi) / bw) ** 2) for xi in xs)
            return s / (len(xs) * bw * math.sqrt(2 * math.pi)) + 1e-12

        best_x, best_score = None, -1.0
        for _ in range(self._n_cand):
            center = self._rng.choice(gx)
            # rejection sampling keeps the proposal INSIDE the domain
            # without boundary pile-up; fall back to clamp if unlucky
            for _try in range(8):
                x = self._rng.gauss(center, bw)
                if lo <= x <= hi:
                    break
            else:
                x = min(hi, max(lo, x))
            score = kde(gx, x) / kde(bx, x)
            if score > best_score:
                best_x, best_score = x, score
        v = math.exp(best_x) if log else best_x
        if isinstance(dom, Integer):
            return max(dom.lower, min(dom.upper - 1, int(round(v))))
        if getattr(dom, "q", None):
            v = round(v / dom.q) * dom.q
        return min(dom.upper, max(dom.lower, v))

    def _suggest_categorical(self, path, dom, split):
        good, bad = split
        cats = dom.categories

        def counts(obs):
            c = {repr(v): 1.0 for v in cats}  # +1 smoothing
            for o in obs:
                if path in o[0]:
                    c[repr(o[0][path])] = c.get(repr(o[0][path]), 1.0) + 1
            total = sum(c.values())
            return {k: v / total for k, v in c.items()}

    # pick the category maximizing p_good/p_bad
        pg, pb = counts(good), counts(bad)
        return max(cats, key=lambda v: pg[repr(v)] / pb[repr(v)])

    # ---- feedback -----------------------------------------------------------

    def on_trial_complete(self, trial_id, result):
        flat = self._configs.pop(trial_id, None)
        if flat is None or not result:
            return
        score = result.get(self._metric)
        if score is None:
            return
        self._obs.append((flat, float(score)))

    def observe(self, config: Dict[str, Any], score: float):
        """Feed an externally-known (config, score) pair — used when an
        interrupted experiment is restored."""
        self._obs.append((_flatten(config), float(score)))

    def register(self, trial_id: str, config: Dict[str, Any]):
        """Make an externally-created trial's config known so its eventual
        on_trial_complete lands in the model (restored in-flight trials)."""
        self._configs[trial_id] = _flatten(config)

    def on_restore(self, num_existing: int):
        self._count = max(self._count, num_existing)


class BOHBSearcher(TPESearcher):
    """Model-based half of BOHB (reference: the TuneBOHB searcher paired
    with schedulers/hb_bohb.py). BOHB fits its KDE model PER BUDGET and
    proposes from the largest budget with enough observations — a trial
    HyperBand stopped at a low rung reports a low score because of its
    short BUDGET, not its config, so mixing budgets in one model (plain
    TPE) poisons it. Observations are bucketed by training_iteration;
    ``suggest`` rebuilds the TPE observation set from the deepest bucket
    that has at least ``n_startup`` entries before proposing."""

    def __init__(self, n_startup: int = 6, gamma: float = 0.25,
                 n_candidates: int = 64):
        super().__init__(n_startup=n_startup, gamma=gamma,
                         n_candidates=n_candidates)
        self._by_budget: Dict[int, List[Tuple[dict, float]]] = {}

    def on_trial_complete(self, trial_id, result):
        flat = self._configs.pop(trial_id, None)
        if flat is None or not result:
            return
        score = result.get(self._metric)
        if score is None:
            return
        budget = int(result.get("training_iteration", 1))
        self._by_budget.setdefault(budget, []).append(
            (flat, float(score)))

    _RESTORED_BUDGET = 1 << 30  # restored trials ran to completion

    def observe(self, config, score):
        """Restored-experiment history (TuneController.restore_trials):
        completed trials count as deepest-budget observations so a
        restored BOHB search keeps its model instead of restarting
        random."""
        self._by_budget.setdefault(self._RESTORED_BUDGET, []).append(
            (_flatten(config), float(score)))

    def suggest(self, trial_id: str):
        # model on the deepest budget with enough data (reference: BOHB's
        # "use the KDE of the highest budget with sufficient points")
        self._obs = []
        for budget in sorted(self._by_budget, reverse=True):
            bucket = self._by_budget[budget]
            if len(bucket) >= max(4, self._n_startup // 2):
                self._obs = list(bucket)
                break
        else:
            # not enough at any single budget yet: pool the deepest few
            for budget in sorted(self._by_budget, reverse=True):
                self._obs.extend(self._by_budget[budget])
        return super().suggest(trial_id)


class GPSearcher(Searcher):
    """Gaussian-process Bayesian optimization with Expected Improvement
    (reference role: tune/search/bayesopt/bayesopt_search.py, which
    wraps the external ``bayesian-optimization`` package — this is the
    in-tree numpy implementation, closing the capability on merit since
    no external searcher library ships in this image).

    Model: zero-mean GP over the unit-cube encoding of the search space
    (numeric dims min-max scaled, log-aware; categoricals one-hot) with
    an RBF kernel and Cholesky-solved exact posterior; acquisition is
    Expected Improvement maximized over random candidates. Trials before
    ``n_startup`` sample randomly.
    """

    def __init__(self, n_startup: int = 6, n_candidates: int = 512,
                 length_scale: float = 0.25, noise: float = 1e-5,
                 xi: float = 0.01):
        self._n_startup = n_startup
        self._n_cand = n_candidates
        self._ls = float(length_scale)
        self._noise = float(noise)
        self._xi = float(xi)
        self._obs: List[Tuple[Dict[Tuple[str, ...], Any], float]] = []
        self._configs: Dict[str, Dict[Tuple[str, ...], Any]] = {}
        self._count = 0

    def set_experiment(self, space, metric, mode, num_samples, seed):
        super().set_experiment(space, metric, mode, num_samples, seed)
        self._rng = random.Random(seed)
        self._dims = _flatten(space)
        for path, dom in self._dims.items():
            if _is_grid(dom):
                raise ValueError(
                    f"GPSearcher does not support grid_search (at "
                    f"{'.'.join(path)}); use tune.choice() so the "
                    f"searcher can model the dimension")

    # ---- encoding -----------------------------------------------------------

    def _encode(self, flat: Dict[Tuple[str, ...], Any]) -> List[float]:
        x: List[float] = []
        for path, dom in sorted(self._dims.items()):
            v = flat.get(path)
            if isinstance(dom, (Float, Integer)):
                log = getattr(dom, "log", False)
                lo = math.log(dom.lower) if log else float(dom.lower)
                hi = math.log(dom.upper) if log else float(dom.upper)
                vv = math.log(v) if log else float(v)
                x.append((vv - lo) / (hi - lo) if hi > lo else 0.0)
            elif isinstance(dom, Categorical):
                for c in dom.categories:
                    x.append(1.0 if repr(v) == repr(c) else 0.0)
            # constants carry no information: skip
        return x

    # ---- proposal -----------------------------------------------------------

    def suggest(self, trial_id: str):
        if self._count >= self._num_samples:
            return None
        self._count += 1
        if len(self._obs) < self._n_startup:
            flat = {p: (d.sample(self._rng) if isinstance(d, Domain)
                        else d)
                    for p, d in self._dims.items()}
        else:
            flat = self._suggest_ei()
        cfg: Dict[str, Any] = {}
        for path, value in flat.items():
            _set_path(cfg, path, value)
        self._configs[trial_id] = flat
        return cfg

    def _suggest_ei(self) -> Dict[Tuple[str, ...], Any]:
        import numpy as np

        # internal convention: MINIMIZE standardized y
        ys = np.array([o[1] for o in self._obs], dtype=np.float64)
        if self._mode == "max":
            ys = -ys
        mu0, sd0 = float(ys.mean()), float(ys.std()) or 1.0
        ys = (ys - mu0) / sd0
        X = np.array([self._encode(o[0]) for o in self._obs],
                     dtype=np.float64)
        n, d = X.shape
        ls = self._ls * max(1.0, math.sqrt(d))

        def k(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / (ls * ls))

        K = k(X, X) + self._noise * np.eye(n)
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, ys))

        cands = [{p: (dom.sample(self._rng) if isinstance(dom, Domain)
                      else dom)
                  for p, dom in self._dims.items()}
                 for _ in range(self._n_cand)]
        Xc = np.array([self._encode(c) for c in cands], dtype=np.float64)
        Kc = k(Xc, X)                                  # [m, n]
        mu = Kc @ alpha
        v = np.linalg.solve(L, Kc.T)                   # [n, m]
        var = np.maximum(1.0 - (v * v).sum(0), 1e-12)
        s = np.sqrt(var)
        best = ys.min()
        z = (best - mu - self._xi) / s
        erf = np.vectorize(math.erf)
        cdf = 0.5 * (1.0 + erf(z / math.sqrt(2.0)))
        pdf = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
        ei = (best - mu - self._xi) * cdf + s * pdf
        return cands[int(np.argmax(ei))]

    # ---- feedback (same protocol as TPESearcher) ---------------------------

    def on_trial_complete(self, trial_id, result):
        flat = self._configs.pop(trial_id, None)
        if flat is None or not result:
            return
        score = result.get(self._metric)
        if score is None:
            return
        self._obs.append((flat, float(score)))

    def observe(self, config: Dict[str, Any], score: float):
        self._obs.append((_flatten(config), float(score)))

    def register(self, trial_id: str, config: Dict[str, Any]):
        self._configs[trial_id] = _flatten(config)

    def on_restore(self, num_existing: int):
        self._count = max(self._count, num_existing)
