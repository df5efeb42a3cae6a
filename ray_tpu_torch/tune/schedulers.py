"""Trial schedulers: FIFO, ASHA, median stopping, PBT.

Reference: python/ray/tune/schedulers/ — async_hyperband.py
(ASHAScheduler), median_stopping_rule.py, pbt.py
(PopulationBasedTraining). The controller calls ``on_result`` for every
report and acts on the returned decision; PBT additionally mutates trial
configs via exploit/explore with checkpoint cloning.

The port's copy of ``ray_tpu/tune/schedulers.py``.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def set_experiment(self, metric: str, mode: str):
        self.metric = metric
        self.mode = mode

    def _score(self, result: Dict[str, Any]) -> Optional[float]:
        v = result.get(self.metric)
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial):
        pass


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion (reference: FIFOScheduler)."""


class ASHAScheduler(TrialScheduler):
    """Asynchronous successive halving (reference:
    schedulers/async_hyperband.py AsyncHyperBandScheduler).

    Rungs at r, r*eta, r*eta^2, ... up to max_t; a trial reaching a rung
    is stopped unless its score is in the top 1/eta of scores recorded at
    that rung so far.
    """

    def __init__(self, *, time_attr: str = "training_iteration",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4.0):
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace = grace_period
        self.eta = reduction_factor
        self._rungs: List[tuple] = []  # (milestone, {trial_id: score})
        m = max_t
        milestones = []
        while m > grace_period:
            milestones.append(m)
            m = int(m / self.eta)
        milestones.append(grace_period)
        # ascending milestones paired with recorded scores
        self._rungs = [(ms, {}) for ms in sorted(milestones)]

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, trial.iterations)
        score = self._score(result)
        if score is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        decision = CONTINUE
        for milestone, recorded in self._rungs:
            if t < milestone or trial.trial_id in recorded:
                continue
            recorded[trial.trial_id] = score
            if len(recorded) > 1:
                # Continue only in the top 1/eta of scores recorded at this
                # rung (newcomer included), as in the reference's
                # AsyncHyperBand cutoff (schedulers/async_hyperband.py).
                vals = sorted(recorded.values())
                q = (1.0 - 1.0 / self.eta)
                cutoff = vals[min(len(vals) - 1,
                                  int(math.floor(q * (len(vals) - 1))))]
                if score < cutoff:
                    decision = STOP
        return decision


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best score so far is below the median of other
    trials' running averages at the same step (reference:
    schedulers/median_stopping_rule.py)."""

    def __init__(self, *, time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.grace = grace_period
        self.min_samples = min_samples_required
        self._avgs: Dict[str, List[float]] = {}

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        score = self._score(result)
        if score is None:
            return CONTINUE
        hist = self._avgs.setdefault(trial.trial_id, [])
        hist.append(score)
        t = result.get(self.time_attr, len(hist))
        if t < self.grace:
            return CONTINUE
        others = [sum(h) / len(h) for tid, h in self._avgs.items()
                  if tid != trial.trial_id and h]
        if len(others) < self.min_samples:
            return CONTINUE
        others.sort()
        median = others[len(others) // 2]
        best = max(hist)
        return STOP if best < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: schedulers/pbt.py): at each perturbation interval,
    bottom-quantile trials exploit a top-quantile trial — clone its latest
    checkpoint and config — then explore by perturbing hyperparameters.

    Exploitation here restarts the trial actor from the donor checkpoint
    (the reference's stop-and-restore path; in-place _exploit is an
    optimization it also only applies with reuse_actors).
    """

    def __init__(self, *, time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 perturbation_factors=(1.2, 0.8),
                 seed: Optional[int] = None):
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self.factors = perturbation_factors
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = {}
        self._scores: Dict[str, float] = {}
        # controller inspects this after on_result returns EXPLOIT
        self.pending_exploit: Optional[dict] = None

    EXPLOIT = "EXPLOIT"

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        score = self._score(result)
        if score is not None:
            self._scores[trial.trial_id] = score
        t = result.get(self.time_attr, trial.iterations)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval or len(self._scores) < 2:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t
        ranked = sorted(self._scores.items(), key=lambda kv: kv[1])
        n = len(ranked)
        k = max(1, int(n * self.quantile))
        bottom = {tid for tid, _ in ranked[:k]}
        top = [tid for tid, _ in ranked[-k:]]
        if trial.trial_id not in bottom or trial.trial_id in top:
            return CONTINUE
        donor_id = self._rng.choice(top)
        self.pending_exploit = {
            "donor_id": donor_id,
            "explore": True,
        }
        return self.EXPLOIT

    def explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Perturb mutated hyperparameters (reference: pbt.py _explore)."""
        from ray_tpu_torch.tune.search_space import Domain
        out = dict(config)
        for key, spec in self.mutations.items():
            if self._rng.random() < self.resample_prob or \
                    key not in out or not isinstance(out[key], (int, float)):
                if isinstance(spec, Domain):
                    out[key] = spec.sample(self._rng)
                elif isinstance(spec, list):
                    out[key] = self._rng.choice(spec)
                elif callable(spec):
                    out[key] = spec()
            else:
                factor = self._rng.choice(self.factors)
                out[key] = out[key] * factor
                if isinstance(spec, list):
                    # snap to nearest allowed value
                    out[key] = min(spec, key=lambda v: abs(v - out[key]))
        return out


PAUSE = "PAUSE"


class _Bracket:
    """One synchronous successive-halving bracket (reference:
    hyperband.py Bracket): n0 trials starting at r0 iterations; at each
    rung every live trial pauses until all have reported, then the top
    1/eta continue to the next rung and the rest stop."""

    def __init__(self, s: int, s_max: int, max_t: int, eta: float):
        self.s = s
        self.eta = eta
        self.max_t = max_t
        self.n0 = max(1, math.ceil((s_max + 1) / (s + 1) * eta ** s))
        self.r0 = max(1, int(max_t * eta ** -s))
        self.rung = 0
        self.members: set = set()       # alive trial ids
        self.recorded: Dict[str, float] = {}   # scores at current rung
        self.paused: set = set()

    @property
    def milestone(self) -> int:
        return min(self.max_t, int(self.r0 * self.eta ** self.rung))

    def has_capacity(self) -> bool:
        return len(self.members) < self.n0 and self.rung == 0

    def keep_count(self) -> int:
        return max(1, int(len(self.recorded) / self.eta))

    def promotion_ready(self) -> bool:
        return (self.members
                and all(tid in self.recorded for tid in self.members))


class HyperBandScheduler(TrialScheduler):
    """Synchronous HyperBand (reference: schedulers/hyperband.py
    HyperBandScheduler). Trials are assigned round-robin into brackets
    s = s_max..0; each bracket successively halves at shared milestones.
    Requires checkpointing trainables (paused trials resume from their
    latest checkpoint, like the reference's PAUSE decision)."""

    def __init__(self, *, time_attr: str = "training_iteration",
                 max_t: int = 81, reduction_factor: float = 3.0):
        self.time_attr = time_attr
        self.max_t = max_t
        self.eta = reduction_factor
        self.s_max = int(math.log(max_t) / math.log(self.eta))
        self._brackets: List[_Bracket] = []
        self._next_s = self.s_max
        self._of: Dict[str, _Bracket] = {}
        self._unpause: List[str] = []
        self._stop_parked: List[str] = []

    # -- controller hooks ---------------------------------------------------

    def on_trial_add(self, trial):
        for b in self._brackets:
            if b.has_capacity():
                b.members.add(trial.trial_id)
                self._of[trial.trial_id] = b
                return
        b = _Bracket(self._next_s, self.s_max, self.max_t, self.eta)
        self._next_s = self._next_s - 1 if self._next_s > 0 else self.s_max
        self._brackets.append(b)
        b.members.add(trial.trial_id)
        self._of[trial.trial_id] = b

    def pop_unpaused(self) -> List[str]:
        out, self._unpause = self._unpause, []
        return out

    def pop_parked_stops(self) -> List[str]:
        out, self._stop_parked = self._stop_parked, []
        return out

    # -- decisions ----------------------------------------------------------

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        b = self._of.get(trial.trial_id)
        if b is None:
            self.on_trial_add(trial)
            b = self._of[trial.trial_id]
        t = result.get(self.time_attr, trial.iterations)
        score = self._score(result)
        if score is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        if t < b.milestone:
            return CONTINUE
        b.recorded[trial.trial_id] = score
        if not b.promotion_ready():
            return PAUSE  # wait for bracket peers at this rung
        return self._promote(b, trial.trial_id)

    def _promote(self, b: _Bracket, reporter_id: str) -> str:
        """All bracket members reached the rung: keep the top 1/eta."""
        ranked = sorted(b.recorded.items(), key=lambda kv: -kv[1])
        keep = {tid for tid, _ in ranked[:b.keep_count()]}
        for tid in list(b.members):
            if tid == reporter_id:
                continue
            if tid in keep:
                if tid in b.paused:
                    b.paused.discard(tid)
                    self._unpause.append(tid)
            else:
                b.members.discard(tid)
                self._of.pop(tid, None)
                if tid in b.paused:
                    b.paused.discard(tid)
                    self._stop_parked.append(tid)
        b.rung += 1
        b.recorded = {}
        if reporter_id in keep:
            return CONTINUE
        b.members.discard(reporter_id)
        self._of.pop(reporter_id, None)
        return STOP

    def on_trial_complete(self, trial):
        """A member left (finished/errored): don't deadlock its bracket."""
        b = self._of.pop(trial.trial_id, None)
        if b is None:
            return
        b.members.discard(trial.trial_id)
        b.recorded.pop(trial.trial_id, None)
        b.paused.discard(trial.trial_id)
        if b.promotion_ready():
            # promote on behalf of a phantom reporter
            self._promote(b, reporter_id="__gone__")

    def note_paused(self, trial_id: str):
        b = self._of.get(trial_id)
        if b is not None:
            b.paused.add(trial_id)


class HyperBandForBOHB(HyperBandScheduler):
    """HyperBand variant pairing with the BOHB searcher (reference:
    schedulers/hb_bohb.py HyperBandForBOHB): identical bracket mechanics;
    trials are filled into ONE bracket at a time (the reference processes
    brackets sequentially so the model-based searcher sees each budget's
    results before proposing the next batch)."""

    def on_trial_add(self, trial):
        if self._brackets and self._brackets[-1].has_capacity():
            b = self._brackets[-1]
            b.members.add(trial.trial_id)
            self._of[trial.trial_id] = b
            return
        super().on_trial_add(trial)


class PB2(PopulationBasedTraining):
    """Population-Based Bandits (reference: schedulers/pb2.py:256
    PB2): PBT where EXPLORE picks new hyperparameters with a Gaussian-
    process UCB bandit fit to observed (config, score-delta) data,
    instead of random perturbation — far more sample-efficient for small
    populations.

    ``hyperparam_bounds`` maps each tuned key to [low, high]."""

    def __init__(self, *, hyperparam_bounds: Dict[str, Any],
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 quantile_fraction: float = 0.25,
                 seed: Optional[int] = None):
        super().__init__(
            time_attr=time_attr,
            perturbation_interval=perturbation_interval,
            hyperparam_mutations={},
            quantile_fraction=quantile_fraction, seed=seed)
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        self._obs_x: List[List[float]] = []   # normalized configs
        self._obs_y: List[float] = []         # score deltas
        self._prev_score: Dict[str, float] = {}

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        score = self._score(result)
        if score is not None:
            prev = self._prev_score.get(trial.trial_id)
            if prev is not None:
                self._record(trial.config, score - prev)
            self._prev_score[trial.trial_id] = score
        decision = super().on_result(trial, result)
        if decision == self.EXPLOIT:
            # the trial restarts from the DONOR's checkpoint: its next
            # score delta reflects the clone, not the explored config —
            # it must not be attributed to the new config
            self._prev_score.pop(trial.trial_id, None)
        return decision

    def on_trial_complete(self, trial):
        self._prev_score.pop(trial.trial_id, None)
        super().on_trial_complete(trial)

    # -- GP-UCB explore ------------------------------------------------------

    def _norm(self, config: Dict[str, Any]) -> List[float]:
        out = []
        for k, (lo, hi) in self.bounds.items():
            v = float(config.get(k, lo))
            out.append((v - lo) / (hi - lo) if hi > lo else 0.0)
        return out

    def _record(self, config: Dict[str, Any], dy: float):
        self._obs_x.append(self._norm(config))
        self._obs_y.append(dy)
        if len(self._obs_y) > 256:   # bounded fit cost
            self._obs_x = self._obs_x[-256:]
            self._obs_y = self._obs_y[-256:]

    def explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        import numpy as np

        out = dict(config)
        keys = list(self.bounds.keys())
        if len(self._obs_y) < 4:
            for k in keys:  # cold start: uniform sample
                lo, hi = self.bounds[k]
                out[k] = lo + (hi - lo) * self._rng.random()
            return out
        X = np.asarray(self._obs_x)
        y = np.asarray(self._obs_y)
        y = (y - y.mean()) / (y.std() + 1e-9)
        # RBF-kernel GP posterior (reference fits TV-SquaredExp; plain
        # RBF keeps the bandit while staying dependency-free)
        ls, noise = 0.2, 1e-2
        def k(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-d2 / (2 * ls * ls))
        K = k(X, X) + noise * np.eye(len(X))
        Kinv = np.linalg.inv(K)
        cand = np.asarray([[self._rng.random() for _ in keys]
                           for _ in range(64)])
        Ks = k(cand, X)
        mu = Ks @ Kinv @ y
        var = np.clip(1.0 - np.einsum("ij,jk,ik->i", Ks, Kinv, Ks),
                      1e-9, None)
        beta = math.sqrt(2 * math.log(len(self._obs_y) + 1))
        best = cand[int(np.argmax(mu + beta * np.sqrt(var)))]
        for k_, u in zip(keys, best):
            lo, hi = self.bounds[k_]
            out[k_] = lo + (hi - lo) * float(u)
        return out


REALLOC = "REALLOC"


def evenly_distribute_cpus(total_cpus: float, num_running: int,
                           trial, base: Dict[str, Any]
                           ) -> Dict[str, Any]:
    """Default allocation policy (reference: the DistributeResources
    function in tune/schedulers/resource_changing_scheduler.py): spread
    the cluster's CPUs evenly over the trials still running, never below
    the trial's base request."""
    if num_running <= 0:
        return dict(base)
    share = max(float(base.get("num_cpus", 1)), total_cpus // num_running)
    out = dict(base)
    out["num_cpus"] = share
    return out


class ResourceChangingScheduler(TrialScheduler):
    """Reallocate trial resources mid-experiment (reference:
    tune/schedulers/resource_changing_scheduler.py:ResourceChangingScheduler).

    Wraps a base scheduler (default FIFO): every decision is the base
    scheduler's; after a CONTINUE, ``resources_allocation_function(
    total_cpus, running_trials, trial, base_resources)`` may return a new
    resource dict for the trial. A change checkpoints the trial, stops
    its actor, and requeues it so it restarts under the new allocation —
    the same restart path PBT exploitation uses.
    """

    def __init__(self, base_scheduler: Optional[TrialScheduler] = None,
                 resources_allocation_function=None):
        self.base = base_scheduler or FIFOScheduler()
        self._alloc = resources_allocation_function
        self._pending: Dict[str, Dict[str, Any]] = {}
        self._running_ids: set = set()
        self._running_count_fn = None
        self._realloc_count = 0

    def set_experiment(self, metric: str, mode: str):
        super().set_experiment(metric, mode)
        self.base.set_experiment(metric, mode)

    def __getattr__(self, name):
        # Delegate base-scheduler-specific surface the controller probes
        # for (on_trial_add, HyperBand's pause bookkeeping, PBT's
        # explore) so wrapping changes no behavior of the wrapped one.
        if name.startswith("_") or name == "base":
            raise AttributeError(name)
        return getattr(self.base, name)

    # PBT's exploit protocol: the controller both reads AND assigns
    # pending_exploit, so a plain __getattr__ forward is not enough —
    # the property keeps reads/writes on the wrapped scheduler.
    @property
    def pending_exploit(self):
        return getattr(self.base, "pending_exploit", None)

    @pending_exploit.setter
    def pending_exploit(self, value):
        self.base.pending_exploit = value

    def on_trial_complete(self, trial):
        self._running_ids.discard(trial.trial_id)
        self.base.on_trial_complete(trial)

    def pop_realloc(self, trial_id: str) -> Optional[Dict[str, Any]]:
        return self._pending.pop(trial_id, None)

    def set_cluster_view(self, total_cpus: float, base_resources: dict,
                         running_count_fn=None):
        """Called by the controller before the run loop starts.
        ``running_count_fn`` reports the live number of RUNNING trials
        (the controller knows; reported-once bookkeeping here would
        hand the first reporter the whole cluster)."""
        self._total_cpus = float(total_cpus)
        self._base_resources = dict(base_resources)
        self._running_count_fn = running_count_fn

    def _num_running(self) -> int:
        if self._running_count_fn is not None:
            try:
                return max(1, int(self._running_count_fn()))
            except Exception:  # noqa: BLE001
                pass
        return max(1, len(self._running_ids))

    def on_result(self, trial, result: Dict[str, Any]) -> str:
        self._running_ids.add(trial.trial_id)
        decision = self.base.on_result(trial, result)
        if decision != CONTINUE or self._alloc is None:
            if decision in (STOP, PAUSE):
                self._running_ids.discard(trial.trial_id)
            return decision
        base = dict(getattr(self, "_base_resources", {}) or
                    {"num_cpus": 1})
        want = self._alloc(getattr(self, "_total_cpus", 1.0),
                           self._num_running(), trial, base)
        # normalize both sides over the base keys: partial dicts from
        # the allocation function must not oscillate vs the stored state
        want = {**base, **(want or {})}
        have = {**base, **(trial.resources or {})}
        if want != have:
            self._pending[trial.trial_id] = want
            self._realloc_count += 1
            return REALLOC
        return decision
