"""Tuner + TuneConfig + ResultGrid.

Reference: python/ray/tune/tuner.py:44 (Tuner.fit / Tuner.restore),
tune/tune_config.py, tune/result_grid.py. Trainables may be plain
functions ``fn(config)`` calling ``tune.report`` or DataParallelTrainer
instances (run per-trial with the trial's config merged into
train_loop_config).

The port's copy of ``ray_tpu/tune/tuner.py``: a trainer trainable is the
port's ``DataParallelTrainer`` / ``TorchTrainer``, whose gang the trial
actor starts; ``ResultGrid.get_dataframe`` imports pandas when called.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.trial import Trial, TrialStatus
from ray_tpu_torch.tune.tune_controller import TuneController


@dataclass
class TuneConfig:
    """Reference: tune/tune_config.py."""

    metric: str = "score"
    mode: str = "max"
    num_samples: int = 1
    scheduler: Optional[TrialScheduler] = None
    search_alg: Optional[Any] = None  # a tune.search.Searcher
    max_concurrent_trials: Optional[int] = None
    seed: Optional[int] = None
    trial_resources: Dict[str, Any] = field(default_factory=dict)


class Result:
    def __init__(self, trial: Trial):
        self.metrics = trial.last_result
        self.config = trial.config
        self.error = trial.error
        self.checkpoint = None
        if trial.checkpoint_path:
            from ray_tpu_torch.train.checkpoint import Checkpoint
            self.checkpoint = Checkpoint(trial.checkpoint_path)
        self.metrics_history = trial.metric_history
        self.trial_id = trial.trial_id
        self.terminated = trial.status == TrialStatus.TERMINATED

    def __repr__(self):
        return f"Result({self.trial_id}, metrics={self.metrics})"


class ResultGrid:
    """Reference: tune/result_grid.py."""

    def __init__(self, trials: List[Trial], metric: str, mode: str):
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._trials)

    def __getitem__(self, i) -> Result:
        return Result(self._trials[i])

    @property
    def errors(self) -> List[str]:
        return [t.error for t in self._trials if t.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [t for t in self._trials
                  if t.last_result.get(metric) is not None]
        if not scored:
            raise RuntimeError("No trial reported metric "
                               f"{metric!r}; errors: {self.errors}")
        best = (max if mode == "max" else min)(
            scored, key=lambda t: t.last_result[metric])
        return Result(best)

    def get_dataframe(self):
        import pandas as pd
        rows = []
        for t in self._trials:
            row = dict(t.last_result)
            row.update({f"config/{k}": v for k, v in t.config.items()
                        if not isinstance(v, (dict, list))})
            row["trial_id"] = t.trial_id
            row["status"] = t.status.value
            rows.append(row)
        return pd.DataFrame(rows)


def _trainable_of(obj) -> Callable:
    """Normalize a Tuner target to fn(config)."""
    from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
    if isinstance(obj, DataParallelTrainer):
        trainer = obj

        def run_trainer(config):
            import copy
            from ray_tpu_torch.tune.trial import report, get_trial_dir
            t = copy.copy(trainer)
            t.train_loop_config = {**trainer.train_loop_config, **config}
            rc = copy.copy(trainer.run_config)
            rc.storage_path = get_trial_dir()
            rc.name = "trainer"
            t.run_config = rc
            result = t.fit()
            if result.error is not None:
                raise result.error
            metrics = dict(result.metrics)
            ckpt = result.checkpoint.path if result.checkpoint else None
            report(metrics, checkpoint=ckpt)

        return run_trainer
    if callable(obj):
        return obj
    raise TypeError(f"Cannot use {type(obj)} as a trainable")


class Tuner:
    def __init__(self, trainable, *, param_space: Optional[Dict] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config=None,
                 _restore_path: Optional[str] = None):
        from ray_tpu_torch.train.config import RunConfig
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._restore_path = _restore_path

    def _experiment_dir(self) -> str:
        base = self._run_config.resolved_storage_path()
        name = self._run_config.name or "tune_experiment"
        return os.path.join(base, name)

    def fit(self) -> ResultGrid:
        cfg = self._tune_config
        fc = getattr(self._run_config, "failure_config", None)
        controller = TuneController(
            _trainable_of(self._trainable),
            param_space=self._param_space,
            metric=cfg.metric, mode=cfg.mode,
            num_samples=cfg.num_samples,
            scheduler=cfg.scheduler,
            search_alg=cfg.search_alg,
            max_concurrent_trials=cfg.max_concurrent_trials,
            max_failures=fc.max_failures if fc else 0,
            experiment_dir=self._experiment_dir(),
            trial_resources=cfg.trial_resources,
            stop=getattr(self._run_config, "stop", None),
            seed=cfg.seed)
        if self._restore_path:
            state_file = os.path.join(self._restore_path,
                                      "experiment_state.json")
            with open(state_file) as f:
                state = json.load(f)
            controller.restore_trials(state["trials"])
        trials = controller.run()
        return ResultGrid(trials, cfg.metric, cfg.mode)

    @classmethod
    def restore(cls, path: str, trainable, *,
                param_space: Optional[Dict] = None,
                tune_config: Optional[TuneConfig] = None,
                run_config=None) -> "Tuner":
        """Resume an interrupted experiment: finished trials keep their
        results, unfinished ones restart (from their latest checkpoint if
        they saved one). Reference: Tuner.restore (tuner.py)."""
        from ray_tpu_torch.train.config import RunConfig
        state_file = os.path.join(path, "experiment_state.json")
        with open(state_file) as f:
            state = json.load(f)
        tc = tune_config or TuneConfig(metric=state["metric"],
                                       mode=state["mode"])
        rc = run_config or RunConfig(
            storage_path=os.path.dirname(path.rstrip("/")),
            name=os.path.basename(path.rstrip("/")))
        return cls(trainable, param_space=param_space or {},
                   tune_config=tc, run_config=rc, _restore_path=path)
