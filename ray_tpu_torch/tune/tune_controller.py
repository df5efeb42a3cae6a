"""TuneController: the experiment event loop.

Reference: python/ray/tune/execution/tune_controller.py:68 — manages trials
as actors, polls results, applies scheduler decisions, persists experiment
state, and retries failed trials. One in-flight ``ack_and_next`` call per
running trial; ray_tpu_torch.wait multiplexes across them.

The port's copy of ``ray_tpu/tune/tune_controller.py``. One difference:
a trial's start is not waited for, so that trials which wait for a GPU
another trial holds do not stall the loop that would free it (the
reference blocks on each start).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.tune.schedulers import (PAUSE, REALLOC, STOP,
                                           FIFOScheduler,
                                           PopulationBasedTraining,
                                           TrialScheduler)
from ray_tpu_torch.tune.trial import Trial, TrialActor, TrialStatus


class TuneController:
    def __init__(self, trainable, *, param_space: Dict[str, Any],
                 metric: str = "score", mode: str = "max",
                 num_samples: int = 1,
                 scheduler: Optional[TrialScheduler] = None,
                 search_alg=None,
                 max_concurrent_trials: Optional[int] = None,
                 max_failures: int = 0,
                 experiment_dir: str = "",
                 trial_resources: Optional[dict] = None,
                 stop: Optional[Dict[str, Any]] = None,
                 seed: Optional[int] = None):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self._trainable = trainable
        self._metric = metric
        self._mode = mode
        self._scheduler = scheduler or FIFOScheduler()
        self._scheduler.set_experiment(metric, mode)
        self._max_concurrent = max_concurrent_trials or 4
        self._max_failures = max_failures
        self._experiment_dir = experiment_dir
        self._trial_resources = trial_resources or {}
        self._stop_criteria = stop or {}
        os.makedirs(experiment_dir, exist_ok=True)

        # With a search algorithm, trials are created LAZILY so each
        # suggestion can learn from completed results (reference:
        # tune/search/searcher.py); otherwise variants are pre-generated.
        self._searcher = search_alg
        self._next_trial_idx = 0
        if search_alg is not None:
            search_alg.set_experiment(param_space, metric, mode,
                                      num_samples, seed)
            self.trials: List[Trial] = []
        else:
            from ray_tpu_torch.tune.search_space import generate_variants
            self.trials = [
                Trial(trial_id=f"trial_{i:05d}", config=cfg)
                for i, cfg in enumerate(
                    generate_variants(param_space, num_samples, seed))
            ]
            self._next_trial_idx = len(self.trials)

    def _maybe_suggest_trial(self) -> Optional[Trial]:
        if self._searcher is None:
            return None
        trial_id = f"trial_{self._next_trial_idx:05d}"
        cfg = self._searcher.suggest(trial_id)
        if cfg is None:
            return None
        self._next_trial_idx += 1
        trial = Trial(trial_id=trial_id, config=cfg)
        self.trials.append(trial)
        return trial

    # ------------------------------------------------------------- running

    def restore_trials(self, snapshots: List[dict]):
        if self._searcher is not None:
            # Searcher mode creates trials lazily, so restored trials are
            # reconstructed directly from their snapshots; completed ones
            # are fed back so the searcher resumes with full history.
            for s in snapshots:
                r = Trial.from_snapshot(s)
                if not r.is_finished:
                    r.status = TrialStatus.PENDING
                    register = getattr(self._searcher, "register", None)
                    if register is not None:
                        register(r.trial_id, r.config)
                self.trials.append(r)
                try:
                    idx = int(r.trial_id.rsplit("_", 1)[-1]) + 1
                    self._next_trial_idx = max(self._next_trial_idx, idx)
                except ValueError:
                    pass
                if r.is_finished and r.last_result:
                    score = r.last_result.get(self._metric)
                    observe = getattr(self._searcher, "observe", None)
                    if observe is not None and score is not None:
                        observe(r.config, score)
            on_restore = getattr(self._searcher, "on_restore", None)
            if on_restore is not None:
                on_restore(len(self.trials))
            return
        restored = {s["trial_id"]: s for s in snapshots}
        for t in self.trials:
            snap = restored.get(t.trial_id)
            if snap:
                r = Trial.from_snapshot(snap)
                # Keep the recorded config: fresh variant generation may
                # have re-sampled random leaves differently.
                t.config = r.config
                if r.is_finished:
                    t.status = r.status
                    t.last_result = r.last_result
                    t.error = r.error
                    t.iterations = r.iterations
                t.checkpoint_path = r.checkpoint_path
                t.resources = r.resources

    def run(self) -> List[Trial]:
        view = getattr(self._scheduler, "set_cluster_view", None)
        if view is not None:
            from ray_tpu_torch import state
            try:
                total = state.cluster_resources().get("CPU", 1.0)
            except Exception:  # noqa: BLE001 — view is best-effort
                total = 1.0
            view(total, self._trial_resources or {"num_cpus": 1},
                 lambda: self._num_live)
        self._num_live = 0
        pending = [t for t in self.trials if not t.is_finished]
        for t in pending:
            self._notify_added(t)
        running: Dict[Any, Trial] = {}  # pending_result ref -> trial
        parked: Dict[str, Trial] = {}   # PAUSED, awaiting the scheduler
        exhausted = False
        try:
            while True:
                while len(pending) + len(running) < self._max_concurrent \
                        and not exhausted:
                    t = self._maybe_suggest_trial()
                    if t is None:
                        exhausted = True
                    else:
                        self._notify_added(t)
                        pending.append(t)
                self._drain_parked(parked, pending)
                if not (pending or running or parked):
                    if self._searcher is None or exhausted:
                        break
                while pending and len(running) < self._max_concurrent:
                    trial = pending.pop(0)
                    self._start_trial(trial)
                    running[trial.pending_result] = trial
                if not running:
                    if parked:
                        # nothing can progress and the scheduler released
                        # nobody (e.g. bracket peers all errored):
                        # fail-safe unpause everyone rather than hang
                        for t in parked.values():
                            t.status = TrialStatus.PENDING
                            pending.append(t)
                        parked.clear()
                        continue
                    break
                self._num_live = len(running)
                ready, _ = ray_tpu_torch.wait(list(running.keys()),
                                              num_returns=1, timeout=5.0)
                for ref in ready:
                    trial = running.pop(ref)
                    requeue = self._process(trial)
                    if requeue == "requeue":
                        pending.append(trial)
                    elif requeue == "park":
                        parked[trial.trial_id] = trial
                    elif not trial.is_finished:
                        running[trial.pending_result] = trial
                self._checkpoint_experiment()
        finally:
            for trial in running.values():
                self._kill_actor(trial)
            self._checkpoint_experiment()
        return self.trials

    def _notify_added(self, trial: Trial):
        hook = getattr(self._scheduler, "on_trial_add", None)
        if hook is not None:
            hook(trial)

    def _drain_parked(self, parked: Dict[str, Trial],
                      pending: List[Trial]):
        """Apply the scheduler's verdicts for paused trials (HyperBand
        releases a bracket's survivors once all peers hit the rung)."""
        sched = self._scheduler
        for tid in (sched.pop_unpaused()
                    if hasattr(sched, "pop_unpaused") else []):
            t = parked.pop(tid, None)
            if t is not None:
                t.status = TrialStatus.PENDING
                pending.append(t)
        for tid in (sched.pop_parked_stops()
                    if hasattr(sched, "pop_parked_stops") else []):
            t = parked.pop(tid, None)
            if t is not None:
                t.status = TrialStatus.TERMINATED
                sched.on_trial_complete(t)
                if self._searcher is not None:
                    self._searcher.on_trial_complete(t.trial_id,
                                                     t.last_result)

    # ------------------------------------------------------------ internals

    def _start_trial(self, trial: Trial, action: str = "continue"):
        trial_dir = os.path.join(self._experiment_dir, trial.trial_id)
        opts = dict(self._trial_resources)
        opts.update(trial.resources or {})
        trial.actor = TrialActor.options(**opts).remote(
            self._trainable, trial.config, trial_dir,
            checkpoint_path=trial.checkpoint_path)
        # not waited for: an actor whose resources another trial holds
        # (the one GPU) starts when they come back, and meanwhile the loop
        # goes on serving the trials that run; the first poll queues
        # behind start on the actor
        trial.actor.start.remote()
        trial.status = TrialStatus.RUNNING
        trial.pending_result = trial.actor.ack_and_next.remote()

    def _process(self, trial: Trial) -> Optional[str]:
        try:
            kind, metrics, ckpt = ray_tpu_torch.get(trial.pending_result)
        except Exception as e:  # actor/worker death
            return self._on_error(trial, repr(e))
        if kind == "error":
            return self._on_error(trial, metrics.get("error", "unknown"),
                                  metrics.get("traceback"))
        if kind in ("done", "stopped"):
            trial.status = TrialStatus.TERMINATED
            self._scheduler.on_trial_complete(trial)
            if self._searcher is not None:
                self._searcher.on_trial_complete(trial.trial_id,
                                                 trial.last_result)
            self._kill_actor(trial)
            return None

        # kind == "result"
        trial.iterations += 1
        metrics.setdefault("training_iteration", trial.iterations)
        metrics["trial_id"] = trial.trial_id
        trial.last_result = metrics
        trial.metric_history.append(metrics)
        if ckpt:
            trial.checkpoint_path = ckpt

        decision = self._scheduler.on_result(trial, metrics)
        if self._should_stop_by_criteria(metrics):
            decision = STOP
        if decision == PopulationBasedTraining.EXPLOIT:
            return self._exploit(trial)
        if decision == REALLOC:
            return self._realloc(trial)
        if decision == PAUSE:
            # park at the latest checkpoint until the scheduler releases
            # the bracket (reference: HyperBand's PauseTrial)
            trial.pending_result = trial.actor.ack_and_next.remote("stop")
            try:
                ray_tpu_torch.get(trial.pending_result, timeout=30)
            except Exception:  # noqa: BLE001
                pass
            self._kill_actor(trial)
            trial.status = TrialStatus.PAUSED
            note = getattr(self._scheduler, "note_paused", None)
            if note is not None:
                note(trial.trial_id)
            return "park"
        action = "stop" if decision == STOP else "continue"
        trial.pending_result = trial.actor.ack_and_next.remote(action)
        return None

    def _stop_and_requeue(self, trial: Trial) -> str:
        """Stop the trial's actor at its latest checkpoint and mark the
        trial PENDING for a restart (shared by PBT exploitation and
        resource reallocation)."""
        trial.pending_result = trial.actor.ack_and_next.remote("stop")
        try:
            ray_tpu_torch.get(trial.pending_result, timeout=30)
        except Exception:  # noqa: BLE001
            pass
        self._kill_actor(trial)
        trial.status = TrialStatus.PENDING
        return "requeue"

    def _exploit(self, trial: Trial) -> str:
        """PBT exploit: stop this trial, clone donor checkpoint+config
        (perturbed), and requeue it to restart from there."""
        sched = self._scheduler
        info = sched.pending_exploit or {}
        sched.pending_exploit = None
        donor = next((t for t in self.trials
                      if t.trial_id == info.get("donor_id")), None)
        out = self._stop_and_requeue(trial)
        if donor is not None:
            trial.checkpoint_path = donor.checkpoint_path
            trial.config = sched.explore(dict(donor.config))
        return out

    def _realloc(self, trial: Trial) -> str:
        """ResourceChangingScheduler: restart the trial from its latest
        checkpoint under a new resource allocation (reference:
        resource_changing_scheduler.py — same stop/requeue path as PBT
        exploitation, config untouched)."""
        new_res = self._scheduler.pop_realloc(trial.trial_id)
        out = self._stop_and_requeue(trial)
        if new_res:
            trial.resources = new_res
        return out

    def _on_error(self, trial: Trial, err: str,
                  tb: Optional[str] = None) -> Optional[str]:
        trial.num_failures += 1
        self._kill_actor(trial)
        if trial.num_failures <= self._max_failures:
            trial.status = TrialStatus.PENDING
            return "requeue"
        trial.status = TrialStatus.ERROR
        trial.error = tb or err
        self._scheduler.on_trial_complete(trial)
        if self._searcher is not None:
            self._searcher.on_trial_complete(trial.trial_id, None)
        return None

    def _should_stop_by_criteria(self, metrics: Dict[str, Any]) -> bool:
        for key, bound in self._stop_criteria.items():
            v = metrics.get(key)
            if v is not None and v >= bound:
                return True
        return False

    def _kill_actor(self, trial: Trial):
        if trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
        trial.pending_result = None

    def _checkpoint_experiment(self):
        """Persist trial states for Tuner.restore (reference:
        tune/execution/experiment_state.py)."""
        path = os.path.join(self._experiment_dir, "experiment_state.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "timestamp": time.time(),
                "metric": self._metric,
                "mode": self._mode,
                "trials": [t.snapshot() for t in self.trials],
            }, f)
        os.replace(tmp, path)
