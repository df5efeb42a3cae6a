"""DataParallelTrainer: SPMD train loop over a worker gang.

Reference: python/ray/train/data_parallel_trainer.py:25 +
base_trainer.py:567 (fit). The port's copy of
``ray_tpu/train/data_parallel_trainer.py``, with ``TorchTrainer`` in place
of ``JaxTrainer``. Difference by design: fit() drives the gang directly
(Tune wraps trainers at its own layer, rather than every fit being a Tune
trial). ``datasets=`` is duck-typed (``streaming_split``) until the port's
Data library lands.

Fault tolerance: FailureConfig(max_failures) — on worker death or loop
error the gang is torn down, rebuilt, and restarted from the latest
persisted checkpoint (reference semantics).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train.backend import BackendConfig, TorchConfig
from ray_tpu_torch.train.backend_executor import BackendExecutor, TrainingWorkerError
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.checkpoint_manager import CheckpointManager
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.result import Result
from ray_tpu_torch.train.session import PreemptedError
from ray_tpu_torch.train.storage import StorageContext

logger = logging.getLogger(__name__)


class DataParallelTrainer:
    def __init__(self,
                 train_loop_per_worker: Callable,
                 *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 metadata: Optional[Dict[str, Any]] = None):
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or BackendConfig()
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint
        self.metadata = metadata or {}

    # ----------------------------------------------------------------- fit
    def fit(self) -> Result:
        # refused before any worker starts (TorchConfig(device=None)
        # without GPUs)
        self.backend_config.validate(self.scaling_config)
        storage = StorageContext(self.run_config.resolved_storage_path(),
                                 experiment_name=self.run_config.name)
        storage.ensure_trial_dir()
        ckpt_mgr = CheckpointManager(storage,
                                     self.run_config.checkpoint_config)
        max_failures = self.run_config.failure_config.max_failures
        failures = 0
        preemptions = 0
        latest_metrics: Dict[str, Any] = {}
        history: list = []
        elastic_stats: list = []
        last_error: Optional[BaseException] = None

        while True:
            executor = BackendExecutor(self.backend_config, self.scaling_config)
            try:
                executor.start()
                # resume from the newest CONSISTENT checkpoint: torn/
                # partial dirs (worker died mid-persist) are dropped with
                # a warning instead of crashing the restart
                resume = ckpt_mgr.latest_consistent() \
                    or self.resume_from_checkpoint
                executor.start_training(
                    self.train_loop_per_worker,
                    self.train_loop_config,
                    context_kwargs={
                        "trial_name": storage.trial_name,
                        "experiment_name": storage.experiment_name,
                        "trial_dir": storage.trial_path,
                        "metadata": self.metadata,
                    },
                    checkpoint_path=resume.path if resume else None,
                    dataset_shards=self._shard_datasets(
                        self.scaling_config.num_workers),
                    storage_info={
                        "storage_path": self.run_config.resolved_storage_path(),
                        "experiment_name": storage.experiment_name,
                        "trial_name": storage.trial_name,
                        "checkpoint_index_start": ckpt_mgr.next_index,
                    },
                    shard_fn=self._shard_datasets,
                )
                while True:
                    results = executor.get_next_results()
                    if results is None:
                        break
                    # rank-0 metrics are the canonical row (reference keeps
                    # per-rank results but reports rank 0 by default)
                    latest_metrics = results[0].metrics
                    history.append(latest_metrics)
                    ckpt_dirs = [r.checkpoint_dir for r in results
                                 if r.checkpoint_dir]
                    if ckpt_dirs:
                        ckpt_mgr.register_persisted(ckpt_dirs[0], latest_metrics)
                last_error = None
                break
            # rtpu-lint: disable=L4 — this handler IS the restart
            # machinery: the enclosing while-loop rebuilds the gang and
            # resumes from the latest consistent checkpoint (bounded by
            # max_failures / max_preemptions)
            except TrainingWorkerError as e:
                last_error = e
                if isinstance(e.__cause__, PreemptedError):
                    # scheduled eviction, not a fault: restart from the
                    # latest checkpoint without consuming max_failures
                    preemptions += 1
                    logger.warning(
                        "gang preempted (%d/%d); restarting from latest "
                        "checkpoint", preemptions,
                        self.run_config.failure_config.max_preemptions)
                    if preemptions > \
                            self.run_config.failure_config.max_preemptions:
                        break
                else:
                    failures += 1
                    logger.warning("training failed (%d/%d): %s",
                                   failures, max_failures, e)
                    if max_failures >= 0 and failures > max_failures:
                        break
            finally:
                elastic_stats.extend(executor.elastic_stats)
                executor.shutdown()

        return Result(metrics=latest_metrics,
                      checkpoint=ckpt_mgr.best,
                      error=last_error,
                      path=storage.trial_path,
                      metrics_history=history,
                      elastic_stats=elastic_stats)

    # ------------------------------------------------------------ datasets
    def _shard_datasets(self, n: int):
        if not self.datasets:
            return None
        shards = [dict() for _ in range(n)]
        for name, ds in self.datasets.items():
            split = getattr(ds, "streaming_split", None)
            if callable(split):
                for rank, piece in enumerate(split(n, equal=True)):
                    shards[rank][name] = piece
            else:
                for rank in range(n):
                    shards[rank][name] = ds
        return shards


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer preconfigured with the torch backend (the
    reference's TorchTrainer, train/torch/config.py:154; ``ray_tpu``'s
    JaxTrainer). The default ``TorchConfig()`` trains on the card each
    worker holds, so it needs ``ScalingConfig(use_gpu=True)``."""

    def __init__(self, train_loop_per_worker: Callable, *,
                 torch_config: Optional[TorchConfig] = None, **kwargs):
        kwargs.setdefault("backend_config", torch_config or TorchConfig())
        super().__init__(train_loop_per_worker, **kwargs)
