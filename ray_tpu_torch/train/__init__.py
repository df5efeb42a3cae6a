"""ray_tpu_torch.train: distributed training orchestration over the port's
runtime.

The port's copy of ``ray_tpu.train``'s surface (which mirrors ray.train):
configs, Checkpoint, report/get_checkpoint/get_context/get_dataset_shard,
DataParallelTrainer/TorchTrainer, Result; ``TorchConfig`` wires each gang
worker to the card it holds and, on request, one ``torch.distributed``
default group. Beside them, sharded checkpoints on
``torch.distributed.checkpoint`` (``dist_checkpoint``) and the predictor
(``TorchPredictor``). ``predict_batches`` waits for the port's Data
library.

Importing this package loads no torch: gang workers that train on the
CPU pay for it only when their loop imports it. ``dist_checkpoint``,
``Predictor`` and ``TorchPredictor`` resolve on first use (PEP 562).
"""

import importlib

from ray_tpu_torch.train.backend import (  # noqa: F401
    Backend,
    BackendConfig,
    TorchConfig,
)
from ray_tpu_torch.train.backend_executor import (  # noqa: F401
    BackendExecutor,
    TrainingWorkerError,
)
from ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.train.checkpoint_manager import CheckpointManager  # noqa: F401
from ray_tpu_torch.train.config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.data_parallel_trainer import (  # noqa: F401
    DataParallelTrainer,
    TorchTrainer,
)
from ray_tpu_torch.train.result import Result  # noqa: F401
from ray_tpu_torch.train.session import (  # noqa: F401
    PreemptedError,
    SessionInterruptedError,
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    preempted,
    report,
)
from ray_tpu_torch.train.storage import (  # noqa: F401
    StorageContext,
    validate_checkpoint_dir,
)
from ray_tpu_torch.train.worker_group import WorkerGroup  # noqa: F401

# names that import torch, resolved on first use
_LAZY = {
    "dist_checkpoint": ("ray_tpu_torch.train.dist_checkpoint", None),
    "Predictor": ("ray_tpu_torch.train.predictor", "Predictor"),
    "TorchPredictor": ("ray_tpu_torch.train.predictor", "TorchPredictor"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _LAZY[name]
    mod = importlib.import_module(module)
    value = mod if attr is None else getattr(mod, attr)
    globals()[name] = value
    return value


__all__ = [
    "Backend", "BackendConfig", "TorchConfig",
    "BackendExecutor", "TrainingWorkerError",
    "Checkpoint", "CheckpointManager", "CheckpointConfig",
    "FailureConfig", "RunConfig", "ScalingConfig",
    "DataParallelTrainer", "TorchTrainer", "Result",
    "PreemptedError", "preempted", "SessionInterruptedError",
    "TrainContext", "get_checkpoint", "get_context", "get_dataset_shard",
    "report", "StorageContext", "validate_checkpoint_dir", "WorkerGroup",
    "dist_checkpoint", "Predictor", "TorchPredictor",
]
