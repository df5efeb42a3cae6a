"""ray_tpu_torch.tune: hyperparameter search over trial actors.

Reference: python/ray/tune/ — Tuner.fit (tuner.py:44), TuneController
(execution/tune_controller.py:68), search spaces (search/sample.py),
schedulers (schedulers/: ASHA, median stopping, PBT).

The port's copy of ``ray_tpu.tune`` on the port's runtime. Differences:
a trial asks for a card with ``trial_resources={"num_gpus": n}`` (a GPU
actor, which sees its cards from ``cuda:0``) where the reference asks for
TPU chips; the controller reads the node's CPU total from the port's
runtime, which has no ``state`` module; ``get_checkpoint`` returns the
port's ``train.Checkpoint`` and a Tuner over a ``DataParallelTrainer`` /
``TorchTrainer`` starts the trainer's gang from inside the trial actor.
Importing this package loads none of torch, pandas and scipy.
"""

from ray_tpu_torch.tune.schedulers import (  # noqa: F401
    ASHAScheduler,
    FIFOScheduler,
    HyperBandForBOHB,
    HyperBandScheduler,
    MedianStoppingRule,
    PB2,
    PopulationBasedTraining,
    ResourceChangingScheduler,
    TrialScheduler,
    evenly_distribute_cpus,
)
from ray_tpu_torch.tune.search_space import (  # noqa: F401
    choice,
    grid_search,
    lograndint,
    loguniform,
    quniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.trial import (  # noqa: F401
    Trial,
    TrialStatus,
    get_checkpoint,
    get_trial_dir,
    report,
)
from ray_tpu_torch.tune.search import (  # noqa: F401
    BasicVariantGenerator,
    BOHBSearcher,
    GPSearcher,
    Searcher,
    TPESearcher,
)
from ray_tpu_torch.tune.tune_controller import TuneController  # noqa: F401
from ray_tpu_torch.tune.tuner import Result, ResultGrid, TuneConfig, Tuner  # noqa: F401

__all__ = [
    "Tuner", "TuneConfig", "TuneController", "Result", "ResultGrid",
    "Trial", "TrialStatus",
    "report", "get_checkpoint", "get_trial_dir",
    "uniform", "loguniform", "quniform", "randint", "lograndint",
    "choice", "sample_from", "grid_search",
    "TrialScheduler", "FIFOScheduler", "ASHAScheduler",
    "HyperBandScheduler", "HyperBandForBOHB", "PB2",
    "MedianStoppingRule", "PopulationBasedTraining",
    "ResourceChangingScheduler", "evenly_distribute_cpus",
    "Searcher", "BasicVariantGenerator", "TPESearcher", "BOHBSearcher",
    "GPSearcher",
]
