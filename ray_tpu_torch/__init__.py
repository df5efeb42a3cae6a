"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's runtime, models,
serving engines, training step and RL learners.

The JAX package ``ray_tpu`` is the reference; this package computes the
same functions with PyTorch on an NVIDIA Hopper card, and every Pallas
kernel of the ported path is a CUDA C++ kernel written for ``sm_90a``
(``ray_tpu_torch/csrc``). Module layout mirrors ``ray_tpu`` so each file
has an obvious counterpart:

    ops/layers.py           <-> ray_tpu/ops/layers.py
    ops/attention.py        <-> ray_tpu/ops/attention.py      (kernel)
    ops/paged_attention.py  <-> ray_tpu/ops/paged_attention.py (kernel)
    ops/ring_attention.py, ops/ulysses.py (sequence parallel)
    parallel/mesh.py, sharding.py, device_collectives.py, pipeline.py
    (over torch.distributed; models/sharded.py runs the models' mesh
    paths on them)
    models/llama.py, llama_decode.py, llama_paged.py, gpt2.py,
    mixtral.py, hf_weights.py
    serve/llm_engine.py, serve/paged_engine.py, serve/disagg.py
    api.py, exceptions.py, core/ (the single-node task/actor/object
    runtime: runtime.py, worker_proc.py, the shm object store, placement
    groups, with GPUs as a resource), util/
    rllib/rl_module.py, learner.py, impala.py, appo.py, dqn.py,
    sac.py, offline.py, dreamer.py (the learners, and the drivers:
    algorithm.py, ppo.py, env_runner.py, envs.py, replay_buffer.py,
    catalog.py, multi_agent.py)

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without CUDA they raise instead of silently running on
the host. On CPU tensors the kernel wrappers run their plain PyTorch
versions, which is how the tests compare the port with ``ray_tpu``.

The core API mirrors ``ray_tpu``'s::

    import ray_tpu_torch

    ray_tpu_torch.init()

    @ray_tpu_torch.remote(num_gpus=1)
    class Replica: ...

An actor with ``num_gpus=N`` runs in a worker of its own whose
``CUDA_VISIBLE_DEVICES`` names its N cards; plain workers see none.

This package never imports ``jax`` or ``ray_tpu``. Importing it stays
light: ``torch`` is imported by the submodules, not here, and the
runtime never imports it (workers pay no torch import unless a task
does).
"""

__version__ = "0.1.0"

from ray_tpu_torch.api import (  # noqa: F401,E402
    cancel,
    free,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    method,
    put,
    remote,
    shutdown,
    timeline,
    wait,
)
from ray_tpu_torch.core.object_ref import (  # noqa: F401,E402
    ObjectRef,
    ObjectRefGenerator,
)
from ray_tpu_torch.core.runtime_context import (  # noqa: F401,E402
    get_runtime_context,
)
from ray_tpu_torch import exceptions  # noqa: F401,E402

__all__ = [
    "__version__",
    "init",
    "shutdown",
    "is_initialized",
    "remote",
    "get",
    "put",
    "wait",
    "kill",
    "cancel",
    "method",
    "get_actor",
    "timeline",
    "ObjectRef",
    "ObjectRefGenerator",
    "get_runtime_context",
    "exceptions",
]
