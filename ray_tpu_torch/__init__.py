"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's models, serving
engines, training step and RL learners.

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
    core/config.py, core/fault_injection.py (the slices serving reads)
    rllib/rl_module.py, learner.py, impala.py, appo.py, dqn.py,
    sac.py, offline.py (the learners)

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without CUDA they raise instead of silently running on
the host. On CPU tensors the kernel wrappers run their plain PyTorch
versions, which is how the tests compare the port with ``ray_tpu``.

This package never imports ``jax`` or ``ray_tpu``. Importing it stays
light: ``torch`` is imported by the submodules, not here.
"""

__version__ = "0.1.0"
