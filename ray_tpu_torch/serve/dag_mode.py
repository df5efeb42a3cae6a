"""Serve DAG mode: replicas backed by compiled actor pipelines.

The port's copy of ``ray_tpu/serve/dag_mode.py``; its generate stage
runs the port's ``models/llama_decode`` on a torch device.

The reference's accelerated-DAG serving path compiles a static graph of
actor stages and drives requests through channel hops instead of actor
RPCs (python/ray/dag/compiled_dag_node.py:482 as used by serve's TP/PP
inference). Here a deployment subclasses (or instantiates)
``PipelineDeployment``: at replica init it spawns its stage actors,
compiles the graph, and serves each request as ONE dag.execute — the hot
path never touches the scheduler.

Stage actors default to the replica's own node (compiled channels are
shm there); a stage entry may carry an OPTIONS dict (resources,
num_cpus, num_gpus, ...) to pin it elsewhere — e.g. the generate stage
on a card of its own with ``num_gpus=1``, or each stage on a node of its
own — and the compiler picks socket channels for the cross-node edges
automatically. Pre-created actors work too.

``LLMPipeline`` is the shipped example: tokenize -> generate (KV-cached
greedy decode on the Llama family) -> detokenize, each hop a channel.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import ray_tpu_torch


class PipelineDeployment:
    """Base for DAG-mode deployments: ``stages`` is a list of
    (actor_class, method, init_args) or (actor_class, method, init_args,
    options) — actors are spawned at replica init (options place them:
    resources/num_cpus/num_gpus route a stage to a fitting node, and
    cross-node edges compile to socket channels) and compiled into a
    resident pipeline."""

    def __init__(self, stages: Sequence[Tuple], capacity: int = 1 << 20,
                 spin_us: Optional[int] = None):
        from ray_tpu_torch.core.config import config
        from ray_tpu_torch.dag import compile_pipeline

        # the replica->engine hot path rides the compiled SPIN lane so
        # TTFT inherits the per-hop win; serve_dag_spin_us = -1 inherits
        # the global dag_spin_us, 0 forces pure-block for serve only
        if spin_us is None:
            spin_us = config.serve_dag_spin_us
            if spin_us < 0:
                spin_us = config.dag_spin_us
        self._spin_us = max(0, int(spin_us))
        self._actors = []
        compiled_stages = []
        ready_refs = []
        for entry in stages:
            cls, method, init_args = entry[:3]
            opts = entry[3] if len(entry) > 3 else None
            wrapped = hasattr(cls, "remote")
            actor_cls = cls if wrapped else ray_tpu_torch.remote(cls)
            if opts:
                actor_cls = actor_cls.options(**opts)
            a = actor_cls.remote(*init_args)
            self._actors.append(a)
            compiled_stages.append((a, method))
            # readiness barrier on classes that define ready(); others are
            # covered by the compile's own __rtpu_dag_start__ ack
            raw = getattr(cls, "_cls", None) or cls
            if hasattr(raw, "ready"):
                ready_refs.append(a.ready.remote())
        for ref in ready_refs:
            ray_tpu_torch.get(ref, timeout=120)
        self._dag = compile_pipeline(compiled_stages, capacity=capacity,
                                     spin_us=self._spin_us)

    def __call__(self, value: Any, timeout_ms: int = 60_000,
                 _deadline: Optional[float] = None) -> Any:
        """One request = one dag.execute on the compiled lane. When the
        router's deadline kwarg survives to here (see ReplicaActor.handle),
        the remaining budget caps the execute timeout so an expired
        request can't pin the pipeline for the full default."""
        if _deadline is not None:
            import time as _time

            remaining_ms = int((_deadline - _time.time()) * 1000)
            if remaining_ms <= 0:
                from ray_tpu_torch.exceptions import BackpressureError

                raise BackpressureError(
                    "request shed at pipeline: deadline expired before "
                    "the DAG hop")
            timeout_ms = min(timeout_ms, remaining_ms)
        return self._dag.execute(value, timeout_ms=timeout_ms)

    def shutdown(self):
        self._dag.teardown()
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001
                pass


class _Tokenize:
    """Toy byte-level tokenizer stage (a real deployment plugs a
    sentencepiece actor here)."""

    def __init__(self, vocab_size: int):
        self._vocab = vocab_size

    def ready(self):
        return True

    def run(self, text: str) -> List[int]:
        return [b % self._vocab for b in text.encode()] or [1]


class _Generate:
    """KV-cached greedy decode stage on the Llama family — the same
    static-slot programs the LLM engine uses (models/llama_decode.py),
    driven synchronously for the pipeline.

    ``model_config`` keeps the reference's keys (``preset`` and the
    config fields). The weights are ``init_params(cfg, seed=0)`` drawn
    on the stage's device, or ``params``: the reference's parameter tree
    as numpy arrays (``models/convert.py``), or the port's tensors.
    ``device`` is the card by default (a ``num_gpus=1`` stage actor sees
    its card as ``cuda:0``), or ``"cpu"`` when asked."""

    def __init__(self, model_config: Optional[dict], max_new: int,
                 params=None, device=None):
        from ray_tpu_torch.models import llama, llama_decode
        from ray_tpu_torch.models.convert import params_from_numpy

        cfg_kw = dict(model_config or {})
        preset = cfg_kw.pop("preset", "tiny")
        cfg = getattr(llama.LlamaConfig, preset)(**cfg_kw)
        self._cfg = cfg
        self._dev = llama.resolve_device(device)
        if params is None:
            params = llama.init_params(cfg, seed=0, device=self._dev)
        else:
            params = params_from_numpy(params, self._dev,
                                       dtype=cfg.param_dtype)
        self._max_new = max_new
        self._max_len = 64
        (self._prefill, self._insert, _dec, self._chunk) = \
            llama_decode.make_engine_fns(cfg, params, num_slots=1,
                                         max_len=self._max_len)
        self._cache = llama_decode.init_cache(cfg, 1, self._max_len,
                                              device=self._dev)

    def ready(self):
        return True

    PREFILL_BUCKET = 32  # one static prefill shape for the pipeline stage

    def run(self, tokens: List[int]) -> List[int]:
        import numpy as np
        import torch

        dev = self._dev
        # truncate to the prefill bucket (minus the sampled first token)
        toks = tokens[: self.PREFILL_BUCKET - 1]
        rows = np.zeros((1, self.PREFILL_BUCKET), np.int32)
        rows[0, : len(toks)] = toks
        with torch.no_grad():
            logits, kv = self._prefill(
                torch.from_numpy(rows).to(dev),
                torch.tensor([len(toks) - 1], dtype=torch.int32,
                             device=dev))
            self._cache = self._insert(self._cache, kv, np.asarray([0]),
                                       np.asarray([True]))
            first = int(torch.argmax(logits[0]))
            self._cache, out, _, _ = self._chunk(
                self._cache,
                torch.tensor([first], dtype=torch.int32, device=dev),
                torch.tensor([len(toks)], dtype=torch.int32, device=dev),
                np.asarray([True]), self._max_new, sample=False)
        return [first] + [int(t) for t in out[:, 0].tolist()][:-1]


class _Detokenize:
    def ready(self):
        return True

    def run(self, ids: List[int]) -> str:
        return " ".join(str(i) for i in ids)


class LLMPipeline(PipelineDeployment):
    """tokenize -> generate -> detokenize on compiled channels.

    Beyond the reference's keywords: ``params`` and ``device`` go to the
    generate stage (``_Generate``), and ``generate_options`` are its
    actor options, e.g. ``{"num_gpus": 1}`` to put it on a card of its
    own."""

    def __init__(self, model_config: Optional[dict] = None,
                 max_new_tokens: int = 8, params=None, device=None,
                 generate_options: Optional[dict] = None):
        vocab = (model_config or {}).get("vocab_size", 256)
        generate = (_Generate, "run",
                    (model_config, max_new_tokens, params, device))
        if generate_options:
            generate += (generate_options,)
        super().__init__([
            (_Tokenize, "run", (vocab,)),
            generate,
            (_Detokenize, "run", ()),
        ])
