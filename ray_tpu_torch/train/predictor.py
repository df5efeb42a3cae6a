"""Predictors: a checkpoint's params and an apply function, for batch
inference.

Counterpart of ``ray_tpu/train/predictor.py``. ``TorchPredictor`` takes
the place of ``JaxPredictor``: the apply function runs eagerly under
``torch.inference_mode()`` on ``device`` (the card unless the caller
asks for the CPU); nothing stands in for ``jax.jit``. The reference's
``predict_batches``, which maps a predictor over a Dataset with an actor
pool, needs the port's Data library and is not here yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.llama import resolve_device


class Predictor:
    """Subclass: implement from_checkpoint() and predict(batch)->batch."""

    @classmethod
    def from_checkpoint(cls, checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        raise NotImplementedError


class TorchPredictor(Predictor):
    """Predictor over an apply function ``apply_fn(params, inputs)`` and
    a params tree (nested dicts of numpy arrays or tensors, moved to
    ``device`` as ``models.convert.params_from_numpy`` moves them)."""

    def __init__(self, params, apply_fn: Callable,
                 input_column: str = "data",
                 output_column: str = "predictions", device=None):
        self._device = resolve_device(device)
        self._params = params_from_numpy(params, self._device)
        self._apply = apply_fn
        self._in = input_column
        self._out = output_column

    @classmethod
    def from_checkpoint(cls, checkpoint, apply_fn: Callable,
                        load_params: Optional[Callable] = None,
                        device=None, **kwargs) -> "TorchPredictor":
        """``checkpoint`` is a directory or any object with ``.path``.
        load_params(dir_path) -> params; defaults to a pickled tree of
        numpy arrays named params.pkl in the checkpoint directory."""
        path = checkpoint.path if hasattr(checkpoint, "path") else checkpoint
        if load_params is not None:
            params = load_params(path)
        else:
            with open(os.path.join(path, "params.pkl"), "rb") as f:
                params = pickle.load(f)
        return cls(params, apply_fn, device=device, **kwargs)

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """The batch with ``apply_fn``'s output added under the output
        column, as numpy (bfloat16 outputs as float32)."""
        with torch.inference_mode():
            out = self._apply(self._params,
                              torch.as_tensor(np.asarray(batch[self._in]),
                                              device=self._device))
            out = out.detach().cpu()
        if out.dtype == torch.bfloat16:
            out = out.float()
        return {**batch, self._out: out.numpy()}
