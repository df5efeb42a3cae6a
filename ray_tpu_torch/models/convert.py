"""Parameters between the JAX package and the port, through numpy.

``params_from_numpy`` takes the reference's parameter pytree as nested
dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``)
and returns the port's params: the same keys and shapes as tensors on
``device`` (by default the CUDA card, as every entry point of the port;
pass ``"cpu"`` for the host). Any nesting and any rank: the Llama,
GPT-2 and Mixtral trees (whose expert stacks are 4-D, ``[L, E, in,
out]``) and the HF loaders' trees (``models/hf_weights.py``). Int8
weight-only leaves ``{"q": int8, "s": float}`` keep their structure;
``q`` stays int8. ``params_to_numpy`` is the inverse.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.models.llama import resolve_device


def params_from_numpy(tree: Dict[str, Any], device=None,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dicts of numpy arrays -> the same nesting of tensors on
    ``device`` (``None``: the card, or raise without one); tensor leaves
    are moved as they are. ``dtype`` (if given) casts floating leaves;
    integer leaves keep theirs."""
    device = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor):
            t = v
        else:
            a = np.asarray(v)
            if a.dtype.kind not in "biuf" or (a.dtype.kind == "f" and
                                              a.dtype.itemsize == 2 and
                                              a.dtype != np.float16):
                a = a.astype(np.float32)   # ml_dtypes bfloat16 from JAX
            t = torch.from_numpy(np.array(a))   # a writable copy
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    return conv(tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's params -> nested dicts of numpy arrays (bfloat16
    leaves become float32, numpy has no bfloat16)."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return conv(params)
