"""Load HuggingFace checkpoints of the five families into the port's
params.

Counterpart of ``ray_tpu/models/hf_weights.py``, with the same mapping
of the HF state dict onto the stacked-layer trees:

- torch ``nn.Linear`` stores [out, in] and computes ``x @ W.T``; the
  params store [in, out] and compute ``x @ W``, so every projection
  transposes on import (GPT-2's Conv1D weights are [in, out] already);
- per-layer tensors stack along a leading layer axis;
- rotary embeddings are split-half in both, so no head permutation.

The loaders take a transformers model, or a checkpoint path that its
``from_pretrained`` accepts, and return ``(cfg, params)`` with the
params as tensors on ``device`` (by default the CUDA card, as every
entry point of the port; ``"cpu"`` for the host), through
``models/convert.py``. ``transformers`` is imported inside the
functions that load a path, never at import: ``llama_config_from_hf``
works on any object with the ``config.json`` attributes. What the
models cannot compute refuses with the reference's ``ValueError``:
other rope types, projection biases, sliding windows, other Gemma
activations and unknown model types.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Any, Dict, Tuple

import numpy as np

from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.models.llama import LlamaConfig, as_dtype


def _parse_rope_scaling(hf_cfg):
    """llama3 / linear / yarn rope scaling are implemented
    (ops/layers.rope_frequencies); every other type refuses loudly:
    silently wrong logits are worse than a load error."""
    scaling = getattr(hf_cfg, "rope_scaling", None)
    if not scaling:
        return None
    rope_type = scaling.get("rope_type") or scaling.get("type")
    if rope_type not in ("llama3", "linear", "yarn"):
        raise ValueError(
            f"unsupported HF config: rope_scaling type {rope_type!r} "
            f"(implemented: 'llama3', 'linear', 'yarn')")
    scaling = dict(scaling)
    if rope_type == "yarn" and not scaling.get(
            "original_max_position_embeddings"):
        # transformers falls back to the fixed config length; pinning it
        # keeps inv_freq identical across table lengths
        scaling["original_max_position_embeddings"] = \
            hf_cfg.max_position_embeddings
    return tuple(sorted(
        (k, v) for k, v in scaling.items() if v is not None))


def llama_config_from_hf(hf_cfg, attn_qkv_bias: bool = False
                         ) -> LlamaConfig:
    """A ``LlamaConfig`` from an HF config, or any object with its
    attributes (``vocab_size``, ``hidden_size``, ...)."""
    rope_scaling = _parse_rope_scaling(hf_cfg)
    if not attn_qkv_bias and (getattr(hf_cfg, "attention_bias", False)
                              or getattr(hf_cfg, "mlp_bias", False)):
        raise ValueError(
            "unsupported HF config: attention_bias/mlp_bias checkpoints "
            "carry bias tensors this model has no slots for")
    return LlamaConfig(
        attn_qkv_bias=attn_qkv_bias,
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=getattr(hf_cfg, "num_key_value_heads", None)
        or hf_cfg.num_attention_heads,
        head_dim=getattr(hf_cfg, "head_dim", None),
        max_seq_len=hf_cfg.max_position_embeddings,
        rope_theta=float(getattr(hf_cfg, "rope_theta", 10000.0)),
        rms_norm_eps=float(hf_cfg.rms_norm_eps),
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        rope_scaling=rope_scaling,
    )


def _fetcher(state_dict):
    """(t, lin): fetch as fp32 numpy, and the torch-Linear-transposed
    fetch."""
    def t(name):
        v = state_dict[name]
        if hasattr(v, "detach"):
            v = v.detach().to("cpu").float().numpy()
        return np.asarray(v)

    def lin(name):  # torch Linear [out, in] -> ours [in, out]
        return t(name).T

    return t, lin


def _refuse_proj_bias(state_dict):
    bias_keys = [k for k in state_dict
                 if k.endswith(("proj.bias",)) and "layers" in k]
    if bias_keys:
        raise ValueError(
            f"unsupported checkpoint: projection bias tensors present "
            f"(e.g. {bias_keys[0]}) — this model implements bias-free "
            f"projections")


def _stack_attn(stacked, t, lin, prefix):
    """The llama-style attention block shared by Llama and Mixtral."""
    stacked["attn_norm"].append(t(prefix + "input_layernorm.weight"))
    stacked["wq"].append(lin(prefix + "self_attn.q_proj.weight"))
    stacked["wk"].append(lin(prefix + "self_attn.k_proj.weight"))
    stacked["wv"].append(lin(prefix + "self_attn.v_proj.weight"))
    stacked["wo"].append(lin(prefix + "self_attn.o_proj.weight"))
    stacked["mlp_norm"].append(
        t(prefix + "post_attention_layernorm.weight"))


def _assemble(cfg, stacked, t, lin, dtype, device):
    tree = {
        "embed": t("model.embed_tokens.weight"),
        "layers": {k: np.stack(v) for k, v in stacked.items()},
        "final_norm": t("model.norm.weight"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = lin("lm_head.weight")
    return params_from_numpy(tree, device, as_dtype(dtype))


def _with_dtype(cfg, dtype):
    return cfg if dtype is None else replace(cfg, param_dtype=dtype)


def llama_params_from_hf(state_dict: Dict[str, Any], cfg, dtype=None,
                         device=None) -> Dict[str, Any]:
    """HF Llama state dict (torch tensors or numpy) -> params."""
    dtype = dtype or cfg.param_dtype
    t, lin = _fetcher(state_dict)
    _refuse_proj_bias(state_dict)
    stacked: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
        "w_up", "w_down")}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        _stack_attn(stacked, t, lin, p)
        stacked["w_gate"].append(lin(p + "mlp.gate_proj.weight"))
        stacked["w_up"].append(lin(p + "mlp.up_proj.weight"))
        stacked["w_down"].append(lin(p + "mlp.down_proj.weight"))
    return _assemble(cfg, stacked, t, lin, dtype, device)


def gpt2_from_hf(source, dtype=None, device=None) -> Tuple[Any, Dict]:
    """(cfg, params) from a transformers GPT2LMHeadModel or a checkpoint
    path. GPT-2's Conv1D weights are [in, out], the params' orientation:
    only the per-layer stacking."""
    from ray_tpu_torch.models.gpt2 import GPT2Config

    if isinstance(source, str):
        from transformers import GPT2LMHeadModel

        source = GPT2LMHeadModel.from_pretrained(source)
    hf_cfg = source.config
    cfg = _with_dtype(GPT2Config(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.n_embd,
        num_layers=hf_cfg.n_layer, num_heads=hf_cfg.n_head,
        max_seq_len=hf_cfg.n_positions,
        ln_eps=float(hf_cfg.layer_norm_epsilon)), dtype)
    t, _ = _fetcher(source.state_dict())
    names = {"ln1_g": "ln_1.weight", "ln1_b": "ln_1.bias",
             "w_qkv": "attn.c_attn.weight", "b_qkv": "attn.c_attn.bias",
             "w_proj": "attn.c_proj.weight", "b_proj": "attn.c_proj.bias",
             "ln2_g": "ln_2.weight", "ln2_b": "ln_2.bias",
             "w_fc": "mlp.c_fc.weight", "b_fc": "mlp.c_fc.bias",
             "w_out": "mlp.c_proj.weight", "b_out": "mlp.c_proj.bias"}
    tree = {
        "wte": t("transformer.wte.weight"),
        "wpe": t("transformer.wpe.weight"),
        "layers": {ours: np.stack([t(f"transformer.h.{i}.{hf}")
                                   for i in range(cfg.num_layers)])
                   for ours, hf in names.items()},
        "lnf_g": t("transformer.ln_f.weight"),
        "lnf_b": t("transformer.ln_f.bias"),
    }
    return cfg, params_from_numpy(tree, device, cfg.param_dtype)


def llama_from_hf(source, dtype=None, device=None) -> Tuple[Any, Dict]:
    """(cfg, params) from a transformers model or a checkpoint path that
    ``LlamaForCausalLM.from_pretrained`` accepts."""
    if isinstance(source, str):
        from transformers import LlamaForCausalLM

        source = LlamaForCausalLM.from_pretrained(source)
    cfg = _with_dtype(llama_config_from_hf(source.config), dtype)
    return cfg, llama_params_from_hf(source.state_dict(), cfg, dtype=dtype,
                                     device=device)


def mixtral_from_hf(source, dtype=None, capacity_factor=None,
                    device=None) -> Tuple[Any, Dict]:
    """(cfg, params) from a transformers MixtralForCausalLM or a
    checkpoint path. Experts map w1 -> e_gate, w3 -> e_up, w2 -> e_down,
    stacked [L, E, ...].

    On parity: the MoE dispatches with a static capacity (overflow
    drops), where HF computes every token's experts; pass
    ``capacity_factor >= num_experts / top_k`` for drop-free parity."""
    from ray_tpu_torch.models.mixtral import MixtralConfig

    if isinstance(source, str):
        from transformers import MixtralForCausalLM

        source = MixtralForCausalLM.from_pretrained(source)
    hf_cfg = source.config
    sw = getattr(hf_cfg, "sliding_window", None)
    if sw is not None and sw < hf_cfg.max_position_embeddings:
        raise ValueError(
            f"unsupported HF config: sliding_window={sw} (this model "
            f"implements full causal attention only; sequences past the "
            f"window would silently diverge from HF)")
    cfg = _with_dtype(MixtralConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=hf_cfg.num_key_value_heads,
        head_dim=getattr(hf_cfg, "head_dim", None),
        max_seq_len=hf_cfg.max_position_embeddings,
        rope_theta=float(hf_cfg.rope_theta),
        rms_norm_eps=float(hf_cfg.rms_norm_eps),
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        num_experts=hf_cfg.num_local_experts,
        top_k=hf_cfg.num_experts_per_tok,
        rope_scaling=_parse_rope_scaling(hf_cfg),
    ), dtype)
    if capacity_factor is not None:
        cfg = replace(cfg, capacity_factor=float(capacity_factor))
    sd = source.state_dict()
    t, lin = _fetcher(sd)
    _refuse_proj_bias(sd)
    E = cfg.num_experts
    stacked: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "router",
        "e_gate", "e_up", "e_down")}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        _stack_attn(stacked, t, lin, p)
        moe = p + "block_sparse_moe."
        stacked["router"].append(lin(moe + "gate.weight"))
        for ours, w in (("e_gate", "w1"), ("e_up", "w3"), ("e_down", "w2")):
            stacked[ours].append(np.stack(
                [lin(f"{moe}experts.{e}.{w}.weight") for e in range(E)]))
    return cfg, _assemble(cfg, stacked, t, lin, cfg.param_dtype, device)


def qwen2_from_hf(source, dtype=None, device=None) -> Tuple[Any, Dict]:
    """(cfg, params) from a transformers Qwen2ForCausalLM or a checkpoint
    path. Qwen2 is the llama block plus additive q/k/v biases
    (``cfg.attn_qkv_bias``); any other bias refuses."""
    if isinstance(source, str):
        from transformers import Qwen2ForCausalLM

        source = Qwen2ForCausalLM.from_pretrained(source)
    hf_cfg = source.config
    sw = getattr(hf_cfg, "sliding_window", None)
    if getattr(hf_cfg, "use_sliding_window", False) and sw is not None \
            and sw < hf_cfg.max_position_embeddings:
        raise ValueError(
            f"unsupported HF config: sliding_window={sw} (full causal "
            f"attention only)")
    cfg = _with_dtype(llama_config_from_hf(hf_cfg, attn_qkv_bias=True),
                      dtype)
    sd = source.state_dict()
    bad = [k for k in sd if k.endswith(("o_proj.bias", "gate_proj.bias",
                                        "up_proj.bias", "down_proj.bias"))]
    if bad:
        raise ValueError(
            f"unsupported checkpoint: unexpected bias {bad[0]} (qwen2 "
            f"carries biases on q/k/v only)")
    t, lin = _fetcher(sd)
    stacked: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
        "w_up", "w_down", "bq", "bk", "bv")}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        _stack_attn(stacked, t, lin, p)
        stacked["bq"].append(t(p + "self_attn.q_proj.bias"))
        stacked["bk"].append(t(p + "self_attn.k_proj.bias"))
        stacked["bv"].append(t(p + "self_attn.v_proj.bias"))
        stacked["w_gate"].append(lin(p + "mlp.gate_proj.weight"))
        stacked["w_up"].append(lin(p + "mlp.up_proj.weight"))
        stacked["w_down"].append(lin(p + "mlp.down_proj.weight"))
    return cfg, _assemble(cfg, stacked, t, lin, cfg.param_dtype, device)


def gemma_from_hf(source, dtype=None, device=None) -> Tuple[Any, Dict]:
    """(cfg, params) from a transformers GemmaForCausalLM or a checkpoint
    path. Gemma's deltas from the llama block, all absorbed here: the
    GeGLU gate (``mlp_act``), embeddings scaled by sqrt(hidden)
    (``embed_scale``), the (1 + w) RMSNorm folded into the stored norm
    weights, the tied head and an explicit head_dim (256 on gemma-7b)."""
    if isinstance(source, str):
        from transformers import GemmaForCausalLM

        source = GemmaForCausalLM.from_pretrained(source)
    hf_cfg = source.config
    act = getattr(hf_cfg, "hidden_activation", None) or getattr(
        hf_cfg, "hidden_act", "gelu_pytorch_tanh")
    try:
        # "gelu" is transformers' exact erf GELU, not the tanh one
        mlp_act = {"gelu_pytorch_tanh": "gelu_tanh", "gelu": "gelu"}[act]
    except KeyError:
        raise ValueError(
            f"unsupported gemma hidden activation {act!r}") from None
    cfg = _with_dtype(LlamaConfig(
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        intermediate_size=hf_cfg.intermediate_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=getattr(hf_cfg, "num_key_value_heads", None)
        or hf_cfg.num_attention_heads,
        head_dim=getattr(hf_cfg, "head_dim", None),
        max_seq_len=hf_cfg.max_position_embeddings,
        rope_theta=float(getattr(hf_cfg, "rope_theta", 10000.0)),
        rms_norm_eps=float(hf_cfg.rms_norm_eps),
        tie_embeddings=True,  # gemma always ties lm_head to embeddings
        mlp_act=mlp_act,
        embed_scale=float(math.sqrt(hf_cfg.hidden_size)),
    ), dtype)
    state_dict = source.state_dict()
    t, lin = _fetcher(state_dict)
    _refuse_proj_bias(state_dict)
    stacked: Dict[str, list] = {k: [] for k in (
        "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
        "w_up", "w_down")}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        _stack_attn(stacked, t, lin, p)
        stacked["w_gate"].append(lin(p + "mlp.gate_proj.weight"))
        stacked["w_up"].append(lin(p + "mlp.up_proj.weight"))
        stacked["w_down"].append(lin(p + "mlp.down_proj.weight"))
    params = _assemble(cfg, stacked, t, lin, cfg.param_dtype, device)
    # gemma's RMSNorm computes normed * (1 + w): fold the +1 in here, in
    # the params' dtype, so ops/layers.rms_norm (normed * w) is exact
    for norms, key in ((params["layers"], "attn_norm"),
                       (params["layers"], "mlp_norm"),
                       (params, "final_norm")):
        norms[key] = norms[key] + 1
    return cfg, params


def hf_model_type(source) -> str:
    """The checkpoint's ``model_type`` without loading weights (the
    config only, for a path), so callers can refuse an architecture
    before paying for its weights."""
    if isinstance(source, str):
        from transformers import AutoConfig

        return AutoConfig.from_pretrained(source).model_type
    return source.config.model_type


def from_hf(source, dtype=None, device=None) -> Tuple[Any, Dict]:
    """The loader of the checkpoint's ``model_type``: llama, qwen2,
    gemma, mixtral or gpt2. Accepts a model or a checkpoint path."""
    model_type = hf_model_type(source)
    loader = {"llama": llama_from_hf, "qwen2": qwen2_from_hf,
              "gemma": gemma_from_hf,
              "mixtral": mixtral_from_hf, "gpt2": gpt2_from_hf}.get(
        model_type)
    if loader is None:
        raise ValueError(
            f"unsupported HF model_type {model_type!r} "
            f"(implemented: llama, qwen2, mixtral, gpt2)")
    return loader(source, dtype=dtype, device=device)
