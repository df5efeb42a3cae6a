"""The port's HF checkpoint loaders against the JAX package's, on tiny
seeded transformers models of the five families (llama, qwen2, gemma,
gpt2, mixtral), on the CPU.

- Each loader gives the same parameter tree as its ``ray_tpu``
  counterpart, leaf for leaf in fp32, and the same config.
- The port's logits on the loaded weights match both the JAX forward
  and HF's own within 1e-4 in fp32.
- Every refusal (rope types, projection biases, sliding windows, Gemma
  activations, unknown model types) raises the reference's
  ``ValueError`` with the same message.
- ``llama_config_from_hf`` works on a plain attribute object, as
  ``chip_smoke.py`` calls it for the published Qwen2-7B and Gemma-7B
  configurations.
- Both port engines serve a saved checkpoint (``model_config={"hf_model":
  path}``) for llama, qwen2 and gemma with greedy transcripts equal to
  the JAX engine's and to ``hf.generate``'s.
"""

import dataclasses
import time
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu.models import hf_weights as jhf  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.models import mixtral as jmixtral  # noqa: E402
from ray_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from ray_tpu_torch.models import hf_weights as thf  # noqa: E402
from ray_tpu_torch.models import llama as tllama  # noqa: E402
from ray_tpu_torch.models import mixtral as tmixtral  # noqa: E402
from ray_tpu_torch.models.convert import params_to_numpy  # noqa: E402
from ray_tpu_torch.serve.llm_engine import LLMEngine  # noqa: E402
from ray_tpu_torch.serve.paged_engine import PagedLLMEngine  # noqa: E402

torch.set_num_threads(1)

FAMILIES = ("llama", "qwen2", "gemma", "gpt2", "mixtral")


def _hf_model(family, **over):
    """A tiny transformers model of ``family`` with weights drawn from
    torch seed 0 (qwen2's zero-initialised q/k/v biases randomised, so
    that the bias path is exercised)."""
    from transformers import (GemmaConfig, GemmaForCausalLM, GPT2Config,
                              GPT2LMHeadModel, LlamaConfig,
                              LlamaForCausalLM, MixtralConfig,
                              MixtralForCausalLM, Qwen2Config,
                              Qwen2ForCausalLM)

    dims = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128)
    torch.manual_seed(0)
    if family == "llama":
        cfg = LlamaConfig(**dims, rope_theta=500000.0, rms_norm_eps=1e-5,
                          tie_word_embeddings=False, attention_bias=False,
                          mlp_bias=False)
        cls = LlamaForCausalLM
    elif family == "qwen2":
        cfg = Qwen2Config(**dims, rope_theta=10000.0, rms_norm_eps=1e-6,
                          tie_word_embeddings=False)
        cls = Qwen2ForCausalLM
    elif family == "gemma":
        cfg = GemmaConfig(**dims, head_dim=24, rope_theta=10000.0,
                          rms_norm_eps=1e-6,
                          hidden_activation="gelu_pytorch_tanh")
        cls = GemmaForCausalLM
    elif family == "gpt2":
        cfg = GPT2Config(vocab_size=256, n_embd=64, n_layer=2, n_head=4,
                         n_positions=128)
        cls = GPT2LMHeadModel
    else:
        cfg = MixtralConfig(vocab_size=128, hidden_size=32,
                            intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4, num_key_value_heads=2,
                            num_local_experts=4, num_experts_per_tok=2,
                            max_position_embeddings=64, rope_theta=10000.0,
                            rms_norm_eps=1e-5)
        cls = MixtralForCausalLM
    for k, v in over.items():
        setattr(cfg, k, v)
    hf = cls(cfg).eval()
    if family == "qwen2":
        with torch.no_grad():
            for layer in hf.model.layers:
                for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                             layer.self_attn.v_proj):
                    proj.bias.normal_(0, 0.5)
    return hf


def _load(family, hf):
    """(JAX (cfg, params), port (cfg, params)) of the same model, fp32;
    mixtral with a drop-free capacity."""
    name = f"{family}_from_hf"
    kw = {"capacity_factor": 2.4} if family == "mixtral" else {}
    want = getattr(jhf, name)(hf, dtype=jnp.float32, **kw)
    got = getattr(thf, name)(hf, dtype=torch.float32, device="cpu", **kw)
    return want, got


def _leaves(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.asarray(v)
    return out


def _same_config(jcfg, tcfg):
    """Every field both configs have is equal (dtypes by name)."""
    names = {f.name for f in dataclasses.fields(tcfg)}
    for f in dataclasses.fields(jcfg):
        if f.name not in names:
            continue
        a, b = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            a, b = np.dtype(a).name, str(b).replace("torch.", "")
        assert a == b, (f.name, a, b)


@pytest.mark.parametrize("family", FAMILIES)
def test_loader_tree_and_config_equal_jax(family):
    hf = _hf_model(family)
    (jcfg, jparams), (tcfg, tparams) = _load(family, hf)
    want = _leaves(jparams)
    got = _leaves(params_to_numpy(tparams))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        assert got[name].dtype == np.float32, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert type(tcfg).__name__ == type(jcfg).__name__
    _same_config(jcfg, tcfg)


def _forward(family, pkg, cfg, params, tokens):
    if family == "gpt2":
        mod = jgpt2 if pkg == "jax" else tgpt2
    elif family == "mixtral":
        mod = jmixtral if pkg == "jax" else tmixtral
    else:
        mod = jllama if pkg == "jax" else tllama
    if pkg == "jax":
        cfg = dataclasses.replace(cfg, dtype=jnp.float32,
                                  attn_impl="reference", remat=False)
        out = mod.forward(cfg, params, jnp.asarray(tokens))
    else:
        cfg = dataclasses.replace(cfg, dtype=torch.float32,
                                  attn_impl="reference", remat=False)
        with torch.no_grad():
            out = mod.forward(cfg, params, torch.from_numpy(tokens))
    out = out[0] if isinstance(out, tuple) else out
    return np.asarray(out)


@pytest.mark.parametrize("family", FAMILIES)
def test_port_logits_match_jax_and_hf(family):
    hf = _hf_model(family)
    (jcfg, jparams), (tcfg, tparams) = _load(family, hf)
    vocab = hf.config.vocab_size
    tokens = np.random.default_rng(3).integers(0, vocab, (2, 19))
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.numpy()
    want = _forward(family, "jax", jcfg, jparams, tokens)
    got = _forward(family, "torch", tcfg, tparams, tokens)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("act,ours", [("gelu_pytorch_tanh", "gelu_tanh"),
                                      ("gelu", "gelu")])
def test_gemma_activation_and_norm_fold(act, ours):
    """Both Gemma activations load as the reference's (``gelu`` is the
    exact erf GELU) and the (1 + w) norms are folded."""
    hf = _hf_model("gemma", hidden_activation=act)
    (jcfg, jparams), (tcfg, tparams) = _load("gemma", hf)
    assert tcfg.mlp_act == jcfg.mlp_act == ours
    assert tcfg.tie_embeddings and tcfg.embed_scale == 8.0
    assert tcfg.head_dim_ == 24
    w = hf.model.norm.weight.detach().numpy()
    np.testing.assert_array_equal(
        params_to_numpy(tparams)["final_norm"], (w + 1).astype(np.float32))
    tokens = np.random.default_rng(4).integers(0, 256, (1, 11))
    with torch.no_grad():
        ref = hf(torch.from_numpy(tokens)).logits.numpy()
    got = _forward("gemma", "torch", tcfg, tparams, tokens)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def _bias_source(family, key):
    """A stand-in model whose state dict carries one more bias tensor."""
    hf = _hf_model(family)
    sd = dict(hf.state_dict())
    sd[key] = torch.zeros(hf.config.hidden_size)
    return types.SimpleNamespace(config=hf.config, state_dict=lambda: sd)


def _refusal_cases():
    def rope(family):
        def make():
            hf = _hf_model(family)
            hf.config.rope_scaling = {"rope_type": "longrope", "factor": 4.0}
            return hf
        return make

    return {
        "llama_longrope": ("llama_from_hf", rope("llama"), {}),
        "mixtral_longrope": ("mixtral_from_hf", rope("mixtral"), {}),
        "llama_attention_bias": (
            "llama_from_hf", lambda: _hf_model("llama", attention_bias=True),
            {}),
        "llama_proj_bias": (
            "llama_from_hf",
            lambda: _bias_source("llama", "model.layers.0.self_attn."
                                          "o_proj.bias"), {}),
        "gemma_proj_bias": (
            "gemma_from_hf",
            lambda: _bias_source("gemma", "model.layers.1.mlp."
                                          "down_proj.bias"), {}),
        "qwen2_o_proj_bias": (
            "qwen2_from_hf",
            lambda: _bias_source("qwen2", "model.layers.0.self_attn."
                                          "o_proj.bias"), {}),
        "qwen2_sliding_window": (
            "qwen2_from_hf",
            lambda: _hf_model("qwen2", use_sliding_window=True,
                              sliding_window=16), {}),
        "mixtral_sliding_window": (
            "mixtral_from_hf", lambda: _hf_model("mixtral",
                                                 sliding_window=16), {}),
        "gemma_activation": (
            "gemma_from_hf", lambda: _hf_model("gemma",
                                               hidden_activation="relu"),
            {}),
        "unknown_model_type": (
            "from_hf", lambda: types.SimpleNamespace(
                config=types.SimpleNamespace(model_type="bert")), {}),
    }


REFUSALS = _refusal_cases()


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case):
    name, make, kw = REFUSALS[case]
    source = make()
    with pytest.raises(ValueError) as want:
        getattr(jhf, name)(source, **kw)
    with pytest.raises(ValueError) as got:
        getattr(thf, name)(source, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_proj_bias_refusal_in_llama_params_from_hf():
    hf = _hf_model("llama")
    sd = dict(hf.state_dict())
    sd["model.layers.1.self_attn.q_proj.bias"] = torch.zeros(64)
    jcfg = jhf.llama_config_from_hf(hf.config)
    tcfg = thf.llama_config_from_hf(hf.config)
    with pytest.raises(ValueError) as want:
        jhf.llama_params_from_hf(sd, jcfg)
    with pytest.raises(ValueError) as got:
        thf.llama_params_from_hf(sd, tcfg, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("model", sorted(chip_smoke.PUBLISHED))
def test_llama_config_from_plain_attributes(model):
    """The published configurations ``chip_smoke.py`` serves, built from
    plain attribute objects as it builds them (without transformers):
    the port's config equals the reference's, and the
    shapes are the ones the kernels were widened for."""
    attrs = types.SimpleNamespace(**chip_smoke.PUBLISHED[model])
    want = jhf.llama_config_from_hf(attrs, attn_qkv_bias=model == "Qwen2-7B")
    got = chip_smoke.published_config(model)
    deltas = {"Gemma-7B": dict(mlp_act="gelu_tanh",
                               embed_scale=float(np.sqrt(3072)))}
    want = dataclasses.replace(want, **deltas.get(model, {}))
    _same_config(want, got)
    group = got.num_heads // got.num_kv_heads
    assert (group, got.head_dim_) == {"Qwen2-7B": (7, 128),
                                      "Gemma-7B": (1, 256)}[model]


def test_loaders_default_to_the_card():
    hf = _hf_model("llama")
    if torch.cuda.is_available():
        _, params = thf.llama_from_hf(hf)
        assert params["embed"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            thf.llama_from_hf(hf)


def test_from_hf_loads_a_saved_checkpoint(tmp_path):
    hf = _hf_model("gemma")
    hf.save_pretrained(str(tmp_path))
    assert thf.hf_model_type(str(tmp_path)) == "gemma"
    cfg, params = thf.from_hf(str(tmp_path), dtype="float32", device="cpu")
    _, want = thf.gemma_from_hf(hf, dtype=torch.float32, device="cpu")
    assert cfg.param_dtype == torch.float32
    got, want = _leaves(params_to_numpy(params)), _leaves(
        params_to_numpy(want))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ---------------------------------------------------------------- engines

PROMPTS = [[5, 3, 7], [9, 1, 4, 4, 2, 8, 6, 3, 11, 2, 7, 1, 5]]


def _drain(engine, reqs, timeout_s=120):
    try:
        for rid, prompt in reqs:
            engine.submit(rid, prompt)
        out = {}
        deadline = time.time() + timeout_s
        while len(out) < len(reqs) and time.time() < deadline:
            out.update(engine.collect())
            time.sleep(0.005)
        return {k: v["tokens"] for k, v in out.items()}
    finally:
        engine.shutdown()


@pytest.mark.parametrize("family", ("llama", "qwen2", "gemma"))
def test_engines_serve_hf_checkpoint_like_jax_and_hf(family, tmp_path):
    """Greedy transcripts of a saved checkpoint through the port's dense
    and paged engines equal the JAX engine's and HF's ``generate``."""
    from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine

    hf = _hf_model(family)
    hf.save_pretrained(str(tmp_path))
    mc = {"hf_model": str(tmp_path), "dtype": "float32",
          "param_dtype": "float32"}
    kw = dict(num_slots=2, max_len=32, prefill_buckets=[16],
              max_new_tokens=6, chunk_steps=2)
    reqs = [(f"r{i}", p) for i, p in enumerate(PROMPTS)]
    ref = {}
    for rid, prompt in reqs:
        out = hf.generate(torch.tensor([prompt]), max_new_tokens=6,
                          do_sample=False)
        ref[rid] = out[0, len(prompt):].tolist()
    jax_tokens = _drain(JaxEngine(model_config=dict(mc), **kw), reqs)
    dense = _drain(LLMEngine(model_config=dict(mc), device="cpu", **kw),
                   reqs)
    paged = _drain(PagedLLMEngine(model_config=dict(mc), page_size=8,
                                  device="cpu", **kw), reqs)
    assert jax_tokens == ref
    assert dense == ref
    assert paged == ref


@pytest.mark.parametrize("family", ("gpt2", "mixtral"))
def test_engine_refuses_other_model_types(family):
    with pytest.raises(ValueError, match="llama-family"):
        LLMEngine(model_config={"hf_model": _hf_model(family)},
                  device="cpu")
