"""The disaggregated engine's prefill workers and the weights' stream.

Each prefill worker runs on a CUDA stream of its own. The weights it
reads are made by work queued on another stream (drawn or loaded by the
caller, on its current stream), and a new stream does not follow that
stream: a worker that prefills before those writes land reads garbage.
The worker's stream therefore first waits for an event recorded where
the engine placed its weights (``DisaggPagedEngine._init_programs``).

CPU tensors are written synchronously, so the race cannot show on the
CPU: the test needs the card (``-m card``) and skips here. On the card
it queues about a second of device work on the default stream ahead of
the weights' copy, builds the engine at once and diverts a prompt to a
worker: its tokens must equal those of the same engine built after a
synchronise. No JAX is imported, so the file runs on the chip as it is:
``python -m pytest -m card tests/test_torch_disagg_streams.py``.
"""

import pytest

torch = pytest.importorskip("torch")


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _tokens(engine, prompt, timeout_s=120):
    import time

    engine.submit("r", prompt)
    deadline = time.monotonic() + timeout_s
    out = {}
    while "r" not in out and time.monotonic() < deadline:
        out.update(engine.collect())
        time.sleep(0.005)
    engine.shutdown()
    assert "r" in out, "the request timed out"
    return out["r"]["tokens"]


@pytest.mark.card
def test_prefill_worker_waits_for_the_weights():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the race is between two CUDA "
                    "streams; run on the chip with python -m pytest -m "
                    "card tests/test_torch_disagg_streams.py")
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.disagg import DisaggPagedEngine

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, seed=0, device=dev)
    kw = dict(model_config={"preset": "tiny"}, num_slots=2, max_len=128,
              prefill_buckets=[32, 64], max_new_tokens=8, page_size=16,
              prefill_workers=1, divert_min_tokens=32,
              handoff_timeout_s=60.0, device=dev)
    prompt = [int(t) for t in torch.randint(
        1, cfg.vocab_size, (60,), generator=torch.Generator().manual_seed(5))]
    torch.cuda.synchronize()
    want = _tokens(DisaggPagedEngine(params=params, **kw), prompt)
    # about a second of device time ahead of the copy of the weights, all
    # on the default stream; the engine is built and fed at once
    torch.cuda._sleep(2_000_000_000)
    late = _clone(params)
    engine = DisaggPagedEngine(params=late, **kw)
    got = _tokens(engine, prompt)
    assert engine.stats()["disagg_handoffs"] == 1
    assert got == want
