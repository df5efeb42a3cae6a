"""Serving replica bodies: the continuous-batching dense engine
(``llm_engine.LLMEngine``), the paged-KV engine with prefix cache
(``paged_engine.PagedLLMEngine``) and the paged engine with
disaggregated prefill workers (``disagg.DisaggPagedEngine``), all behind
the submit / collect / peek / cancel / stats / shutdown mailbox. The
first two also serve tensor-parallel over several ranks (``tp``: the
process group, the command link and the weight scatter)."""
