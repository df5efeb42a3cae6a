"""Serving replica bodies: the continuous-batching dense engine
(``llm_engine.LLMEngine``) and the paged-KV engine with prefix cache
(``paged_engine.PagedLLMEngine``), both behind the submit / collect /
peek / cancel / stats / shutdown mailbox."""
