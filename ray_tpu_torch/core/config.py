"""The serving flags the port reads, resolved from the environment.

A copy of two rows of ``ray_tpu/core/config.py``'s flag table, read from
the same ``RTPU_<NAME>`` variables with the same parsing, so one
environment configures both packages::

    from ray_tpu_torch.core.config import config
    if config.serve_disagg: ...

``config.reload()`` re-reads the environment (tests, or after mutating
``os.environ``). The rest of the reference's table belongs to runtime
parts the port has not taken over.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional


@dataclass(frozen=True)
class Flag:
    name: str
    type: type
    default: Any
    doc: str

    @property
    def env_var(self) -> str:
        return "RTPU_" + self.name.upper()


def _parse_bool(s: str) -> bool:
    return s.strip().lower() not in ("", "0", "false", "no", "off")


_FLAGS: List[Flag] = [
    Flag("serve_disagg", bool, False,
         "Prefill/decode disaggregation for paged engine replicas: long "
         "prompts divert to dedicated prefill workers whose finished KV "
         "pages are adopted by the decode engine as cached prefixes. "
         "serve.disagg.engine_class() resolves the flag."),
    Flag("serve_prefill_workers", int, 1,
         "Dedicated prefill workers per disaggregated engine: each owns "
         "a private staging KV pool of the engine's geometry and "
         "prefills diverted prompts on its own CUDA stream."),
]


class _Config:
    """Singleton holding the resolved flag values as attributes."""

    def __init__(self):
        self.reload()

    def reload(self, env: Optional[Dict[str, str]] = None):
        """Re-resolve every flag from ``env`` (default ``os.environ``)."""
        env = os.environ if env is None else env
        for f in _FLAGS:
            raw = env.get(f.env_var)
            if raw is None:
                value = f.default
            elif f.type is bool:
                value = _parse_bool(raw)
            else:
                value = f.type(raw)
            object.__setattr__(self, f.name, value)


config = _Config()
