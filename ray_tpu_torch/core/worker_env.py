"""Env rules shared by BOTH worker spawn paths (cold Popen and zygote
fork). One definition so a new device env rule can never apply to one
path and silently miss the other."""

from __future__ import annotations


def sanitize_cpu_worker_env(env) -> None:
    """Hide every card from a plain CPU pool worker.

    A worker that imports torch and touches CUDA would open a context
    (hundreds of MB of device memory) on a card that a GPU actor owns;
    with ``CUDA_VISIBLE_DEVICES=""`` CUDA finds no device and
    ``torch.cuda.is_available()`` is false. GPU actors' workers get
    their ids instead (``Runtime._start_actor``). Mutates ``env`` in
    place (works for both a dict and os.environ)."""
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("RTPU_GPU_IDS", None)
