"""Replica actor: hosts one copy of a deployment's callable.

The port's copy of ``ray_tpu/serve/replica.py``.

Reference: serve/_private/replica.py. Request concurrency lives in the
router (dynamic batching, pow-2 balancing); engine-style deployments (LLM
continuous batching) run their own background thread and expose a
submit/collect mailbox the router polls — actor calls stay short so the
replica's queue never blocks behind a long generation.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List

import ray_tpu_torch

#: bound on the applied-results memo: old entries age out FIFO once the
#: router has long since resolved (or abandoned) the request
_APPLIED_LIMIT = 1024


@ray_tpu_torch.remote
class ReplicaActor:
    def __init__(self, pickled_def: bytes, init_args: tuple,
                 init_kwargs: dict):
        import cloudpickle

        target = cloudpickle.loads(pickled_def)
        if isinstance(target, type):
            self._instance = target(*init_args, **init_kwargs)
            self._call = getattr(self._instance, "__call__", None)
        else:
            self._instance = None
            self._call = target
        # engine-style mailbox (LLM continuous batching)
        self._is_engine = (self._instance is not None
                           and hasattr(self._instance, "submit")
                           and hasattr(self._instance, "collect"))
        # DAG-mode pipeline deployments get the request's REMAINING
        # deadline forwarded into dag.execute (compiled spin lane)
        from ray_tpu_torch.serve.dag_mode import PipelineDeployment

        self._is_pipeline = isinstance(self._instance, PipelineDeployment)
        self._collect_takes_ids = False
        if self._is_engine:
            import inspect

            try:
                sig = inspect.signature(self._instance.collect)
                self._collect_takes_ids = len(sig.parameters) >= 1
            except (TypeError, ValueError):
                pass
        # exactly-once dedup memo: requests dispatched under
        # serve_request_replay carry a nonce; a replayed nonce whose
        # first attempt already executed here (reply lost, not request)
        # returns the recorded result instead of re-running side effects
        self._applied: OrderedDict = OrderedDict()

    def _applied_put(self, nonce: str, result: Any) -> None:
        self._applied[nonce] = result
        while len(self._applied) > _APPLIED_LIMIT:
            self._applied.popitem(last=False)

    def ping(self) -> str:
        return "ok"

    def graceful_shutdown(self) -> None:
        """Pre-kill hook: deployments holding external resources (DAG-mode
        pipelines with stage actors, engines with device state) clean up
        here — a bare kill would leak actors that outlive this replica."""
        inst = self._instance
        if inst is not None and hasattr(inst, "shutdown"):
            try:
                inst.shutdown()
            except Exception:  # noqa: BLE001
                pass

    def is_engine(self) -> bool:
        return self._is_engine

    def handle(self, args: tuple, kwargs: dict) -> Any:
        from ray_tpu_torch.serve.multiplex import _MUX_KWARG, _current_model_id
        from ray_tpu_torch.serve.retry import _NONCE_KWARG

        nonce = kwargs.pop(_NONCE_KWARG, None)
        if nonce is not None and nonce in self._applied:
            # replay of a request that already executed here (the reply
            # was lost, not the request): exactly-once, skip re-execution
            return self._applied[nonce]
        deadline = self._check_deadline(kwargs)
        if deadline is not None and self._is_pipeline:
            kwargs["_deadline"] = deadline
        mid = kwargs.pop(_MUX_KWARG, None)
        if mid is not None:
            token = _current_model_id.set(mid)
            try:
                out = self._call(*args, **kwargs)
            finally:
                _current_model_id.reset(token)
        else:
            out = self._call(*args, **kwargs)
        if nonce is not None:
            self._applied_put(nonce, out)
        return out

    @staticmethod
    def _check_deadline(kwargs: dict):
        """Requests carry their wall-clock deadline in an internal kwarg
        (the router injects it); one already expired by the time it
        reaches the replica — queued behind slow work — is shed here
        with BackpressureError instead of burning compute on a result
        the client stopped waiting for. Returns the deadline (or None)
        so pipeline deployments can cap their DAG hop timeout with the
        remaining budget."""
        import time

        from ray_tpu_torch.exceptions import BackpressureError
        from ray_tpu_torch.serve.router import _DEADLINE_KWARG

        deadline = kwargs.pop(_DEADLINE_KWARG, None)
        if deadline is not None and time.time() > deadline:
            raise BackpressureError(
                "request shed at replica: deadline expired before "
                "execution started")
        return deadline

    def handle_stream(self, args: tuple, kwargs: dict):
        """Generator deployments: invoked with num_returns="streaming" so
        every yielded item seals into the object store as produced and the
        router consumes refs via ObjectRefGenerator — no mailbox polling."""
        from ray_tpu_torch.serve.multiplex import _MUX_KWARG, _current_model_id

        mid = kwargs.pop(_MUX_KWARG, None)
        token = _current_model_id.set(mid) if mid is not None else None
        try:
            yield from self._call(*args, **kwargs)
        finally:
            if token is not None:
                _current_model_id.reset(token)

    def handle_batch(self, requests: List[tuple]) -> List[Any]:
        """Dynamic batching: the router flushes a list of (args, kwargs);
        the deployment's batch callable receives the list of first args
        (reference @serve.batch semantics: fn(list) -> list). Under
        replay each member carries its own nonce: a replayed batch runs
        the callable only on members this replica has not executed yet
        (a prior attempt may have partially/fully executed before the
        reply was lost) and splices memoized results back in order."""
        from ray_tpu_torch.serve.retry import _NONCE_KWARG

        nonces = [kw.pop(_NONCE_KWARG, None) for _, kw in requests]
        items = [a[0] if a else None for a, _ in requests]
        fresh = [i for i, n in enumerate(nonces)
                 if n is None or n not in self._applied]
        results: List[Any] = [None] * len(items)
        if fresh:
            out = self._call([items[i] for i in fresh])
            if not isinstance(out, (list, tuple)) or len(out) != len(fresh):
                raise ValueError(
                    "@serve.batch callable must return a list of the same "
                    f"length as its input (got {type(out).__name__})")
            for i, r in zip(fresh, out):
                results[i] = r
                if nonces[i] is not None:
                    self._applied_put(nonces[i], r)
        for i, n in enumerate(nonces):
            if i not in fresh and n is not None:
                results[i] = self._applied[n]
        return results

    def call_method(self, method: str, args: tuple, kwargs: dict) -> Any:
        from ray_tpu_torch.serve.retry import _NONCE_KWARG

        nonce = kwargs.pop(_NONCE_KWARG, None)
        if nonce is not None and nonce in self._applied:
            return self._applied[nonce]
        out = getattr(self._instance, method)(*args, **kwargs)
        if nonce is not None:
            self._applied_put(nonce, out)
        return out

    # ---- engine mailbox ----------------------------------------------------

    def submit(self, req_id: str, *args, **kwargs) -> None:
        self._instance.submit(req_id, *args, **kwargs)

    def collect(self, req_ids=None) -> Dict[str, Any]:
        """{req_id: result} for finished requests since last collect."""
        if self._collect_takes_ids:
            return self._instance.collect(req_ids)
        return self._instance.collect()

    def peek(self, req_ids=None, since=None) -> Dict[str, Any]:
        """Streaming progress snapshot (engines that support it); None
        signals the engine has no streaming surface."""
        if hasattr(self._instance, "peek"):
            try:
                return self._instance.peek(req_ids, since)
            except TypeError:
                return self._instance.peek(req_ids)
        return None

    def cancel(self, req_id: str) -> None:
        if hasattr(self._instance, "cancel"):
            self._instance.cancel(req_id)

    def engine_stats(self) -> dict:
        if hasattr(self._instance, "stats"):
            return self._instance.stats()
        return {}

    def residency_digest(self) -> Any:
        """Prefix-cache residency snapshot for cache-affinity routing
        (serve/affinity.py); None for deployments without the surface —
        the router must keep routing those blind, never error."""
        inst = self._instance
        if inst is not None and hasattr(inst, "residency_digest"):
            try:
                return inst.residency_digest()
            except Exception:  # noqa: BLE001
                return None
        return None
