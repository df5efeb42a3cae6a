"""ObjectRef: a distributed future (reference: python/ray/includes/object_ref.pxi).

Serialization contract: pickling an ObjectRef emits a resolver call so that a
ref nested inside task args / put objects is reconstructed on the receiving
process bound to *that* process's core client (reference nests refs the same
way via CoreWorker serialization context). While the driver serializes task
args it also *collects* every ref it encounters so the scheduler can wait on
dependencies (reference: LocalDependencyResolver).
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

from ray_tpu_torch.core.ids import ObjectID

_collect_ctx = threading.local()


def begin_ref_collection() -> List["ObjectRef"]:
    refs: List[ObjectRef] = []
    _collect_ctx.refs = refs
    return refs


def end_ref_collection():
    _collect_ctx.refs = None


def _resolve_ref(oid_bytes: bytes) -> "ObjectRef":
    """Unpickle hook: rebuild the ref bound to the local core client."""
    from ray_tpu_torch.core import runtime_context

    return ObjectRef(ObjectID(oid_bytes), core=runtime_context.get_core_or_none())


class ObjectRef:
    __slots__ = ("_id", "_core", "__weakref__")

    def __init__(self, oid: ObjectID, core=None):
        self._id = oid
        self._core = core

    @property
    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def get(self, timeout: Optional[float] = None) -> Any:
        from ray_tpu_torch.core import runtime_context

        core = self._core or runtime_context.get_core()
        return core.get_objects([self], timeout=timeout)[0]

    def __reduce__(self):
        refs = getattr(_collect_ctx, "refs", None)
        if refs is not None:
            refs.append(self)
        return (_resolve_ref, (self._id.binary(),))

    def __hash__(self):
        return hash(self._id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __await__(self):
        """Allow ``await ref`` inside async actors."""
        from ray_tpu_torch.core import runtime_context

        core = self._core or runtime_context.get_core()
        fut = core.as_future(self)
        return fut.__await__()


_STREAM_DONE = object()


def _resolve_generator(seed: bytes, owner) -> "ObjectRefGenerator":
    """Unpickle hook: rebind the generator to the local core client."""
    from ray_tpu_torch.core import runtime_context

    return ObjectRefGenerator(
        seed, core=runtime_context.get_core_or_none(), owner=owner)


class ObjectRefGenerator:
    """Iterator over the returns of a ``num_returns="streaming"`` task
    (reference: ObjectRefGenerator, python/ray/_raylet.pyx:263).

    Each ``next()`` blocks until the producing generator has sealed the
    next yield, then hands back an ``ObjectRef`` — so consumption starts
    while the task is still running. Advancing the iterator reports the
    previous index consumed, releasing producer backpressure credit.
    A mid-stream task failure surfaces as a final ref whose ``get()``
    raises, followed by ``StopIteration``.
    """

    def __init__(self, seed: bytes, core=None, owner=None):
        self._seed = seed
        self._core = core
        self._owner = owner  # producing node addr hint (cluster path)
        self._index = 0
        self._end: Optional[int] = None

    @property
    def seed(self) -> bytes:
        return self._seed

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        return self.next_ref(timeout=None)

    def next_ref(self, timeout: Optional[float] = None) -> "ObjectRef":
        """Blocking next; raises StopIteration at end of stream and
        ObjectTimeoutError if ``timeout`` (seconds) elapses first."""
        if self._end is not None and self._index >= self._end:
            raise StopIteration
        from ray_tpu_torch.core import runtime_context

        core = self._core or runtime_context.get_core()
        kind, detail = core.stream_next(
            self._seed, self._index, timeout=timeout, owner=self._owner)
        if kind == "end":
            self._end = detail
            raise StopIteration
        ref = ObjectRef(ObjectID(detail), core=core)
        core.stream_consumed(self._seed, self._index, owner=self._owner)
        self._index += 1
        return ref

    def _next_or_done(self):
        try:
            return self.__next__()
        except StopIteration:
            return _STREAM_DONE

    def __aiter__(self):
        return self

    async def __anext__(self) -> "ObjectRef":
        import asyncio

        loop = asyncio.get_running_loop()
        res = await loop.run_in_executor(None, self._next_or_done)
        if res is _STREAM_DONE:
            raise StopAsyncIteration
        return res

    def __reduce__(self):
        return (_resolve_generator, (self._seed, self._owner))

    def __repr__(self):
        return (f"ObjectRefGenerator(seed={self._seed.hex()}, "
                f"next_index={self._index})")
