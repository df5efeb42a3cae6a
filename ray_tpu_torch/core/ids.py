"""Unique identifiers for jobs, tasks, actors, objects, nodes, and placement groups.

TPU-native analogue of the reference's ID types (ref: src/ray/common/id.h,
src/ray/common/id_def.h). IDs are fixed-length random byte strings with a cheap
hex representation. Unlike the reference we do not embed lineage information in
object IDs; ownership metadata lives in the driver-side object directory.
"""

from __future__ import annotations

import os
import threading

from ray_tpu_torch.util.debug_lock import make_lock

_ID_LENGTH = 16  # bytes; reference uses 28 for ObjectID, 16 is plenty single-cluster.


class BaseID:
    """A fixed-length immutable binary identifier."""

    __slots__ = ("_bytes", "_hash")

    LENGTH = _ID_LENGTH

    def __init__(self, id_bytes: bytes):
        if not isinstance(id_bytes, bytes) or len(id_bytes) != self.LENGTH:
            raise ValueError(
                f"{type(self).__name__} requires {self.LENGTH} bytes, "
                f"got {id_bytes!r}"
            )
        self._bytes = id_bytes
        self._hash = hash((type(self).__name__, id_bytes))

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.LENGTH))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.LENGTH)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.LENGTH

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __ne__(self, other):
        return not self.__eq__(other)

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    LENGTH = 4


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class ObjectID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class _Counter:
    """Thread-safe monotonically increasing counter (for deterministic sub-IDs)."""

    def __init__(self):
        self._value = 0
        self._lock = make_lock("_IdGen._lock")

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value


_task_counter = _Counter()


def make_task_id(job_id: JobID) -> TaskID:
    """Derive a unique task ID: 4 job bytes + 8 counter bytes + 4 random."""
    n = _task_counter.next()
    return TaskID(job_id.binary() + n.to_bytes(8, "little") + os.urandom(4))


def make_object_id() -> ObjectID:
    return ObjectID.from_random()
