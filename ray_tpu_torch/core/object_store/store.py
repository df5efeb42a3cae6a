"""Python client for the shared-memory object store.

Zero-copy reads: ``get`` returns a memoryview directly over the shared
mapping; the object stays pinned (refcount) until ``release``. The plasma
equivalent in the reference exposes the same create/seal/get/release/delete
lifecycle (src/ray/object_manager/plasma/client.h), but over a unix-socket
protocol — here every process talks to the mapping directly.
"""

from __future__ import annotations

import ctypes
import mmap
import os
from typing import Optional

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_store.build import ensure_built
from ray_tpu_torch.exceptions import ObjectStoreFullError, ObjectTimeoutError


def _load_lib() -> ctypes.CDLL:
    # RTPU_STORE_LIB: a prebuilt library (the store_lib config row)
    override = os.environ.get("RTPU_STORE_LIB")
    try:
        lib = ctypes.CDLL(override or ensure_built())
    except OSError:
        if override:
            raise
        # a cached binary can be ABI-incompatible with this host (a
        # build directory copied from another machine); recompile from
        # source and retry
        lib = ctypes.CDLL(ensure_built(force=True))
    if not hasattr(lib, "rtpu_chan_wait_spin") and not override:
        # cached .so predates the spin entry point; rebuild from source
        lib = ctypes.CDLL(ensure_built(force=True))
    lib.rtpu_store_create.restype = ctypes.c_void_p
    lib.rtpu_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
    lib.rtpu_store_connect.restype = ctypes.c_void_p
    lib.rtpu_store_connect.argtypes = [ctypes.c_char_p]
    lib.rtpu_store_close.argtypes = [ctypes.c_void_p]
    lib.rtpu_store_destroy.argtypes = [ctypes.c_char_p]
    lib.rtpu_store_base.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.rtpu_store_base.argtypes = [ctypes.c_void_p]
    lib.rtpu_store_mapping_size.restype = ctypes.c_uint64
    lib.rtpu_store_mapping_size.argtypes = [ctypes.c_void_p]
    lib.rtpu_store_create_object.restype = ctypes.c_uint64
    lib.rtpu_store_create_object.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.rtpu_store_seal.restype = ctypes.c_int
    lib.rtpu_store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_seal_retain.restype = ctypes.c_int
    lib.rtpu_store_seal_retain.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_get.restype = ctypes.c_int
    lib.rtpu_store_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.rtpu_store_release.restype = ctypes.c_int
    lib.rtpu_store_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_contains.restype = ctypes.c_int
    lib.rtpu_store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_delete.restype = ctypes.c_int
    lib.rtpu_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_store_stats.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_uint64)] * 4
    lib.rtpu_store_prefault.argtypes = [ctypes.c_void_p]
    lib.rtpu_store_refcount.restype = ctypes.c_int64
    lib.rtpu_store_refcount.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.rtpu_chan_header_size.restype = ctypes.c_uint64
    lib.rtpu_chan_header_size.argtypes = []
    lib.rtpu_chan_init.restype = ctypes.c_int
    lib.rtpu_chan_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.rtpu_chan_seqno.restype = ctypes.c_uint64
    lib.rtpu_chan_seqno.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                    ctypes.c_int]
    lib.rtpu_chan_post.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_int, ctypes.c_uint64]
    lib.rtpu_chan_wait.restype = ctypes.c_uint64
    lib.rtpu_chan_wait.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_int, ctypes.c_uint64,
                                   ctypes.c_int]
    if hasattr(lib, "rtpu_chan_wait_spin"):
        # an RTPU_STORE_LIB override built before the spin entry point
        # stays usable: chan_wait_spin falls back to the blocking wait
        lib.rtpu_chan_wait_spin.restype = ctypes.c_uint64
        lib.rtpu_chan_wait_spin.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_uint32]
    return lib


_lib: Optional[ctypes.CDLL] = None


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load_lib()
    return _lib


class ShmObjectStore:
    """Handle to a shared-memory object store (creator or connected client)."""

    def __init__(self, name: str, handle: int, owner: bool):
        self._name = name
        self._handle = handle
        self._owner = owner
        # Optional backpressure hook: called with a byte count when an
        # allocation fails; returns True if space may have been freed
        # (spilling). The runtime installs its spill manager here; workers
        # install an RPC to the owner.
        self.need_space_hook = None
        lib = _get_lib()
        size = lib.rtpu_store_mapping_size(handle)
        base = lib.rtpu_store_base(handle)
        # A writable zero-copy view over the whole mapping.
        self._mv = memoryview(
            ctypes.cast(base, ctypes.POINTER(ctypes.c_uint8 * size)).contents
        ).cast("B")

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(cls, name: str, capacity: int, table_slots: int = 0) -> "ShmObjectStore":
        handle = _get_lib().rtpu_store_create(name.encode(), capacity, table_slots)
        if not handle:
            raise OSError(f"failed to create shm store {name!r}")
        return cls(name, handle, owner=True)

    @classmethod
    def connect(cls, name: str) -> "ShmObjectStore":
        handle = _get_lib().rtpu_store_connect(name.encode())
        if not handle:
            raise OSError(f"failed to connect to shm store {name!r}")
        return cls(name, handle, owner=False)

    def close(self):
        if self._handle:
            try:
                self._mv.release()
            except BufferError:
                pass  # zero-copy views still exported; mapping stays alive
            _get_lib().rtpu_store_close(self._handle)
            if self._owner:
                _get_lib().rtpu_store_destroy(self._name.encode())
            self._handle = 0

    @property
    def name(self) -> str:
        return self._name

    # -- object lifecycle ----------------------------------------------------

    def _h(self) -> int:
        if not self._handle:
            raise ValueError("object store is closed")
        return self._handle

    def create_object(self, oid: ObjectID, size: int) -> memoryview:
        """Allocate an unsealed object; returns a writable view of its payload."""
        off = _get_lib().rtpu_store_create_object(self._h(), oid.binary(), size)
        if off == 0:
            raise ObjectStoreFullError(
                f"cannot allocate {size} bytes for {oid} (store full or duplicate)"
            )
        return self._mv[off : off + size]

    def seal(self, oid: ObjectID, retain: bool = False):
        """Seal an object. With ``retain`` the creator reference is kept
        (refcount >= 1) for handoff to the owner's tracking pin — there is
        never an evictable refcount==0 window for a live object."""
        fn = (_get_lib().rtpu_store_seal_retain if retain
              else _get_lib().rtpu_store_seal)
        if fn(self._h(), oid.binary()) != 0:
            raise ValueError(f"seal failed for {oid}")

    def put(self, oid: ObjectID, data, retain: bool = False) -> None:
        """Allocate + copy + seal in one call."""
        view = memoryview(data).cast("B")
        dst = self.create_object(oid, view.nbytes)
        dst[:] = view
        self.seal(oid, retain=retain)

    def get(self, oid: ObjectID, timeout_ms: int = -1) -> memoryview:
        """Blocking get; returns a zero-copy read view, pinning the object.

        Call :meth:`release` when the view is no longer needed.
        """
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = _get_lib().rtpu_store_get(
            self._h(), oid.binary(), timeout_ms, ctypes.byref(off), ctypes.byref(size)
        )
        if rc != 0:
            raise ObjectTimeoutError(f"object {oid} not available within {timeout_ms}ms")
        return self._mv[off.value : off.value + size.value]

    def release(self, oid: ObjectID):
        # Pin finalizers (zero-copy numpy views) can fire at interpreter
        # exit, after close(); the C handle is freed then — never call in.
        if not self._handle:
            return
        _get_lib().rtpu_store_release(self._handle, oid.binary())

    def contains(self, oid: ObjectID) -> bool:
        return bool(_get_lib().rtpu_store_contains(self._h(), oid.binary()))

    def refcount(self, oid: ObjectID) -> int:
        """Current refcount (-1 if absent)."""
        return int(_get_lib().rtpu_store_refcount(self._h(), oid.binary()))

    def create_object_with_pressure(self, oid: ObjectID, size: int
                                    ) -> memoryview:
        """create_object, invoking the need_space hook and retrying once
        when the store is full."""
        try:
            return self.create_object(oid, size)
        except ObjectStoreFullError:
            hook = self.need_space_hook
            if hook is None or not hook(size):
                raise
            return self.create_object(oid, size)

    def delete(self, oid: ObjectID):
        _get_lib().rtpu_store_delete(self._h(), oid.binary())

    def prefault(self):
        """Blocking eager population of the heap (content-preserving)."""
        _get_lib().rtpu_store_prefault(self._h())

    # -- channel primitives (seqno-gated mutable regions; see dag/channel.py)

    def object_offset(self, oid: ObjectID) -> int:
        """Mapping offset of a sealed object's payload (pins it)."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = _get_lib().rtpu_store_get(
            self._h(), oid.binary(), 0, ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            raise ObjectTimeoutError(f"object {oid} not found")
        return off.value

    def chan_header_size(self) -> int:
        return int(_get_lib().rtpu_chan_header_size())

    def chan_init(self, offset: int):
        if _get_lib().rtpu_chan_init(self._h(), offset) != 0:
            raise OSError("channel init failed")

    def chan_counter(self, offset: int, which: int) -> int:
        return int(_get_lib().rtpu_chan_seqno(self._h(), offset, which))

    def chan_post(self, offset: int, which: int, value: int):
        _get_lib().rtpu_chan_post(self._h(), offset, which, value)

    def chan_wait(self, offset: int, which: int, last: int,
                  timeout_ms: int) -> int:
        return int(_get_lib().rtpu_chan_wait(self._h(), offset, which, last,
                                             timeout_ms))

    def chan_wait_spin(self, offset: int, which: int, last: int,
                       timeout_ms: int, spin_us: int) -> int:
        """chan_wait with a busy-poll budget of ``spin_us`` microseconds
        before the condvar fallback (0 = pure block). Degrades to
        chan_wait under an RTPU_STORE_LIB override lacking the symbol."""
        lib = _get_lib()
        if spin_us <= 0 or not hasattr(lib, "rtpu_chan_wait_spin"):
            return int(lib.rtpu_chan_wait(self._h(), offset, which, last,
                                          timeout_ms))
        return int(lib.rtpu_chan_wait_spin(self._h(), offset, which, last,
                                           timeout_ms, spin_us))

    def view(self, offset: int, size: int) -> memoryview:
        return self._mv[offset: offset + size]

    def stats(self) -> dict:
        vals = [ctypes.c_uint64() for _ in range(4)]
        _get_lib().rtpu_store_stats(self._h(), *[ctypes.byref(v) for v in vals])
        return {
            "heap_size": vals[0].value,
            "bytes_in_use": vals[1].value,
            "num_objects": vals[2].value,
            "evictions": vals[3].value,
        }


def default_store_capacity() -> int:
    """A configurable fraction of system memory (default 30%), capped at
    4 GiB (single host; same heuristic as the reference —
    python/ray/_private/ray_constants.py)."""
    from ray_tpu_torch.core.config import config

    try:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):
        total = 8 << 30
    return min(int(total * config.object_store_memory_fraction), 4 << 30)
