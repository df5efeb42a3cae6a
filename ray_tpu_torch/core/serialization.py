"""Serialization for task args/returns and ``put`` objects.

Pickle protocol 5 with out-of-band buffers (the reference uses the same
approach via cloudpickle: python/ray/_private/serialization.py). Large buffer
payloads (numpy arrays, torch tensors, bytes) are written to the
shared-memory object store and mapped zero-copy on read; small objects are
inlined into control messages (reference inlines <100KB task returns into the
in-process memory store).

Torch tensors travel as numpy arrays do: a dense tensor of any dtype (bf16
included) is pickled as its dtype, shape and a byte view of its storage,
which goes out of band; the receiver rebuilds a CPU tensor over the buffer
(over the shm mapping for a stored object: no copy). A CUDA tensor is
copied to the host for transport and arrives as a CPU tensor: unlike a
``jax.Array``, which unpickles onto the receiver's default device, torch
has no default device, so the receiver moves it where it wants it. The
reducer is registered only once ``torch`` has been imported by someone
else: this module never imports torch.

Wire container format (used both inline and inside a shm object)::

    u32  magic        (0x52545055 'RTPU')
    u32  num_buffers
    u64  pickle_len
    u64  buffer_len[num_buffers]
    ...  pickled bytes
    ...  buffers, each 64-byte aligned
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
from typing import Any, List, Tuple

import cloudpickle

_MAGIC = 0x52545055
_ALIGN = 64
# Objects whose serialized size is below this are inlined into control-plane
# messages instead of the shm store (reference: 100KB task-return inline cap).
from ray_tpu_torch.core.config import config as _config


def inline_threshold() -> int:
    """Size cutoff below which values travel inline rather than via shm.
    Read per-call so config.reload() takes effect (flag:
    inline_threshold_bytes)."""
    return _config.inline_threshold_bytes


def _align(offset: int) -> int:
    return (offset + _ALIGN - 1) & ~(_ALIGN - 1)


def _rebuild_tensor(buf, dtype: str, shape: tuple, requires_grad: bool):
    """Unpickle a tensor sent by ``_reduce_tensor``: a CPU tensor over
    ``buf`` (the out-of-band buffer; the shm store's pinned block for a
    stored object, which the tensor keeps alive)."""
    import torch

    dt = getattr(torch, dtype)
    mv = memoryview(buf)
    if mv.nbytes == 0:
        t = torch.empty(shape, dtype=dt)
    else:
        if mv.readonly:
            # an inline payload is a bytes object: torch has no read-only
            # tensors, so the (small) value gets a writable copy
            buf = bytearray(mv)
        t = torch.frombuffer(buf, dtype=torch.uint8).view(dt).view(shape)
    return t.requires_grad_(requires_grad)


def _reduce_tensor(t):
    if t.layout is not _torch_strided or t.is_quantized or t.is_nested:
        return t.__reduce_ex__(5)  # torch's own (in-band) pickling
    data = t.detach()
    if data.device.type != "cpu":
        data = data.cpu()
    data = data.resolve_conj().resolve_neg().contiguous()
    raw = data.reshape(-1).view(_torch_uint8).numpy()
    return (_rebuild_tensor, (pickle.PickleBuffer(raw),
                              str(data.dtype).rpartition(".")[2],
                              tuple(data.shape), t.requires_grad))


_torch_strided = _torch_uint8 = None


class _Pickler(cloudpickle.Pickler):
    """cloudpickle with the tensor reducer in its dispatch table once
    torch is loaded (``_register_torch``)."""

    dispatch_table = cloudpickle.Pickler.dispatch_table


def _register_torch() -> None:
    global _torch_strided, _torch_uint8
    torch = sys.modules["torch"]
    _torch_strided, _torch_uint8 = torch.strided, torch.uint8
    from collections import ChainMap

    _Pickler.dispatch_table = ChainMap({torch.Tensor: _reduce_tensor},
                                       cloudpickle.Pickler.dispatch_table)


def _dumps(obj: Any, buffer_callback) -> bytes:
    if _torch_uint8 is None and "torch" in sys.modules:
        _register_torch()
    with io.BytesIO() as f:
        _Pickler(f, protocol=5, buffer_callback=buffer_callback).dump(obj)
        return f.getvalue()


def serialize(obj: Any) -> Tuple[bytes, List[memoryview], int]:
    """Serialize ``obj``.

    Returns (pickled_bytes, oob_buffers, total_container_size).
    """
    buffers: List[pickle.PickleBuffer] = []
    pickled = _dumps(obj, buffers.append)
    views = [b.raw() for b in buffers]
    header = 16 + 8 * len(views)
    total = _align(header + len(pickled))
    for v in views:
        total = _align(total + v.nbytes)
    return pickled, views, total


def write_container(dst: memoryview, pickled: bytes, views: List[memoryview]) -> int:
    """Write the container format into ``dst``; returns bytes written."""
    struct.pack_into("<IIQ", dst, 0, _MAGIC, len(views), len(pickled))
    off = 16
    for v in views:
        struct.pack_into("<Q", dst, off, v.nbytes)
        off += 8
    dst[off : off + len(pickled)] = pickled
    off = _align(off + len(pickled))
    for v in views:
        flat = v.cast("B") if v.ndim != 1 or v.format != "B" else v
        if flat.nbytes >= (1 << 20):
            # np.copyto streams ~2x faster than memoryview slice assignment
            # for multi-MB copies (vectorized non-temporal stores).
            import numpy as _np

            _np.copyto(
                _np.frombuffer(dst[off : off + flat.nbytes], dtype=_np.uint8),
                _np.frombuffer(flat, dtype=_np.uint8),
            )
        else:
            dst[off : off + flat.nbytes] = flat
        off = _align(off + flat.nbytes)
    return off


def pack(obj: Any) -> bytes:
    """Serialize to a standalone bytes container (for inline transport)."""
    pickled, views, total = serialize(obj)
    out = bytearray(total)
    write_container(memoryview(out), pickled, views)
    return bytes(out)


def unpack(data, wrap_buffer=None) -> Any:
    """Deserialize a container from bytes/memoryview.

    When ``data`` is a memoryview over shared memory, buffers are zero-copy
    views into it. ``wrap_buffer(mv_slice)`` lets the caller substitute a
    lifetime-tracked buffer object (used by the shm store to pin objects for
    as long as deserialized arrays reference them).
    """
    mv = memoryview(data)
    magic, num_buffers, pickle_len = struct.unpack_from("<IIQ", mv, 0)
    if magic != _MAGIC:
        raise ValueError("corrupt object container (bad magic)")
    off = 16
    buf_lens = []
    for _ in range(num_buffers):
        (n,) = struct.unpack_from("<Q", mv, off)
        buf_lens.append(n)
        off += 8
    pickled = bytes(mv[off : off + pickle_len])
    off = _align(off + pickle_len)
    buffers = []
    for n in buf_lens:
        chunk = mv[off : off + n]
        buffers.append(wrap_buffer(chunk) if wrap_buffer is not None else chunk)
        off = _align(off + n)
    return pickle.loads(pickled, buffers=buffers)
